"""The port's server (``sdrmodem_tpu_torch.server``) end to end on the CPU:
exact-mode RX, TX and the server's device choice.

The cases of ``tests/test_server.py`` that need no fast group, run against
the port's ``SdrModemServer(config, device="cpu")``: the real server, the
mock sdr-server and the wire client of ``tests/server_helpers.py``.  That
client encodes with the JAX package's ``wire``, so every case also shows
that the two servers speak the same bytes.

Tolerances, and why:
- RX symbols against the reference golden: +-2 LSB (the reference's own
  bound, test_fsk_demod.c:43-48), hard decisions equal;
- the server's RX bytes against the port's exact streamer over the same
  buffers: equal (the same calls on the same data);
- the server's TX dump against ``StreamingGfskMod`` over the same
  payloads: equal; against the JAX package's modulator: 1e-3, the
  tolerance ``tests/test_torch_tx.py`` holds the port's TX to (JAX's B5
  carries the phase in float32);
- pipelined against sequential TX: 0.01, the reference's complex golden
  tolerance (test/utils.c:134-140), as in ``tests/test_server.py``.
"""

import asyncio
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from sdrmodem_tpu.dsp.gfsk_mod import GfskModConfig as JaxModConfig
from sdrmodem_tpu.dsp.streaming import StreamingGfskMod as JaxStreaming
from sdrmodem_tpu.server import wire
from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
from sdrmodem_tpu_torch.dsp.gfsk_mod import GfskModConfig
from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
from sdrmodem_tpu_torch.dsp.streaming import StreamingGfskMod
from sdrmodem_tpu_torch.server import session as session_mod
from sdrmodem_tpu_torch.server import tcp_server
from sdrmodem_tpu_torch.server.config import RxSdrType, ServerConfig, TxSdrType
from sdrmodem_tpu_torch.server.tcp_server import SdrModemServer, main
from sdrmodem_tpu_torch.utils.queue import BufferQueue

from tests.server_helpers import MockSdrServer, ModemClient
from tests.test_server import run, rx_request
from tests.test_torch_devices import MockIioLib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LUCKY7 = (48000, 4800, 5000, 2, 2000, True)

TLE = [
    "LUCKY-7",
    "1 44406U 19038W   20069.88080907  .00000505  00000-0  32890-4 0  9992",
    "2 44406  97.5270  32.5584 0026284 107.4758 252.9348 15.12089395 37524",
]
PASS_START = 1583840449  # the lucky7 pass the Doppler goldens were recorded with


def make_config(tmp_path, **kw) -> ServerConfig:
    """``tests/test_server.py:make_config`` on the port's ServerConfig
    (its enums are the port's own)."""
    cfg = ServerConfig()
    cfg.bind_address = "127.0.0.1"
    cfg.port = 0
    cfg.buffer_size = 4096
    cfg.base_path = str(tmp_path)
    cfg.read_timeout_seconds = 5
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def cpu_server(config) -> SdrModemServer:
    return SdrModemServer(config, device="cpu")


def tx_request(path, **kw) -> wire.TxRequest:
    req = wire.TxRequest(
        tx_center_freq=437525000,
        tx_sampling_freq=48000,
        tx_offset=0,
        mod_type=wire.ModemType.GMSK,
        mod_baud_rate=9600,
        fsk_settings=wire.FskModulationSettings(mod_fsk_deviation=5000),
        file_settings=wire.FileSettings(filename=str(path)),
    )
    for k, v in kw.items():
        setattr(req, k, v)
    return req


async def until(cond, timeout=30.0):
    """Wait until ``cond()`` holds; fail after ``timeout`` seconds."""
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    while not cond():
        assert loop.time() - t0 < timeout, "timed out"
        await asyncio.sleep(0.05)


def best_agreement(soft: np.ndarray, payload: bytes) -> float:
    """Hard decisions against the payload's bits, at the best offset."""
    bits_tx = np.unpackbits(np.frombuffer(payload, np.uint8)).astype(np.int8) * 2 - 1
    hard = np.sign(soft).astype(np.int8)
    best = 0.0
    for off in range(0, 64):
        n = min(len(hard) - off, len(bits_tx))
        best = max(best, float((hard[off : off + n] == bits_tx[:n]).mean()))
    return best


def test_ping(tmp_path):
    async def body():
        server = cpu_server(make_config(tmp_path))
        await server.start()
        client = await ModemClient.connect("127.0.0.1", server.port)
        resp = await client.ping()
        assert resp.status == wire.ResponseStatus.SUCCESS
        client.close()
        await server.stop()

    run(body())


@pytest.mark.parametrize(
    "mutate",
    [
        dict(demod_type=99),
        dict(rx_center_freq=0),
        dict(rx_sampling_freq=0),
        dict(demod_baud_rate=0),
        dict(demod_decimation=0),
        dict(demod_destination=42),
        dict(fsk_settings=None),
        dict(doppler=wire.DopplerSettings(tle=["only", "two"])),
    ],
)
def test_invalid_rx_requests(tmp_path, mutate):
    async def body():
        server = cpu_server(make_config(tmp_path))
        await server.start()
        client = await ModemClient.connect("127.0.0.1", server.port)
        resp = await client.rx_request(rx_request(**mutate))
        assert resp.status == wire.ResponseStatus.FAILURE
        assert resp.details == wire.ResponseDetails.INVALID_REQUEST
        client.close()
        await server.stop()

    run(body())


def test_rx_stream_demod_golden(tmp_path, resources_dir):
    """The mock sdr-server pushes the Doppler-corrected capture; the client
    receives int8 soft symbols within +-2 LSB of the golden, equal to the
    port's exact streamer over the same buffers; the dump files hold the
    samples in and the symbols out."""
    iq = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)[:48000]
    golden = np.fromfile(resources_dir / "lucky7.expected.s8", dtype=np.int8)
    expected_symbols = 4801

    async def body():
        mock = MockSdrServer()
        ss_port = await mock.start()
        config = make_config(
            tmp_path, rx_sdr_type=RxSdrType.SDR_SERVER, rx_sdr_server_port=ss_port
        )
        server = cpu_server(config)
        await server.start()

        client = await ModemClient.connect("127.0.0.1", server.port)
        resp = await client.rx_request(
            rx_request(rx_dump_file=True, demod_destination=wire.DemodDestination.BOTH)
        )
        assert resp.status == wire.ResponseStatus.SUCCESS
        client_id = resp.details
        await mock.wait_client()
        center, rate, band, dest = mock.requests[0]
        assert (center, rate, band, dest) == (437525000, 48000, 437525000, 1)

        await mock.send_iq(iq)
        data = await client.read_stream(expected_symbols)
        got = np.frombuffer(data, dtype=np.int8)
        diff = np.abs(got.astype(np.int32) - golden[: len(got)].astype(np.int32))
        assert diff.max() <= 2
        assert (np.sign(got) == np.sign(golden[: len(got)])).all()

        await client.shutdown()
        await asyncio.sleep(0.2)
        dump_iq = np.fromfile(tmp_path / f"rx.sdr2demod.{client_id}.cf32", dtype=np.complex64)
        assert len(dump_iq) == len(iq)
        dump_sym = np.fromfile(tmp_path / f"rx.demod2client.{client_id}.s8", dtype=np.int8)
        assert len(dump_sym) >= expected_symbols

        # the same buffers through the port's exact streamer
        streamer = DemodPipeline(FskDemodConfig(*LUCKY7), config.buffer_size, exact=True,
                                 device="cpu").streamer()
        bufs = np.split(dump_iq, np.arange(config.buffer_size, len(dump_iq), config.buffer_size))
        direct = np.concatenate([streamer.process(b) for b in bufs])
        np.testing.assert_array_equal(dump_sym, direct)
        np.testing.assert_array_equal(got, direct[: len(got)])

        client.close()
        await mock.stop()
        await server.stop()

    run(body())


def test_multiple_clients_share_sdr_connection(tmp_path, resources_dir):
    """Two clients with identical tuning share one sdr-server connection
    (test_tcp_server.c test_multiple_clients)."""

    async def body():
        mock = MockSdrServer()
        ss_port = await mock.start()
        config = make_config(tmp_path, rx_sdr_server_port=ss_port)
        server = cpu_server(config)
        await server.start()

        c1 = await ModemClient.connect("127.0.0.1", server.port)
        r1 = await c1.rx_request(rx_request())
        assert r1.status == wire.ResponseStatus.SUCCESS
        c2 = await ModemClient.connect("127.0.0.1", server.port)
        r2 = await c2.rx_request(rx_request())
        assert r2.status == wire.ResponseStatus.SUCCESS
        assert len(mock.requests) == 1  # one upstream connection only
        assert len(server.streams) == 1
        assert len(server.streams[0].sessions) == 2

        iq = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)[:24000]
        await mock.send_iq(iq)
        d1 = await c1.read_stream(1000)
        d2 = await c2.read_stream(1000)
        assert d1 == d2

        await c1.shutdown()
        await asyncio.sleep(0.2)
        assert len(server.streams) == 1  # second client keeps it alive
        await c2.shutdown()
        # cascade teardown, once each session has drained the buffers it
        # had queued (the poison pill goes behind them)
        await until(lambda: len(server.streams) == 0)
        c1.close()
        c2.close()
        await mock.stop()
        await server.stop()

    run(body())


def test_file_tx_then_rx_loopback(tmp_path):
    """TX to a file device, then demodulate that file back (the
    reference's test_file_data flow, test_tcp_server.c:435-480)."""
    payload = bytes(b"\xca\xfe\x01\x02\x03\x04\x05\x06\x07\x08" * 40)

    async def body():
        tx_file = tmp_path / "tx.cf32"
        config = make_config(tmp_path, tx_sdr_type=TxSdrType.FILE, rx_sdr_type=RxSdrType.FILE)
        server = cpu_server(config)
        await server.start()

        tx = await ModemClient.connect("127.0.0.1", server.port)
        resp = await tx.tx_request(tx_request(tx_file))
        assert resp.status == wire.ResponseStatus.SUCCESS
        ack = await tx.tx_data(payload)
        assert ack.status == wire.ResponseStatus.SUCCESS
        await tx.shutdown()
        await asyncio.sleep(0.2)
        assert tx_file.exists() and tx_file.stat().st_size > 0

        rx = await ModemClient.connect("127.0.0.1", server.port)
        resp = await rx.rx_request(
            rx_request(
                rx_sampling_freq=48000,
                demod_baud_rate=9600,
                demod_decimation=1,
                fsk_settings=wire.FskDemodulationSettings(
                    demod_fsk_deviation=5000,
                    demod_fsk_transition_width=2000,
                    demod_fsk_use_dc_block=False,
                ),
                file_settings=wire.FileSettings(filename=str(tx_file)),
            )
        )
        assert resp.status == wire.ResponseStatus.SUCCESS
        data = await rx.read_stream(len(payload) * 8 - 32)
        best = best_agreement(np.frombuffer(data, dtype=np.int8), payload)
        assert best > 0.995, f"loopback BER {1-best:.4f}"
        await rx.shutdown()
        rx.close()
        tx.close()
        await server.stop()

    run(body())


def test_tx_dump_equals_the_modulator(tmp_path):
    """The server's TX dump over three TxData equals the port's
    StreamingGfskMod over the same payloads, and lies within 1e-3 of the
    JAX package's modulator."""
    rng = np.random.default_rng(3)
    payloads = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (2048, 100, 700)]

    async def body():
        config = make_config(tmp_path, tx_sdr_type=TxSdrType.FILE)
        server = cpu_server(config)
        await server.start()
        tx = await ModemClient.connect("127.0.0.1", server.port)
        resp = await tx.tx_request(tx_request(tmp_path / "sink.cf32", tx_dump_file=True))
        assert resp.status == wire.ResponseStatus.SUCCESS
        for p in payloads:
            assert (await tx.tx_data(p)).status == wire.ResponseStatus.SUCCESS
        await tx.shutdown()
        await asyncio.sleep(0.2)
        tx.close()
        await server.stop()

    run(body())
    (dump_path,) = tmp_path.glob("tx.mod2sdr.*.cf32")
    dump = np.fromfile(dump_path, np.complex64)
    sink = np.fromfile(tmp_path / "sink.cf32", np.complex64)
    port = StreamingGfskMod(GfskModConfig.from_radio(48000, 9600, 5000), device="cpu")
    want = np.concatenate([port.process(p) for p in payloads])
    np.testing.assert_array_equal(dump, want)
    np.testing.assert_array_equal(sink, want)
    jax_mod = JaxStreaming(JaxModConfig.from_radio(48000, 9600, 5000))
    jax_want = np.concatenate([np.asarray(jax_mod.process(p)) for p in payloads])
    assert np.abs(dump - jax_want).max() < 1e-3


def test_plutosdr_tx_e2e_golden(tmp_path):
    """TX through the server into the mocked iio device: the int16 DAC
    samples and the dump file match the reference's goldens
    (test_tcp_server.c:198-239)."""

    async def body():
        lib = MockIioLib()
        config = make_config(tmp_path, tx_sdr_type=TxSdrType.PLUTOSDR, iio_lib=lib)
        server = cpu_server(config)
        await server.start()
        tx = await ModemClient.connect("127.0.0.1", server.port)
        resp = await tx.tx_request(
            wire.TxRequest(
                tx_center_freq=437525000,
                tx_sampling_freq=580000,
                tx_dump_file=True,
                tx_offset=0,
                mod_type=wire.ModemType.GMSK,
                mod_baud_rate=4800,
                fsk_settings=wire.FskModulationSettings(mod_fsk_deviation=5000),
            )
        )
        assert resp.status == wire.ResponseStatus.SUCCESS
        ack = await tx.tx_data(bytes(range(50)))
        assert ack.status == wire.ResponseStatus.SUCCESS
        await tx.shutdown()
        await asyncio.sleep(0.2)
        tx.close()
        await server.stop()
        return lib

    lib = run(body())
    pushed = np.frombuffer(b"".join(lib.tx_pushed), np.int16)
    assert len(pushed) == 50 * 8 * 120 * 2  # 50 bytes * 8 bits * sps, I+Q
    expected = np.zeros(50, np.int16)
    expected[0::2] = 32767
    np.testing.assert_array_equal(pushed[:50], expected)
    dumps = list(tmp_path.glob("tx.mod2sdr.*.cf32"))
    assert len(dumps) == 1
    dump = np.frombuffer(dumps[0].read_bytes(), np.complex64)
    assert len(dump) == 50 * 8 * 120
    np.testing.assert_allclose(dump[:50].real, 1.0, atol=1e-3)
    np.testing.assert_allclose(dump[:50].imag, 0.0, atol=1e-3)


def test_plutosdr_rx_e2e(tmp_path):
    """RX over the mocked pluto demodulates a GMSK capture back to its
    bits; a second concurrent client gets RX_IS_BEING_USED, and a later
    client succeeds after teardown (reference src/tcp_server.c:425-430)."""
    payload = bytes(b"\xca\xfe\x01\x02\x03\x04\x05\x06\x07\x08" * 10)
    iq = StreamingGfskMod(GfskModConfig.from_radio(576000, 9600, 5000), device="cpu").process(payload)
    raw = np.empty(2 * len(iq), np.int16)
    raw[0::2] = np.round(iq.real * 2048.0).astype(np.int16)
    raw[1::2] = np.round(iq.imag * 2048.0).astype(np.int16)

    def request():
        return rx_request(
            rx_sampling_freq=576000,
            demod_baud_rate=9600,
            demod_decimation=6,
            fsk_settings=wire.FskDemodulationSettings(
                demod_fsk_deviation=5000,
                demod_fsk_transition_width=2000,
                demod_fsk_use_dc_block=False,
            ),
        )

    async def body():
        lib = MockIioLib(rx_data=raw)
        config = make_config(tmp_path, rx_sdr_type=RxSdrType.PLUTOSDR, iio_lib=lib)
        server = cpu_server(config)
        await server.start()

        rx = await ModemClient.connect("127.0.0.1", server.port)
        resp = await rx.rx_request(request())
        assert resp.status == wire.ResponseStatus.SUCCESS

        rx2 = await ModemClient.connect("127.0.0.1", server.port)
        resp2 = await rx2.rx_request(request())
        assert resp2.status == wire.ResponseStatus.FAILURE
        assert resp2.details == wire.ResponseDetails.RX_IS_BEING_USED
        rx2.close()

        data = await rx.read_stream(len(payload) * 8 - 32)
        best = best_agreement(np.frombuffer(data, dtype=np.int8), payload)
        assert best > 0.995, f"pluto rx BER {1-best:.4f}"
        # TX LO was powered down for RX sensitivity (plutosdr.c:251-258)
        assert any("powerdown" in str(k) and v for k, v in lib.attrs.items())
        await rx.shutdown()
        await asyncio.sleep(0.3)
        rx.close()

        server.config.iio_lib = MockIioLib(rx_data=raw)
        rx3 = await ModemClient.connect("127.0.0.1", server.port)
        resp3 = await rx3.rx_request(request())
        assert resp3.status == wire.ResponseStatus.SUCCESS
        await rx3.shutdown()
        rx3.close()
        await server.stop()

    run(body())


def test_tx_pipelined_coalescing_matches_sequential(tmp_path):
    """A pipelining client gets every ACK in order, the modulated stream
    matches one-message-at-a-time processing, and the server coalesced the
    burst into fewer modulator calls."""
    rng = np.random.default_rng(7)
    payloads = [rng.integers(0, 256, 512, dtype=np.uint8).tobytes() for _ in range(6)]

    async def run_tx(fname, pipelined):
        server = cpu_server(make_config(tmp_path, tx_sdr_type=TxSdrType.FILE))
        await server.start()
        tx = await ModemClient.connect("127.0.0.1", server.port)
        resp = await tx.tx_request(tx_request(fname))
        assert resp.status == wire.ResponseStatus.SUCCESS
        if pipelined:
            for p in payloads:
                await tx._send(wire.MsgType.TX_DATA, wire.TxData(data=p).encode())
            for _ in payloads:
                ack = await tx.read_response()
                assert ack.status == wire.ResponseStatus.SUCCESS
        else:
            for p in payloads:
                ack = await tx.tx_data(p)
                assert ack.status == wire.ResponseStatus.SUCCESS
        await tx.shutdown()
        await asyncio.sleep(0.2)
        tx.close()
        await server.stop()
        return server

    async def body():
        seq_file = tmp_path / "seq.cf32"
        pipe_file = tmp_path / "pipe.cf32"
        server_seq = await run_tx(seq_file, pipelined=False)
        assert server_seq.tx_msgs_coalesced == len(payloads)
        server_pipe = await run_tx(pipe_file, pipelined=True)
        assert server_pipe.tx_msgs_coalesced == len(payloads)
        assert server_pipe.tx_bursts < len(payloads)
        seq = np.frombuffer(seq_file.read_bytes(), np.complex64)
        pipe = np.frombuffer(pipe_file.read_bytes(), np.complex64)
        assert len(seq) == len(pipe) == sum(len(p) for p in payloads) * 8 * 5
        assert np.abs(seq - pipe).max() < 0.01

    run(body())


def test_tx_busy(tmp_path):
    async def body():
        server = cpu_server(make_config(tmp_path, tx_sdr_type=TxSdrType.FILE))
        await server.start()
        req = tx_request(tmp_path / "a.cf32")
        c1 = await ModemClient.connect("127.0.0.1", server.port)
        r1 = await c1.tx_request(req)
        assert r1.status == wire.ResponseStatus.SUCCESS
        c2 = await ModemClient.connect("127.0.0.1", server.port)
        r2 = await c2.tx_request(req)
        assert r2.status == wire.ResponseStatus.FAILURE
        assert r2.details == wire.ResponseDetails.TX_IS_BEING_USED
        await c1.shutdown()
        c1.close()
        c2.close()
        await server.stop()

    run(body())


def test_tx_not_supported(tmp_path):
    async def body():
        server = cpu_server(make_config(tmp_path, tx_sdr_type=TxSdrType.NONE))
        await server.start()
        c = await ModemClient.connect("127.0.0.1", server.port)
        r = await c.tx_request(
            wire.TxRequest(
                tx_center_freq=1, tx_sampling_freq=1, mod_type=wire.ModemType.GMSK,
                mod_baud_rate=1, fsk_settings=wire.FskModulationSettings(1),
            )
        )
        assert r.status == wire.ResponseStatus.FAILURE
        assert r.details == wire.ResponseDetails.INVALID_REQUEST
        c.close()
        await server.stop()

    run(body())


@pytest.mark.parametrize("case", ["invalid_basepath", "bad_tle", "invalid_fsk_params"])
def test_rx_internal_error(tmp_path, case):
    """A dump file that cannot be opened, three TLE lines that fail the
    checksum, and FSK parameters that fail filter design (Carson cutoff
    past Nyquist) each answer INTERNAL_ERROR (test_dsp_worker.c's
    test_invalid_basepath, test_invalid_doppler_configuration and
    test_invalid_fsk_configuration)."""
    config = make_config(tmp_path)
    req = {
        "invalid_basepath": lambda: rx_request(rx_dump_file=True),
        "bad_tle": lambda: rx_request(doppler=wire.DopplerSettings(
            tle=["SAT", "1 garbage", "2 garbage"],
            latitude=537200000, longitude=475700000, altitude=0)),
        "invalid_fsk_params": lambda: rx_request(
            rx_sampling_freq=8000,
            fsk_settings=wire.FskDemodulationSettings(
                demod_fsk_deviation=50000, demod_fsk_transition_width=2000,
                demod_fsk_use_dc_block=True)),
    }[case]()
    if case == "invalid_basepath":
        config.base_path = str(tmp_path / "does" / "not" / "exist")

    async def body():
        server = cpu_server(config)
        await server.start()
        c = await ModemClient.connect("127.0.0.1", server.port)
        r = await c.rx_request(req)
        assert r.status == wire.ResponseStatus.FAILURE
        assert r.details == wire.ResponseDetails.INTERNAL_ERROR
        c.close()
        await server.stop()

    run(body())


def test_observability_counters(tmp_path):
    """Running samples/s log lines, queue-drop and overflow counters on
    the session (SURVEY §5)."""
    import logging

    async def body():
        q = BufferQueue(2, blocking=False)
        for _ in range(5):
            await q.put(np.zeros(4, np.complex64))
        assert q.dropped == 3

        sess = session_mod.RxSession(7, rx_request(), make_config(tmp_path), writer=None,
                                     dsp_device="cpu")
        sess._rate_interval = 0.0
        records = []
        handler = logging.Handler()
        handler.emit = lambda r: records.append(r.getMessage())
        session_mod.log.addHandler(handler)
        old_level = session_mod.log.level
        session_mod.log.setLevel(logging.INFO)
        try:
            sess.note_progress(48000)
            sess.note_progress(48000)
        finally:
            session_mod.log.removeHandler(handler)
            session_mod.log.setLevel(old_level)
        assert sess.samples_in == 96000
        assert any("rx rate" in m and "queue drops" in m for m in records)
        await sess.stop()

    asyncio.run(body())


def test_exact_session_takes_queued_buffers_in_one_call(tmp_path, resources_dir):
    """Buffers already queued when an exact session's worker wakes go into
    one streamer call, with Doppler still corrected a buffer at a time: the
    symbols equal the streamer's called once a buffer."""
    iq = np.fromfile(resources_dir / "lucky7.cf32", np.complex64)[: 4 * 3000]
    bufs = [iq[k * 3000 : (k + 1) * 3000] for k in range(4)]
    settings = wire.DopplerSettings(tle=TLE, latitude=537200000, longitude=475700000, altitude=0)

    def doppler():
        return session_mod.doppler_from_settings(settings, 48000, 437525000, 0, PASS_START)

    async def body():
        sess = session_mod.RxSession(7, rx_request(), make_config(tmp_path), writer=None,
                                     dsp_device="cpu")
        sess.doppler = doppler()
        calls, out, process = [], [], sess.demod.process

        def counted(buf):
            calls.append(len(buf))
            out.append(process(buf))
            return out[-1]

        sess.demod.process = counted
        for buf in bufs:
            await sess.put(buf)
        await sess.queue.interrupt()
        sess.start()
        await sess.finished.wait()
        return calls, np.concatenate(out), sess

    calls, got, sess = asyncio.run(body())
    assert calls == [len(iq)]
    assert sess.samples_in == len(iq)
    dop, per_buffer = doppler(), DemodPipeline(sess.fsk_config, 4096, exact=True, device="cpu").streamer()
    want = np.concatenate([per_buffer.process(dop.process_rx(buf)) for buf in bufs])
    np.testing.assert_array_equal(got, want)
    # one Doppler call over the whole would step its shift once, not four times
    whole = DemodPipeline(sess.fsk_config, 4096, exact=True, device="cpu").streamer()
    assert not np.array_equal(whole.process(doppler().process_rx(iq)), want)


def test_server_defaults_to_the_card(tmp_path):
    """Without a device the server and its CLI take the card; on a machine
    without one they raise and name --device cpu, and never carry on on
    the CPU by themselves."""
    conf = tmp_path / "server.conf"
    conf.write_text(f'bind_address = "127.0.0.1";\nport = 0;\nbase_path = "{tmp_path}";\n')
    if torch.cuda.is_available():
        assert SdrModemServer(make_config(tmp_path)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="--device cpu"):
        SdrModemServer(make_config(tmp_path))
    with pytest.raises(RuntimeError, match="--device cpu"):
        main([str(conf)])
    with pytest.raises(RuntimeError, match="--device cpu"):
        main([str(conf), "--device", "cuda"])
    # the session classes default to the card too
    with pytest.raises(RuntimeError, match="no CUDA device"):
        session_mod.RxSession(1, rx_request(), make_config(tmp_path), writer=None)


def test_server_device_faults_are_not_reported_as_no_card(tmp_path, monkeypatch):
    """Only a missing card is reported as one: a mistyped device and a
    fault of a card that is there raise as they are, without the
    --device cpu hint."""
    with pytest.raises(RuntimeError) as err:
        SdrModemServer(make_config(tmp_path), device="bogus")
    assert "bogus" in str(err.value) and "--device cpu" not in str(err.value)

    def failing(device=None):
        raise RuntimeError("CUDA driver initialization failed")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tcp_server, "resolve_device", failing)
    with pytest.raises(RuntimeError, match="^CUDA driver initialization failed$"):
        SdrModemServer(make_config(tmp_path))


def test_cli_serves_on_the_cpu(tmp_path):
    """``python -m sdrmodem_tpu_torch.server <config> --device cpu`` serves:
    it answers a ping, then stops on SIGTERM."""
    conf = tmp_path / "server.conf"
    conf.write_text(f'bind_address = "127.0.0.1";\nport = 0;\nbase_path = "{tmp_path}";\n')
    proc = subprocess.Popen(
        [sys.executable, "-m", "sdrmodem_tpu_torch.server", str(conf), "--device", "cpu"],
        cwd=REPO, stderr=subprocess.PIPE, text=True,
    )
    try:
        port = None
        for line in proc.stderr:
            if "listening on" in line:
                port = int(line.rsplit(":", 1)[1])
                break
        assert port, "the server did not start"

        async def ping():
            client = await ModemClient.connect("127.0.0.1", port)
            resp = await client.ping()
            client.close()
            return resp

        assert run(ping()).status == wire.ResponseStatus.SUCCESS
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
