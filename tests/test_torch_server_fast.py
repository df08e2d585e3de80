"""The port's fast mode (``demod_mode = fast``) on the CPU: the
``BatchedRxGroup`` of ``sdrmodem_tpu_torch/server/session.py`` and the
server around it.

The cases of ``tests/test_server.py`` that drive the fast group, run on the
port with ``device="cpu"`` (where the step's kernels run their plain
versions), the lane sharding over several devices (``SDRM_SERVER_MESH``)
on two CPU shards.  Beside them: every lane's symbols equal the port's step
run directly over the same blocks and Doppler tables, ``_reset_lane``
gives a lane ``init_full_state(1)``'s values and leaves every other lane's
bits alone, and a sharded group's lanes equal the one-device group's.

Tolerances: the lanes against the direct step and the one-device group,
and the reset, bit for bit (the same calls on the same data); the sharded
group against the JAX package's sharded group as JAX's own test holds its
two groups (+-2 LSB, fewer than 1% differing); symbols against the
reference golden +-2 LSB with hard decisions equal (test_fsk_demod.c:43-48).
"""

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

from sdrmodem_tpu.server import wire
from sdrmodem_tpu_torch.dsp.doppler import Doppler
from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
from sdrmodem_tpu_torch.server.config import RxSdrType
from sdrmodem_tpu_torch.server.session import BatchedRxGroup, RxSession, doppler_from_settings
from sdrmodem_tpu_torch.server.tcp_server import SdrModemServer
from sdrmodem_tpu_torch.utils.convert import doppler_tables_from_numpy, segment_tables

from tests.server_helpers import MockSdrServer, ModemClient
from tests.test_server import run, rx_request
from tests.test_torch_server import PASS_START, TLE, make_config
from tests.test_torch_fir import one_thread  # noqa: F401 (torch on one thread)

LUCKY7 = FskDemodConfig(48000, 4800, 5000, 2, 2000, True)


class Stub:
    """A fast lane's session as the group sees it."""

    samples_in = 0
    group = None
    lane = -1
    id = 0

    def __init__(self, doppler=None):
        self.doppler = doppler
        self.finished = asyncio.Event()
        self.emitted = []

    def note_progress(self, n):
        self.samples_in += n

    async def emit(self, symbols):
        self.emitted.append(np.asarray(symbols))


async def _drain(group, n, timeout=60.0):
    """Wait until the group's worker has processed >= n blocks."""
    t0 = time.monotonic()
    while group.blocks_processed < n:
        assert time.monotonic() - t0 < timeout, "group worker stalled"
        await asyncio.sleep(0.01)


def noise(seed, n=2048):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def state_numpy(state):
    """Every leaf of a DemodStateFull as a numpy copy (None kept)."""
    def leaf(t):
        return None if t is None else t.detach().clone().numpy()

    return [leaf(t) for t in state[:4]] + [leaf(t) for t in state.clock]


def stall(group):
    """Make the group's step wait: (entered, release) events."""
    entered, release = threading.Event(), threading.Event()
    orig = group._step_host

    def slow_step(x, dop):
        entered.set()
        release.wait(60)
        return orig(x, dop)

    group._step_host = slow_step
    return entered, release


def test_fast_lane_attach_race_gets_fresh_state():
    """A client attaching while a step is in flight starts from ZERO
    history: attach() queues the lane reset and _step_block applies it
    before the next step."""

    async def body():
        group = BatchedRxGroup(LUCKY7, 2048, device="cpu")
        a = Stub()
        group.attach(a)
        assert a.lane == 0

        entered, release = threading.Event(), threading.Event()
        captured = []
        orig = group._step_host

        def slow_step(x, dop):
            captured.append(group.state)
            entered.set()
            release.wait(60)
            return orig(x, dop)

        group._step_host = slow_step
        buf = noise(0)
        await group.feed(buf)
        await asyncio.to_thread(entered.wait, 60)
        # step 1 in flight: occupant leaves, new client takes the lane
        group.detach(a)
        b = Stub()
        group.attach(b)
        assert b.lane == 0
        release.set()
        await _drain(group, 1)
        assert 0 in group._pending_resets  # reset survives the step return

        await group.feed(buf)  # step 2: b's first step
        await _drain(group, 2)
        seen = captured[1]
        cp = seen.quad_prev.shape[1] // 2
        assert not seen.lpf1_hist[:, 0].any()
        assert not seen.lpf1_hist[:, cp].any()  # Q half
        assert not seen.clock.suffix[:, 0].any()
        assert seen.clock.resid[0] == 0
        # every empty lane rides the same broadcast stream: equal, real history
        assert torch.equal(group.state.lpf1_hist[:, 1], group.state.lpf1_hist[:, 2])
        assert (group.state.lpf1_hist[:, 1] != 0).any()
        await group.close()

    run(body())


def test_group_ingest_overlaps_device_step():
    """With the step stalled, feed() keeps accepting blocks (lossy mode)
    and the bounded queue drops instead of blocking (reference
    src/queue.c:124-128, 168-200)."""

    async def body():
        group = BatchedRxGroup(LUCKY7, 2048, queue_capacity=2, device="cpu")
        s = Stub()
        group.attach(s)
        entered, release = stall(group)
        buf = noise(1)
        await group.feed(buf)
        await asyncio.to_thread(entered.wait, 60)
        t0 = time.monotonic()
        for _ in range(4):  # capacity 2 -> the extras hit the lossy drop
            await group.feed(buf)
        assert time.monotonic() - t0 < 5.0  # the stall is 60 s
        assert group.queue.dropped >= 2
        release.set()
        await _drain(group, 3)
        assert group.blocks_processed == 3
        assert s.samples_in == 3 * 2048
        await group.close()

    run(body())


def test_group_blocking_mode_backpressures_file_reader():
    """File sources must not drop: with the queue full and the step
    stalled, feed() blocks until the worker frees space (the reference's
    blocking queue, src/dsp_worker.c:176-179)."""

    async def body():
        group = BatchedRxGroup(LUCKY7, 2048, blocking=True, queue_capacity=2, device="cpu")
        s = Stub()
        group.attach(s)
        entered, release = stall(group)
        buf = noise(2)
        await group.feed(buf)
        await asyncio.to_thread(entered.wait, 60)
        await group.feed(buf)
        await group.feed(buf)
        blocked = asyncio.create_task(group.feed(buf))
        await asyncio.sleep(0.2)
        assert not blocked.done()  # reader is held, nothing dropped
        release.set()
        await blocked
        await _drain(group, 4)
        assert group.queue.dropped == 0
        assert s.samples_in == 4 * 2048
        await group.close()

    run(body())


def test_fast_emit_after_stop_is_noop(tmp_path):
    """An in-flight step that snapshotted a stopped lane emits into a
    no-op, not a ValueError that would kill the stream reader."""

    async def body():
        cfg = make_config(tmp_path, demod_mode="fast")
        req = rx_request(demod_destination=wire.DemodDestination.BOTH)
        s = RxSession(7, req, cfg, writer=None, dsp_device="cpu")
        await s.emit(np.ones(8, np.int8))
        assert s.symbols_out == 8
        s.finish_fast()
        s.finish_fast()  # idempotent
        await s.emit(np.ones(8, np.int8))
        assert s.symbols_out == 8

    run(body())


def test_rx_stream_demod_fast_mode(tmp_path, resources_dir):
    """Clients on one SDR stream are lanes of one batched step: two
    clients receive the same symbols, within +-2 LSB of the golden."""
    iq = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)[:24576]
    golden = np.fromfile(resources_dir / "lucky7.expected.s8", dtype=np.int8)

    async def body():
        mock = MockSdrServer()
        ss_port = await mock.start()
        config = make_config(tmp_path, rx_sdr_type=RxSdrType.SDR_SERVER,
                             rx_sdr_server_port=ss_port, demod_mode="fast")
        server = SdrModemServer(config, device="cpu")
        await server.start()
        c1 = await ModemClient.connect("127.0.0.1", server.port)
        assert (await c1.rx_request(rx_request())).status == wire.ResponseStatus.SUCCESS
        c2 = await ModemClient.connect("127.0.0.1", server.port)
        assert (await c2.rx_request(rx_request())).status == wire.ResponseStatus.SUCCESS
        await mock.wait_client()
        assert len(mock.requests) == 1  # shared sdr connection
        (stream,) = server.streams
        (group,) = stream.groups
        assert sorted(group.lanes) == [0, 1] and group.device == torch.device("cpu")

        await mock.send_iq(iq)
        # 24576 samples = 6 full 4096-sample blocks -> ~2400 symbols
        d1 = np.frombuffer(await c1.read_stream(2300, timeout=90), dtype=np.int8)
        d2 = np.frombuffer(await c2.read_stream(2300, timeout=90), dtype=np.int8)
        np.testing.assert_array_equal(d1, d2)
        diff = np.abs(d1.astype(np.int32) - golden[: len(d1)].astype(np.int32))
        assert diff.max() <= 2
        assert (np.sign(d1) == np.sign(golden[: len(d1)])).all()

        await c1.shutdown()
        await c2.shutdown()
        c1.close()
        c2.close()
        await mock.stop()
        await server.stop()

    run(body())


def test_group_cap_demotes_to_standalone(tmp_path, monkeypatch, resources_dir):
    """SDRM_MAX_GROUPS: a fast client whose config matches no group past
    the cap runs as a standalone (float32 streamer) lane; both clients get
    sane symbols from the shared connection."""
    monkeypatch.setenv("SDRM_MAX_GROUPS", "1")
    iq = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)[:24576]
    golden = np.fromfile(resources_dir / "lucky7.expected.s8", dtype=np.int8)

    async def body():
        mock = MockSdrServer()
        ss_port = await mock.start()
        config = make_config(tmp_path, rx_sdr_type=RxSdrType.SDR_SERVER,
                             rx_sdr_server_port=ss_port, demod_mode="fast")
        server = SdrModemServer(config, device="cpu")
        await server.start()
        c1 = await ModemClient.connect("127.0.0.1", server.port)
        assert (await c1.rx_request(rx_request())).status == wire.ResponseStatus.SUCCESS
        c2 = await ModemClient.connect("127.0.0.1", server.port)
        req2 = rx_request(
            fsk_settings=wire.FskDemodulationSettings(
                demod_fsk_deviation=5000, demod_fsk_transition_width=1000,
                demod_fsk_use_dc_block=True,
            )
        )
        assert (await c2.rx_request(req2)).status == wire.ResponseStatus.SUCCESS
        await mock.wait_client()
        assert len(server.streams) == 1
        stream = server.streams[0]
        assert len(stream.groups) == 1  # cap respected
        assert sorted(s.mode for s in stream.sessions) == ["fast", "standalone"]

        await mock.send_iq(iq)
        d1 = np.frombuffer(await c1.read_stream(2300, timeout=90), dtype=np.int8)
        d2 = np.frombuffer(await c2.read_stream(2300, timeout=90), dtype=np.int8)
        diff1 = np.abs(d1.astype(np.int32) - golden[: len(d1)].astype(np.int32))
        assert diff1.max() <= 2
        assert np.abs(d2.astype(np.int32)).max() > 20

        await c1.shutdown()
        await c2.shutdown()
        c1.close()
        c2.close()
        await mock.stop()
        await server.stop()

    run(body())


def lane_settings(k):
    """Lane k's Doppler: the lucky7 pass, starting k seconds in."""
    return wire.DopplerSettings(tle=TLE, latitude=537200000, longitude=475700000, altitude=0), \
        PASS_START + k


def test_group_lanes_equal_the_direct_step(resources_dir):
    """Every lane's symbols equal the port's step run directly over the
    same blocks, with Doppler tables from device_segments of Dopplers built
    by doppler_from_settings with the same settings, bit for bit."""
    block, n_blocks = 4096, 3
    iq = np.fromfile(resources_dir / "lucky7.cf32", dtype=np.complex64)[: block * n_blocks]
    with_doppler = (0, 2, 5)
    lanes = 6

    def dop(k):
        settings, start = lane_settings(k)
        return doppler_from_settings(settings, 48000, 437525000, 0, start)

    async def body():
        group = BatchedRxGroup(LUCKY7, block, queue_capacity=8, device="cpu")
        stubs = [Stub(dop(k) if k in with_doppler else None) for k in range(lanes)]
        for s in stubs:
            group.attach(s)
        await group.feed(iq)
        await _drain(group, n_blocks)
        await group.close()
        return [np.concatenate(s.emitted) for s in stubs]

    got = run(body())

    pipe = DemodPipeline(LUCKY7, block, exact=False, device="cpu")
    step = pipe.make_batched_step_full("pallas", doppler=True, layout="fanout")
    c = BatchedRxGroup.LANES
    state = pipe.init_full_state(c)
    dops = {k: dop(k) for k in with_doppler}
    want = {k: [] for k in range(lanes)}
    for t in range(n_blocks):
        acc = iq[t * block : (t + 1) * block]
        x = torch.from_numpy(np.stack([acc.real, acc.imag]).astype(np.float32))
        rows = {k: d.device_segments(block, +1) for k, d in dops.items()}
        tables = doppler_tables_from_numpy(
            segment_tables(rows, Doppler.max_rows(block, LUCKY7.sampling_freq), c), c, device="cpu")
        state, sym, cnt = step(state, x, tables)
        for k in range(lanes):
            want[k] += [sym[k, j, : cnt[k, j]].numpy() for j in range(cnt.shape[1])]
    for k in range(lanes):
        np.testing.assert_array_equal(got[k], np.concatenate(want[k]), err_msg=f"lane {k}")
    # the Doppler lanes differ from the plain ones
    assert not np.array_equal(got[0][:500], got[1][:500])


def test_reset_lane_gives_fresh_state_and_leaves_the_others():
    """_reset_lane writes init_full_state(1)'s values into one lane (I and
    Q halves), leaves every other lane's bits alone, and writes into no
    tensor that the template or an earlier state holds."""
    group = BatchedRxGroup(LUCKY7, 2048, device="cpu")
    for k in range(3):
        group.attach(Stub())
    x = np.stack([noise(4).real, noise(4).imag]).astype(np.float32)
    tables = segment_tables({}, group.dop_rows, group.LANES)
    group.state = group._step_host(x, tables)[0]
    before = group.state
    before_np = state_numpy(before)
    template_np = state_numpy(group._init_state_template)
    lane, c = 1, group.LANES
    group._reset_lane(lane)
    after_np = state_numpy(group.state)
    fresh = state_numpy(group.pipe.init_full_state(1))
    for a, b in zip(state_numpy(before), before_np):  # the earlier state is untouched
        assert (a is None and b is None) or np.array_equal(a, b)
    for tmpl, init in zip(template_np, fresh):  # the template is untouched
        assert (tmpl is None and init is None) or np.array_equal(tmpl, init)
    assert_reset(after_np, before_np, fresh, lane, c)
    assert np.any(before_np[0][:, lane] != 0)  # the step had left history in the lane


def assert_reset(after_np, before_np, fresh, lane, c):
    """``lane`` of a c-lane state holds init_full_state(1)'s values (I and
    Q halves) and every other lane its bits from before."""
    for got, was, init in zip(after_np, before_np, fresh):
        if got is None:
            assert was is None and init is None
            continue
        if got.ndim == 1:
            lanes = [lane]
            np.testing.assert_array_equal(got[lane], init[0])
        elif got.shape[-1] == 2 * c:
            lanes = [lane, c + lane]
            np.testing.assert_array_equal(got[..., lane], init[..., 0])
            np.testing.assert_array_equal(got[..., c + lane], init[..., 1])
        else:
            lanes = [lane]
            np.testing.assert_array_equal(got[..., lane], init[..., 0])
        others = np.delete(got, lanes, axis=-1)
        np.testing.assert_array_equal(others, np.delete(was, lanes, axis=-1))


def group_lanes(iq, block, n_blocks, lanes, dopplers=(), **kw):
    """Each of ``lanes`` stub lanes' symbols from a group over ``iq``; lane k
    with the lucky7 pass's Doppler from PASS_START + k where k is in
    ``dopplers``."""

    def dop(k):
        settings, start = lane_settings(k)
        return doppler_from_settings(settings, 48000, 437525000, 0, start)

    async def body():
        group = BatchedRxGroup(LUCKY7, block, queue_capacity=8, **kw)
        stubs = [Stub(dop(k) if k in dopplers else None) for k in range(lanes)]
        for s in stubs:
            group.attach(s)
        await group.feed(iq[: n_blocks * block])
        await _drain(group, n_blocks)
        await group.close()
        return group, [np.concatenate(s.emitted) for s in stubs]

    return run(body())


def test_group_mesh_lanes_equal_the_one_device_group(resources_dir, monkeypatch):
    """SDRM_SERVER_MESH's sharding: a 256-lane group on two CPU shards (lanes
    0-127 and 128-255, each with its own pipeline, step and state) gives
    every lane the bytes of the one-device group, bit for bit, Doppler
    lanes in both shards included."""
    monkeypatch.setattr(BatchedRxGroup, "LANES", 256)
    block, n_blocks, lanes = 4096, 2, 131
    iq = np.fromfile(resources_dir / "lucky7.cf32", dtype=np.complex64)
    dopplers = (0, 5, 128, 130)
    sharded, got = group_lanes(iq, block, n_blocks, lanes, dopplers, device="cpu", devices=["cpu", "cpu"])
    assert sharded.sharded and sharded.local == 128 and len(sharded.state) == 2
    assert [s.quad_prev.shape for s in sharded.state] == [(1, 256), (1, 256)]
    one, want = group_lanes(iq, block, n_blocks, lanes, dopplers, device="cpu")
    assert not one.sharded and one.state.quad_prev.shape == (1, 512)
    for k in range(lanes):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"lane {k}")
    assert not np.array_equal(got[128][:300], got[129][:300])  # Doppler sets lane 128 apart


def test_group_mesh_matches_the_jax_mesh_group(resources_dir, monkeypatch):
    """The JAX package's own SDRM_SERVER_MESH case
    (``tests/test_server.py::test_group_mesh_shards_lanes_over_devices``:
    256 lanes, two shards, blocks of 8192, the corrected capture) on the
    port: the sharded group's lane 0 within that test's tolerance of the
    JAX sharded group's, and within +-2 LSB of the golden."""
    from sdrmodem_tpu.dsp.fsk_demod import FskDemodConfig as JaxConfig
    from sdrmodem_tpu.server.session import BatchedRxGroup as JaxGroup

    iq = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)[:16384]
    golden = np.fromfile(resources_dir / "lucky7.expected.s8", dtype=np.int8)
    monkeypatch.setattr(BatchedRxGroup, "LANES", 256)
    _, got = group_lanes(iq, 8192, 2, 1, device="cpu", devices=["cpu", "cpu"])

    async def jax_group():
        group = JaxGroup(JaxConfig(48000, 4800, 5000, 2, 2000, True), 8192, queue_capacity=4)
        s = Stub()
        group.attach(s)
        await group.feed(iq)
        await _drain(group, 2, timeout=300)
        await group.close()
        return np.concatenate(s.emitted)

    monkeypatch.setattr(JaxGroup, "LANES", 256)
    monkeypatch.setenv("SDRM_SERVER_MESH", "1")
    want = run(jax_group())
    assert len(got[0]) == len(want)
    d = np.abs(got[0].astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 2 and (d > 0).mean() < 0.01
    dg = np.abs(got[0].astype(np.int32) - golden[: len(got[0])].astype(np.int32))
    assert dg.max() <= 2


def test_group_mesh_reset_touches_only_its_shard(monkeypatch):
    """A reset of lane 129 (shard 1's lane 1) writes only shard 1's state:
    shard 0's state is the same object, and in shard 1 the lane gets
    init_full_state(1)'s values while every other lane keeps its bits."""
    monkeypatch.setattr(BatchedRxGroup, "LANES", 256)
    group = BatchedRxGroup(LUCKY7, 2048, device="cpu", devices=["cpu", "cpu"])
    for k in range(130):
        group.attach(Stub())
    x = np.stack([noise(4).real, noise(4).imag]).astype(np.float32)
    group.state = group._step_host(x, segment_tables({}, group.dop_rows, group.LANES))[0]
    before = group.state
    before_np = [state_numpy(s) for s in before]
    group._reset_lane(129)
    assert group.state[0] is before[0]
    assert_reset(state_numpy(group.state[1]), before_np[1], state_numpy(group.pipe.init_full_state(1)), 1, 128)
    assert np.any(before_np[1][0][:, 1] != 0)  # the step had left history in the lane


@pytest.mark.parametrize("lanes,visible,want", [
    (256, 8, 2), (512, 4, 4), (512, 8, 4), (384, 4, 3), (128, 8, 1), (256, 1, 1), (1024, 3, 2),
])
def test_mesh_shards_follows_the_jax_rule(lanes, visible, want):
    """SDRM_SERVER_MESH's choice: the most visible devices that divide the
    lanes into multiples of 128 (sdrmodem_tpu/server/session.py:375-382)."""
    from sdrmodem_tpu_torch.server.session import mesh_shards

    assert mesh_shards(lanes, visible) == want


def test_group_devices_are_checked_and_the_mesh_needs_cards(monkeypatch):
    """Devices that do not split the lanes into 128s raise, never quietly
    run on fewer; SDRM_SERVER_MESH on a CPU group keeps the one device, as
    there is no card to shard over; without the variable one device."""
    monkeypatch.setattr(BatchedRxGroup, "LANES", 256)
    with pytest.raises(ValueError, match="multiples of 128"):
        BatchedRxGroup(LUCKY7, 2048, device="cpu", devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="multiples of 128"):
        BatchedRxGroup(LUCKY7, 2048, device="cpu", devices=["cpu"] * 4)
    monkeypatch.setenv("SDRM_SERVER_MESH", "1")
    group = BatchedRxGroup(LUCKY7, 2048, device="cpu")
    assert group.devices == [torch.device("cpu")] and group.state.quad_prev.shape == (1, 512)
    monkeypatch.setenv("SDRM_SERVER_MESH", "0")
    group = BatchedRxGroup(LUCKY7, 2048, device="cpu", devices=["cpu"] * 2)
    assert group.sharded and group.devices == [torch.device("cpu")] * 2


def test_server_passes_its_devices_to_the_group(tmp_path, resources_dir, monkeypatch):
    """SdrModemServer(config, device, devices): a fast client's group
    shards its lanes over the server's devices, and the client's symbols
    stay within +-2 LSB of the golden."""
    monkeypatch.setattr(BatchedRxGroup, "LANES", 256)
    iq = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)[:16384]
    golden = np.fromfile(resources_dir / "lucky7.expected.s8", dtype=np.int8)

    async def body():
        mock = MockSdrServer()
        ss_port = await mock.start()
        config = make_config(tmp_path, rx_sdr_type=RxSdrType.SDR_SERVER,
                             rx_sdr_server_port=ss_port, demod_mode="fast")
        server = SdrModemServer(config, device="cpu", devices=["cpu", "cpu"])
        await server.start()
        c1 = await ModemClient.connect("127.0.0.1", server.port)
        assert (await c1.rx_request(rx_request())).status == wire.ResponseStatus.SUCCESS
        await mock.wait_client()
        (stream,) = server.streams
        (group,) = stream.groups
        assert group.sharded and group.devices == [torch.device("cpu")] * 2
        await mock.send_iq(iq)
        d1 = np.frombuffer(await c1.read_stream(1500, timeout=90), dtype=np.int8)
        diff = np.abs(d1.astype(np.int32) - golden[: len(d1)].astype(np.int32))
        assert diff.max() <= 2
        await c1.shutdown()
        c1.close()
        await mock.stop()
        await server.stop()

    run(body())
