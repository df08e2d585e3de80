"""The asyncio TCP front-end speaking the reference wire protocol.

Behavioural equivalent of reference src/tcp_server.c: one acceptor, a
connection handler per client (tcp_worker), request validation with the
same error details, single-TX and single-pluto-RX enforcement, SDR
connection sharing, and the same response/ack sequencing — so existing
sdr-modem clients (and the reference's own test client) work unchanged.

The port of ``sdrmodem_tpu/server/tcp_server.py``.  The server runs its DSP
on one device, chosen when it starts (``--device``, CUDA by default); it
raises without a card rather than fall back to the CPU.  A fast-mode
group's lanes shard over ``devices`` when the server is given them, or
over the cards SDRM_SERVER_MESH picks (``session.py:BatchedRxGroup``).  Run it with
``python -m sdrmodem_tpu_torch.server <config> [--device cpu]``.
"""

from __future__ import annotations

import asyncio
import logging

import torch

from sdrmodem_tpu_torch.devices.base import SdrDevice
from sdrmodem_tpu_torch.devices.file_source import FileSource
from sdrmodem_tpu_torch.devices.sdr_server_client import SdrServerClient, SdrServerError
from sdrmodem_tpu_torch.dsp.clock_recovery import MAX_SPS
from sdrmodem_tpu_torch.ops import _build
from sdrmodem_tpu_torch.ops._build import resolve_device
from sdrmodem_tpu_torch.server import wire
from sdrmodem_tpu_torch.server.config import RxSdrType, ServerConfig, TxSdrType
from sdrmodem_tpu_torch.server.session import RxKey, RxSession, SdrStream, TxSession

log = logging.getLogger("sdrmodem.server")


class _TxDone(Exception):
    """Control-flow sentinel: orderly end of a TX session's message loop."""


def validate_rx_request(req: wire.RxRequest, config: ServerConfig) -> bool:
    """src/tcp_server.c:123-169, same order of checks."""
    if req.demod_type != wire.ModemType.GMSK:
        return False
    if req.rx_center_freq == 0 or req.rx_sampling_freq == 0 or req.demod_baud_rate == 0:
        return False
    if req.doppler is not None and len(req.doppler.tle) != 3:
        return False
    if req.demod_decimation == 0:
        return False
    if req.demod_destination not in (
        wire.DemodDestination.FILE,
        wire.DemodDestination.SOCKET,
        wire.DemodDestination.BOTH,
    ):
        return False
    if config.rx_sdr_type == RxSdrType.FILE and req.file_settings is None:
        return False
    if req.fsk_settings is None or req.fsk_settings.demod_fsk_transition_width == 0:
        return False
    # the clock state's capacity derives from samples-per-symbol; beyond
    # MAX_SPS the request is rejected cleanly instead of silently dropping
    # unconsumed samples (the reference's unbounded history has no such
    # limit, clock_recovery_mm.c:127-135)
    sps = req.rx_sampling_freq / req.demod_baud_rate / req.demod_decimation
    if sps > MAX_SPS:
        return False
    return True


def validate_tx_request(req: wire.TxRequest, config: ServerConfig) -> bool:
    """src/tcp_server.c:89-121."""
    if req.mod_type != wire.ModemType.GMSK:
        return False
    if config.tx_sdr_type == TxSdrType.NONE:
        return False
    if req.tx_center_freq == 0 or req.tx_sampling_freq == 0 or req.mod_baud_rate == 0:
        return False
    if req.doppler is not None and len(req.doppler.tle) != 3:
        return False
    if config.tx_sdr_type == TxSdrType.FILE and req.file_settings is None:
        return False
    if req.fsk_settings is None:
        return False
    return True


def server_device(device=None):
    """The device the server's DSP runs on: ``device``, or the CUDA card
    when it is None.  Raises without a card, naming ``--device cpu``; any
    other fault (a mistyped device, a driver that fails) raises as it is."""
    if torch.device("cuda" if device is None else device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the server runs its DSP on the card; start it with "
            "--device cpu (SdrModemServer(config, device='cpu')) to serve on the CPU"
        )
    return resolve_device(device)


class SdrModemServer:
    def __init__(self, config: ServerConfig, device=None, devices=None):
        self.config = config
        self.device = server_device(device)
        # a fast-mode group's lanes sharded over these (BatchedRxGroup)
        self.devices = None if devices is None else [server_device(d) for d in devices]
        self.client_counter = 0
        self.streams: list[SdrStream] = []
        self.tx_initialized = False
        self.rx_initialized = False  # single pluto RX enforcement
        self._server: asyncio.Server | None = None
        self._lock = asyncio.Lock()
        # observability: TX dispatch-coalescing effectiveness
        self.tx_bursts = 0
        self.tx_msgs_coalesced = 0

    # ------------------------------------------------------------------
    async def start(self):
        self._server = await asyncio.start_server(
            self._handle_connection, self.config.bind_address, self.config.port
        )
        addr = self._server.sockets[0].getsockname()
        log.info("sdr-modem server listening on %s:%d", addr[0], addr[1])
        return addr

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    async def stop(self):
        if self._server:
            self._server.close()
            await self._server.wait_closed()
        for stream in list(self.streams):
            for session in list(stream.sessions):
                await session.stop()
                await stream.remove_session(session)
        self.streams.clear()

    async def serve_forever(self):
        await self.start()
        async with self._server:
            await self._server.serve_forever()

    # ------------------------------------------------------------------
    async def _read_message(self, reader: asyncio.StreamReader):
        hdr = await asyncio.wait_for(
            reader.readexactly(wire.HEADER.size), self.config.read_timeout_seconds
        )
        version, msg_type, length = wire.parse_header(hdr)
        if length > wire.MAX_MESSAGE_LENGTH:
            raise wire.WireError("message too long")
        payload = await asyncio.wait_for(
            reader.readexactly(length), self.config.read_timeout_seconds
        ) if length else b""
        return version, msg_type, payload

    @staticmethod
    async def _respond(writer, status: int, details: int):
        writer.write(
            wire.frame(wire.MsgType.RESPONSE, wire.Response(status, details).encode())
        )
        await writer.drain()

    async def _handle_connection(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.client_counter += 1
        client_id = self.client_counter
        try:
            version, msg_type, payload = await self._read_message(reader)
        except (asyncio.IncompleteReadError, asyncio.TimeoutError, ConnectionError, wire.WireError):
            await self._respond_safe(writer, wire.ResponseStatus.FAILURE, wire.ResponseDetails.INVALID_REQUEST)
            writer.close()
            return
        if version != wire.PROTOCOL_VERSION:
            log.error("[%d] unsupported protocol: %d", client_id, version)
            await self._respond_safe(writer, wire.ResponseStatus.FAILURE, wire.ResponseDetails.INVALID_REQUEST)
            writer.close()
            return

        try:
            if msg_type == wire.MsgType.PING:
                await self._respond(writer, wire.ResponseStatus.SUCCESS, 0)
                writer.close()
            elif msg_type == wire.MsgType.RX_REQUEST:
                await self._handle_rx_client(client_id, payload, reader, writer)
            elif msg_type == wire.MsgType.TX_REQUEST:
                await self._handle_tx_client(client_id, payload, reader, writer)
            else:
                log.error("[%d] unsupported request: %d", client_id, msg_type)
                await self._respond_safe(writer, wire.ResponseStatus.FAILURE, wire.ResponseDetails.INVALID_REQUEST)
                writer.close()
        except ConnectionError:
            writer.close()

    async def _respond_safe(self, writer, status, details):
        try:
            await self._respond(writer, status, details)
        except (ConnectionError, RuntimeError):
            pass

    # ------------------------------------------------------------------
    # RX path
    async def _init_rx_device(self, client_id: int, req: wire.RxRequest) -> SdrStream | int:
        key = RxKey(req.rx_center_freq, req.rx_sampling_freq, req.rx_offset)
        cfg = self.config
        if cfg.rx_sdr_type == RxSdrType.SDR_SERVER:
            for stream in self.streams:
                if stream.key.matches(key):
                    return stream  # connection sharing
            try:
                device: SdrDevice = await SdrServerClient.connect(
                    cfg.rx_sdr_server_address,
                    cfg.rx_sdr_server_port,
                    req.rx_center_freq + req.rx_offset,
                    req.rx_sampling_freq,
                    req.rx_center_freq,
                    cfg.buffer_size,
                    cfg.read_timeout_seconds,
                )
            except (OSError, SdrServerError) as e:
                log.error("[%d] connection with sdr server failed: %s", client_id, e)
                return wire.ResponseDetails.INTERNAL_ERROR
        elif cfg.rx_sdr_type == RxSdrType.FILE:
            try:
                device = FileSource(
                    rx_filename=req.file_settings.filename,
                    sampling_freq=req.rx_sampling_freq,
                    freq_offset=req.rx_offset,
                    max_output_buffer_length=cfg.buffer_size,
                )
            except OSError as e:
                log.error("[%d] unable to init file source: %s", client_id, e)
                return wire.ResponseDetails.INTERNAL_ERROR
            # native SPSC read-ahead (reference's sdr_worker thread +
            # queue.c decoupling) when the native library is built
            from sdrmodem_tpu_torch.devices.native_ingest import maybe_wrap

            device = maybe_wrap(device, cfg.buffer_size, cfg.queue_size)
            log.info("[%d] demod file input at: %s", client_id, req.file_settings.filename)
        elif cfg.rx_sdr_type == RxSdrType.PLUTOSDR:
            if self.rx_initialized:
                log.error("[%d] rx is being used", client_id)
                return wire.ResponseDetails.RX_IS_BEING_USED
            from sdrmodem_tpu_torch.devices.plutosdr import PlutoSdr, PlutoSdrError

            try:
                device = PlutoSdr.create_rx(
                    sampling_freq=req.rx_sampling_freq,
                    center_freq=req.rx_center_freq + req.rx_offset,
                    gain=cfg.rx_plutosdr_gain,
                    timeout_millis=cfg.tx_plutosdr_timeout_millis,
                    buffer_size=cfg.buffer_size,
                    power_down_tx=not self.tx_initialized,
                    lib=cfg.iio_lib,
                )
            except PlutoSdrError as e:
                log.error("[%d] unable to init pluto rx: %s", client_id, e)
                return wire.ResponseDetails.INTERNAL_ERROR
            self.rx_initialized = True
        else:
            return wire.ResponseDetails.INTERNAL_ERROR

        stream = SdrStream(client_id, key, device, group_devices=self.devices)
        self.streams.append(stream)
        stream.start()
        return stream

    async def _handle_rx_client(self, client_id, payload, reader, writer):
        try:
            req = wire.RxRequest.decode(payload)
        except wire.WireError:
            await self._respond_safe(writer, wire.ResponseStatus.FAILURE, wire.ResponseDetails.INVALID_REQUEST)
            writer.close()
            return
        if not validate_rx_request(req, self.config):
            await self._respond_safe(writer, wire.ResponseStatus.FAILURE, wire.ResponseDetails.INVALID_REQUEST)
            writer.close()
            return
        try:
            session = RxSession(client_id, req, self.config, writer, dsp_device=self.device)
        except Exception:
            log.exception("[%d] unable to create dsp worker", client_id)
            await self._respond_safe(writer, wire.ResponseStatus.FAILURE, wire.ResponseDetails.INTERNAL_ERROR)
            writer.close()
            return
        async with self._lock:
            stream = await self._init_rx_device(client_id, req)
        if isinstance(stream, int):
            await self._respond_safe(writer, wire.ResponseStatus.FAILURE, stream)
            writer.close()
            return
        stream.add_session(session)
        session.start()
        await self._respond(writer, wire.ResponseStatus.SUCCESS, client_id)
        log.info(
            "[%d] demod: GMSK, rx freq: %d, rx offset: %d, rx sampling_rate: %d, baud: %d",
            client_id, req.rx_center_freq, req.rx_offset, req.rx_sampling_freq,
            req.demod_baud_rate,
        )

        # control loop: wait for SHUTDOWN / disconnect (tcp_worker_callback)
        try:
            while True:
                try:
                    version, msg_type, payload = await self._read_message(reader)
                except asyncio.TimeoutError:
                    continue  # read timeout is a normal control-loop event
                if msg_type == wire.MsgType.SHUTDOWN:
                    log.info("[%d] client requested disconnect", client_id)
                    break
                log.error("[%d] unsupported request: %d", client_id, msg_type)
        except (asyncio.IncompleteReadError, ConnectionError):
            log.info("[%d] client disconnected", client_id)
        finally:
            await session.stop()
            async with self._lock:
                torn_down = await stream.remove_session(session)
                if torn_down and stream in self.streams:
                    self.streams.remove(stream)
                    if self.config.rx_sdr_type == RxSdrType.PLUTOSDR:
                        self.rx_initialized = False
            writer.close()

    # ------------------------------------------------------------------
    # TX path
    async def _init_tx_device(self, client_id: int, req: wire.TxRequest) -> SdrDevice | int | None:
        cfg = self.config
        if self.tx_initialized:
            log.error("[%d] tx is being used", client_id)
            return wire.ResponseDetails.TX_IS_BEING_USED
        if cfg.tx_sdr_type == TxSdrType.FILE:
            sps = int(req.tx_sampling_freq / req.mod_baud_rate)
            try:
                device = FileSource(
                    tx_filename=req.file_settings.filename,
                    sampling_freq=req.tx_sampling_freq,
                    freq_offset=0,  # tx offset handled in tx_data
                    max_output_buffer_length=8 * sps * cfg.buffer_size,
                )
            except OSError as e:
                log.error("[%d] unable to init file tx: %s", client_id, e)
                return wire.ResponseDetails.INTERNAL_ERROR
            log.info("[%d] mod file output at: %s", client_id, req.file_settings.filename)
        elif cfg.tx_sdr_type == TxSdrType.PLUTOSDR:
            from sdrmodem_tpu_torch.devices.plutosdr import PlutoSdr, PlutoSdrError

            try:
                device = PlutoSdr.create_tx(
                    sampling_freq=req.tx_sampling_freq,
                    center_freq=req.tx_center_freq,
                    gain=cfg.tx_plutosdr_gain,
                    timeout_millis=cfg.tx_plutosdr_timeout_millis,
                    buffer_size=cfg.buffer_size,
                    lib=cfg.iio_lib,
                )
            except PlutoSdrError as e:
                log.error("[%d] unable to init pluto tx: %s", client_id, e)
                return wire.ResponseDetails.INTERNAL_ERROR
        else:
            return wire.ResponseDetails.INTERNAL_ERROR
        self.tx_initialized = True
        return device

    async def _handle_tx_client(self, client_id, payload, reader, writer):
        try:
            req = wire.TxRequest.decode(payload)
        except wire.WireError:
            await self._respond_safe(writer, wire.ResponseStatus.FAILURE, wire.ResponseDetails.INVALID_REQUEST)
            writer.close()
            return
        if not validate_tx_request(req, self.config):
            await self._respond_safe(writer, wire.ResponseStatus.FAILURE, wire.ResponseDetails.INVALID_REQUEST)
            writer.close()
            return
        async with self._lock:
            device = await self._init_tx_device(client_id, req)
        if isinstance(device, int):
            await self._respond_safe(writer, wire.ResponseStatus.FAILURE, device)
            writer.close()
            return
        try:
            session = TxSession(client_id, req, self.config, device, dsp_device=self.device)
        except Exception:
            log.exception("[%d] unable to create fsk modulator", client_id)
            self.tx_initialized = False
            await self._respond_safe(writer, wire.ResponseStatus.FAILURE, wire.ResponseDetails.INTERNAL_ERROR)
            writer.close()
            return
        await self._respond(writer, wire.ResponseStatus.SUCCESS, client_id)
        log.info(
            "[%d] mod: GMSK, tx freq: %d, tx offset: %d, tx sampling_rate: %d, baud: %d",
            client_id, req.tx_center_freq, req.tx_offset, req.tx_sampling_freq,
            req.mod_baud_rate,
        )
        # TX control loop with DISPATCH COALESCING: a pump task reads
        # messages into a queue; when several TX_DATA messages are already
        # queued (pipelining clients), their payloads are concatenated and
        # modulated as ONE stream — the carried modulator state makes the
        # samples identical to per-message processing up to float64
        # rounding, and the host's work around a modulator call (staging,
        # one upload, the launches, one download) is paid once per burst
        # instead of once per message.  Each message still gets its own
        # ordered RESPONSE (reference src/tcp_server.c:236-239).
        queue: asyncio.Queue = asyncio.Queue()
        pump = asyncio.create_task(self._tx_pump(reader, queue))
        try:
            while True:
                kind, item = await queue.get()
                while True:
                    if kind == "eof":
                        log.info("[%d] client disconnected", client_id)
                        raise _TxDone
                    if kind == "err":
                        raise item
                    version, msg_type, payload = item
                    if msg_type == wire.MsgType.SHUTDOWN:
                        log.info("[%d] client requested disconnect", client_id)
                        raise _TxDone
                    if msg_type != wire.MsgType.TX_DATA:
                        log.error("[%d] unsupported request: %d", client_id, msg_type)
                        break
                    try:
                        burst = [wire.TxData.decode(payload).data]
                    except wire.WireError:
                        await self._respond_safe(writer, wire.ResponseStatus.FAILURE, wire.ResponseDetails.INVALID_REQUEST)
                        break
                    # drain consecutive already-buffered TX_DATA into the burst
                    leftover = None
                    total = len(burst[0])
                    while (
                        leftover is None
                        and total < self.TX_COALESCE_BYTES
                        and len(burst) < self.TX_COALESCE_MSGS
                        and not queue.empty()
                    ):
                        kind2, item2 = queue.get_nowait()
                        if kind2 == "msg" and item2[1] == wire.MsgType.TX_DATA:
                            try:
                                d2 = wire.TxData.decode(item2[2]).data
                            except wire.WireError:
                                leftover = ("badtx", None)
                            else:
                                burst.append(d2)
                                total += len(d2)
                        else:
                            leftover = (kind2, item2)
                    self.tx_bursts += 1
                    self.tx_msgs_coalesced += len(burst)
                    code = await session.handle_tx_data(b"".join(burst))
                    for d in burst:
                        if code == 0:
                            log.info("[%d] successfully sent %d bytes", client_id, len(d))
                            await self._respond(writer, wire.ResponseStatus.SUCCESS, 0)
                        else:
                            await self._respond_safe(writer, wire.ResponseStatus.FAILURE, code)
                    if leftover is None:
                        break
                    if leftover[0] == "badtx":
                        await self._respond_safe(writer, wire.ResponseStatus.FAILURE, wire.ResponseDetails.INVALID_REQUEST)
                        break
                    kind, item = leftover  # control message deferred past the burst
        except _TxDone:
            pass
        except (asyncio.IncompleteReadError, ConnectionError):
            log.info("[%d] client disconnected", client_id)
        finally:
            pump.cancel()
            await session.close()
            self.tx_initialized = False
            writer.close()

    # burst bounds: latency/memory caps for the coalesced TX path (the
    # modulator sub-dispatches at 32 KiB anyway, so bigger bursts only
    # amortize host-side work)
    TX_COALESCE_BYTES = 512 * 1024
    TX_COALESCE_MSGS = 128

    async def _tx_pump(self, reader, queue: asyncio.Queue):
        """Read client messages into ``queue`` (("msg", (v, type, payload))
        rows, then one ("eof"/"err", exc) terminal row)."""
        try:
            while True:
                try:
                    msg = await self._read_message(reader)
                except asyncio.TimeoutError:
                    continue  # read timeout is a normal control-loop event
                await queue.put(("msg", msg))
        except (asyncio.IncompleteReadError, ConnectionError):
            await queue.put(("eof", None))
        except asyncio.CancelledError:
            raise
        except Exception as e:  # e.g. wire.WireError: oversize header
            await queue.put(("err", e))


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="sdr-modem server on PyTorch and CUDA")
    parser.add_argument("config", help="libconfig-style configuration file")
    parser.add_argument("--device", default="cuda",
                        help="where the DSP runs: cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    config = ServerConfig.load(args.config)
    server = SdrModemServer(config, device=args.device)
    if server.device.type == "cuda":
        # build every kernel before the first client, so no client's first
        # block waits on nvcc
        _build.build()

    async def run():
        import signal

        loop = asyncio.get_running_loop()
        stop = asyncio.Event()
        for sig in (signal.SIGINT, signal.SIGTERM, signal.SIGHUP):
            loop.add_signal_handler(sig, stop.set)
        await server.start()
        await stop.wait()
        await server.stop()
        log.info("tcp server stopped")

    asyncio.run(run())


if __name__ == "__main__":
    main()
