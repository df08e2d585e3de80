"""Test doubles for driving the port's server where JAX is not installed
(the card's tests, ``chip_smoke.py``): ``tests/server_helpers.py`` on the
port's own ``server/wire.py``.

- ``MockSdrServer`` — an in-process TCP server speaking the sdr-server
  protocol (reference test/sdr_server_mock.c): it takes the handshake and
  pushes IQ on demand to every connected reader;
- ``ModemClient`` — a wire-protocol client of the modem server
  (reference test/sdr_modem_client.c);
- ``serve_rx`` — the port's server in-process on its default device, one
  mock stream and one client a request, timed a block.
"""

from __future__ import annotations

import asyncio
import struct
import time

import numpy as np

from sdrmodem_tpu_torch.server import wire

_SS_HEADER = struct.Struct(">BB")
_SS_REQUEST = struct.Struct(">IIIB")
_SS_RESPONSE = struct.Struct(">BI")


class MockSdrServer:
    def __init__(self):
        self.server: asyncio.Server | None = None
        self.requests: list[tuple] = []
        self.clients: list[asyncio.StreamWriter] = []
        self._client_connected = asyncio.Event()

    async def start(self) -> int:
        self.server = await asyncio.start_server(self._handle, "127.0.0.1", 0)
        return self.server.sockets[0].getsockname()[1]

    async def _handle(self, reader, writer):
        version, msg_type = _SS_HEADER.unpack(await reader.readexactly(_SS_HEADER.size))
        assert version == 0 and msg_type == 0
        self.requests.append(_SS_REQUEST.unpack(await reader.readexactly(_SS_REQUEST.size)))
        writer.write(_SS_HEADER.pack(0, 2) + _SS_RESPONSE.pack(0, 0))
        await writer.drain()
        self.clients.append(writer)
        self._client_connected.set()
        try:  # keep the connection open until the modem sends SHUTDOWN
            while True:
                data = await reader.read(4096)
                if not data or (len(data) >= 2 and data[1] == 1):
                    break
        except ConnectionError:
            pass
        finally:
            writer.close()

    async def wait_client(self):
        await self._client_connected.wait()

    async def send_iq(self, iq: np.ndarray):
        data = np.asarray(iq, np.complex64).tobytes()
        for w in self.clients:
            w.write(data)
            await w.drain()

    async def stop(self):
        for w in self.clients:
            w.close()
        if self.server:
            self.server.close()
            await self.server.wait_closed()


class ModemClient:
    def __init__(self, reader, writer):
        self.reader = reader
        self.writer = writer

    @classmethod
    async def connect(cls, host: str, port: int) -> "ModemClient":
        return cls(*await asyncio.open_connection(host, port))

    async def send(self, msg_type: wire.MsgType, payload: bytes = b""):
        self.writer.write(wire.frame(msg_type, payload))
        await self.writer.drain()

    async def read_response(self) -> wire.Response:
        _, msg_type, length = wire.parse_header(await self.reader.readexactly(wire.HEADER.size))
        assert msg_type == wire.MsgType.RESPONSE, f"unexpected type {msg_type}"
        return wire.Response.decode(await self.reader.readexactly(length))

    async def rx_request(self, req: wire.RxRequest) -> wire.Response:
        await self.send(wire.MsgType.RX_REQUEST, req.encode())
        return await self.read_response()

    async def tx_request(self, req: wire.TxRequest) -> wire.Response:
        await self.send(wire.MsgType.TX_REQUEST, req.encode())
        return await self.read_response()

    async def tx_data(self, data: bytes) -> wire.Response:
        await self.send(wire.MsgType.TX_DATA, wire.TxData(data=data).encode())
        return await self.read_response()

    async def read_stream(self, n: int, timeout: float = 60.0) -> bytes:
        return await asyncio.wait_for(self.reader.readexactly(n), timeout)

    async def shutdown(self):
        await self.send(wire.MsgType.SHUTDOWN)

    def close(self):
        self.writer.close()


def server_config(base_path, **kw):
    """The default ServerConfig on 127.0.0.1:0, writing under ``base_path``,
    with ``kw`` set over it."""
    from sdrmodem_tpu_torch.server.config import ServerConfig

    cfg = ServerConfig()
    cfg.bind_address, cfg.port, cfg.base_path = "127.0.0.1", 0, str(base_path)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def rx_request(doppler=None, start=0) -> wire.RxRequest:
    """The lucky7 capture's RX request (48000 Hz, 4800 Bd, deviation 5000,
    decimation 2, transition width 2000, DC block) to the socket, with
    ``doppler`` settings from ``start`` seconds when given."""
    return wire.RxRequest(
        rx_center_freq=437525000, rx_sampling_freq=48000, rx_offset=0,
        demod_type=wire.ModemType.GMSK, demod_baud_rate=4800, demod_decimation=2,
        demod_destination=wire.DemodDestination.SOCKET, doppler=doppler,
        fsk_settings=wire.FskDemodulationSettings(5000, 2000, True),
        file_settings=wire.FileSettings("", start) if start else None,
    )


def serve_rx(base_path, config_kw, requests, blocks, cumulative, timeout=900.0, server_kw=None):
    """Drive the port's server in-process with its default device (and
    ``server_kw``, e.g. the fast group's ``devices``): a mock
    sdr-server stream, one client a request.  The mock sends ``blocks``
    one at a time, and after each one client k reads up to its
    ``cumulative[k][t]`` bytes.  Returns each client's bytes (int8), the ms
    from each block leaving the mock to the last client's last symbol, and
    each client's (lane, DSP device type): its group's in fast mode, its
    streamer's otherwise."""
    from sdrmodem_tpu_torch.server.config import RxSdrType
    from sdrmodem_tpu_torch.server.tcp_server import SdrModemServer

    async def body():
        mock = MockSdrServer()
        server = SdrModemServer(server_config(
            base_path, rx_sdr_type=RxSdrType.SDR_SERVER, rx_sdr_server_port=await mock.start(),
            **config_kw), **(server_kw or {}))
        await server.start()
        clients, ids = [], []
        for req in requests:
            c = await ModemClient.connect("127.0.0.1", server.port)
            resp = await c.rx_request(req)
            if resp.status != 0:
                raise RuntimeError(f"rx request refused: {resp}")
            clients.append(c)
            ids.append(resp.details)
        await mock.wait_client()
        if len(server.streams) != 1 or len(mock.requests) != 1:
            raise RuntimeError("the clients do not share one stream")
        sessions = {s.id: s for s in server.streams[0].sessions}
        got, ms, have = [[] for _ in clients], [], [0] * len(clients)
        for t, blk in enumerate(blocks):
            t0 = time.perf_counter()
            await mock.send_iq(blk)
            parts = await asyncio.gather(*(c.read_stream(cumulative[k][t] - have[k], timeout)
                                           for k, c in enumerate(clients)))
            ms.append((time.perf_counter() - t0) * 1e3)
            for k, part in enumerate(parts):
                got[k].append(part)
                have[k] = cumulative[k][t]
        where = [(s.lane, (s.group.device if s.group else s.demod.p.device).type)
                 for s in (sessions[i] for i in ids)]
        for c in clients:
            await c.shutdown()
            c.close()
        await mock.stop()
        await server.stop()
        return [np.frombuffer(b"".join(g), np.int8) for g in got], ms, where

    return asyncio.run(asyncio.wait_for(body(), timeout))
