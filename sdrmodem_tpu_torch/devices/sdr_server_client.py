"""TCP client for the companion ``sdr-server`` IQ source.

Behavioural equivalent of reference src/sdr/sdr_server_client.c /
sdr_server_api.h: 2-byte header {version=0, type}, packed request
{u32 center_freq, u32 sampling_rate, u32 band_freq, u8 destination} in
network byte order, response {u8 status, u32 details(BE)}; raw cf32
stream follows; graceful stop sends SHUTDOWN and drains until the
server closes (:190-212).

A copy of ``sdrmodem_tpu/devices/sdr_server_client.py`` with its imports pointing at the port.
"""

from __future__ import annotations

import asyncio
import struct

import numpy as np

from sdrmodem_tpu_torch.devices.base import SdrDevice

PROTOCOL_VERSION = 0
TYPE_REQUEST = 0
TYPE_SHUTDOWN = 1
TYPE_RESPONSE = 2
TYPE_PING = 3

DESTINATION_SOCKET = 1

STATUS_SUCCESS = 0

_HEADER = struct.Struct(">BB")
_REQUEST = struct.Struct(">IIIB")
_RESPONSE = struct.Struct(">BI")


class SdrServerError(RuntimeError):
    pass


class SdrServerClient(SdrDevice):
    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        max_output_buffer_length: int,
        read_timeout_seconds: float,
    ):
        self.reader = reader
        self.writer = writer
        self.block = int(max_output_buffer_length)
        self.timeout = read_timeout_seconds
        self._stopping = False

    @classmethod
    async def connect(
        cls,
        address: str,
        port: int,
        center_freq: int,
        sampling_freq: int,
        band_freq: int,
        max_output_buffer_length: int,
        read_timeout_seconds: float = 5.0,
    ) -> "SdrServerClient":
        """Connect + handshake (sdr_server_client_create:72-148)."""
        reader, writer = await asyncio.open_connection(address, port)
        client = cls(reader, writer, max_output_buffer_length, read_timeout_seconds)
        writer.write(
            _HEADER.pack(PROTOCOL_VERSION, TYPE_REQUEST)
            + _REQUEST.pack(center_freq, sampling_freq, band_freq, DESTINATION_SOCKET)
        )
        await writer.drain()
        hdr = await asyncio.wait_for(reader.readexactly(_HEADER.size), read_timeout_seconds)
        version, msg_type = _HEADER.unpack(hdr)
        if version != PROTOCOL_VERSION or msg_type != TYPE_RESPONSE:
            await client.close()
            raise SdrServerError(f"unsupported response: version={version} type={msg_type}")
        body = await asyncio.wait_for(reader.readexactly(_RESPONSE.size), read_timeout_seconds)
        status, details = _RESPONSE.unpack(body)
        if status != STATUS_SUCCESS:
            await client.close()
            raise SdrServerError(f"request to sdr server rejected: {details}")
        return client

    async def read_stream(self) -> np.ndarray | None:
        """Partial reads are fine — return whatever arrived (:150-162)."""
        try:
            data = await self.reader.read(self.block * 8)
        except (ConnectionError, asyncio.IncompleteReadError):
            return None
        if not data:
            return None
        if len(data) % 8:
            # top up to a whole complex64 sample
            try:
                data += await self.reader.readexactly(8 - len(data) % 8)
            except (ConnectionError, asyncio.IncompleteReadError):
                return None
        return np.frombuffer(data, dtype=np.complex64)

    async def stop_rx(self) -> None:
        """Graceful stop: send SHUTDOWN, drain until server closes (:190-212)."""
        if self._stopping:
            return
        self._stopping = True
        try:
            self.writer.write(_HEADER.pack(PROTOCOL_VERSION, TYPE_SHUTDOWN))
            await self.writer.drain()

            async def _drain():
                while await self.reader.read(65536):
                    pass

            # the server is expected to close after SHUTDOWN; cap the drain
            # so a misbehaving peer cannot wedge the teardown cascade
            await asyncio.wait_for(_drain(), timeout=self.timeout)
        except (ConnectionError, asyncio.IncompleteReadError, asyncio.TimeoutError):
            pass

    async def close(self) -> None:
        try:
            self.writer.close()
            await self.writer.wait_closed()
        except Exception:
            pass
