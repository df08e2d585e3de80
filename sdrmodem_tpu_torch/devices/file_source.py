"""File-based SDR device: cf32 file RX source / TX sink.

Behavioural equivalent of reference src/sdr/file_source.c:33-172:

- RX: reads ``buffer_size`` complex64 samples per block; at EOF it BLOCKS
  until the session stops (the reference cond-waits until the client
  disconnects, :109-117) and then signals end-of-stream.
- Optional ``freq_offset`` applied by NCO multiply on both RX and TX.
- TX: appends cf32 to the output file (write errors ignored, as in the
  reference's dump path).

A copy of ``sdrmodem_tpu/devices/file_source.py`` with its imports pointing at the port.
"""

from __future__ import annotations

import asyncio
from pathlib import Path

import numpy as np

from sdrmodem_tpu_torch.devices.base import SdrDevice
from sdrmodem_tpu_torch.dsp.nco_host import HostNco


class FileSource(SdrDevice):
    lossless_rx = True  # file replay must not drop (src/dsp_worker.c:176-179)

    def __init__(
        self,
        rx_filename: str | None = None,
        tx_filename: str | None = None,
        sampling_freq: int = 0,
        freq_offset: int = 0,
        max_output_buffer_length: int = 262144,
    ):
        self.freq_offset = int(freq_offset)
        self.block = int(max_output_buffer_length)
        self.nco = HostNco(sampling_freq) if self.freq_offset != 0 else None
        self._rx = open(rx_filename, "rb") if rx_filename else None
        self._tx = open(tx_filename, "wb") if tx_filename else None
        self._stopped = asyncio.Event()

    def read_stream_sync(self) -> np.ndarray | None:
        """Blocking block read (no EOF hold) — the producer-thread entry
        used by the native read-ahead ring (devices/native_ingest.py)."""
        if self._rx is None:
            raise RuntimeError("rx file was not initialized")
        data = self._rx.read(self.block * 8)
        if len(data) == 0:
            return None
        iq = np.frombuffer(data, dtype=np.complex64)
        if self.nco is not None:
            iq = self.nco.mix(self.freq_offset, iq)
        return iq

    async def read_stream(self) -> np.ndarray | None:
        iq = await asyncio.to_thread(self.read_stream_sync)
        if iq is None:
            # EOF: hold the session open until the client disconnects
            await self._stopped.wait()
            return None
        return iq

    async def write_stream(self, iq: np.ndarray) -> None:
        if self._tx is None:
            raise RuntimeError("tx file was not initialized")
        if self.nco is not None:
            iq = self.nco.mix(self.freq_offset, iq)
        await asyncio.to_thread(self._tx.write, np.asarray(iq, np.complex64).tobytes())
        self._tx.flush()

    async def stop_rx(self) -> None:
        self._stopped.set()

    async def close(self) -> None:
        self._stopped.set()
        if self._rx:
            self._rx.close()
        if self._tx:
            self._tx.close()
