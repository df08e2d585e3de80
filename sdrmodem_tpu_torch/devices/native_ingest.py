"""Threaded device read-ahead through the native SPSC ring.

The reference decouples the SDR read loop from demodulation with a
dedicated sdr_worker THREAD and a pthread block queue
(src/sdr_worker.c:31-55, src/queue.c:99-223) — the device keeps reading
while the consumer crunches.  The asyncio server gets the same
decoupling here: a producer thread runs the device's blocking read loop
and lands blocks in the native ring (native/sdrm_host.cpp), and the
event loop drains it.  Reads overlap all of the loop's Python work
instead of being serialized into `SdrStream._run`'s await chain.

Blocking (file sources: no sample may ever be dropped) vs lossy (live
SDRs: overwrite-newest + drop counter) follows the wrapped device's
``lossless_rx`` policy, exactly like the reference picks the queue mode
per source type (src/dsp_worker.c:176-179).

Enabled for devices that expose a synchronous ``read_stream_sync`` when
the native library is built; ``SDRM_NATIVE_INGEST=0`` disables.

A copy of ``sdrmodem_tpu/devices/native_ingest.py`` with its imports pointing at the port.
"""

from __future__ import annotations

import asyncio
import logging
import os
import threading

import numpy as np

from sdrmodem_tpu_torch.devices.base import SdrDevice
from sdrmodem_tpu_torch.utils import native

log = logging.getLogger(__name__)


def native_ingest_enabled() -> bool:
    return os.environ.get("SDRM_NATIVE_INGEST", "1") != "0" and native.available()


def maybe_wrap(device: SdrDevice, block_samples: int, capacity: int) -> SdrDevice:
    """Wrap ``device`` in the native read-ahead when possible (the device
    has a sync read and the native library is built); otherwise return it
    unchanged."""
    if native_ingest_enabled() and hasattr(device, "read_stream_sync"):
        return NativeReadAhead(device, block_samples, capacity)
    return device


class NativeReadAhead(SdrDevice):
    """SPSC-ring read-ahead wrapper; implements the SdrDevice protocol."""

    def __init__(self, device: SdrDevice, block_samples: int, capacity: int):
        self.device = device
        self.lossless_rx = device.lossless_rx
        self.block_bytes = int(block_samples) * 8  # complex64
        self.queue = native.NativeQueue(
            max(2, int(capacity)), self.block_bytes, blocking=device.lossless_rx
        )
        self._eof = False
        self._stopped = asyncio.Event()
        self._thread = threading.Thread(
            target=self._pump, name="sdrm-native-ingest", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------------
    def _pump(self):
        try:
            while True:
                iq = self.device.read_stream_sync()
                if iq is None:
                    self._eof = True
                    break
                buf = np.ascontiguousarray(iq, np.complex64)
                if not self.queue.put(buf.view(np.uint8)):
                    break  # interrupted (teardown)
        except Exception:
            log.exception("native ingest reader failed")
            self._eof = True
        finally:
            # drains remaining blocks, then take() returns the pill
            self.queue.interrupt()

    async def read_stream(self) -> np.ndarray | None:
        data = await asyncio.to_thread(self.queue.take)
        if data is None:
            if self.lossless_rx and self._eof and not self._stopped.is_set():
                # file EOF holds the session open until the client
                # disconnects (reference src/sdr/file_source.c:109-117);
                # a live-SDR EOF tears down immediately
                await self._stopped.wait()
            return None
        return np.frombuffer(data, np.complex64)

    @property
    def dropped(self) -> int:
        """Lossy-mode overwrites (reference logs "queue is full")."""
        return self.queue.dropped

    async def write_stream(self, iq: np.ndarray) -> None:
        await self.device.write_stream(iq)

    async def stop_rx(self) -> None:
        self._stopped.set()
        self.queue.interrupt()
        await self.device.stop_rx()

    async def close(self) -> None:
        self._stopped.set()
        self.queue.interrupt()
        await asyncio.to_thread(self._thread.join, 2.0)
        await self.device.close()
