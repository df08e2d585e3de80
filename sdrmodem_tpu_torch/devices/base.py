"""SDR device interface — the async analog of the reference's vtable
``struct sdr_device_t`` (src/sdr/sdr_device.h:16-23):
{sdr_process_rx, sdr_process_tx, stop_rx, destroy}.

A copy of ``sdrmodem_tpu/devices/base.py`` with its imports pointing at the port.
"""

from __future__ import annotations

import abc

import numpy as np


class SdrDevice(abc.ABC):
    """A device may implement RX, TX, or both (like file_source)."""

    # True when no RX sample may ever be dropped (file replay); live SDRs
    # use lossy back-pressure instead (reference src/dsp_worker.c:176-179)
    lossless_rx: bool = False

    async def read_stream(self) -> np.ndarray | None:
        """Return the next block of complex64 IQ, or None when the stream
        ends (socket closed / stop requested)."""
        raise NotImplementedError("device does not support rx")

    async def write_stream(self, iq: np.ndarray) -> None:
        raise NotImplementedError("device does not support tx")

    async def stop_rx(self) -> None:
        """Graceful stop; unblocks any pending read_stream."""

    async def close(self) -> None:
        """Release resources (destroy)."""
