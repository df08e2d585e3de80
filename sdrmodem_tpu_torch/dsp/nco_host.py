"""Host-side (numpy) NCO matching the reference sig_source semantics.

A copy of ``sdrmodem_tpu/dsp/nco_host.py`` (numpy only).

Used by the IO layer (file source offset mixing, TX offset shift) where
samples move through host memory anyway.  The per-sample increment is the
float32 value 2*pi*freq/fs and the carried phase is tracked in float64,
which follows the reference's float32 accumulator within test tolerances
(src/dsp/sig_source.c:43-75).
"""

from __future__ import annotations

import numpy as np


class HostNco:
    def __init__(self, sampling_freq: float, amplitude: float = 1.0):
        self.fs = float(sampling_freq)
        self.amp = np.float32(amplitude)
        self.phase = 0.0

    def generate(self, freq: int, n: int) -> np.ndarray:
        adj = float(np.float32(np.float32(2 * np.pi) * np.float32(freq) / np.float32(self.fs)))
        phases = self.phase + np.arange(n, dtype=np.float64) * adj
        self.phase = float(np.fmod(self.phase + n * adj, 2 * np.pi))
        ph = np.mod(phases, 2 * np.pi).astype(np.float32)
        return (self.amp * (np.cos(ph) + 1j * np.sin(ph))).astype(np.complex64)

    def mix(self, freq: int, x: np.ndarray) -> np.ndarray:
        """Frequency-translate x by freq Hz (sig_source_multiply)."""
        return (np.asarray(x, np.complex64) * self.generate(freq, len(x))).astype(
            np.complex64
        )
