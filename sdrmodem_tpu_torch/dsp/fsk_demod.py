"""GMSK/FSK demodulator configuration and the int8 soft-symbol conversion.

Counterpart of ``sdrmodem_tpu/dsp/fsk_demod.py:35-85``.  The derived
parameters match reference src/dsp/fsk_demod.c:28-110:

- LPF1: complex, decimation 1, Carson-rule cutoff |deviation| + baud/2,
  transition width 0.1 * cutoff (truncated to integer Hz).
- quadrature demod gain = Fs / (2*pi*deviation).
- LPF2: real, decimation = ``decimation``, cutoff = baud/2 (integer
  division), transition width as requested.
- optional DC blocker of length ceil(32 * sps).
- M&M clock recovery with omega = sps = Fs/baud/decimation.
- int8 soft symbols: round(clip(x * 127)) (volk_32f_s32f_convert_8i).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sdrmodem_tpu_torch.dsp import taps as taps_mod
from sdrmodem_tpu_torch.dsp.clock_recovery import mm_params
from sdrmodem_tpu_torch.dsp.elementwise import dc_blocker_length


def float_to_int8(x: torch.Tensor, scale: float = 127.0) -> torch.Tensor:
    """volk_32f_s32f_convert_8i: scale, clip to int8 range, round half to even."""
    r = torch.clamp(x * float(np.float32(scale)), -128.0, 127.0)
    return torch.round(r).to(torch.int8)


@dataclass(frozen=True)
class FskDemodConfig:
    sampling_freq: int
    baud_rate: int
    deviation: int
    decimation: int = 1
    transition_width: int = 2000
    use_dc_block: bool = True

    @property
    def carson_cutoff(self) -> float:
        return float(abs(self.deviation)) + float(self.baud_rate) / 2.0

    @property
    def quad_gain(self) -> float:
        return float(
            np.float32(self.sampling_freq / (2.0 * np.pi * float(self.deviation)))
        )

    @property
    def sps(self) -> float:
        """Samples per symbol after decimation, float32 (fsk_demod.c:52)."""
        return float(
            np.float32(self.sampling_freq / self.baud_rate / self.decimation)
        )

    @property
    def dc_length(self) -> int:
        return dc_blocker_length(self.sps)

    def lpf1_taps(self) -> np.ndarray:
        cutoff = int(self.carson_cutoff)  # (uint64) truncation
        tw = int(np.float32(0.1) * np.float32(self.carson_cutoff))  # (uint32)(0.1f * c)
        return taps_mod.low_pass_taps(1.0, self.sampling_freq, cutoff, tw)

    def lpf2_taps(self) -> np.ndarray:
        return taps_mod.low_pass_taps(
            1.0, self.sampling_freq, self.baud_rate // 2, self.transition_width
        )

    def clock_params(self) -> dict:
        return mm_params(self.sps)
