"""GMSK/FSK demodulator chain: LPF -> quadrature demod -> LPF(decim) -> DC
block -> M&M, its configuration and the int8 soft-symbol conversion.

Counterpart of ``sdrmodem_tpu/dsp/fsk_demod.py``.  The derived parameters
match reference src/dsp/fsk_demod.c:28-110:

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
from sdrmodem_tpu_torch.dsp.clock_recovery import (
    ClockState,
    check_sps_supported,
    clock_mm_stream,
    mm_params,
)
from sdrmodem_tpu_torch.dsp.elementwise import (
    dc_blocker_length,
    dc_blocker_taps,
    is_lut_mode,
    quad_demod_stream,
)
from sdrmodem_tpu_torch.dsp.fir import fir_stream
from sdrmodem_tpu_torch.ops._build import resolve_device


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


class FskDemodulator:
    """Whole-stream (offline) FSK demodulator.

    ``process(iq)`` demodulates complex64 IQ (N,) or (B, N), a tensor or
    anything numpy takes, into int8 soft symbols (K,)/(B, K) padded to the
    static symbol bound, with a per-stream valid count.  ``exact=True``
    (default) accumulates the FIRs in float64 for deterministic golden
    parity; ``exact=False`` is the float32 path.  ``device`` defaults to
    CUDA; pass ``device="cpu"`` for the plain versions of the kernels."""

    def __init__(self, config: FskDemodConfig, *, use_atan_lut=True, exact: bool = True,
                 device=None):
        is_lut_mode(use_atan_lut)  # raises for a mode the port does not take
        self.config = config
        self.use_atan_lut = use_atan_lut
        self.exact = exact
        self.device = resolve_device(device)

        def taps(t):
            return torch.from_numpy(np.asarray(t, np.float32).copy()).to(self.device)

        self._lpf1 = taps(config.lpf1_taps())
        self._lpf2 = taps(config.lpf2_taps())
        self._dc = taps(dc_blocker_taps(config.dc_length)) if config.use_dc_block else None
        self._clock = config.clock_params()
        check_sps_supported(self._clock["omega"])

    def soft_stream(self, iq, clock_state: ClockState | None = None):
        """Float soft symbols of iq (..., N) complex64: (symbols (..., K),
        count (...), clock state')."""
        cfg = self.config
        if not isinstance(iq, torch.Tensor):
            iq = torch.from_numpy(np.asarray(iq, np.complex64))
        iq = iq.to(device=self.device, dtype=torch.complex64)
        if iq.shape[-1] == 0:  # the reference returns zero output for an empty buffer
            zeros = torch.zeros(iq.shape[:-1] + (0,), dtype=torch.float32, device=self.device)
            return zeros, torch.zeros(iq.shape[:-1], dtype=torch.int32, device=self.device), clock_state
        x = fir_stream(iq, self._lpf1, 1, exact=self.exact)
        x = quad_demod_stream(x, cfg.quad_gain, use_lut=self.use_atan_lut)
        x = fir_stream(x, self._lpf2, cfg.decimation, exact=self.exact)
        if self._dc is not None:
            x = fir_stream(x, self._dc, 1, exact=self.exact)
        p = self._clock
        return clock_mm_stream(
            x, omega=p["omega"], gain_omega=p["gain_omega"], mu=p["mu"], gain_mu=p["gain_mu"],
            omega_relative_limit=p["omega_relative_limit"], state=clock_state,
        )

    def process(self, iq, clock_state: ClockState | None = None):
        """Demodulate to int8 soft symbols: (symbols_i8, count, clock_state)."""
        soft, count, state = self.soft_stream(iq, clock_state)
        return float_to_int8(soft), count, state
