"""Mueller & Müller symbol-timing recovery for the full-block fast path.

Counterpart of ``sdrmodem_tpu/dsp/clock_recovery.py:36-160, 326-456``.
Reference: src/dsp/clock_recovery_mm.c:78-139 plus the 8-tap MMSE
fractional-delay interpolator (src/dsp/mmse_fir_interpolator.c:188-191):

    y_k     = dot(x[ii .. ii+7], bank[rint(mu * 128)])
    mm      = sgn(last) * y_k - sgn(y_k) * last
    omega  <- omega_mid + clip(omega + g_o * mm - omega_mid, +-lim)
    mu     <- mu + omega + g_m * mm;   ii += floor(mu);   mu -= floor(mu)

(NaN input emits 0.0 and strides floor(omega), reference :107-113.)

The state carries the last ``suffix`` input samples verbatim plus
``resid``, the number of them not yet consumed; the next block prepends
the suffix and starts its read pointer at ``suffix - resid``.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from sdrmodem_tpu_torch.dsp import taps as taps_mod
from sdrmodem_tpu_torch.ops.clock import clock_mm_chunked

NTAPS = taps_mod.MMSE_INTERP_NTAPS  # 8
NSTEPS = taps_mod.MMSE_INTERP_NSTEPS  # 128

# Floor of the carried suffix (covers sps <= ~53); the capacity is derived
# from omega (suffix_cap_for), always a multiple of 8.
SUFFIX = 64

# Largest supported samples-per-symbol, the JAX package's contract bound.
MAX_SPS = 512.0


def suffix_cap_for(omega: float, omega_relative_limit: float = 0.01) -> int:
    """Suffix capacity (multiple of 8) provably >= the largest unconsumed
    tail for this omega: NTAPS + ceil(omega*(1+limit)) + 2."""
    need = NTAPS + int(np.ceil(float(omega) * (1.0 + omega_relative_limit))) + 2
    return max(SUFFIX, -(-need // 8) * 8)


def check_sps_supported(omega: float) -> None:
    if float(omega) > MAX_SPS:
        raise ValueError(
            f"samples-per-symbol {float(omega):.1f} exceeds the supported "
            f"bound {MAX_SPS:.0f}; increase demod_decimation so "
            f"Fs/baud/decimation <= {MAX_SPS:.0f}"
        )


class ClockFullState(NamedTuple):
    """State of the full-block clock path (lanes last, unpadded)."""

    omega: torch.Tensor  # (C,) f32
    mu: torch.Tensor  # (C,) f32
    last_sample: torch.Tensor  # (C,) f32
    suffix: torch.Tensor  # (sfx, C) f32 — last sfx input samples
    resid: torch.Tensor  # (C,) i32 — unconsumed count (< sfx)
    overflow: torch.Tensor  # (C,) f32 — always 0: the port has no window ladder


def initial_full_state(
    omega: float, channels: int, mu: float = 0.5, *, device
) -> ClockFullState:
    f32 = dict(dtype=torch.float32, device=device)
    return ClockFullState(
        omega=torch.full((channels,), omega, **f32),
        mu=torch.full((channels,), mu, **f32),
        last_sample=torch.zeros((channels,), **f32),
        suffix=torch.zeros((suffix_cap_for(omega), channels), **f32),
        resid=torch.zeros((channels,), dtype=torch.int32, device=device),
        overflow=torch.zeros((channels,), **f32),
    )


def mm_params(sps: float) -> dict:
    """The reference fsk_demod's M&M constants (src/dsp/fsk_demod.c:63-67)."""
    sps = np.float32(sps)
    return dict(
        omega=float(sps),
        gain_omega=float(np.float32(sps * np.float32(np.pi)) / np.float32(100.0)),
        mu=0.5,
        gain_mu=0.0625,
        omega_relative_limit=0.01,
    )


def max_symbols(n_in: int, omega_mid: float, omega_relative_limit: float, gain_mu: float) -> int:
    """Static upper bound on symbols produced from n_in input samples."""
    min_stride = max(1.0, np.floor(omega_mid * (1.0 - omega_relative_limit) - 4.0 * gain_mu))
    return int(np.ceil(n_in / min_stride)) + 2


def clock_chunk(lanes: int = 128) -> int:
    """Samples per clock chunk: the JAX package's partition (2048 rows at up
    to 128 lanes, halved for each further 128 lanes), so the port's
    (C, n_chunks, K) output splits symbols exactly as the JAX step does.
    ``SDRM_CLOCK_CHUNK`` overrides it, read on each call."""
    raw = os.environ.get("SDRM_CLOCK_CHUNK")
    if raw is None:
        lane_tiles = max(1, -(-int(lanes) // 128))
        val = max(SUFFIX, 2048 * 128 // (lane_tiles * 128) // 8 * 8)
    else:
        val = int(raw)
    if val % 8 != 0 or val < SUFFIX:
        raise ValueError(
            f"SDRM_CLOCK_CHUNK={val}: must be a multiple of 8 and >= {SUFFIX} "
            "(the carried suffix must fit one chunk)"
        )
    return val


def chunk_plan(
    n: int,
    c: int,
    sfx: int,
    *,
    omega: float,
    gain_omega: float,
    gain_mu: float = 0.0625,
    omega_relative_limit: float = 0.01,
    num_symbols: int | None = None,
    mu: float | None = None,  # accepted so a clock_params() dict can be passed whole
) -> dict:
    """The keyword arguments of ``ops.clock`` for an (n, c) block: the
    chunk, the symbol slots K of every chunk (sized by the largest, so the
    chunks stack) and the step's float32 constants."""
    chunk = max(clock_chunk(c), sfx)
    omega_mid = float(np.float32(omega))
    if num_symbols is None:
        num_symbols = max_symbols(min(chunk, n) + sfx, omega_mid, omega_relative_limit, gain_mu)
    return dict(
        chunk=chunk,
        num_symbols=int(num_symbols),
        omega_mid=omega_mid,
        omega_lim=float(np.float32(np.float32(omega_mid) * np.float32(omega_relative_limit))),
        gain_omega=float(np.float32(gain_omega)),
        gain_mu=float(np.float32(gain_mu)),
    )


def clock_mm_batched_full(
    y3: torch.Tensor,  # (N, C) float32, time-major
    state: ClockFullState,
    *,
    bank: torch.Tensor,  # (129, 8) MMSE bank on y3's device
    omega: float,
    gain_omega: float,
    mu: float = 0.5,
    gain_mu: float = 0.0625,
    omega_relative_limit: float = 0.01,
    num_symbols: int | None = None,
):
    """Batched M&M over one full block, in chunks of ``clock_chunk(C)``.

    Returns (outs (C, n_chunks, K) f32, counts (C, n_chunks) i32, state').
    """
    n, c = y3.shape
    sfx = state.suffix.shape[0]
    plan = chunk_plan(
        n, c, sfx, omega=omega, gain_omega=gain_omega, gain_mu=gain_mu,
        omega_relative_limit=omega_relative_limit, num_symbols=num_symbols,
    )
    outs, counts, fin = clock_mm_chunked(
        y3, state.suffix, state.omega, state.mu, state.last_sample, state.resid, bank, **plan
    )
    if n >= sfx:
        suffix = y3[n - sfx :]
    else:
        suffix = torch.cat([state.suffix, y3], dim=0)[-sfx:]
    new_state = ClockFullState(
        fin[0], fin[1], fin[2], suffix.contiguous(), fin[3], state.overflow
    )
    return outs.permute(2, 0, 1), counts.T, new_state
