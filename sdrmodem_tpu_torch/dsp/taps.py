"""Filter-tap design (trace-time, pure numpy float64 -> float32).

Reproduces the tap families used by the reference chain:

- ``low_pass_taps``      — GNU-Radio-style windowed-sinc low-pass design
                           (reference src/dsp/lpf_taps.c:33-103).
- ``gaussian_taps``      — Gaussian pulse-shaping taps for GFSK
                           (reference src/dsp/gaussian_taps.c:10-33).
- ``mmse_interp_taps``   — the 129x8 MMSE fractional-delay filter bank
                           used by Mueller&Muller clock recovery
                           (reference src/dsp/mmse_fir_interpolator.c:23-154).
                           Derived here from first principles: each row is
                           the least-squares solution of the band-limited
                           (B = 1/4 cycles/sample) fractional-delay
                           approximation problem, which reproduces the
                           classic GNU Radio table to its printed 6-digit
                           precision.
- ``atan_table``         — the 257-entry arctangent LUT of
                           reference src/math/fast_atan2f.c:23-67,
                           regenerated as atan(i/255).

All design happens at trace/build time on the host in float64 and is cast
to float32, exactly like the C code designs taps once in ``*_create``.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np


def compute_ntaps(sampling_freq: float, transition_width: float) -> int:
    """Number of taps for the windowed-sinc design; forced odd.

    Matches reference src/dsp/lpf_taps.c:33-40 (53 dB Hamming heuristic).
    """
    a = 53.0
    ntaps = int(a * float(sampling_freq) / (22.0 * float(transition_width)))
    if ntaps % 2 == 0:
        ntaps += 1
    return ntaps


def hamming_window(ntaps: int) -> np.ndarray:
    """0.54 - 0.46 cos Hamming window (reference src/dsp/lpf_taps.c:42-53)."""
    n = np.arange(ntaps, dtype=np.float64)
    m = ntaps - 1
    return (0.54 - 0.46 * np.cos(2.0 * np.pi * n / m)).astype(np.float32)


def low_pass_taps(
    gain: float,
    sampling_freq: float,
    cutoff_freq: float,
    transition_width: float,
) -> np.ndarray:
    """Windowed-sinc low-pass FIR taps, DC gain normalised.

    Matches reference src/dsp/lpf_taps.c:55-103 step for step, including
    the float32 rounding points (window and taps are stored as float32
    before normalisation).
    """
    if sampling_freq <= 0:
        raise ValueError("sampling frequency should be positive")
    if cutoff_freq <= 0 or float(cutoff_freq) > float(sampling_freq) / 2:
        raise ValueError(
            "cutoff frequency should be positive and less than sampling freq / 2"
        )
    if transition_width <= 0:
        raise ValueError("transition width should be positive")

    ntaps = compute_ntaps(sampling_freq, transition_width)
    w = hamming_window(ntaps).astype(np.float64)

    m = (ntaps - 1) // 2
    fw_t0 = 2.0 * np.pi * float(cutoff_freq) / float(sampling_freq)
    n = np.arange(-m, m + 1, dtype=np.float64)
    taps = np.empty(ntaps, dtype=np.float64)
    nz = n != 0
    taps[~nz] = fw_t0 / np.pi * w[m]
    taps[nz] = np.sin(n[nz] * fw_t0) / (n[nz] * np.pi) * w[nz.nonzero()[0]]
    taps = taps.astype(np.float32)

    # normalise to unity (well, `gain`) DC gain, float32 accumulation order
    # as in the C loop (fmax += 2 * taps[n + M]).
    fmax = np.float32(taps[m])
    for i in range(1, m + 1):
        fmax = np.float32(fmax + np.float32(2.0) * taps[i + m])
    g = np.float32(gain) / fmax
    return (taps * g).astype(np.float32)


def gaussian_taps(
    gain: float, samples_per_symbol: float, bt: float, ntaps: int
) -> np.ndarray:
    """Gaussian pulse taps normalised to sum == gain.

    Matches reference src/dsp/gaussian_taps.c:10-33:
    s = 2*pi*bt/sqrt(ln 2); taps[i] = exp(-0.5*(s*dt*t0)^2) with
    t0 = -ntaps/2 + 1 + i, then scaled so the float32 taps sum to gain.
    """
    dt = 1.0 / float(samples_per_symbol)
    s = 1.0 / (math.sqrt(math.log(2.0)) / (2.0 * np.pi * float(bt)))
    t0 = -0.5 * ntaps + np.arange(1, ntaps + 1, dtype=np.float64)
    ts = s * dt * t0
    raw = np.exp(-0.5 * ts * ts).astype(np.float32)
    # C accumulates `scale` in double over float32 tap values and divides in
    # double before the final float32 store.
    scale = float(np.sum(raw.astype(np.float64)))
    return (raw.astype(np.float64) / scale * float(gain)).astype(np.float32)


def convolve_full(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Full linear convolution in float32 (reference src/dsp/gfsk_mod.c:17-41)."""
    return np.convolve(x.astype(np.float32), y.astype(np.float32)).astype(np.float32)


def gfsk_pulse_taps(samples_per_symbol: float, bt: float) -> np.ndarray:
    """GFSK pulse = gaussian taps convolved with a square wave of one symbol.

    Matches reference src/dsp/gfsk_mod.c:57-83: gaussian length 4*sps,
    square wave of ones with length int(sps), full convolution.
    """
    g = gaussian_taps(1.0, samples_per_symbol, bt, int(4 * samples_per_symbol))
    square = np.ones(int(samples_per_symbol), dtype=np.float32)
    return convolve_full(g, square)


def polyphase_taps(taps: np.ndarray, interpolation: int) -> np.ndarray:
    """Split taps into an (interpolation, K) polyphase bank, zero-padded.

    Phase i holds taps[i::interpolation]; taps are first zero-padded up to a
    multiple of the interpolation factor
    (reference src/dsp/interp_fir_filter.c:19-73).
    """
    taps = np.asarray(taps, dtype=np.float32)
    n = len(taps) % interpolation
    if n:
        taps = np.concatenate([taps, np.zeros(interpolation - n, np.float32)])
    return taps.reshape(-1, interpolation).T.copy()  # (I, K)


@lru_cache(maxsize=None)
def mmse_interp_taps() -> np.ndarray:
    """(129, 8) MMSE fractional-delay filter bank, window orientation.

    Row ``imu`` contains weights h such that the interpolated sample at
    fractional position ``3 + imu/128`` inside an 8-sample window
    ``x[0..7]`` is ``dot(x, h)``.  This matches how the reference applies
    its (reversed-tap) bank: mmse_fir_interpolator_process(input, mu) =
    sum_j input[j] * table[imu][7-j] (src/dsp/mmse_fir_interpolator.c:188-191
    + the tap reversal in src/dsp/fir_filter.c:8-33).

    Rows are the solution of::

        min_h  integral_{-B}^{B} | H(f) - e^{-j 2 pi f (3 + mu)} |^2 df,
        B = 1/4

    i.e. ``sinc(2B(j-k)) h_k = sinc(2B(j - 3 - mu))`` — which reproduces the
    canonical GNU Radio interpolator table.  Values are rounded to 6
    significant digits to match the table's printed precision.
    """
    j = np.arange(8, dtype=np.float64)
    a = np.sinc(0.5 * (j[:, None] - j[None, :]))
    banks = np.empty((129, 8), dtype=np.float64)
    for imu in range(129):
        d = 3.0 + imu / 128.0
        banks[imu] = np.linalg.solve(a, np.sinc(0.5 * (j - d)))
    # snap solver noise to exact zero (row 0 is an exact unit impulse), then
    # round to 6 significant decimal digits (the table's literal precision)
    banks[np.abs(banks) < 1e-9] = 0.0
    with np.errstate(divide="ignore"):
        mag = np.where(banks == 0.0, 1.0, np.abs(banks))
        decimals = 5 - np.floor(np.log10(mag)).astype(int)
    out = np.array(
        [
            [round(float(v), int(k)) for v, k in zip(row, krow)]
            for row, krow in zip(banks, decimals)
        ],
        dtype=np.float32,
    )
    return out


MMSE_INTERP_NTAPS = 8
MMSE_INTERP_NSTEPS = 128


@lru_cache(maxsize=None)
def atan_table() -> np.ndarray:
    """257-entry arctangent table: atan(i/255) for i in 0..255, repeated tail.

    Regenerates the table of reference src/math/fast_atan2f.c:23-67
    (TAN_MAP_RES = 1/255, last entry duplicated as an interpolation guard).
    """
    i = np.arange(257, dtype=np.float64)
    i[256] = 255.0
    return np.arctan(i / 255.0).astype(np.float32)
