"""Elementwise blocks of the demodulator front end.

Counterpart of ``sdrmodem_tpu/dsp/elementwise.py:28-69, 258-280, 347-388``:

- ``fast_atan2``        — the reference's 257-entry LUT arctangent
                          (src/math/fast_atan2f.c:87-150), a real table
                          gather: the GPU has gathers, so the JAX package's
                          gather-free polynomial variants are not ported;
- ``atan2_dispatch``    — the quad demod's arctangent by mode
                          (``elementwise.py:207-232``);
- ``quad_demod_stream`` — the FM discriminator (reference
                          src/dsp/quadrature_demod.c:57-73);
- ``dc_blocker_length`` / ``dc_blocker_taps`` / ``dc_blocker_stream``
                        — the 4-stage moving-average DC blocker
                          (src/dsp/dc_blocker.c:56-119) as one causal FIR;
- ``nco_steps`` / ``nco_mix_pair_tm``
                        — the per-lane Doppler NCO multiply, the device
                          half of Doppler correction (dsp/doppler.py keeps
                          the 1 Hz host half);
- ``bytes_to_nrz``      — bytes to +-1 NRZ, MSB first (``gfsk_mod.py:44-50``);
- ``nco_phases`` / ``nco_stream``
                        — a complex NCO at an integer frequency
                          (``elementwise.py:293-330``);
- ``freq_mod_stream`` / ``freq_mod_stream_pair`` / ``freq_mod_pair_fast``
                        — the TX VCO (``elementwise.py:333-457``): a float64
                          phase prefix, or the two-level float32 one.  The
                          TX kernels (``csrc/tx.cu``) carry the float64
                          prefix, as ``freq_mod_stream_pair`` does.

``csrc/front.cu`` evaluates ``fast_atan2`` with the same operations in the
same order, so the kernel and this plain version agree bit for bit;
``csrc/nco.cuh`` takes the NCO ramp in ``nco_mix_pair_tm``'s order, and
the two differ only in the last ulp of cos and sin.
"""

from __future__ import annotations

import numpy as np
import torch

from sdrmodem_tpu_torch.dsp import taps as taps_mod
from sdrmodem_tpu_torch.dsp.fir import fir_stream
from sdrmodem_tpu_torch.ops._build import resolve_device

_PI = float(np.float32(np.pi))
_TWO_PI32 = float(np.float32(2 * np.pi))
_HALF_PI = float(np.float32(np.pi / 2))
_TAN_MAP_RES = float(np.float32(0.003921569))  # smallest non-zero table value
_TINY = float(np.float32(1e-45))


def atan_table(device) -> torch.Tensor:
    """The 257-entry reference arctangent table as a float32 tensor."""
    return torch.from_numpy(taps_mod.atan_table().copy()).to(device)


def fast_atan2(
    y: torch.Tensor, x: torch.Tensor, table: torch.Tensor | None = None
) -> torch.Tensor:
    """Table-lookup arctangent, float32: linear interpolation in the
    257-entry table over [0, pi/4], octant folding and a small-angle
    shortcut, exactly as reference src/math/fast_atan2f.c:87-150."""
    if table is None:
        table = atan_table(y.device)
    y = y.to(torch.float32)
    x = x.to(torch.float32)
    y_abs = y.abs()
    x_abs = x.abs()
    both_zero = ~((y_abs > 0.0) | (x_abs > 0.0))
    denom = torch.clamp(torch.maximum(y_abs, x_abs), min=_TINY)
    z = torch.minimum(y_abs, x_abs) / denom

    alpha = z * 255.0
    index = torch.clamp(alpha.to(torch.int64), 0, 255)
    frac = alpha - index.to(torch.float32)
    t0 = table[index]
    t1 = table[index + 1]
    interp = t0 + (t1 - t0) * frac
    base = torch.where(z < _TAN_MAP_RES, z, interp)

    # octant folding identical to the C branch ladder
    angle = torch.where(
        x_abs > y_abs,
        torch.where(
            x >= 0.0,
            torch.where(y >= 0.0, base, -base),
            torch.where(y >= 0.0, _PI - base, base - _PI),
        ),
        torch.where(
            y >= 0.0,
            torch.where(x >= 0.0, _HALF_PI - base, _HALF_PI + base),
            torch.where(x >= 0.0, base - _HALF_PI, -_HALF_PI - base),
        ),
    )
    return torch.where(both_zero, torch.zeros_like(angle), angle)


LUT_MODES = (True, "lut", "free")
ATAN2_MODES = (False, "atan2")


def is_lut_mode(mode) -> bool:
    """Whether the arctangent ``mode`` is the reference LUT; raise for a
    mode the port does not take.

    True, "lut" and "free" are the reference LUT ("free" is the TPU's
    gather-free evaluation of the same table; the port keeps the gather);
    False and "atan2" are ``torch.atan2`` with the LUT's (0, 0) -> 0 rule.
    The JAX package's profiling mode "null" (deliberately not an
    arctangent) and its in-kernel forms are not ported."""
    for modes, lut in ((LUT_MODES, True), (ATAN2_MODES, False)):
        if any(mode is m if isinstance(m, bool) else mode == m for m in modes):
            return lut
    raise ValueError(
        f"arctangent mode {mode!r}: the port takes True/'lut'/'free' (the reference LUT) "
        "or False/'atan2'"
    )


def atan2_dispatch(im: torch.Tensor, re: torch.Tensor, mode, table: torch.Tensor | None = None):
    """The quad demod's arctangent of im / re in ``mode`` (``is_lut_mode``)."""
    if is_lut_mode(mode):
        return fast_atan2(im, re, table)
    both_zero = ~((im.abs() > 0) | (re.abs() > 0))
    return torch.where(both_zero, torch.zeros((), device=im.device), torch.atan2(im, re))


def conj_product(xr, xi, sr, si):
    """(re, im) of x * conj(s), float32, each part one fused multiply-add:
    re = fma(xr, sr, xi*si), im = fma(xi, sr, -(xr*si)), the rounding of
    the JAX package's conjugate products on the CPU (XLA contracts them;
    checked bit for bit on the lucky7 capture).  Taken in float64, where the
    product of two float32 is exact, and rounded once to float32: fmaf's
    result barring a tie of the double rounding, the same on the CPU and
    the card.  The lucky7_nodc fixture's clock lock turns on these bits
    (ROADMAP §C)."""
    re = (xr.double() * sr.double() + (xi * si).double()).float()
    im = (xi.double() * sr.double() - (xr * si).double()).float()
    return re, im


def quad_demod_stream(
    x: torch.Tensor, gain: float, prev: torch.Tensor | None = None, *, use_lut=True
) -> torch.Tensor:
    """FM discriminator y[n] = gain * arg(x[n] * conj(x[n-1])) over complex
    x (..., N); ``prev`` is the carried sample (0 by default, the
    reference's fresh state, so y[0] = 0)."""
    if prev is None:
        prev = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    else:
        prev = torch.as_tensor(prev, dtype=x.dtype, device=x.device).expand(x.shape[:-1] + (1,))
    shifted = torch.cat([prev, x[..., :-1]], dim=-1)
    re, im = conj_product(x.real, x.imag, shifted.real, shifted.imag)
    return float(np.float32(gain)) * atan2_dispatch(im, re, use_lut)


def dc_blocker_length(sps: float) -> int:
    """Reference DC blocker length: ceil(sps * 32) (src/dsp/fsk_demod.c:56)."""
    return int(np.ceil(np.float32(sps) * 32))


def dc_blocker_taps(length: int) -> np.ndarray:
    """Equivalent causal FIR taps of the 4-stage moving-average DC blocker.

    The reference (src/dsp/dc_blocker.c:105-119) computes, per sample,
    out[t] = x[t - 2(L-1)] - MA_L^4(x)[t], where MA_L is a length-L moving
    average and the delayed path a 2(L-1)-sample delay line.  Composing the
    four averages gives a single causal FIR of length 4L-3:

        taps[j] = delta[j - 2(L-1)] - (u*u*u*u)[j],   u = ones(L)/L
    """
    u = np.full(length, 1.0 / length, np.float64)
    k = np.convolve(np.convolve(u, u), np.convolve(u, u))  # length 4L-3
    taps = -k
    taps[2 * (length - 1)] += 1.0
    return taps.astype(np.float32)


def dc_blocker_stream(x: torch.Tensor, length: int) -> torch.Tensor:
    """The DC blocker over a whole stream from a zero state."""
    return fir_stream(x, dc_blocker_taps(length), 1)


def nco_steps(adjs: torch.Tensor) -> torch.Tensor:
    """Per-row coarse phase step of the two-level NCO ramp:
    float32(mod(float64(adj) * 4096, 2 pi)), taken in float64 once per
    call (``sdrmodem_tpu/dsp/elementwise.py:378``,
    ``ops/pallas_front.py:337-339``).  The kernel reads this table too."""
    return torch.remainder(adjs.double() * 4096.0, 2 * np.pi).float()


def nco_mix_pair_tm(
    x_tm: torch.Tensor,  # (B, 2C) f32 time-major, I lanes [0, C), Q [C, 2C)
    starts: torch.Tensor,  # (S, C) f32: row s is active from starts[s]
    ends: torch.Tensor,  # (S, C) f32: ... to ends[s] (exclusive)
    adjs: torch.Tensor,  # (S, C) f32: phase increment a sample
    ph0s: torch.Tensor,  # (S, C) f32: phase at the row's first sample
) -> torch.Tensor:
    """Per-lane piecewise-linear-phase NCO multiply, float32.

    Sample n of lane c gets phase ph0 + (n - start) * adj of the row whose
    [start, end) holds n, summed over rows; a lane with no active row gets
    phase 0, an exact identity multiply (i*1 - q*0 = i), so Doppler-free
    lanes pass through bit for bit.  The ramp is two-level, d = k*4096 + m,
    with the k term's step from ``nco_steps``.  Each operation is one torch
    op on float32, in the order of ``csrc/nco.cuh`` (which takes each with
    a round-to-nearest intrinsic), so no multiply and add are contracted."""
    b, c2 = x_tm.shape
    c = c2 // 2
    steps = nco_steps(adjs)
    nrow = torch.arange(b, dtype=torch.float32, device=x_tm.device)[:, None]
    ph = torch.zeros((b, c), dtype=torch.float32, device=x_tm.device)
    for s in range(starts.shape[0]):
        st, en = starts[s], ends[s]
        active = (nrow >= st) & (nrow < en)
        dd = nrow - st
        kq = torch.floor(dd * (1.0 / 4096.0))
        mq = dd - kq * 4096.0
        ramp = (ph0s[s] + mq * adjs[s]) + kq * steps[s]
        ph = ph + torch.where(active, ramp, 0.0)
    cs, sn = torch.cos(ph), torch.sin(ph)
    i, q = x_tm[:, :c], x_tm[:, c:]
    return torch.cat([i * cs - q * sn, i * sn + q * cs], dim=1)


def bytes_to_nrz(data: torch.Tensor) -> torch.Tensor:
    """uint8 bytes (..., N) -> float32 (..., N*8) of +-1.0, MSB first."""
    data = data.to(torch.uint8)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=data.device)
    bits = (data[..., :, None] >> shifts) & 1
    nrz = torch.where(bits == 0, -1.0, 1.0).to(torch.float32)
    return nrz.reshape(*data.shape[:-1], data.shape[-1] * 8)


def nco_phases(freq, n: int, sampling_freq: float, phase0=0.0, *, device=None):
    """Phases of a complex NCO at integer frequency ``freq`` for n samples
    (reference src/dsp/sig_source.c:43-58): the increment is the float32
    value 2*pi*freq/Fs, sample i gets phase0 + i*adj, taken in float64 and
    reduced mod 2*pi, on ``device`` (CUDA when None, ``resolve_device``).
    Returns (phases (n,) float32, next phase0 float64)."""
    device = resolve_device(device)
    adj = float(np.float32(np.float32(_TWO_PI32 * np.float32(freq)) / np.float32(sampling_freq)))
    i = torch.arange(n, dtype=torch.float64, device=device)
    ramp = torch.remainder(i * adj, 2 * np.pi)
    ph0 = torch.as_tensor(phase0, dtype=torch.float64, device=device)
    phase = torch.remainder(ph0 + ramp, 2 * np.pi)
    next_phase = torch.remainder(ph0 + n * adj, 2 * np.pi)
    return phase.float(), next_phase


def nco_stream(freq, n: int, sampling_freq: float, amplitude: float = 1.0, phase0=0.0, *,
               device=None):
    """Complex NCO output amplitude * (cos + j sin) and the carried phase,
    on ``device`` as ``nco_phases``."""
    phase, next_phase = nco_phases(freq, n, sampling_freq, phase0, device=device)
    amp = float(np.float32(amplitude))
    return torch.complex(amp * torch.cos(phase), amp * torch.sin(phase)), next_phase


def _vco_phase(x: torch.Tensor, sensitivity: float, phase0):
    """phase0 + cumsum(float32(sensitivity * x)) along the last axis, in
    float64, and the next phase mod 2*pi."""
    sens = torch.tensor(float(np.float32(sensitivity)), dtype=torch.float32, device=x.device)
    inc = (sens * x.to(torch.float32)).double()
    ph0 = torch.as_tensor(phase0, dtype=torch.float64, device=x.device)
    phase = ph0 + torch.cumsum(inc, dim=-1)
    # an empty x carries phase0 on
    last = phase[..., -1] if phase.shape[-1] else (ph0 + inc.sum(-1, keepdim=True))[..., 0]
    return phase, torch.remainder(last, 2 * np.pi)


def freq_mod_stream(x: torch.Tensor, sensitivity: float, phase0=0.0):
    """VCO (reference src/dsp/frequency_modulator.c:48-57): phase[n] =
    phase0 + sensitivity * cumsum(x), carried in float64 and reduced mod
    2*pi; out = exp(j*phase).  x: (..., N) float32.  Returns ((..., N)
    complex64, next phase float64)."""
    phase, next_phase = _vco_phase(x, sensitivity, phase0)
    ph32 = torch.remainder(phase, 2 * np.pi).float()
    return torch.complex(torch.cos(ph32), torch.sin(ph32)), next_phase


def freq_mod_stream_pair(x: torch.Tensor, sensitivity: float, phase0=0.0, *, exact: bool = True):
    """``freq_mod_stream`` as (I, Q, next phase) float arrays; ``exact=False``
    routes to the two-level float32 prefix (``freq_mod_pair_fast``)."""
    if not exact:
        return freq_mod_pair_fast(x, sensitivity, phase0)
    phase, next_phase = _vco_phase(x, sensitivity, phase0)
    ph32 = torch.remainder(phase, 2 * np.pi).float()
    return torch.cos(ph32), torch.sin(ph32), next_phase


def freq_mod_pair_fast(x: torch.Tensor, sensitivity: float, phase0=0.0, *, tile: int = 1024):
    """The JAX package's production VCO: a float32 cumsum inside tiles of
    ``tile`` samples, the tile offsets an exclusive float64 cumsum of the
    tile totals reduced mod 2*pi.  Returns (I, Q, next phase float64) like
    ``freq_mod_stream_pair``."""
    xf = x.to(torch.float32)
    shape = xf.shape
    n = shape[-1]
    m = min(tile, n)
    pad = (-n) % m
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
    tiles = xf.shape[-1] // m
    sens = torch.tensor(float(np.float32(sensitivity)), dtype=torch.float32, device=x.device)
    local = torch.cumsum((sens * xf).reshape(*shape[:-1], tiles, m), dim=-1)
    totals = local[..., -1].double()
    offs = torch.cumsum(totals, dim=-1) - totals
    ph0 = torch.as_tensor(phase0, dtype=torch.float64, device=x.device)
    offs = torch.remainder(ph0 + offs, 2 * np.pi)
    phase = offs.float()[..., None] + local
    next_phase = torch.remainder(offs[..., -1] + totals[..., -1], 2 * np.pi)
    i = torch.cos(phase).reshape(*shape[:-1], tiles * m)[..., :n]
    q = torch.sin(phase).reshape(*shape[:-1], tiles * m)[..., :n]
    return i, q, next_phase
