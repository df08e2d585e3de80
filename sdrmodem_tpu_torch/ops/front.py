"""The demodulator front end: the CUDA kernel's wrapper and its plain version.

Counterpart of ``sdrmodem_tpu/ops/pallas_front.py:fused_front_call``
without its Doppler stage: LPF1 (complex, d=1) -> quadrature demod
(x * conj(x[-1]) -> LUT atan -> * gain) -> LPF2 (stride d) -> DC blocker
(one causal (4L-3)-tap FIR), carrying every tail between blocks.

Time-major throughout: x is (B, 2C) with I in lanes [0, C) and Q in
[C, 2C); y3 is (B/d, C).  ``fused_front`` launches ``csrc/front.cu`` for
a CUDA tensor and runs ``fused_front_plain`` for a CPU tensor.

The plain version takes every FIR as the kernel does: one fused
multiply-add a tap, in tap order, so the CPU and the card give the same
y3.  The lucky7_nodc fixture has a stretch (symbols ~6300-6400) where the
clock's lock turns on the last ulp of y3 (tests/test_torch_clock.py,
``test_nodc_clocks_agree_on_either_front``); on the kernel's sums the port
holds the reference's ±2 LSB there.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from sdrmodem_tpu_torch.dsp.elementwise import fast_atan2
from sdrmodem_tpu_torch.ops import _build

launches = 0  # kernels launched by fused_front; a run resets and reads it

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "front_forward": [
        _P, _I, _I,  # x, block, lanes
        _P, _P, _I,  # lpf1 hist, taps, t1
        _P, _F, _P,  # quad_prev, quad_gain, atan_table
        _P, _P, _I, _I,  # lpf2 hist, taps, t2, decim
        _P, _P, _I,  # dc hist, taps, t3 (0 = no DC stage)
        _P, _P, _P, _P,  # y1, yq, y2, y3
        _P, _P,  # stream, kernels launched (int out)
    ]
}


class FrontTaps(NamedTuple):
    """The front end's constants, as tensors on the device they run on."""

    rev1: torch.Tensor  # LPF1 taps, reversed
    rev2: torch.Tensor  # LPF2 taps, reversed
    rev_dc: torch.Tensor | None  # DC-blocker FIR taps, reversed (None = no DC)
    d: int  # LPF2 decimation
    quad_gain: float  # float32-exact
    atan_table: torch.Tensor  # (257,) reference arctangent table


def _tail(hist: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The last hist.shape[0] rows of [hist | x]: the FIR's next history."""
    h = hist.shape[0]
    if x.shape[0] >= h:
        return x[x.shape[0] - h :].clone()
    return torch.cat([hist, x], dim=0)[x.shape[0] :]


def _fir_plain(hist, x, rev, d, n_out):
    """y[k] = sum_j rev[j] * [hist | x][k*d + j], per lane, as the kernel
    sums it: acc = fmaf(rev[j], ., acc) for j = 0, 1, ...  Each step is
    taken in float64, where the product of two float32 is exact, and
    rounded once to float32, which is fmaf's result barring a tie of the
    double rounding."""
    work = torch.cat([hist, x], dim=0).double()
    span = (n_out - 1) * d + 1
    acc = torch.zeros((n_out, x.shape[1]), dtype=torch.float32, device=x.device)
    for j, tap in enumerate(rev.double().tolist()):
        acc = torch.add(acc, work[j : j + span : d], alpha=tap).float()
    return acc


def fused_front_plain(x, lpf1_hist, quad_prev, lpf2_hist, dc_hist, taps: FrontTaps):
    """Plain PyTorch front end.  Returns (y3, (lpf1_hist', quad_prev',
    lpf2_hist', dc_hist')) like the JAX ``fused_front_call``."""
    b, c2 = x.shape
    c = c2 // 2
    y1 = _fir_plain(lpf1_hist, x, taps.rev1, 1, b)
    shifted = torch.cat([quad_prev, y1[:-1]], dim=0)
    i, q = y1[:, :c], y1[:, c:]
    si, sq = shifted[:, :c], shifted[:, c:]
    re = i * si + q * sq
    im = q * si - i * sq
    yq = taps.quad_gain * fast_atan2(im, re, taps.atan_table)
    n2 = b // taps.d
    y2 = _fir_plain(lpf2_hist, yq, taps.rev2, taps.d, n2)
    if taps.rev_dc is None:
        y3, dc_new = y2, dc_hist
    else:
        y3 = _fir_plain(dc_hist, y2, taps.rev_dc, 1, n2)
        dc_new = _tail(dc_hist, y2)
    front = (_tail(lpf1_hist, x), y1[b - 1 :].clone(), _tail(lpf2_hist, yq), dc_new)
    return y3, front


def fused_front(x, lpf1_hist, quad_prev, lpf2_hist, dc_hist, taps: FrontTaps):
    """The front end over one full block: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor.  Arguments as ``fused_front_plain``."""
    if x.device.type == "cpu":
        return fused_front_plain(x, lpf1_hist, quad_prev, lpf2_hist, dc_hist, taps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_front: unsupported device {x.device}")
    return _front_cuda(x, lpf1_hist, quad_prev, lpf2_hist, dc_hist, taps)


def _check(name, t, shape, device):
    _build.check_arg("front", name, t, shape, torch.float32, device)


def _front_cuda(x, lpf1_hist, quad_prev, lpf2_hist, dc_hist, taps):
    global launches
    b, c2 = x.shape
    c = c2 // 2
    d = taps.d
    dev = x.device
    t1, t2 = taps.rev1.numel(), taps.rev2.numel()
    t3 = 0 if taps.rev_dc is None else taps.rev_dc.numel()
    if c2 % 2 or b % d:
        raise ValueError(f"front kernel: x {tuple(x.shape)} needs 2C lanes and B % {d} == 0")
    _check("x", x, (b, c2), dev)
    _check("lpf1_hist", lpf1_hist, (t1 - 1, c2), dev)
    _check("quad_prev", quad_prev, (1, c2), dev)
    _check("lpf2_hist", lpf2_hist, (t2 - 1, c), dev)
    _check("rev1", taps.rev1, (t1,), dev)
    _check("rev2", taps.rev2, (t2,), dev)
    _check("atan_table", taps.atan_table, (257,), dev)
    if t3:
        _check("dc_hist", dc_hist, (t3 - 1, c), dev)
        _check("rev_dc", taps.rev_dc, (t3,), dev)
    n2 = b // d
    y1 = torch.empty((b, c2), dtype=torch.float32, device=dev)
    yq = torch.empty((b, c), dtype=torch.float32, device=dev)
    y2 = torch.empty((n2, c), dtype=torch.float32, device=dev) if t3 else None
    y3 = torch.empty((n2, c), dtype=torch.float32, device=dev)
    lib = _build.load("front", _SIGNATURES)
    started = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.front_forward(
            x.data_ptr(), b, c,
            lpf1_hist.data_ptr(), taps.rev1.data_ptr(), t1,
            quad_prev.data_ptr(), taps.quad_gain, taps.atan_table.data_ptr(),
            lpf2_hist.data_ptr(), taps.rev2.data_ptr(), t2, d,
            dc_hist.data_ptr() if t3 else None, taps.rev_dc.data_ptr() if t3 else None, t3,
            y1.data_ptr(), yq.data_ptr(), y2.data_ptr() if t3 else None, y3.data_ptr(),
            stream, ctypes.addressof(started),
        )
    launches += started.value
    _build.check(lib, rc, "front_forward")
    front = (
        _tail(lpf1_hist, x),
        y1[b - 1 :].clone(),
        _tail(lpf2_hist, yq),
        _tail(dc_hist, y2) if t3 else dc_hist,
    )
    return y3, front
