"""Time-major strided FIR: the CUDA kernel's wrapper and its plain version.

Counterpart of ``sdrmodem_tpu/ops/pallas_fir.py``:

- ``conv1d_banded_tm`` (B3, ``pallas_fir.py:181``): out[k, l] =
  sum_j rev[j] * x_tm[k*stride + col_offset + j, l], rows past the end of
  x_tm read as zeros.  The banded front's three FIRs.  The port has no
  128-lane or ``col_offset < 128`` restriction: those come from the TPU's
  tiles, and its summation order does not depend on any row grouping.
- ``fir_tpu`` (B8, ``pallas_fir.py:311``): a fresh-filter FIR (T - 1
  leading zeros, ceil(N/d) output rows), the same kernel behind another
  face, with its own launch count.
- ``conv1d_exact_tm``: the same FIR with a float64 accumulator rounded
  once to float32, the exact mode's FIR (``sdrmodem_tpu/dsp/fir.py:conv1d``
  with ``exact=True``, an XLA convolution there), with its own launch count.

All launch ``csrc/fir.cu`` for a CUDA tensor and run the plain version
for a CPU tensor.  ``conv1d_banded_tm_plain`` sums as the kernel does: one
fused multiply-add a tap, in tap order, each taken in float64 (where the
product of two float32 is exact) and rounded once to float32, which is
fmaf's result barring a tie of the double rounding.  The front end's FIRs
(``ops/front.py``) are this function too.  ``conv1d_exact_tm_plain`` keeps
the sum in float64 in tap order, as the kernel does, so the two agree bit
for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sdrmodem_tpu_torch.ops import _build

launches = 0  # fir kernels launched by conv1d_banded_tm; a run resets and reads it
fir_tpu_launches = 0  # fir kernels launched by fir_tpu
exact_launches = 0  # float64-accumulated fir kernels launched by conv1d_exact_tm

_P = ctypes.c_void_p
_I = ctypes.c_int
_FIR_ARGS = [
    _P, _I, _P, _I,  # x_tm, lanes, rev taps, ntaps
    _I, _I, _I, _P,  # stride, col_offset, n_out, y
    _P,  # stream
]
_SIGNATURES = {"fir_tm_forward": _FIR_ARGS, "fir_exact_tm_forward": _FIR_ARGS}


def _padded(x_tm: torch.Tensor, rows: int) -> torch.Tensor:
    """x_tm with zero rows appended up to ``rows`` (the JAX contract: rows
    past the end read as zeros)."""
    short = rows - x_tm.shape[0]
    if short <= 0:
        return x_tm
    return torch.cat([x_tm, x_tm.new_zeros((short, x_tm.shape[1]))], dim=0)


def _check_shape(x_tm, rev_taps, stride, n_out, col_offset):
    if x_tm.dim() != 2 or rev_taps.dim() != 1 or rev_taps.numel() < 1:
        raise ValueError(
            f"fir: x_tm must be (R, L) and rev_taps (T,), got {tuple(x_tm.shape)} "
            f"and {tuple(rev_taps.shape)}"
        )
    if stride < 1 or n_out < 1 or col_offset < 0:
        raise ValueError(f"fir: stride {stride} and n_out {n_out} must be >= 1, col_offset >= 0")


def _plain(x_tm, rev_taps, stride, n_out, col_offset, acc_dtype):
    """Tap-order FIR through float64, the sum kept in ``acc_dtype``."""
    _check_shape(x_tm, rev_taps, stride, n_out, col_offset)
    t = rev_taps.numel()
    span = (n_out - 1) * stride + 1
    work = _padded(x_tm, col_offset + span + t - 1)[col_offset:].double()
    acc = torch.zeros((n_out, x_tm.shape[1]), dtype=acc_dtype, device=x_tm.device)
    for j, tap in enumerate(rev_taps.double().tolist()):
        acc = torch.add(acc, work[j : j + span : stride], alpha=tap).to(acc_dtype)
    return acc.float()


def conv1d_banded_tm_plain(x_tm, rev_taps, stride: int, n_out: int, *, col_offset: int = 0):
    """Plain PyTorch strided FIR: (R, L) float32 -> (n_out, L) float32."""
    return _plain(x_tm, rev_taps, stride, n_out, col_offset, torch.float32)


def conv1d_exact_tm_plain(x_tm, rev_taps, stride: int, n_out: int, *, col_offset: int = 0):
    """Plain version of ``conv1d_exact_tm``: the sum in float64, in tap
    order, rounded once to float32."""
    return _plain(x_tm, rev_taps, stride, n_out, col_offset, torch.float64)


def _fir_cuda(x_tm, rev_taps, stride, n_out, col_offset, entry="fir_tm_forward"):
    _check_shape(x_tm, rev_taps, stride, n_out, col_offset)
    dev = x_tm.device
    t = rev_taps.numel()
    x_tm = _padded(x_tm, (n_out - 1) * stride + col_offset + t)
    _build.check_arg("fir", "x_tm", x_tm, tuple(x_tm.shape), torch.float32, dev)
    _build.check_arg("fir", "rev_taps", rev_taps, (t,), torch.float32, dev)
    lanes = x_tm.shape[1]
    y = torch.empty((n_out, lanes), dtype=torch.float32, device=dev)
    lib = _build.load("fir", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(
            x_tm.data_ptr(), lanes, rev_taps.data_ptr(), t,
            stride, col_offset, n_out, y.data_ptr(), stream,
        )
    _build.check(lib, rc, entry)
    return y


def conv1d_banded_tm(x_tm, rev_taps, stride: int, n_out: int, *, col_offset: int = 0):
    """Strided time-major FIR over x_tm (R, L) float32 with reversed taps
    ``rev_taps`` (T,) float32 on x_tm's device: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor.  Returns (n_out, L)."""
    global launches
    if _build.device_kind(x_tm, "conv1d_banded_tm") == "cpu":
        return conv1d_banded_tm_plain(x_tm, rev_taps, stride, n_out, col_offset=col_offset)
    y = _fir_cuda(x_tm, rev_taps, stride, n_out, col_offset)
    launches += 1
    return y


def conv1d_exact_tm(x_tm, rev_taps, stride: int, n_out: int, *, col_offset: int = 0):
    """``conv1d_banded_tm``'s FIR with a float64 accumulator, rounded once
    to float32: the float64 kernel for a CUDA tensor, the plain version for
    a CPU tensor.  Returns (n_out, L) float32."""
    global exact_launches
    if _build.device_kind(x_tm, "conv1d_exact_tm") == "cpu":
        return conv1d_exact_tm_plain(x_tm, rev_taps, stride, n_out, col_offset=col_offset)
    y = _fir_cuda(x_tm, rev_taps, stride, n_out, col_offset, "fir_exact_tm_forward")
    exact_launches += 1
    return y


def _fresh_filter(x, taps):
    """(T - 1 leading zeros | x) and the reversed float32 taps on x's device."""
    if isinstance(taps, torch.Tensor):
        taps = taps.to(torch.float32)
    else:  # a copy, so a reversed numpy view converts too
        taps = torch.from_numpy(np.array(taps, np.float32))
    rev = taps.flip(0).to(x.device).contiguous()
    x_pad = torch.cat([x.new_zeros((rev.numel() - 1, x.shape[1])), x], dim=0)
    return x_pad, rev


def fir_tpu_plain(x, taps, decimation: int = 1):
    """Plain version of ``fir_tpu``."""
    x_pad, rev = _fresh_filter(x, taps)
    d = int(decimation)
    return conv1d_banded_tm_plain(x_pad, rev, d, -(-x.shape[0] // d))


def fir_tpu(x, taps, decimation: int = 1):
    """Batched FIR with fresh-filter stream semantics over x (N, C) float32,
    taps (T,) in natural order (a tensor, or anything numpy takes): T - 1
    leading zeros, output rows ceil(N / d).  Returns (ceil(N/d), C) float32,
    what ``sdrmodem_tpu/dsp/fir.py:fir_stream`` computes."""
    global fir_tpu_launches
    if _build.device_kind(x, "fir_tpu") == "cpu":
        return fir_tpu_plain(x, taps, decimation)
    x_pad, rev = _fresh_filter(x, taps)
    d = int(decimation)
    y = _fir_cuda(x_pad, rev, d, -(-x.shape[0] // d), 0)
    fir_tpu_launches += 1
    return y
