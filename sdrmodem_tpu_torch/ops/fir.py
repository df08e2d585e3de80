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
for a CPU tensor.  The kernel reads its input in place, rows past the end
as zeros (``fir_tpu``'s T - 1 leading zeros too), in one of two forms that
``fir_plan`` picks by the lanes: the wide form (32 lanes a block, tiles of
outputs staged in shared memory) or the narrow one (threads over the
outputs of one lane, one client's stream); both walk long filters in tap
parts and give the same bits.  ``conv1d_banded_tm_plain`` sums as the
kernel does: one
fused multiply-add a tap, in tap order, each taken in float64 (where the
product of two float32 is exact) and rounded once to float32, which is
fmaf's result barring a tie of the double rounding.  The front end's FIRs
(``ops/front.py``) are this function too.  ``conv1d_exact_tm_plain`` keeps
the sum in float64 in tap order, as the kernel does, so the two agree bit
for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from sdrmodem_tpu_torch.ops import _build

launches = 0  # fir kernels launched by conv1d_banded_tm; a run resets and reads it
fir_tpu_launches = 0  # fir kernels launched by fir_tpu
exact_launches = 0  # float64-accumulated fir kernels launched by conv1d_exact_tm

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_FIR_ARGS = [
    _P, _L, _P, _L, _I,  # hist (or null: zeros), h, x, x_rows, lanes
    _P, _I, _I, _I,  # rev taps, ntaps, stride, n_out
    _I, _I, _I, _P, _P,  # the plan's form, part and segment; y, stream
]
_SIGNATURES = {
    "fir_tm_forward": _FIR_ARGS,
    "fir_exact_tm_forward": _FIR_ARGS,
    "fir_shared_bytes": [_I, _I, _I],
}

# csrc/fir.cuh's geometry (kFirWarps, kNarrowThreads, kFirBufferBytes)
WIDE_LANES = 32  # lanes a wide block; fewer lanes take the narrow form
FIR_WARPS = 8  # warps of a wide block, rows_a_thread outputs of a tile each
NARROW_THREADS = 128  # threads of a narrow block
FIR_BUFFER_BYTES = 57600  # one stage buffer: two a block, two blocks an SM
H100_SMS = 132
WIDE_WAVES = 16  # wide segments: the lane groups fill the SMs this many times


def rows_a_thread(wide: bool, stride: int) -> int:
    """Outputs a thread (``fir_rows_a_thread``): the register window slides
    at strides 1 and 2, odd in the narrow form; other strides take the D =
    0 form."""
    if wide:
        return {1: 24, 2: 16}.get(stride, 4)
    return {1: 15, 2: 7}.get(stride, 5)


def _tile(wide: bool, stride: int) -> int:
    return (FIR_WARPS if wide else NARROW_THREADS) * rows_a_thread(wide, stride)


def _stage_step(stride: int, part: int) -> int:
    """Rows between consecutive outputs' windows in a stage
    (``fir_stage_step``)."""
    return part if stride > 2 and part < stride else stride


def _buffer_floats(wide: bool, stride: int, part: int) -> int:
    rows = (_tile(wide, stride) - 1) * _stage_step(stride, part) + part
    return -(-part // 4) * 4 + -(-rows * (WIDE_LANES if wide else 1) // 4) * 4


def fir_shared_bytes(wide: bool, stride: int, part: int) -> int:
    """Bytes of shared memory of one block: two stage buffers
    (``csrc/fir.cu:fir_shared_bytes``)."""
    return 2 * 4 * _buffer_floats(wide, stride, part)


class FirPlan(NamedTuple):
    """How ``fir_tm_forward`` cuts one FIR: the form (``wide``: 32 lanes a
    block, else one), ``tile`` outputs a stage, ``rows_a_thread`` of them a
    thread, the taps in ``parts`` ((j0, j1) each, in order) of at most
    ``part`` taps, ``seg`` outputs a block, ``blocks`` blocks."""

    wide: bool
    lanes_a_block: int
    tile: int
    rows_a_thread: int
    part: int
    parts: tuple
    seg: int
    blocks: int
    shared_bytes: int


@functools.lru_cache(maxsize=256)
def fir_plan(n_out: int, lanes: int, ntaps: int, stride: int, sms: int = H100_SMS) -> FirPlan:
    """The wide form for 32 lanes or more, else the narrow; the taps in
    the fewest parts whose stage buffer fits FIR_BUFFER_BYTES, of equal
    length; wide segments so that the lane groups fill ``sms`` SMs
    WIDE_WAVES times, in whole tiles, at most 65535 a lane group."""
    wide = lanes >= WIDE_LANES
    tile = _tile(wide, stride)
    lo, hi = 1, ntaps  # the longest part that fits: the buffer grows with the part
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if 4 * _buffer_floats(wide, stride, mid) <= FIR_BUFFER_BYTES else (lo, mid - 1)
    n_parts = -(-ntaps // lo)
    part = -(-ntaps // n_parts)
    parts = tuple((j, min(ntaps, j + part)) for j in range(0, ntaps, part))
    if wide:
        groups = -(-lanes // WIDE_LANES)
        n_seg = max(1, WIDE_WAVES * sms // groups)
        seg = max(-(-n_out // n_seg), -(-n_out // 65535))
        seg = -(-seg // tile) * tile
        blocks = groups * -(-n_out // seg)
    else:
        seg = tile
        blocks = lanes * -(-n_out // tile)
    return FirPlan(wide=wide, lanes_a_block=WIDE_LANES if wide else 1, tile=tile,
                   rows_a_thread=rows_a_thread(wide, stride), part=part, parts=parts, seg=seg,
                   blocks=blocks, shared_bytes=fir_shared_bytes(wide, stride, part))


def _check_shape(x_tm, rev_taps, stride, n_out, col_offset):
    if x_tm.dim() != 2 or rev_taps.dim() != 1 or rev_taps.numel() < 1:
        raise ValueError(
            f"fir: x_tm must be (R, L) and rev_taps (T,), got {tuple(x_tm.shape)} "
            f"and {tuple(rev_taps.shape)}"
        )
    if stride < 1 or n_out < 1 or col_offset < 0:
        raise ValueError(f"fir: stride {stride} and n_out {n_out} must be >= 1, col_offset >= 0")


def _plain(x_tm, rev_taps, stride, n_out, col_offset, acc_dtype):
    """Tap-order FIR through float64, the sum kept in ``acc_dtype``; rows
    past the end of x_tm read as zeros."""
    _check_shape(x_tm, rev_taps, stride, n_out, col_offset)
    t = rev_taps.numel()
    span = (n_out - 1) * stride + 1
    work = x_tm[col_offset:].double()
    if work.shape[0] < span + t - 1:
        work = torch.nn.functional.pad(work, (0, 0, 0, span + t - 1 - work.shape[0]))
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


def _fir_cuda(x, rev_taps, stride, n_out, *, col_offset=0, zeros_before=0, entry="fir_tm_forward"):
    """The kernel over [zeros_before rows of zeros | x[col_offset:] | zeros]."""
    _check_shape(x, rev_taps, stride, n_out, col_offset)
    dev = x.device
    t = rev_taps.numel()
    _build.check_arg("fir", "x_tm", x, tuple(x.shape), torch.float32, dev)
    _build.check_arg("fir", "rev_taps", rev_taps, (t,), torch.float32, dev)
    rows, lanes = x.shape
    skip = min(col_offset, rows)
    plan = fir_plan(n_out, lanes, t, stride, torch.cuda.get_device_properties(dev).multi_processor_count)
    y = torch.empty((n_out, lanes), dtype=torch.float32, device=dev)
    lib = _build.load("fir", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(
            None, zeros_before, x.data_ptr() + 4 * skip * lanes, rows - skip, lanes,
            rev_taps.data_ptr(), t, stride, n_out, int(plan.wide), plan.part, plan.seg,
            y.data_ptr(), stream,
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
    y = _fir_cuda(x_tm, rev_taps, stride, n_out, col_offset=col_offset)
    launches += 1
    return y


def conv1d_exact_tm(x_tm, rev_taps, stride: int, n_out: int, *, col_offset: int = 0):
    """``conv1d_banded_tm``'s FIR with a float64 accumulator, rounded once
    to float32: the float64 kernel for a CUDA tensor, the plain version for
    a CPU tensor.  Returns (n_out, L) float32."""
    global exact_launches
    if _build.device_kind(x_tm, "conv1d_exact_tm") == "cpu":
        return conv1d_exact_tm_plain(x_tm, rev_taps, stride, n_out, col_offset=col_offset)
    y = _fir_cuda(x_tm, rev_taps, stride, n_out, col_offset=col_offset, entry="fir_exact_tm_forward")
    exact_launches += 1
    return y


def _rev_taps(taps, device):
    """The reversed float32 taps on ``device``."""
    if isinstance(taps, torch.Tensor):
        taps = taps.to(torch.float32)
    else:  # a copy, so a reversed numpy view converts too
        taps = torch.from_numpy(np.array(taps, np.float32))
    return taps.flip(0).to(device).contiguous()


def fir_tpu_plain(x, taps, decimation: int = 1):
    """Plain version of ``fir_tpu``."""
    rev = _rev_taps(taps, x.device)
    x_pad = torch.cat([x.new_zeros((rev.numel() - 1, x.shape[1])), x], dim=0)
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
    rev = _rev_taps(taps, x.device)
    d = int(decimation)
    y = _fir_cuda(x, rev, d, -(-x.shape[0] // d), zeros_before=rev.numel() - 1)
    fir_tpu_launches += 1
    return y
