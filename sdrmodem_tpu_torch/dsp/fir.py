"""FIR filtering: the demodulator's strided FIRs and the TX chain's
interpolating FIR.

Counterpart of ``sdrmodem_tpu/dsp/fir.py``.  Stream semantics of the
reference FIR (src/dsp/fir_filter.c:93-144): with X' = [T-1 zeros,
stream], y[k] = sum_j X'[k*d + j] * taps[T-1-j].

- ``conv1d`` / ``conv1d_banded`` / ``fir_stream``: batched strided
  correlations, each output channel one launch of a time-major FIR of
  ``ops/fir.py`` over the transposed rows: the float32 path is B3's kernel
  (``conv1d_banded_tm``), ``exact=True`` the float64-accumulated one
  (``conv1d_exact_tm``).  No library convolution is on the path: cuDNN runs
  float32 convolutions in TF32 by default, and promises no order.

``interp_fir_stream`` is the counterpart of ``interp_fir_stream`` (reference
src/dsp/interp_fir_filter.c:139-154): y[n*I + i] = sum_m x[n-m] *
taps[m*I + i], the taps zero-padded to k*I.  ``polyphase_rows`` sums as
the TX kernels do (``csrc/tx.cu:tx_inc``): one fused multiply-add a tap,
from the oldest row (m = k-1) to the newest, each taken in float64 (where
the product of two float32 is exact) and rounded once to float32, which is
fmaf's result barring a tie of the double rounding.  That is the order of
the JAX package's correlation over reversed taps, whose y it equals bit
for bit on the CPU.  So the unfused chain, the kernels' plain versions
(``ops/tx.py``) and the kernels share one FIR.
"""

from __future__ import annotations

import numpy as np
import torch

from sdrmodem_tpu_torch.dsp import taps as taps_mod
from sdrmodem_tpu_torch.ops.fir import conv1d_banded_tm, conv1d_exact_tm


def _taps(taps, device) -> torch.Tensor:
    """float32 taps (a tensor, or anything numpy takes) on ``device``."""
    if isinstance(taps, torch.Tensor):
        return taps.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(taps, np.float32)).to(device)


def conv1d(x: torch.Tensor, kernel, stride: int, left_pad: int, *, exact: bool = False):
    """Batched 1-D correlation.  x: (B, N) float32, kernel: (T,) or (O, T).

    Returns (B, O, M), M = (N + left_pad - T) // stride + 1, with
    out[b, o, k] = sum_j x_pad[b, k*stride + j] * kernel[o, j], x padded with
    ``left_pad`` zeros on the left.  ``exact=True`` accumulates in float64
    in tap order and rounds once to float32: a canonical deterministic dot
    product (the golden-parity mode); ``exact=False`` is the float32 path."""
    k2 = _taps(kernel, x.device)
    k2 = k2[None, :] if k2.dim() == 1 else k2
    b, n = x.shape
    m = (n + left_pad - k2.shape[1]) // stride + 1
    if m <= 0:
        return x.new_zeros((b, k2.shape[0], 0))
    x_tm = torch.cat([x.new_zeros((left_pad, b)), x.to(torch.float32).T]).contiguous()
    fir = conv1d_exact_tm if exact else conv1d_banded_tm
    out = torch.stack([fir(x_tm, k.contiguous(), stride, m) for k in k2])  # (O, M, B)
    return out.permute(2, 0, 1)


def conv1d_banded(x: torch.Tensor, rev_taps, stride: int, max_out: int) -> torch.Tensor:
    """out[b, k] = sum_j x[b, k*stride + j] * rev_taps[j], k < max_out, over
    rows x (B, W) float32; windows past the end read zeros.  B3's kernel
    over the transposed rows (the JAX package's banded MXU matmul)."""
    rev = _taps(rev_taps, x.device)
    return conv1d_banded_tm(x.to(torch.float32).T.contiguous(), rev, stride, max_out).T


def fir_stream(x: torch.Tensor, taps, decimation: int = 1, *, history: bool = True,
               exact: bool = False) -> torch.Tensor:
    """Decimating FIR over a whole stream, float32 or complex64 x (..., N).

    With ``history=True`` (fresh-filter semantics) the stream is pre-padded
    with T-1 zeros and the output length is ceil(N / d); with
    ``history=False`` the first output's window starts at x[0]."""
    rev = _taps(taps, x.device).flip(0)
    left_pad = rev.numel() - 1 if history else 0
    batch, n = x.shape[:-1], x.shape[-1]
    if x.is_complex():
        flat = torch.cat([x.real.reshape(-1, n), x.imag.reshape(-1, n)])
        out = conv1d(flat, rev, decimation, left_pad, exact=exact)[:, 0, :]
        half = out.shape[0] // 2
        return torch.complex(out[:half], out[half:]).reshape(*batch, -1)
    out = conv1d(x.reshape(-1, n), rev, decimation, left_pad, exact=exact)[:, 0, :]
    return out.reshape(*batch, -1)


def phase_taps(taps, interpolation: int) -> np.ndarray:
    """(k, I) float32: row m, column i = taps[m*I + i], zero-padded to k*I."""
    return taps_mod.polyphase_taps(np.asarray(taps, np.float32), int(interpolation)).T.copy()


def polyphase_rows(work: torch.Tensor, taps2d: torch.Tensor, n: int) -> torch.Tensor:
    """y (n, I, L) float32 from work = [history (k-1 rows) | x (>= n rows)],
    (rows, L) float32: y[r, i, l] = sum_m taps2d[m, i] * work[k-1+r-m, l]."""
    k = taps2d.shape[0]
    t = taps2d.double()[:, :, None]  # (k, I, 1)
    acc = torch.zeros((n, taps2d.shape[1], work.shape[1]), dtype=torch.float32, device=work.device)
    for m in range(k - 1, -1, -1):
        xm = work[k - 1 - m : k - 1 - m + n].double()[:, None, :]  # rows r - m
        acc = (acc.double() + t[m] * xm).float()
    return acc


def interp_fir_stream(x: torch.Tensor, taps, interpolation: int) -> torch.Tensor:
    """Interpolating polyphase FIR over whole streams from a zero history.

    x: (..., N) float32; taps: (T,) natural order.  Returns (..., N*I)
    float32 with y[n*I + i] = sum_m x[n-m] * taps[m*I + i]."""
    t2d = torch.from_numpy(phase_taps(taps, interpolation)).to(x.device)
    k, ii = t2d.shape
    batch, n = x.shape[:-1], x.shape[-1]
    x_tm = x.reshape(-1, n).to(torch.float32).T  # (N, B)
    work = torch.cat([x_tm.new_zeros((k - 1, x_tm.shape[1])), x_tm])
    y = polyphase_rows(work, t2d, n)  # (N, I, B)
    return y.permute(2, 0, 1).reshape(*batch, n * ii)
