"""The interpolating polyphase FIR of the TX chain, plain PyTorch.

Counterpart of ``sdrmodem_tpu/dsp/fir.py:interp_fir_stream`` (reference
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
