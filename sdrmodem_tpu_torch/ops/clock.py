"""The chunked M&M clock: the CUDA kernel's wrapper and its plain version.

Counterpart of ``sdrmodem_tpu/ops/pallas_clock.py:clock_mm_chunked_tpu``.
``clock_mm_chunked`` launches ``csrc/clock.cu`` for a CUDA tensor and runs
``clock_mm_chunked_plain`` for a CPU tensor.

Both return (outs (n_chunks, K, C) f32, counts (n_chunks, C) i32,
(omega, mu, last, resid) each (C,)).  The plain version walks the block
chunk by chunk, each chunk as the JAX scan backend does
(``dsp/clock_recovery.py:_clock_full_one`` and ``_mm_scan_core``): K masked
steps over [suffix | chunk], a lane freezing once its read position passes
the chunk's end.  It sums the interpolator's 8 products in tap order, as
the kernel does, so on the card the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from sdrmodem_tpu_torch.ops import _build

NTAPS = 8
NSTEPS = 128

launches = 0  # kernel launches by clock_mm_chunked; a run resets and reads it

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "clock_forward": [
        _P, _I, _I, _P, _I,  # y3, n, lanes, suffix, sfx
        _P, _P, _P, _P,  # omega, mu, last, resid
        _P, _I, _I, _I,  # bank, chunk, n_chunks, k_max
        _F, _F, _F, _F,  # omega_mid, omega_lim, gain_omega, gain_mu
        _P, _P, _P, _P, _P, _P,  # outs, counts, omega', mu', last', resid'
        _P,  # stream
    ]
}


def clock_mm_chunked_plain(
    y3, suffix, omega, mu, last, resid, bank, *,
    chunk, num_symbols, omega_mid, omega_lim, gain_omega, gain_mu,
):
    """Plain PyTorch M&M over one block, vectorised over lanes."""
    n, c = y3.shape
    sfx = suffix.shape[0]
    n_chunks = max(1, -(-n // chunk))
    dev = y3.device
    taps_idx = torch.arange(NTAPS, device=dev)[:, None]
    one = torch.ones((), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    suf = suffix
    ii = sfx - resid.to(torch.int64)
    outs, counts = [], []
    for t in range(n_chunks):
        work = torch.cat([suf, y3[t * chunk : min((t + 1) * chunk, n)]], dim=0)
        w = work.shape[0]
        cnt = torch.zeros(c, dtype=torch.int32, device=dev)
        rows = []
        for _ in range(num_symbols):
            valid = ii <= w - NTAPS
            base = ii.clamp(0, w - NTAPS)
            window = work.gather(0, base[None, :] + taps_idx)  # (8, C)
            imu = torch.round(mu * float(NSTEPS)).to(torch.int64).clamp(0, NSTEPS)
            prod = window * bank[imu].T
            y = prod[0]
            for j in range(1, NTAPS):
                y = y + prod[j]
            is_nan = torch.isnan(y)
            out = torch.where(is_nan, zero, y)
            mm = torch.where(last < 0, -one, one) * out - torch.where(out < 0, -one, one) * last
            omega_n = omega + gain_omega * mm
            d = omega_n - omega_mid
            omega_n = omega_mid + 0.5 * ((d + omega_lim).abs() - (d - omega_lim).abs())
            mu_n = mu + omega_n + gain_mu * mm
            stride_n = torch.floor(mu_n)
            mu_n = mu_n - stride_n
            stride = torch.where(is_nan, torch.floor(omega), stride_n).to(torch.int64)
            rows.append(torch.where(valid, out, zero))
            ii = torch.where(valid, ii + stride, ii)
            mu = torch.where(valid & ~is_nan, mu_n, mu)
            omega = torch.where(valid & ~is_nan, omega_n, omega)
            last = torch.where(valid & ~is_nan, out, last)
            cnt = cnt + valid.to(torch.int32)
        outs.append(torch.stack(rows))
        counts.append(cnt)
        # hand-off: the next chunk reads on from sfx - resid in [suffix | chunk]
        resid_t = torch.clamp(w - ii, max=sfx - 1)
        ii = sfx - resid_t
        suf = work[w - sfx :]
    return (
        torch.stack(outs),
        torch.stack(counts),
        (omega, mu, last, resid_t.to(torch.int32)),
    )


def clock_mm_chunked(
    y3, suffix, omega, mu, last, resid, bank, *,
    chunk, num_symbols, omega_mid, omega_lim, gain_omega, gain_mu,
):
    """M&M over one block: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor.  Arguments as ``clock_mm_chunked_plain``."""
    kw = dict(
        chunk=chunk, num_symbols=num_symbols, omega_mid=omega_mid,
        omega_lim=omega_lim, gain_omega=gain_omega, gain_mu=gain_mu,
    )
    if y3.device.type == "cpu":
        return clock_mm_chunked_plain(y3, suffix, omega, mu, last, resid, bank, **kw)
    if y3.device.type != "cuda":
        raise ValueError(f"clock_mm_chunked: unsupported device {y3.device}")
    return _clock_cuda(y3, suffix, omega, mu, last, resid, bank, **kw)


def _check(name, t, shape, dtype, device):
    _build.check_arg("clock", name, t, shape, dtype, device)


def _clock_cuda(
    y3, suffix, omega, mu, last, resid, bank, *,
    chunk, num_symbols, omega_mid, omega_lim, gain_omega, gain_mu,
):
    global launches
    n, c = y3.shape
    sfx = suffix.shape[0]
    dev = y3.device
    f32, i32 = torch.float32, torch.int32
    _check("y3", y3, (n, c), f32, dev)
    _check("suffix", suffix, (sfx, c), f32, dev)
    for name, t in (("omega", omega), ("mu", mu), ("last", last)):
        _check(name, t, (c,), f32, dev)
    _check("resid", resid, (c,), i32, dev)
    _check("bank", bank, (NSTEPS + 1, NTAPS), f32, dev)
    if chunk % 8 or chunk < sfx:
        raise ValueError(f"clock kernel: chunk {chunk} must be a multiple of 8 and >= {sfx}")
    n_chunks = max(1, -(-n // chunk))
    outs = torch.empty((n_chunks, num_symbols, c), dtype=f32, device=dev)
    counts = torch.empty((n_chunks, c), dtype=i32, device=dev)
    fin = [torch.empty(c, dtype=f32, device=dev) for _ in range(3)]
    resid_out = torch.empty(c, dtype=i32, device=dev)
    lib = _build.load("clock", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.clock_forward(
            y3.data_ptr(), n, c, suffix.data_ptr(), sfx,
            omega.data_ptr(), mu.data_ptr(), last.data_ptr(), resid.data_ptr(),
            bank.data_ptr(), chunk, n_chunks, num_symbols,
            omega_mid, omega_lim, gain_omega, gain_mu,
            outs.data_ptr(), counts.data_ptr(),
            fin[0].data_ptr(), fin[1].data_ptr(), fin[2].data_ptr(), resid_out.data_ptr(),
            stream,
        )
    _build.check(lib, rc, "clock_forward")
    launches += 1
    return outs, counts, (fin[0], fin[1], fin[2], resid_out)
