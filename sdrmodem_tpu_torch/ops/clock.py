"""The M&M clocks: the CUDA kernels' wrappers and their plain versions.

- ``clock_mm_chunked`` (B2), counterpart of ``sdrmodem_tpu/ops/
  pallas_clock.py:clock_mm_chunked_tpu``: every lane over one full block in
  the JAX chunk partition.  Returns (outs (n_chunks, K, C) f32, counts
  (n_chunks, C) i32, (omega, mu, last, resid) each (C,)).  The plain
  version walks the block chunk by chunk, each chunk as the JAX scan
  backend does (``dsp/clock_recovery.py:_clock_full_one``): K masked steps
  over the chunk's work buffer [the sfx rows before it | the chunk], a lane
  freezing once its read position passes the buffer's end, a read position
  below the buffer's first row reading that row.  The kernel gives each
  lane a thread block that stages whole chunks into shared memory,
  ``CLOCK_SLOT_ROWS`` rows of them at a time, and walks each chunk in its
  own buffer as the plain version does (``csrc/mm_chunk.cuh``); the slot
  size changes no bit, only the speed.
- ``clock_mm_tpu`` (B4), counterpart of ``pallas_clock.py:clock_mm_tpu``:
  the ragged walk, every lane over its own prepared buffer from ``ii0``,
  frozen once ii > n_valid - 8.  Returns (outs (C, K) f32, counts (C,)
  i32, {omega, mu, last, ii, overflow} each (C,)), K = num_symbols rounded
  up to a multiple of 8 as the JAX kernel rounds it; the walk takes at most
  num_symbols steps, as the JAX scan does, and slots past a lane's count are
  0.  ``overflow`` is always 0: the port reads every window directly and
  has no window ladder to overflow.  Its plain version is ``mm_walk_plain``
  (under the JAX scan's signature, ``dsp/clock_recovery.py:_mm_scan_core``).
  The kernel gives each lane a thread block that walks it from rows staged
  in shared memory ``RAGGED_SLOT_ROWS`` at a time; the slot size changes
  no bit, only the speed.

Each wrapper launches ``csrc/clock.cu`` for a CUDA tensor and runs its
plain version for a CPU tensor.  The plain versions take one step for every
lane at once with ``_mm_step_plain``, which sums the interpolator's 8
products in tap order and contracts no multiply and add, as the kernels'
``csrc/mm_step.cuh`` does, so on the card each kernel and its plain version
agree bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sdrmodem_tpu_torch.dsp import taps as taps_mod
from sdrmodem_tpu_torch.ops import _build

NTAPS = 8
NSTEPS = 128

launches = 0  # kernel launches by clock_mm_chunked; a run resets and reads it
ragged_launches = 0  # kernel launches by clock_mm_tpu
# rows of a lane B4 stages into shared memory at a time: two slots of
# 4096 + 8 floats and the bank are ~37 KB a block, so ~6 blocks fit an SM
RAGGED_SLOT_ROWS = 4096
# rows of y3 a slot of B2 holds at least: max(1, CLOCK_SLOT_ROWS // chunk)
# whole chunks, so at the small chunks of many lanes (64 rows at 4096) a
# barrier still comes every few hundred symbols; ~37 KB a block, as B4
CLOCK_SLOT_ROWS = 4096

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "clock_forward": [
        _P, _I, _I, _P, _I,  # y3, n, lanes, suffix, sfx
        _P, _P, _P, _P,  # omega, mu, last, resid
        _P, _I, _I, _I, _I,  # bank, chunk, n_chunks, k_max, chunks a slot
        _F, _F, _F, _F,  # omega_mid, omega_lim, gain_omega, gain_mu
        _P, _P, _P, _P, _P, _P,  # outs, counts, omega', mu', last', resid'
        _P,  # stream
    ],
    "clock_ragged_forward": [
        _P, _L, _I, _L, _L,  # y, len, lanes, row stride, lane stride
        _P, _P, _P, _P, _P,  # n_valid, ii0, omega, mu, last
        _P, _I, _I, _L, _L,  # bank, num_symbols, k_out, out k stride, out lane stride
        _I,  # slot rows
        _F, _F, _F, _F,  # omega_mid, omega_lim, gain_omega, gain_mu
        _P, _P, _P, _P, _P, _P,  # outs, counts, omega', mu', last', ii'
        _P,  # stream
    ],
}
_banks: dict[torch.device, torch.Tensor] = {}


def default_bank(device) -> torch.Tensor:
    """The (129, 8) MMSE interpolator bank on ``device``, made once."""
    device = torch.device(device)
    if device not in _banks:
        _banks[device] = torch.from_numpy(taps_mod.mmse_interp_taps().copy()).to(device)
    return _banks[device]


def _step_consts(device, *, omega_mid, omega_lim, gain_omega, gain_mu):
    """The step's constants, made once a walk: the signs as tensors on
    ``device`` and the loop's float32 constants."""
    one = torch.ones((), dtype=torch.float32, device=device)
    return dict(one=one, neg=-one, omega_mid=omega_mid, omega_lim=omega_lim,
                gain_omega=gain_omega, gain_mu=gain_mu)


def _mm_step_plain(window, bank, omega, mu, last, valid, consts):
    """One M&M step for every lane: window (8, C) of samples at each lane's
    read position, ``valid`` (C,) the lanes that step.  Returns (out, stride
    int64, omega', mu', last'), a frozen lane's out and stride 0 and its
    state kept; on a NaN window the lane emits 0, strides floor(omega) and
    keeps its state."""
    k = consts
    imu = torch.round(mu * float(NSTEPS)).to(torch.int64).clamp_(0, NSTEPS)
    prod = (window * bank[imu].T).unbind(0)
    y = prod[0]
    for j in range(1, NTAPS):
        y = y + prod[j]
    is_nan = torch.isnan(y)
    out = y.masked_fill(is_nan, 0.0)
    mm = torch.where(last < 0, k["neg"], k["one"]) * out - torch.where(out < 0, k["neg"], k["one"]) * last
    omega_n = omega + k["gain_omega"] * mm
    d = omega_n - k["omega_mid"]
    omega_n = k["omega_mid"] + 0.5 * ((d + k["omega_lim"]).abs() - (d - k["omega_lim"]).abs())
    mu_n = mu + omega_n + k["gain_mu"] * mm
    stride_n = torch.floor(mu_n)
    mu_n = mu_n - stride_n
    frozen = ~valid
    keep = is_nan | frozen
    stride = torch.where(is_nan, torch.floor(omega), stride_n).to(torch.int64).masked_fill_(frozen, 0)
    return (
        out.masked_fill(frozen, 0.0),
        stride,
        torch.where(keep, omega, omega_n),
        torch.where(keep, mu, mu_n),
        torch.where(keep, last, out),
    )


def _counts(valids, c, device):
    """Steps each lane took: the sum of the walk's ``valid`` masks."""
    if not valids:
        return torch.zeros(c, dtype=torch.int32, device=device)
    return torch.stack(valids).sum(0, dtype=torch.int32)


def clock_mm_chunked_plain(
    y3, suffix, omega, mu, last, resid, bank, *,
    chunk, num_symbols, omega_mid, omega_lim, gain_omega, gain_mu,
):
    """Plain PyTorch M&M over one block, vectorised over lanes, chunk by
    chunk, each chunk in the coordinates of its work buffer."""
    n, c = y3.shape
    sfx = suffix.shape[0]
    n_chunks = max(1, -(-n // chunk))
    dev = y3.device
    taps_idx = torch.arange(NTAPS, device=dev)[:, None]
    consts = _step_consts(dev, omega_mid=omega_mid, omega_lim=omega_lim, gain_omega=gain_omega,
                          gain_mu=gain_mu)
    suf = suffix
    ii = sfx - resid.to(torch.int64)
    outs, counts = [], []
    for t in range(n_chunks):
        work = torch.cat([suf, y3[t * chunk : min((t + 1) * chunk, n)]], dim=0)
        w = work.shape[0]
        rows, valids = [], []
        for _ in range(num_symbols):
            valid = ii <= w - NTAPS
            window = work.gather(0, ii.clamp(0, w - NTAPS) + taps_idx)  # (8, C)
            out, stride, omega, mu, last = _mm_step_plain(window, bank, omega, mu, last, valid, consts)
            ii = ii + stride
            rows.append(out)
            valids.append(valid)
        outs.append(torch.stack(rows))
        counts.append(_counts(valids, c, dev))
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
            bank.data_ptr(), chunk, n_chunks, num_symbols, max(1, CLOCK_SLOT_ROWS // chunk),
            omega_mid, omega_lim, gain_omega, gain_mu,
            outs.data_ptr(), counts.data_ptr(),
            fin[0].data_ptr(), fin[1].data_ptr(), fin[2].data_ptr(), resid_out.data_ptr(),
            stream,
        )
    _build.check(lib, rc, "clock_forward")
    launches += 1
    return outs, counts, (fin[0], fin[1], fin[2], resid_out)


# ---- B4: the ragged walk


def omega_limit(omega_mid: float, omega_relative_limit: float) -> float:
    """The omega clip, float32(omega_mid) * float32(relative limit)."""
    return float(np.float32(np.float32(omega_mid) * np.float32(omega_relative_limit)))


def k_slots(num_symbols: int) -> int:
    """Symbol slots of ``clock_mm_tpu``: num_symbols rounded up to a
    multiple of 8, as the JAX kernel's ``_groups_for`` rounds it."""
    return -(-int(num_symbols) // 8) * 8


def mm_walk_plain(
    work, n_valid, ii0, omega, mu, last, bank, *,
    num_symbols, omega_mid, omega_lim, gain_omega, gain_mu,
):
    """The ragged M&M walk in plain PyTorch, every lane at once: work (C, L)
    float32, per-lane n_valid, ii0 (int), omega, mu, last (C,).  At most
    ``num_symbols`` masked steps (the JAX scan's), a lane frozen once
    ii > n_valid - 8; rows past L read as 0.  Returns (outs (C, steps) f32
    with steps <= num_symbols, the rest 0, counts (C,) i32, (omega, mu,
    last, ii int64))."""
    c, length = work.shape
    dev = work.device
    work = torch.cat([work, work.new_zeros((c, NTAPS))], dim=1).T  # (L + 8, C)
    taps_idx = torch.arange(NTAPS, device=dev)[:, None]
    consts = _step_consts(dev, omega_mid=omega_mid, omega_lim=omega_lim, gain_omega=gain_omega,
                          gain_mu=gain_mu)
    ii = ii0.to(torch.int64)
    last_row = n_valid.to(torch.int64) - NTAPS
    rows, valids = [], []
    for k in range(int(num_symbols)):
        valid = ii <= last_row
        # frozen lanes stay frozen: stop once every lane is (checked every 16
        # steps, to keep the host's syncs few on the card)
        if k % 16 == 0 and not bool(valid.any()):
            break
        window = work.gather(0, ii.clamp(0, length) + taps_idx)  # (8, C)
        out, stride, omega, mu, last = _mm_step_plain(window, bank, omega, mu, last, valid, consts)
        ii = ii + stride
        rows.append(out)
        valids.append(valid)
    outs = torch.stack(rows, dim=1) if rows else work.new_zeros((c, 0))
    return outs, _counts(valids, c, dev), (omega, mu, last, ii)


def _ragged_args(y, ii0, time_major, bank):
    """ii0 (zeros by default) and the bank (the table by default)."""
    c = y.shape[1] if time_major else y.shape[0]
    if ii0 is None:
        ii0 = torch.zeros(c, dtype=torch.int32, device=y.device)
    return ii0, default_bank(y.device) if bank is None else bank


def _finals(omega, mu, last, ii, c, device):
    return dict(
        omega=omega, mu=mu, last=last, ii=ii.to(torch.int32),
        overflow=torch.zeros(c, dtype=torch.float32, device=device),
    )


def clock_mm_tpu_plain(
    y, n_valid, omega, mu, last, ii0=None, *,
    omega_mid, omega_relative_limit, gain_omega, gain_mu, num_symbols,
    time_major=False, bank=None,
):
    """Plain version of ``clock_mm_tpu``, arguments and results as it."""
    ii0, bank = _ragged_args(y, ii0, time_major, bank)
    work = y.T if time_major else y
    c = work.shape[0]
    outs, counts, (om, m, la, ii) = mm_walk_plain(
        work, n_valid, ii0, omega, mu, last, bank, num_symbols=num_symbols,
        omega_mid=float(np.float32(omega_mid)), omega_lim=omega_limit(omega_mid, omega_relative_limit),
        gain_omega=float(np.float32(gain_omega)), gain_mu=float(np.float32(gain_mu)),
    )
    k = k_slots(num_symbols)
    outs = torch.cat([outs, outs.new_zeros((c, k - outs.shape[1]))], dim=1)
    return outs, counts, _finals(om, m, la, ii, c, y.device)


def clock_mm_tpu(
    y, n_valid, omega, mu, last, ii0=None, *,
    omega_mid, omega_relative_limit, gain_omega, gain_mu, num_symbols,
    time_major=False, bank=None,
):
    """The ragged M&M walk over y (C, L), or (L, C) with ``time_major``,
    float32: n_valid and ii0 int32 (C,) (ii0 defaults to 0), omega, mu and
    last float32 (C,), ``bank`` the (129, 8) MMSE bank (default: the
    table).  The CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor.  Returns (outs (C, K), counts (C,) i32, {omega, mu, last, ii,
    overflow}); K = ``k_slots(num_symbols)``.  The JAX kernel takes at most
    128 lanes (a vector register); this one takes any number."""
    global ragged_launches
    kw = dict(
        omega_mid=omega_mid, omega_relative_limit=omega_relative_limit, gain_omega=gain_omega,
        gain_mu=gain_mu, num_symbols=num_symbols, time_major=time_major, bank=bank,
    )
    if _build.device_kind(y, "clock_mm_tpu") == "cpu":
        return clock_mm_tpu_plain(y, n_valid, omega, mu, last, ii0, **kw)
    ii0, bank = _ragged_args(y, ii0, time_major, bank)
    dev = y.device
    f32, i32 = torch.float32, torch.int32
    if y.dim() != 2:
        raise ValueError(f"clock_mm_tpu: y must be 2-D, got {tuple(y.shape)}")
    length, c = y.shape if time_major else (y.shape[1], y.shape[0])
    _check("y", y, tuple(y.shape), f32, dev)
    for name, t in (("n_valid", n_valid), ("ii0", ii0)):
        _check(name, t, (c,), i32, dev)
    for name, t in (("omega", omega), ("mu", mu), ("last", last)):
        _check(name, t, (c,), f32, dev)
    _check("bank", bank, (NSTEPS + 1, NTAPS), f32, dev)
    k = k_slots(num_symbols)
    if time_major:  # neighbouring lanes on neighbouring words, in and out
        outs = torch.empty((k, c), dtype=f32, device=dev)
        strides = (c, 1, c, 1)  # y row, y lane, outs k, outs lane
    else:
        outs = torch.empty((c, k), dtype=f32, device=dev)
        strides = (1, length, 1, k)
    counts = torch.empty(c, dtype=i32, device=dev)
    fin = [torch.empty(c, dtype=f32, device=dev) for _ in range(3)]
    ii = torch.empty(c, dtype=i32, device=dev)
    lib = _build.load("clock", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.clock_ragged_forward(
            y.data_ptr(), length, c, strides[0], strides[1],
            n_valid.data_ptr(), ii0.data_ptr(), omega.data_ptr(), mu.data_ptr(), last.data_ptr(),
            bank.data_ptr(), int(num_symbols), k, strides[2], strides[3], RAGGED_SLOT_ROWS,
            float(np.float32(omega_mid)), omega_limit(omega_mid, omega_relative_limit),
            float(np.float32(gain_omega)), float(np.float32(gain_mu)),
            outs.data_ptr(), counts.data_ptr(),
            fin[0].data_ptr(), fin[1].data_ptr(), fin[2].data_ptr(), ii.data_ptr(),
            stream,
        )
    _build.check(lib, rc, "clock_ragged_forward")
    ragged_launches += 1
    return (outs.T if time_major else outs), counts, _finals(*fin, ii, c, dev)
