"""The fused front+clock step (B7): the CUDA kernel's wrapper and its plain version.

Counterpart of ``sdrmodem_tpu/ops/pallas_step.py:fused_step_call``: one
full block through the front end (``ops/front.py``) and the M&M clock
(``ops/clock.py``) in one launch, the clock walking the decimated stream
y3 in chunks of ``chunk`` rows as the front produces them, so y3 never
reaches device memory.

Time-major throughout: x is (B, 2C) with I in lanes [0, C) and Q in
[C, 2C), B a whole number of tiles of ``d * chunk`` rows.  Returns the
JAX contract: symbols (n_chunks, K, C) float32 with K =
``k_slots(num_symbols)``, counts (n_chunks, C) int32, overflow (n_chunks,
C) float32 (always 0: the port reads every window directly and has no
window ladder to overflow), the front's four histories, and the clock
state {omega, mu, last, resid, suffix} with the next block's suffix.

- ``fused_step`` launches ``csrc/step.cu`` for a CUDA tensor and runs
  ``fused_step_plain`` for a CPU tensor;
- ``fused_step_plain`` is ``fused_front_plain`` followed by
  ``clock_mm_chunked_plain`` in chunks of ``chunk``;
- ``step_plan`` is the kernel's shared memory a block, from the shapes
  alone, and ``step_available`` whether the kernel takes a block: the
  pipeline's ``front="step"`` asks it when the step is built and takes
  the fused front and B2 where it is False, as the JAX package does.

The kernel gives the bits of the fused front (B1) followed by the chunked
clock (B2) at the same ``chunk``: the same device functions in the same
order, each clock chunk walked by B2's own chunk walk
(``csrc/mm_chunk.cuh``).  Another partition moves symbols between output
rows without changing them, unless a stride runs back past a chunk's first
row (each chunk reads only its own work buffer) or a chunk's K slots fill.
No environment variable is read: ``chunk`` is an argument.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sdrmodem_tpu_torch.ops import _build
from sdrmodem_tpu_torch.ops.clock import (
    NSTEPS,
    NTAPS,
    clock_mm_chunked_plain,
    k_slots,
    omega_limit,
)
from sdrmodem_tpu_torch.ops.front import FrontTaps, _dop_table, check_dop, check_lut, fused_front_plain

DEFAULT_CHUNK = 1024  # decimated rows a clock chunk (pallas_step.py:68)
MAX_SHARED_BYTES = 232448  # shared memory one block may have on an H100 (227 KB)
# csrc/step.cu's Layout: the clock's bank, the arctangent table, the pad
# rows past LPF1's tile and the lane's Doppler rows kept in shared memory
MM_BANK_FLOATS = (NSTEPS + 1) * NTAPS
ATAN_TABLE = 257
PAD_ROWS = 12
ROWS = 5  # LPF2 and DC outputs a thread
DOP_ROWS = 32

launches = 0  # kernels launched by fused_step; a run resets and reads it

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "step_forward": [
        _P, _I, _I, _P, _I,  # x, block, lanes, doppler table (5, S, C) or null, S
        _P, _P, _I,  # lpf1 hist, taps, t1
        _P, _F, _P,  # quad_prev, quad_gain, atan_table
        _P, _P, _I, _I,  # lpf2 hist, taps, t2, decim
        _P, _P, _I,  # dc hist, taps, t3 (0 = no DC stage)
        _P, _I, _P, _P, _P, _P,  # suffix, sfx, omega, mu, last, resid
        _P, _I, _I,  # bank, chunk, k_max
        _F, _F, _F, _F,  # omega_mid, omega_lim, gain_omega, gain_mu
        _P, _P,  # outs, counts
        _P, _P, _P, _P,  # lpf1', quad', lpf2', dc'
        _P, _P, _P, _P, _P,  # omega', mu', last', resid', suffix'
        _P,  # stream
    ],
    "step_shared_bytes": [_I, _I, _I, _I, _I, _I],
}


def check_step(chunk: int, sfx: int, block: int | None = None, d: int = 1) -> None:
    """Raise ``ValueError`` unless the chunk is one B2 takes (a multiple of
    8 that holds the carried suffix) and, given a block, the block is a
    whole number (>= 1) of tiles of d * chunk rows."""
    if chunk % 8 or chunk < sfx:
        raise ValueError(f"fused step: chunk {chunk} must be a multiple of 8 and >= {sfx}")
    if block is not None and (block < d * chunk or block % (d * chunk)):
        raise ValueError(
            f"fused step: block {block} must hold a whole number of chunks "
            f"(block % (d * chunk) == 0 with d {d}, chunk {chunk})"
        )


def step_plan(t1: int, t2: int, t3: int, d: int, chunk: int, sfx: int) -> int:
    """Bytes of shared memory one block of ``csrc/step.cu`` takes: its
    ``Layout``, every region rounded up to 4 floats.  t3 = 0 without a DC
    stage.  The lane's Doppler rows take a fixed region (at most
    ``DOP_ROWS`` of them; past that the kernel reads the table in device
    memory), so the table's size adds nothing."""
    r4 = lambda n: -(-n // 4) * 4  # noqa: E731
    r = d * chunk
    floats = MM_BANK_FLOATS + r4(ATAN_TABLE) + r4(t1) + r4(t2) + r4(t3)
    floats += r4(5 * DOP_ROWS + 1)  # the lane's Doppler rows that meet the block, and their count
    floats += 2 * r  # the staged tile
    floats += 2 * r4(4 + t1 - 1 + r + PAD_ROWS)  # [row before | LPF1 history | tile | pad], I and Q
    floats += r4(t2 - 1 + r + ROWS * d + 4)  # [LPF2 history | quad demod | pad]
    floats += r4(t3 - 1 + chunk + ROWS + 4) if t3 else 0  # [DC history | LPF2 | pad]
    floats += 4 + 2 * r4(sfx + chunk)  # the carried LPF1 row by parity; two y3 slots
    return 4 * floats


def step_available(block: int, t1: int, t2: int, t3: int, d: int, chunk: int, sfx: int) -> bool:
    """Whether the kernel takes this block, answered without raising: the
    conditions of ``check_step``, and a layout within one block's shared
    memory (``step_plan``)."""
    return (chunk % 8 == 0 and chunk >= sfx and block >= d * chunk and block % (d * chunk) == 0
            and step_plan(t1, t2, t3, d, chunk, sfx) <= MAX_SHARED_BYTES)


def _clock_consts(omega_mid, omega_relative_limit, gain_omega, gain_mu):
    """The clock step's float32 constants (as ``chunk_plan`` makes them)."""
    return dict(
        omega_mid=float(np.float32(omega_mid)),
        omega_lim=omega_limit(omega_mid, omega_relative_limit),
        gain_omega=float(np.float32(gain_omega)),
        gain_mu=float(np.float32(gain_mu)),
    )


def fused_step_plain(
    x, lpf1_hist, quad_prev, lpf2_hist, dc_hist, suffix, omega, mu, last, resid,
    taps: FrontTaps, bank, *, chunk=DEFAULT_CHUNK, num_symbols, omega_mid,
    omega_relative_limit, gain_omega, gain_mu, dop=None,
):
    """Plain PyTorch step: the plain front over the block, then the plain
    clock over its y3 in chunks of ``chunk``.  Arguments and results as
    ``fused_step``."""
    sfx = suffix.shape[0]
    check_step(chunk, sfx, x.shape[0], taps.d)
    y3, front = fused_front_plain(x, lpf1_hist, quad_prev, lpf2_hist, dc_hist, taps, dop)
    outs, counts, (om, m, la, rs) = clock_mm_chunked_plain(
        y3, suffix, omega, mu, last, resid, bank, chunk=chunk, num_symbols=k_slots(num_symbols),
        **_clock_consts(omega_mid, omega_relative_limit, gain_omega, gain_mu),
    )
    clock = dict(omega=om, mu=m, last=la, resid=rs, suffix=y3[y3.shape[0] - sfx :].clone())
    return outs, counts, torch.zeros(counts.shape, dtype=torch.float32, device=x.device), front, clock


def fused_step(
    x, lpf1_hist, quad_prev, lpf2_hist, dc_hist, suffix, omega, mu, last, resid,
    taps: FrontTaps, bank, *, chunk=DEFAULT_CHUNK, num_symbols, omega_mid,
    omega_relative_limit, gain_omega, gain_mu, dop=None,
):
    """One full block, front and clock fused: ``csrc/step.cu`` for a CUDA
    tensor, the plain version for a CPU tensor.

    x (B, 2C) float32; the histories and clock state as ``DemodStateFull``
    holds them (suffix (sfx, C), omega, mu, last (C,) float32, resid (C,)
    int32); ``taps`` the front's constants and ``bank`` the (129, 8) MMSE
    bank; ``num_symbols`` the symbols a chunk can emit
    (``max_symbols(chunk + sfx, ...)``); ``dop`` the Doppler tables of
    ``ops/front.py`` or None.  Returns (outs (n_chunks, K, C), counts
    (n_chunks, C) int32, overflow (n_chunks, C), (lpf1', quad', lpf2',
    dc'), {omega, mu, last, resid, suffix}).  The taps' arctangent is the
    table (``ops/front.py:check_lut``)."""
    check_lut(taps, "fused_step")
    kw = dict(chunk=chunk, num_symbols=num_symbols, omega_mid=omega_mid,
              omega_relative_limit=omega_relative_limit, gain_omega=gain_omega, gain_mu=gain_mu,
              dop=dop)
    args = (x, lpf1_hist, quad_prev, lpf2_hist, dc_hist, suffix, omega, mu, last, resid, taps, bank)
    if _build.device_kind(x, "fused_step") == "cpu":
        return fused_step_plain(*args, **kw)
    return _step_cuda(*args, **kw)


def _check(name, t, shape, device, dtype=torch.float32):
    _build.check_arg("step", name, t, shape, dtype, device)


def _step_cuda(
    x, lpf1_hist, quad_prev, lpf2_hist, dc_hist, suffix, omega, mu, last, resid,
    taps, bank, *, chunk, num_symbols, omega_mid, omega_relative_limit, gain_omega, gain_mu, dop,
):
    global launches
    b, c2 = x.shape
    c = c2 // 2
    d = taps.d
    dev = x.device
    sfx = suffix.shape[0]
    t1, t2 = taps.rev1.numel(), taps.rev2.numel()
    t3 = 0 if taps.rev_dc is None else taps.rev_dc.numel()
    if c2 % 2 or c < 1:
        raise ValueError(f"step kernel: x {tuple(x.shape)} needs 2C lanes, C >= 1")
    check_step(chunk, sfx, b, d)
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
    _check("suffix", suffix, (sfx, c), dev)
    for name, t in (("omega", omega), ("mu", mu), ("last", last)):
        _check(name, t, (c,), dev)
    _check("resid", resid, (c,), dev, torch.int32)
    _check("bank", bank, (NSTEPS + 1, NTAPS), dev)
    tab = None
    if dop is not None:
        check_dop(dop, b, c, dev)
        tab = _dop_table(dop)
    s_rows = tab.shape[1] if tab is not None else 0
    need = step_plan(t1, t2, t3, d, chunk, sfx)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"step kernel: {need} bytes of shared memory a lane at chunk {chunk} with these "
            f"taps, above the {MAX_SHARED_BYTES} a block can have; take a smaller chunk"
        )
    lib = _build.load("step", _SIGNATURES)
    k = k_slots(num_symbols)
    n_chunks = b // (d * chunk)
    f32, i32 = torch.float32, torch.int32
    outs = torch.empty((n_chunks, k, c), dtype=f32, device=dev)
    counts = torch.empty((n_chunks, c), dtype=i32, device=dev)
    hists = [torch.empty_like(lpf1_hist), torch.empty_like(quad_prev), torch.empty_like(lpf2_hist),
             torch.empty_like(dc_hist) if t3 else None]
    fin = [torch.empty(c, dtype=f32, device=dev) for _ in range(3)]
    resid_out = torch.empty(c, dtype=i32, device=dev)
    suffix_out = torch.empty_like(suffix)
    consts = _clock_consts(omega_mid, omega_relative_limit, gain_omega, gain_mu)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(dev):
        rc = lib.step_forward(
            x.data_ptr(), b, c, ptr(tab), s_rows,
            lpf1_hist.data_ptr(), taps.rev1.data_ptr(), t1,
            quad_prev.data_ptr(), taps.quad_gain, taps.atan_table.data_ptr(),
            lpf2_hist.data_ptr(), taps.rev2.data_ptr(), t2, d,
            ptr(dc_hist) if t3 else None, ptr(taps.rev_dc), t3,
            suffix.data_ptr(), sfx, omega.data_ptr(), mu.data_ptr(), last.data_ptr(),
            resid.data_ptr(), bank.data_ptr(), chunk, k,
            consts["omega_mid"], consts["omega_lim"], consts["gain_omega"], consts["gain_mu"],
            outs.data_ptr(), counts.data_ptr(), *(ptr(h) for h in hists),
            *(t.data_ptr() for t in fin), resid_out.data_ptr(), suffix_out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, rc, "step_forward")
    launches += 1
    front = (*hists[:3], hists[3] if t3 else dc_hist)
    clock = dict(omega=fin[0], mu=fin[1], last=fin[2], resid=resid_out, suffix=suffix_out)
    return outs, counts, torch.zeros((n_chunks, c), dtype=f32, device=dev), front, clock
