"""The demodulator front end: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``sdrmodem_tpu/ops/pallas_front.py:fused_front_call`` (B1)
and of the banded front it falls back to
(``sdrmodem_tpu/dsp/pipeline.py:_front_batched_full``, built on B3):
optional per-lane Doppler NCO mix -> LPF1 (complex, d=1) -> quadrature
demod (x * conj(x[-1]) -> LUT atan -> * gain) -> LPF2 (stride d) -> DC
blocker (one causal (4L-3)-tap FIR), carrying every tail between blocks.

Time-major throughout: x is (B, 2C) with I in lanes [0, C) and Q in
[C, 2C); y3 is (B/d, C).  ``dop`` is the (starts, ends, adjs, ph0s)
tuple of (S, C) float32 tables from ``Doppler.device_segments``; with it
LPF1 reads the mixed block, and lpf1_hist' is the mixed block's tail.

- ``fused_front`` launches ``csrc/front.cu``: one kernel runs the NCO,
  LPF1, the quad demod and LPF2 over tiles in shared memory, lane groups
  x time segments of the block (``front_plan``), and writes y2 and the
  tails; a second (``dc_fir``) runs the DC blocker's FIR over [dc_hist |
  y2];
- ``banded_front`` launches the NCO and quad-demod kernels one at a time
  (``nco_mix``, ``quad_demod``) and its FIRs through B3
  (``ops/fir.py:conv1d_banded_tm``) over [history | block].  It takes any
  taps; ``fused_front`` takes those whose histories and tile fit one
  block's shared memory (``front_tile``), and the pipeline's step takes the
  banded front for the others (``DemodPipeline.fused_front_available``).

Both sum every FIR output in tap order with one rounding a tap and take
the NCO and the quad demod with the same device code, so on the card they
give the same bits, as the JAX package's fused and banded fronts do.  For
a CPU tensor each wrapper runs its plain version.

The plain FIRs sum as the kernel does (``ops/fir.py``), so the CPU and the
card give the same y3.  The lucky7_nodc fixture has a stretch (symbols
~6300-6400) where the clock's lock turns on the last ulp of y3
(tests/test_torch_clock.py, ``test_nodc_clocks_agree_on_either_front``);
on the kernel's sums the port holds the reference's ±2 LSB there.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from sdrmodem_tpu_torch.dsp.elementwise import atan2_dispatch, nco_mix_pair_tm, nco_steps
from sdrmodem_tpu_torch.ops import _build
from sdrmodem_tpu_torch.ops.fir import conv1d_banded_tm, conv1d_banded_tm_plain

launches = 0  # kernels launched by this module's wrappers; a run resets and reads it
fused_launches = 0  # of those, B1's own (front_forward, dc_fir_forward): 0 on the banded route

# the NCO compares the row index in float32, exact below 2^24 (as the TPU
# kernel does, pallas_front.py:189-191)
MAX_DOPPLER_BLOCK = 1 << 24

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "front_forward": [
        _P, _I, _I, _P, _I,  # x, block, lanes, doppler table (5, S, C) or null, S
        _P, _P, _I,  # lpf1 hist, taps, t1
        _P, _F, _P,  # quad_prev, quad_gain, atan_table
        _P, _P, _I, _I,  # lpf2 hist, taps, t2, decim
        _I, _I, _I, _I,  # the plan: tile, warps, seg_rows, lead
        _P, _P, _P, _P, _P,  # y2 (y3 without DC), lpf1', quad', lpf2', stream
    ],
    "dc_fir_forward": [
        _P, _P, _I, _I,  # dc hist, y2, n2, lanes
        _P, _I, _I, _P, _P,  # taps, t3, seg_rows, y3, stream
    ],
    "front_shared_bytes": [_I, _I, _I],
    "quad_demod_forward": [
        _P, _P, _I, _I,  # y1, prev, rows, lanes
        _P, _I, _F, _P, _P,  # atan_table, atan_lut, quad_gain, yq, stream
    ],
    "nco_mix_forward": [
        _P, _I, _I,  # x, rows, lanes
        _P, _I, _P, _P,  # doppler table (5, S, C), S, y, stream
    ],
}


class FrontTaps(NamedTuple):
    """The front end's constants, as tensors on the device they run on."""

    rev1: torch.Tensor  # LPF1 taps, reversed
    rev2: torch.Tensor  # LPF2 taps, reversed
    rev_dc: torch.Tensor | None  # DC-blocker FIR taps, reversed (None = no DC)
    d: int  # LPF2 decimation
    quad_gain: float  # float32-exact
    atan_table: torch.Tensor  # (257,) reference arctangent table
    # the quad demod's arctangent: the table (True), or atan2 with the
    # table's (0, 0) -> 0 rule (False; the banded front only: B1 and B7
    # take the table)
    atan_lut: bool = True


# front.cu's launch geometry (csrc/front.cu: kGroupLanes, kRows1, kMaxWarps)
MAX_SHARED_BYTES = 232448  # shared memory one block may have on an H100 (227 KB)
H100_SMS = 132
GROUP_LANES = 32  # lanes a thread block
ROWS1 = 16  # LPF1 rows a thread
MAX_WARPS = 8
MAX_TILE = 128  # rows a tile, at most
SEG_DOPPLER_ROWS = 8  # Doppler rows a lane keeps for its segment (kSegRows)
DC_ROWS = 24  # DC FIR outputs a thread (fir.cuh: kBlockedRows)
DC_BLOCKS_PER_SM = 4


class FrontPlan(NamedTuple):
    """How ``front_forward`` cuts one block: segments of ``seg_rows`` input
    rows for every group of 32 lanes, each walked in tiles of ``tile`` rows
    by ``warps`` warps, a later segment starting ``lead`` rows early."""

    tile: int
    warps: int
    seg_rows: int
    lead: int
    segments: int
    shared_bytes: int

    def segment_rows(self, block: int):
        """(first row, end row, first row walked) of each segment."""
        out = []
        for k in range(self.segments):
            a = k * self.seg_rows
            out.append((a, min(block, a + self.seg_rows), max(0, a - self.lead)))
        return out


def lpf2_rows(d: int) -> int:
    """LPF2 outputs a thread: the register window slides at strides 1 and
    2; another stride takes one output a thread."""
    return {1: 16, 2: 8}.get(d, 1)


def front_shared_bytes(t1: int, t2: int, tile: int) -> int:
    """Bytes of shared memory of one block (``csrc/front.cu:Layout``)."""
    g, groups = GROUP_LANES, tile // ROWS1
    floats = (-(-257 // 4) + -(-t1 // 4) + -(-t2 // 4)) * 4
    floats += 2 * (t1 - 1 + tile) * g + (t2 - 1 + tile) * g + 4 * groups * g + 2 * g
    floats += 3 * SEG_DOPPLER_ROWS * g + g  # each lane's Doppler rows for its segment
    return 4 * floats


@functools.lru_cache(maxsize=64)
def front_tile(t1: int, t2: int, d: int) -> tuple[int, bool] | None:
    """The largest tile (at most MAX_TILE rows, a multiple of 16 and of
    LPF2's d * rows a thread) whose layout lets two blocks share an SM, else
    the largest that fits one, and whether two blocks share an SM; None
    where no tile fits (long filters: the banded front takes those)."""
    unit = math.lcm(ROWS1, d * lpf2_rows(d))
    tiles = [k * unit for k in range(max(1, MAX_TILE // unit), 0, -1)]
    # two blocks share an SM's 228 KB, each with 1 KB the runtime reserves
    two = [t for t in tiles if front_shared_bytes(t1, t2, t) <= MAX_SHARED_BYTES // 2 - 1024]
    one = [t for t in tiles if front_shared_bytes(t1, t2, t) <= MAX_SHARED_BYTES]
    if not one:
        return None
    return (two or one)[0], bool(two)


@functools.lru_cache(maxsize=64)
def front_plan(block: int, lanes: int, t1: int, t2: int, d: int, sms: int = H100_SMS) -> FrontPlan:
    """``front_tile``'s tile (ValueError where none fits); then enough
    segments that the lane groups fill ``sms`` SMs once.  A later segment
    recomputes t2 rows rounded up to d before its first (the mixed input's
    t1 - 1 rows of history before those are loaded, not computed)."""
    fit = front_tile(t1, t2, d)
    if fit is None:
        raise ValueError(f"front kernel: taps {t1} / {t2} at d = {d} do not fit shared memory")
    tile, two = fit
    groups = -(-lanes // GROUP_LANES)
    n_seg = max(1, sms * (2 if two else 1) // groups)
    seg_rows = -(-(-(-block // n_seg)) // tile) * tile
    return FrontPlan(tile=tile, warps=min(MAX_WARPS, tile // ROWS1), seg_rows=seg_rows,
                     lead=-(-t2 // d) * d, segments=-(-block // seg_rows),
                     shared_bytes=front_shared_bytes(t1, t2, tile))


def dc_seg_rows(n2: int, lanes: int, sms: int = H100_SMS) -> int:
    """DC FIR outputs a thread block: DC_BLOCKS_PER_SM blocks an SM over
    the lane groups, in whole groups of DC_ROWS."""
    n_seg = max(1, sms * DC_BLOCKS_PER_SM // -(-lanes // GROUP_LANES))
    return -(-(-(-n2 // n_seg)) // DC_ROWS) * DC_ROWS


def _tail(hist: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The last hist.shape[0] rows of [hist | x]: the FIR's next history."""
    h = hist.shape[0]
    if x.shape[0] >= h:
        return x[x.shape[0] - h :].clone()
    return torch.cat([hist, x], dim=0)[x.shape[0] :]


def check_dop(dop, block: int, channels: int, device) -> None:
    """Raise unless ``dop`` is four (S, C) float32 tables on ``device``
    with S >= 1, for a block short enough for the float32 row index."""
    if len(dop) != 4:
        raise ValueError(f"dop must be (starts, ends, adjs, ph0s), got {len(dop)} tables")
    s_rows = dop[0].shape[0] if dop[0].dim() == 2 else 0
    for name, t in zip(("starts", "ends", "adjs", "ph0s"), dop):
        if t.dim() != 2 or t.shape[0] != s_rows or s_rows < 1:
            raise ValueError(f"dop {name}: want (S >= 1, {channels}), got {tuple(t.shape)}")
        _build.check_arg("doppler", name, t, (s_rows, channels), torch.float32, device)
    if block >= MAX_DOPPLER_BLOCK:
        raise ValueError(f"doppler: block {block} must be < 2^24 (float32 row index)")


def _dop_table(dop) -> torch.Tensor:
    """(5, S, C) contiguous: starts, ends, adjs, ph0s and the coarse steps."""
    return torch.stack([*dop, nco_steps(dop[2])]).contiguous()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


# ---- the Doppler NCO stage alone (the banded front's stage 0)


def nco_mix_plain(x: torch.Tensor, dop) -> torch.Tensor:
    """``dsp/elementwise.py:nco_mix_pair_tm`` on checked tables."""
    check_dop(dop, x.shape[0], x.shape[1] // 2, x.device)
    return nco_mix_pair_tm(x, *dop)


def nco_mix(x: torch.Tensor, dop) -> torch.Tensor:
    """x (B, 2C) mixed by the Doppler tables: ``csrc/nco.cuh`` for a CUDA
    tensor, the plain version for a CPU tensor."""
    global launches
    if _build.device_kind(x, "nco_mix") == "cpu":
        return nco_mix_plain(x, dop)
    b, c2 = x.shape
    check_dop(dop, b, c2 // 2, x.device)
    _build.check_arg("nco", "x", x, (b, c2), torch.float32, x.device)
    tab = _dop_table(dop)
    y = torch.empty_like(x)
    lib = _build.load("front", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.nco_mix_forward(
            x.data_ptr(), b, c2 // 2, tab.data_ptr(), tab.shape[1], y.data_ptr(), _stream(x.device)
        )
    _build.check(lib, rc, "nco_mix_forward")
    launches += 1
    return y


# ---- the quadrature demod stage alone


def quad_demod_plain(y1, quad_prev, taps: FrontTaps):
    """yq (B, C) = gain * atan2 of y1 * conj(y1[-1]), y1[-1] = quad_prev,
    the arctangent ``taps.atan_lut`` names (``elementwise.atan2_dispatch``)."""
    c = y1.shape[1] // 2
    shifted = torch.cat([quad_prev, y1[:-1]], dim=0)
    i, q = y1[:, :c], y1[:, c:]
    si, sq = shifted[:, :c], shifted[:, c:]
    re = i * si + q * sq
    im = q * si - i * sq
    return taps.quad_gain * atan2_dispatch(im, re, taps.atan_lut, taps.atan_table)


def quad_demod(y1, quad_prev, taps: FrontTaps):
    """The quad-demod stage: front.cu's kernel for a CUDA tensor, the plain
    version for a CPU tensor.  The kernel takes the table or, where
    ``taps.atan_lut`` is False, ``atan2f`` with the same (0, 0) -> 0 rule."""
    global launches
    if _build.device_kind(y1, "quad_demod") == "cpu":
        return quad_demod_plain(y1, quad_prev, taps)
    b, c2 = y1.shape
    dev = y1.device
    _check("y1", y1, (b, c2), dev)
    _check("quad_prev", quad_prev, (1, c2), dev)
    _check("atan_table", taps.atan_table, (257,), dev)
    yq = torch.empty((b, c2 // 2), dtype=torch.float32, device=dev)
    lib = _build.load("front", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.quad_demod_forward(
            y1.data_ptr(), quad_prev.data_ptr(), b, c2 // 2, taps.atan_table.data_ptr(),
            int(taps.atan_lut), taps.quad_gain, yq.data_ptr(), _stream(dev),
        )
    _build.check(lib, rc, "quad_demod_forward")
    launches += 1
    return yq


# ---- the whole front


def _front_stages(x, lpf1_hist, quad_prev, lpf2_hist, dc_hist, taps, dop, *, mix, fir, quad):
    """The front end stage by stage, each stage one of the given functions."""
    b = x.shape[0]
    if dop is not None:
        x = mix(x, dop)
    y1 = fir(torch.cat([lpf1_hist, x]), taps.rev1, 1, b)
    yq = quad(y1, quad_prev, taps)
    n2 = b // taps.d
    y2 = fir(torch.cat([lpf2_hist, yq]), taps.rev2, taps.d, n2)
    if taps.rev_dc is None:
        y3, dc_new = y2, dc_hist
    else:
        y3 = fir(torch.cat([dc_hist, y2]), taps.rev_dc, 1, n2)
        dc_new = _tail(dc_hist, y2)
    return y3, (_tail(lpf1_hist, x), y1[b - 1 :].clone(), _tail(lpf2_hist, yq), dc_new)


def fused_front_plain(x, lpf1_hist, quad_prev, lpf2_hist, dc_hist, taps: FrontTaps, dop=None):
    """Plain PyTorch front end.  Returns (y3, (lpf1_hist', quad_prev',
    lpf2_hist', dc_hist')) like the JAX ``fused_front_call``."""
    return _front_stages(
        x, lpf1_hist, quad_prev, lpf2_hist, dc_hist, taps, dop,
        mix=nco_mix_plain, fir=conv1d_banded_tm_plain, quad=quad_demod_plain,
    )


def fused_front(x, lpf1_hist, quad_prev, lpf2_hist, dc_hist, taps: FrontTaps, dop=None):
    """The front end over one full block: the CUDA kernels for a CUDA tensor,
    the plain version for a CPU tensor.  Arguments as ``fused_front_plain``;
    the taps' arctangent is the table (``check_lut``)."""
    check_lut(taps, "fused_front")
    if _build.device_kind(x, "fused_front") == "cpu":
        return fused_front_plain(x, lpf1_hist, quad_prev, lpf2_hist, dc_hist, taps, dop)
    return _front_cuda(x, lpf1_hist, quad_prev, lpf2_hist, dc_hist, taps, dop)


def banded_front(x, lpf1_hist, quad_prev, lpf2_hist, dc_hist, taps: FrontTaps, dop=None):
    """The same front end stage by stage: the NCO and quad-demod kernels
    alone and B3 over each [history | block] (``pipeline.py:383-452``, with
    the NCO mix ahead of it as ``pipeline.py:657-662`` puts it).  Arguments
    and results as ``fused_front``; on a CPU tensor every stage runs its
    plain version, so it is ``fused_front_plain``."""
    return _front_stages(
        x, lpf1_hist, quad_prev, lpf2_hist, dc_hist, taps, dop,
        mix=nco_mix, fir=conv1d_banded_tm, quad=quad_demod,
    )


def check_lut(taps: FrontTaps, what: str) -> None:
    """Raise unless the taps name the table arctangent: B1 and B7 have no
    other (the pipeline routes the atan2 modes to ``banded_front``)."""
    if not taps.atan_lut:
        raise ValueError(f"{what}: the fused kernels take the LUT arctangent only; "
                         "the atan2 modes run on banded_front")


def _check(name, t, shape, device):
    _build.check_arg("front", name, t, shape, torch.float32, device)


def _front_cuda(x, lpf1_hist, quad_prev, lpf2_hist, dc_hist, taps, dop):
    global launches, fused_launches
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
    tab = None
    if dop is not None:
        check_dop(dop, b, c, dev)
        tab = _dop_table(dop)
    plan = front_plan(b, c, t1, t2, d, torch.cuda.get_device_properties(dev).multi_processor_count)
    y = torch.empty((b // d, c), dtype=torch.float32, device=dev)
    lpf1_out = torch.empty((t1 - 1, c2), dtype=torch.float32, device=dev)
    quad_out = torch.empty((1, c2), dtype=torch.float32, device=dev)
    lpf2_out = torch.empty((t2 - 1, c), dtype=torch.float32, device=dev)
    lib = _build.load("front", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.front_forward(
            x.data_ptr(), b, c,
            tab.data_ptr() if tab is not None else None, tab.shape[1] if tab is not None else 0,
            lpf1_hist.data_ptr(), taps.rev1.data_ptr(), t1,
            quad_prev.data_ptr(), taps.quad_gain, taps.atan_table.data_ptr(),
            lpf2_hist.data_ptr(), taps.rev2.data_ptr(), t2, d,
            plan.tile, plan.warps, plan.seg_rows, plan.lead,
            y.data_ptr(), lpf1_out.data_ptr(), quad_out.data_ptr(), lpf2_out.data_ptr(), _stream(dev),
        )
    _build.check(lib, rc, "front_forward")
    launches += 1
    fused_launches += 1
    if not t3:
        return y, (lpf1_out, quad_out, lpf2_out, dc_hist)
    return dc_fir(y, dc_hist, taps), (lpf1_out, quad_out, lpf2_out, _tail(dc_hist, y))


def dc_fir(y2, dc_hist, taps: FrontTaps):
    """The DC blocker's FIR, y3 (n2, C) over [dc_hist | y2]: the fused
    front's second launch (``csrc/front.cu:dc_fir_forward``) for a CUDA
    tensor, the plain FIR for a CPU tensor."""
    global launches, fused_launches
    n2, c = y2.shape
    t3 = taps.rev_dc.numel()
    if _build.device_kind(y2, "dc_fir") == "cpu":
        return conv1d_banded_tm_plain(torch.cat([dc_hist, y2]), taps.rev_dc, 1, n2)
    dev = y2.device
    _check("y2", y2, (n2, c), dev)
    _check("dc_hist", dc_hist, (t3 - 1, c), dev)
    _check("rev_dc", taps.rev_dc, (t3,), dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    y3 = torch.empty((n2, c), dtype=torch.float32, device=dev)
    lib = _build.load("front", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.dc_fir_forward(
            dc_hist.data_ptr(), y2.data_ptr(), n2, c, taps.rev_dc.data_ptr(), t3,
            dc_seg_rows(n2, c, sms), y3.data_ptr(), _stream(dev),
        )
    _build.check(lib, rc, "dc_fir_forward")
    launches += 1
    fused_launches += 1
    return y3
