"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and nvcc; without them they skip.  Run them
on a machine with the card: ``python -m pytest tests/test_torch_cuda.py``.
Small sizes; ``chip_smoke.py`` repeats the comparison at the main path's.

Tolerances: the front's y3 and FIR tails within 1e-4 (both sum each FIR
in tap order with one rounding a tap, the plain version through float64,
which can round a tie twice); lpf1_hist (a copy of the input) and
quad_prev (the last LPF1 row) exact.  With Doppler the mixed block's cos
and sin come from two libraries (the kernel's cosf/sinf, torch's on the
plain side), an ulp apart: the mixed tail within 2e-6 and quad_prev within
1e-6.  The FIR kernel alone (B3, B8) within 1e-5 of its plain version.
The clock, fed the same y3, is exact: both sum the interpolator in tap
order and neither contracts a multiply and an add, and both walk each chunk
in its own work buffer, at any number of B2's staged chunks a slot.  The fused and banded
fronts sum every FIR output in tap order with one fmaf a tap and share the
NCO's and the quad demod's device code: bit for bit, in y3 and the four
tails, at every tile and segment edge of the fused kernel.  The TX
kernels (B5, B6) within 1e-4 of their plain versions on I/Q and the phase
(both carry the phase prefix in float64, summed in another order, and
take cos/sin from two libraries), the exported history exact, and two
identical calls give the same bits.  The ragged
clock (B4) and the float64-accumulated FIR are exact: the same operations
in the same order, at any number of B4's staged rows a slot.  The exact streamer on the card gives the bytes it
gives on the CPU.  The fused step (B7) runs the front's and the clock's
device code in their order: bit for bit against its plain version without
Doppler, and against the fused front (B1) followed by B2 with and without
it (the same symbol stream, chunked otherwise, and the same state).  On
shards of the card (``parallel/``, the server's sharded group) every
sharded result equals the unsharded step's bit for bit: the same kernels on
the same rows, the histories handed between shards.  The quad-demod
kernel's atan2 form against its plain version (``torch.atan2`` on the card,
the same (0, 0) -> 0 rule): the same products, then two atan2f
implementations each within ATAN2F_ULP of the true angle, so within
``gain * 2 * ATAN2F_ULP`` ulps of pi plus one ulp of the scaled result;
the atan2 full-block step's three fronts the same bytes (all three run the
banded route).
"""

import pathlib

import numpy as np
import pytest
import torch

from sdrmodem_tpu_torch.dsp.clock_recovery import chunk_plan, clock_mm_batched_full, initial_full_state, mm_params
from sdrmodem_tpu_torch.dsp.doppler import Doppler
from sdrmodem_tpu_torch.dsp.gfsk_mod import GfskModConfig, GfskModulator
from sdrmodem_tpu_torch.dsp.streaming import StreamingGfskMod
from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig, float_to_int8
from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline, DemodStateFull
from sdrmodem_tpu_torch.ops import clock as clock_ops
from sdrmodem_tpu_torch.ops import fir as fir_ops
from sdrmodem_tpu_torch.ops import front as front_ops
from sdrmodem_tpu_torch.ops import step as step_ops
from sdrmodem_tpu_torch.ops import tx as tx_ops
from sdrmodem_tpu_torch.utils.convert import doppler_tables_from_numpy, segment_tables

TLE = [
    "LUCKY-7",
    "1 44406U 19038W   20069.88080907  .00000505  00000-0  32890-4 0  9992",
    "2 44406  97.5270  32.5584 0026284 107.4758 252.9348 15.12089395 37524",
]
DOPPLER = dict(latitude=53.72, longitude=47.57, altitude_km=0.0, sampling_freq=48000,
               center_freq=437525000, tle_lines=TLE, start_time_seconds=1583840449)
CONFIGS = {
    "lucky7": (48000, 4800, 5000, 2, 2000, True),
    "lucky7_nodc": (48000, 4800, 5000, 2, 2000, False),
    "nusat": (192000, 40000, 5000, 1, 2000, True),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
def test_kernels_match_plain(cuda, name):
    c, block = 5, 8192
    pipe = DemodPipeline(FskDemodConfig(*CONFIGS[name]), block, device=cuda)
    p = pipe.config.clock_params()
    st_k = st_p = pipe.init_full_state(c)
    rng = np.random.default_rng(0)
    for _ in range(3):
        x = torch.from_numpy(rng.standard_normal((block, 2 * c)).astype(np.float32)).to(cuda)
        args = lambda s: (x, s.lpf1_hist, s.quad_prev, s.lpf2_hist, s.dc_hist, pipe.front_taps)
        n0 = front_ops.launches
        y3_k, f_k = front_ops.fused_front(*args(st_k))
        # one kernel for the NCO, LPF1, the quad demod and LPF2, one for the DC FIR
        assert front_ops.launches == n0 + (2 if CONFIGS[name][5] else 1)
        y3_p, f_p = front_ops.fused_front_plain(*args(st_p))
        torch.cuda.synchronize()
        torch.testing.assert_close(y3_k, y3_p, rtol=0, atol=1e-4)
        assert torch.equal(f_k[0], f_p[0])
        assert torch.equal(f_k[1], f_p[1])
        torch.testing.assert_close(f_k[2], f_p[2], rtol=0, atol=1e-4)
        if f_p[3] is not None:
            torch.testing.assert_close(f_k[3], f_p[3], rtol=0, atol=1e-4)

        # both clocks on the kernel's y3 and the same state
        n0 = clock_ops.launches
        o_k, c_k, ck_k = clock_mm_batched_full(y3_k, st_k.clock, bank=pipe.bank, **p)
        assert clock_ops.launches == n0 + 1
        ck = st_k.clock
        plan = chunk_plan(*y3_k.shape, ck.suffix.shape[0], **p)
        o_p, c_p, fin_p = clock_ops.clock_mm_chunked_plain(
            y3_k, ck.suffix, ck.omega, ck.mu, ck.last_sample, ck.resid, pipe.bank, **plan
        )
        assert torch.equal(o_k, o_p.permute(2, 0, 1))
        assert torch.equal(c_k, c_p.T)
        for a, b in zip((ck_k.omega, ck_k.mu, ck_k.last_sample, ck_k.resid), fin_p):
            assert torch.equal(a, b)
        assert c_k.sum() > 0
        st_k = DemodStateFull(*f_k, ck_k)
        st_p = DemodStateFull(*f_p, ck_k)


def _dop_blocks(block, blocks, c, lanes_with_rows, device):
    """Per block, Doppler tables on ``device`` with rows on the given lanes."""
    dops = {k: Doppler(**DOPPLER, constant_offset=700 * k) for k in lanes_with_rows}
    s_rows = Doppler.max_rows(block, 48000)
    out = []
    for _ in range(blocks):
        rows = {k: d.device_segments(block, +1) for k, d in dops.items()}
        out.append(doppler_tables_from_numpy(segment_tables(rows, s_rows, c), c, device=device))
    return out


@pytest.mark.cuda
def test_doppler_front_matches_plain(cuda):
    c, block = 5, 8192
    pipe = DemodPipeline(FskDemodConfig(*CONFIGS["lucky7"]), block, device=cuda)
    st_k = st_p = pipe.init_full_state(c)
    rng = np.random.default_rng(1)
    for dop in _dop_blocks(block, 3, c, [0, 1, 2], cuda):
        x = torch.from_numpy(rng.standard_normal((block, 2 * c)).astype(np.float32)).to(cuda)
        n0 = front_ops.launches
        y3_k, f_k = front_ops.fused_front(x, *st_k[:4], pipe.front_taps, dop)
        assert front_ops.launches == n0 + 2  # NCO to LPF2 in one, then the DC FIR
        y3_p, f_p = front_ops.fused_front_plain(x, *st_p[:4], pipe.front_taps, dop)
        torch.cuda.synchronize()
        torch.testing.assert_close(y3_k, y3_p, rtol=0, atol=1e-4)
        torch.testing.assert_close(f_k[0], f_p[0], rtol=0, atol=2e-6)
        torch.testing.assert_close(f_k[1], f_p[1], rtol=0, atol=1e-6)
        for a, b in zip(f_k[2:], f_p[2:]):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
        # lanes 3 and 4 have no rows: their tails are the raw input's
        tail = x[-f_k[0].shape[0] :]
        cols = [3, 4, c + 3, c + 4]
        assert torch.equal(f_k[0][:, cols], tail[:, cols])
        st_k = st_k._replace(lpf1_hist=f_k[0], quad_prev=f_k[1], lpf2_hist=f_k[2], dc_hist=f_k[3])
        st_p = st_p._replace(lpf1_hist=f_p[0], quad_prev=f_p[1], lpf2_hist=f_p[2], dc_hist=f_p[3])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lucky7", "lucky7_nodc"])
@pytest.mark.parametrize("with_dop", [False, True])
def test_fused_and_banded_fronts_bit_equal(cuda, name, with_dop):
    c, block = 6, 4096
    pipe = DemodPipeline(FskDemodConfig(*CONFIGS[name]), block, device=cuda)
    st_f = st_b = pipe.init_full_state(c)
    rng = np.random.default_rng(2)
    dops = _dop_blocks(block, 2, c, [0, 2, 5], cuda) if with_dop else [None, None]
    for dop in dops:
        x = torch.from_numpy(rng.standard_normal((block, 2 * c)).astype(np.float32)).to(cuda)
        n0 = (front_ops.launches, fir_ops.launches)
        y3_f, f_f = front_ops.fused_front(x, *st_f[:4], pipe.front_taps, dop)
        y3_b, f_b = front_ops.banded_front(x, *st_b[:4], pipe.front_taps, dop)
        # the fused front is one kernel and the DC FIR; the banded front runs
        # its FIRs through B3 and the quad demod and the NCO alone
        n_fir = 3 if CONFIGS[name][5] else 2
        stages = 1 + (dop is not None)
        assert front_ops.launches == n0[0] + (n_fir - 1) + stages
        assert fir_ops.launches == n0[1] + n_fir
        assert torch.equal(y3_f, y3_b)
        for a, b in zip(f_f, f_b):
            assert (a is None and b is None) or torch.equal(a, b)
        st_f = st_f._replace(lpf1_hist=f_f[0], quad_prev=f_f[1], lpf2_hist=f_f[2], dc_hist=f_f[3])
        st_b = st_b._replace(lpf1_hist=f_b[0], quad_prev=f_b[1], lpf2_hist=f_b[2], dc_hist=f_b[3])


NAN_CONFIG = (240000, 9600, 5000, 1, 2000, True)  # tests/fixtures/inputnan.cf32's


def _same_bits(a, b):
    """Equal bit for bit, NaN equal to NaN wherever either has one."""
    if a is None or b is None:
        return a is None and b is None
    nan = torch.isnan(a)
    return (a.shape == b.shape and torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def _edge_tables(block, c, plan, rng, device):
    """(S, C) Doppler tables whose rows start and end on the plan's tile and
    segment edges and one row off them, on the even lanes; lane 3 has S
    rows of one sample each from row 0; the rest have no rows."""
    edges = {e + k for step in (plan.tile, plan.seg_rows) for e in range(step, block, step)
             for k in (-1, 0, 1)}
    cuts = sorted({0, *(e for e in edges if 0 < e < block), block})
    s_rows = min(len(cuts) - 1, 24)
    tables = [np.zeros((s_rows, c), np.float32) for _ in range(4)]
    for lane in range(0, c, 2):
        picks = np.sort(rng.choice(len(cuts) - 1, s_rows, replace=False))
        for s, k in enumerate(picks):  # disjoint rows in row order; gaps between some
            tables[0][s, lane] = cuts[k]
            tables[1][s, lane] = cuts[k + 1]
            tables[2][s, lane] = rng.uniform(-0.3, 0.3)
            tables[3][s, lane] = rng.uniform(-np.pi, np.pi)
    # lane 3: one-row rows from row 0, more than a tile's kept rows
    tables[0][:, 3] = np.arange(s_rows)
    tables[1][:, 3] = np.arange(1, s_rows + 1)
    tables[2][:, 3] = 0.1
    tables[3][:, 3] = 1.0
    return doppler_tables_from_numpy(tables, c, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lucky7", "lucky7_nodc", "nusat", "nan"])
@pytest.mark.parametrize("c", [5, 130, 300])
@pytest.mark.parametrize("block", [64, 1000, 65536])
def test_front_kernel_equals_banded(cuda, name, c, block):
    """The fused front (two launches) against the banded front, bit for bit
    in y3 and the four tails, three blocks with the state carried, without
    and with Doppler rows on the tile and segment edges; a NaN stretch
    across a segment edge in the second block."""
    cfg = NAN_CONFIG if name == "nan" else CONFIGS[name]
    pipe = DemodPipeline(FskDemodConfig(*cfg), block, device=cuda)
    taps = pipe.front_taps
    plan = front_ops.front_plan(block, c, taps.rev1.numel(), taps.rev2.numel(), taps.d,
                                torch.cuda.get_device_properties(cuda).multi_processor_count)
    rng = np.random.default_rng(block + c)
    for with_dop in (False, True):
        st_f = st_b = pipe.init_full_state(c)
        for blk in range(3):
            x = rng.standard_normal((block, 2 * c)).astype(np.float32)
            if blk == 1:
                edge = plan.seg_rows if plan.segments > 1 else block // 2
                x[max(0, edge - 5) : edge + 5, [1, c + 1]] = np.nan
            x = torch.from_numpy(x).to(cuda)
            dop = _edge_tables(block, c, plan, rng, cuda) if with_dop else None
            n0 = front_ops.launches
            y3_f, f_f = front_ops.fused_front(x, *st_f[:4], taps, dop)
            assert front_ops.launches == n0 + (2 if taps.rev_dc is not None else 1)
            y3_b, f_b = front_ops.banded_front(x, *st_b[:4], taps, dop)
            torch.cuda.synchronize()
            assert _same_bits(y3_f, y3_b), (with_dop, blk, "y3")
            for k, (a, b) in enumerate(zip(f_f, f_b)):
                assert _same_bits(a, b), (with_dop, blk, k)
            st_f = st_f._replace(lpf1_hist=f_f[0], quad_prev=f_f[1], lpf2_hist=f_f[2], dc_hist=f_f[3])
            st_b = st_b._replace(lpf1_hist=f_b[0], quad_prev=f_b[1], lpf2_hist=f_b[2], dc_hist=f_b[3])


@pytest.mark.cuda
def test_front_kernel_layout_matches_plan(cuda):
    """front_plan's shared-memory bytes are front.cu's Layout."""
    lib = front_ops._build.load("front", front_ops._SIGNATURES)
    for t1, t2 in ((157, 57), (185, 231), (589, 289)):
        for tile in (16, 48, 96, 128):
            assert lib.front_shared_bytes(t1, t2, tile) == front_ops.front_shared_bytes(t1, t2, tile)


@pytest.mark.cuda
@pytest.mark.parametrize("t,stride,col_offset", [(57, 2, 99), (157, 1, 0), (637, 1, 5), (637, 2, 0)])
def test_fir_kernel_matches_plain(cuda, t, stride, col_offset):
    rng = np.random.default_rng(t)
    rev = torch.from_numpy(rng.standard_normal(t).astype(np.float32) / t).to(cuda)
    n_out, lanes = 3000, 130
    rows = (n_out - 1) * stride + col_offset + t - 17  # the last windows run off the end
    x = torch.from_numpy(rng.standard_normal((rows, lanes)).astype(np.float32)).to(cuda)
    n0 = fir_ops.launches
    y = fir_ops.conv1d_banded_tm(x, rev, stride, n_out, col_offset=col_offset)
    assert fir_ops.launches == n0 + 1
    y_p = fir_ops.conv1d_banded_tm_plain(x, rev, stride, n_out, col_offset=col_offset)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_p, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("decim", [1, 2, 4])
def test_fir_tpu_kernel_matches_plain(cuda, decim):
    rng = np.random.default_rng(decim)
    taps = rng.standard_normal(101).astype(np.float32) / 101
    x = torch.from_numpy(rng.standard_normal((5001, 64)).astype(np.float32)).to(cuda)
    n0 = fir_ops.fir_tpu_launches
    y = fir_ops.fir_tpu(x, taps, decim)
    assert fir_ops.fir_tpu_launches == n0 + 1
    y_p = fir_ops.fir_tpu_plain(x, taps, decim)
    torch.cuda.synchronize()
    assert y.shape == (-(-5001 // decim), 64)
    torch.testing.assert_close(y, y_p, rtol=0, atol=1e-5)


FORM_LANES = [1, 2, 3, 31, 32, 33, 130]
FORM_TAPS = [1, 57, 157, 637, 12797]


@pytest.mark.cuda
@pytest.mark.parametrize("t", FORM_TAPS)
@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("lanes", FORM_LANES)
def test_fir_forms_match_plain(cuda, lanes, stride, t):
    """Both forms of the FIR kernel (narrow below 32 lanes, wide from 32)
    against the plain versions, through all three faces: B3 with a band
    offset and its last windows past the input's end, the float64 FIR and
    B8 (T - 1 leading zeros); 4001 outputs, no multiple of any form's
    outputs a thread.  637 taps take tap parts in the wide form, 12,797 in
    both.  float32 within 1e-5; the float64 FIR bit for bit."""
    rng = np.random.default_rng(lanes * 1000 + stride * 100 + t)
    rev = torch.from_numpy((rng.standard_normal(t) / np.sqrt(t)).astype(np.float32)).to(cuda)
    n_out, col_offset = 4001, 5
    rows = (n_out - 1) * stride + col_offset + t - 11
    x = torch.from_numpy(rng.standard_normal((rows, lanes)).astype(np.float32)).to(cuda)
    plan = fir_ops.fir_plan(n_out, lanes, t, stride)
    assert plan.wide == (lanes >= 32)
    if t == 12797 or (t == 637 and plan.wide and stride == 1):
        assert len(plan.parts) > 1
    n0 = (fir_ops.launches, fir_ops.exact_launches, fir_ops.fir_tpu_launches)
    y = fir_ops.conv1d_banded_tm(x, rev, stride, n_out, col_offset=col_offset)
    y64 = fir_ops.conv1d_exact_tm(x, rev, stride, n_out, col_offset=col_offset)
    taps = rev.flip(0)
    y8 = fir_ops.fir_tpu(x, taps, stride)
    assert (fir_ops.launches, fir_ops.exact_launches, fir_ops.fir_tpu_launches) == tuple(n + 1 for n in n0)
    y_p = fir_ops.conv1d_banded_tm_plain(x, rev, stride, n_out, col_offset=col_offset)
    y64_p = fir_ops.conv1d_exact_tm_plain(x, rev, stride, n_out, col_offset=col_offset)
    y8_p = fir_ops.fir_tpu_plain(x, taps, stride)
    torch.cuda.synchronize()
    assert y.shape == y64.shape == (n_out, lanes) and y8.shape == (-(-rows // stride), lanes)
    torch.testing.assert_close(y, y_p, rtol=0, atol=1e-5)
    assert torch.equal(y64, y64_p)
    torch.testing.assert_close(y8, y8_p, rtol=0, atol=1e-5)
    assert y[0].abs().max() > 0


@pytest.mark.cuda
def test_fir_shared_bytes_match_plan(cuda):
    """fir_plan's shared-memory bytes are fir.cu's fir_shared_bytes."""
    lib = fir_ops._build.load("fir", fir_ops._SIGNATURES)
    for wide in (False, True):
        for stride in (1, 2, 3, 7, 40):
            for part in (1, 5, 57, 313, 2000):
                assert lib.fir_shared_bytes(int(wide), stride, part) == fir_ops.fir_shared_bytes(wide, stride, part)
    for t in (157, 637, 12797, 65533):
        for lanes in (1, 2, 128):
            for stride in (1, 2, 3):
                plan = fir_ops.fir_plan(262144, lanes, t, stride)
                assert lib.fir_shared_bytes(int(plan.wide), stride, plan.part) == plan.shared_bytes


@pytest.mark.cuda
@pytest.mark.parametrize("t", [637, 12797, 61437])
def test_dc_fir_takes_any_tap_count(cuda, t):
    """B1's DC launch (fir_blocked_tm_kernel) past 48 KB of taps, and past
    one block's shared memory (61,437 taps: the DC FIR at 480 samples a
    symbol, taps read through L1), against B3's staged form on [dc_hist |
    y2] bit for bit (the same order) and the plain FIR within 1e-5."""
    rng = np.random.default_rng(t)
    c, n2 = 64, 3000
    taps = DemodPipeline(FskDemodConfig(*CONFIGS["lucky7"]), 4096, device=cuda).front_taps
    taps = taps._replace(rev_dc=torch.from_numpy((rng.standard_normal(t) / np.sqrt(t)).astype(np.float32)).to(cuda))
    y2 = torch.from_numpy(rng.standard_normal((n2, c)).astype(np.float32)).to(cuda)
    hist = torch.from_numpy(rng.standard_normal((t - 1, c)).astype(np.float32)).to(cuda)
    n0 = front_ops.launches
    y3 = front_ops.dc_fir(y2, hist, taps)
    assert front_ops.launches == n0 + 1
    work = torch.cat([hist, y2])
    staged = fir_ops.conv1d_banded_tm(work, taps.rev_dc, 1, n2)
    plain = fir_ops.conv1d_banded_tm_plain(work, taps.rev_dc, 1, n2)
    torch.cuda.synchronize()
    assert torch.equal(y3, staged)
    torch.testing.assert_close(y3, plain, rtol=0, atol=1e-5)


LONG_TAPS = (288000, 9600, 5000, 2, 2000, True)  # LPF1 707 taps, LPF2 347, DC 1917


def _gfsk_lanes(fs, baud, deviation, n, lanes, seed):
    """(lanes, 2, n) float32: a GFSK signal a lane with a little noise
    (tests/test_torch_front.py:gfsk_lanes; that module imports jax)."""
    rng = np.random.default_rng(seed)
    sps = fs // baud
    out = np.empty((lanes, 2, n), np.float32)
    for k in range(lanes):
        nrz = np.repeat(rng.integers(0, 2, n // sps + 1) * 2.0 - 1.0, sps)[:n]
        pulse = np.exp(-0.5 * (np.arange(-2 * sps, 2 * sps + 1) / (0.5 * sps)) ** 2)
        freq = np.convolve(nrz, pulse / pulse.sum(), mode="same")
        iq = np.exp(1j * np.cumsum(2 * np.pi * deviation / fs * freq))
        iq += 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        out[k, 0], out[k, 1] = iq.real, iq.imag
    return out


@pytest.mark.cuda
def test_long_tap_step_takes_banded_route(cuda):
    """288 kHz at 9600 Bd, where B1 has no layout: the server's call
    ``make_batched_step_full(doppler=True, layout="fanout")`` runs on the
    card through the banded front, B1 never launched, three FIR launches a
    step (LPF1 707 taps and the DC FIR 1917 in tap parts), the NCO and the
    quad demod kernels; against the same step on the CPU (the plain
    versions): counts equal, symbols within 1 LSB (the mixed block's cos and
    sin, and the quad demod's table arctangent, come from two
    implementations, an ulp apart)."""
    c, block = 4, 8192
    pipe = DemodPipeline(FskDemodConfig(*LONG_TAPS), block, device=cuda)
    host = DemodPipeline(FskDemodConfig(*LONG_TAPS), block, device="cpu")
    assert not pipe.fused_front_available()
    step = pipe.make_batched_step_full(doppler=True, layout="fanout")
    step_h = host.make_batched_step_full(doppler=True, layout="fanout")
    dop_args = {**DOPPLER, "sampling_freq": 288000}
    dops = {k: Doppler(**dop_args, constant_offset=700 * k) for k in (0, 2, 3)}
    s_rows = Doppler.max_rows(block, 288000)
    x_all = _gfsk_lanes(288000, 9600, 5000, 3 * block, 1, 5)[0]
    st, st_h = pipe.init_full_state(c), host.init_full_state(c)
    for k in range(3):
        x = torch.from_numpy(x_all[:, k * block : (k + 1) * block].copy())
        tables = segment_tables({lane: d.device_segments(block, +1) for lane, d in dops.items()}, s_rows, c)
        n0 = (front_ops.fused_launches, fir_ops.launches, front_ops.launches)
        st, sym, cnt = step(st, x.to(cuda), doppler_tables_from_numpy(tables, c, device=cuda))
        assert (front_ops.fused_launches, fir_ops.launches, front_ops.launches) == (n0[0], n0[1] + 3, n0[2] + 2)
        st_h, sym_h, cnt_h = step_h(st_h, x, doppler_tables_from_numpy(tables, c, device="cpu"))
        torch.cuda.synchronize()
        assert torch.equal(cnt.cpu(), cnt_h) and cnt.sum() > c * 0.9 * block / 2 / 15
        assert (sym.cpu().int() - sym_h.int()).abs().max() <= 1


TX_ATOL = 1e-4


def _phase_gap(a, b):
    """|a - b| on the circle: wrapped phases near 0 and 2 pi are close."""
    d = abs(float(a) - float(b)) % (2 * np.pi)
    return min(d, 2 * np.pi - d)


def _tx_case(fs, seed):
    mod = GfskModulator(GfskModConfig.from_radio(fs, 9600, 5000), device="cpu")
    return mod, np.random.default_rng(seed)


@pytest.mark.cuda
@pytest.mark.parametrize("fs,nbytes,packed", [(19200, 2048, True), (19200, 333, False),
                                              (576000, 700, True)])
def test_tx_folded_kernel_matches_plain(cuda, fs, nbytes, packed):
    mod, rng = _tx_case(fs, nbytes)
    data = torch.from_numpy(rng.integers(0, 256, nbytes).astype(np.uint8))
    nrz = data if packed else tx_ops.bytes_to_nrz(data)
    hist = torch.from_numpy(rng.choice([-1.0, 1.0], mod.k - 1).astype(np.float32))
    args = (mod.taps, mod.interpolation, mod.config.sensitivity, 4.5)
    n_valid = nbytes * 8 - 37  # a ragged tail adds no phase
    n0 = tx_ops.folded_launches
    if packed:
        iq, ph = tx_ops.gfsk_tx_folded_iq(nrz.to(cuda), *args, hist.to(cuda), n_valid=n_valid)
        iq_p, ph_p = tx_ops.gfsk_tx_folded_iq_plain(nrz, *args, hist, n_valid=n_valid)
    else:  # float NRZ through the JAX call's signature, (i, q, phase')
        i, q, ph = tx_ops.gfsk_tx_call_folded(nrz.to(cuda), *args, hist.to(cuda), n_valid=n_valid)
        i_p, q_p, ph_p = tx_ops.gfsk_tx_call_folded_plain(nrz, *args, hist, n_valid=n_valid)
        iq, iq_p = torch.complex(i, q), torch.complex(i_p, q_p)
    assert tx_ops.folded_launches == n0 + tx_ops.tx_plan(nbytes * 8, mod.interpolation, mod.k).launches
    torch.testing.assert_close(iq.cpu(), iq_p, rtol=0, atol=TX_ATOL)
    assert 0.0 <= ph.item() < 2 * np.pi
    assert _phase_gap(ph.item(), ph_p.item()) < TX_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("c,nbytes", [(5, 96), (128, 256), (33, 1000)])
def test_tx_batched_kernel_matches_plain(cuda, c, nbytes):
    mod, rng = _tx_case(48000, c)
    nrz_tm = torch.from_numpy(rng.choice([-1.0, 1.0], (nbytes * 8, c)).astype(np.float32))
    hist = torch.from_numpy(rng.choice([-1.0, 1.0], (mod.k - 1, c)).astype(np.float32))
    ph0 = torch.from_numpy(rng.uniform(0, 2 * np.pi, c))
    args = (mod.taps, mod.interpolation, mod.config.sensitivity)
    n_valid = nbytes * 8 - 11
    n0 = tx_ops.batched_launches
    out = tx_ops.gfsk_tx_call(nrz_tm.to(cuda), *args, ph0.to(cuda), hist.to(cuda), n_valid=n_valid)
    assert tx_ops.batched_launches == n0 + tx_ops.tx_plan(nbytes * 8, mod.interpolation, mod.k, c).launches
    ref = tx_ops.gfsk_tx_call_plain(nrz_tm, *args, ph0, hist, n_valid=n_valid)
    for got, want in zip(out[:2], ref[:2]):
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=TX_ATOL)
    assert max(_phase_gap(a, b) for a, b in zip(out[2].tolist(), ref[2].tolist())) < TX_ATOL
    assert torch.equal(out[3].cpu(), ref[3])


@pytest.mark.cuda
def test_streaming_mod_on_card_launches_b5(cuda):
    cfg = GfskModConfig.from_radio(19200, 9600, 5000)
    payload = np.random.default_rng(5).integers(0, 256, 40000).astype(np.uint8)
    card, host = StreamingGfskMod(cfg), StreamingGfskMod(cfg, device="cpu")
    assert card.device.type == "cuda"
    n0 = tx_ops.folded_launches
    got, want, i = [], [], 0
    for c in (100, 250, 35000, 4650):
        got.append(card.process(payload[i : i + c]))
        want.append(host.process(payload[i : i + c]))
        i += c
    # 35000 B is two dispatches, 32768 B and 2232 B
    launches = sum(tx_ops.tx_plan(8 * c, 2, card.k).launches for c in (100, 250, 32768, 2232, 4650))
    assert tx_ops.folded_launches == n0 + launches
    got, want = np.concatenate(got), np.concatenate(want)
    assert got.shape == want.shape == (40000 * 8 * 2,)
    assert np.abs(got - want).max() < TX_ATOL
    assert _phase_gap(card.phase, host.phase) < TX_ATOL and np.array_equal(card.hist, host.hist)


def _tx_hist(rng, kind, shape):
    """A carried history: +-1 (a stream under way), zeros (its first call)
    or other floats (any state ``load_state`` takes)."""
    if kind == "zero":
        return torch.zeros(shape, dtype=torch.float32)
    vals = rng.choice([-1.0, 1.0], shape) if kind == "pm1" else rng.uniform(-1.5, 1.5, shape)
    return torch.from_numpy(vals.astype(np.float32))


# (sampling rate, NRZ rows, n_valid, history): n_valid at 0, on a tile edge,
# on a run edge and past the payload; one tile of rows (one launch) and one
# either side, eight and nine tiles; a zero and a non-+-1 history; I = 60 at
# 32 KiB and on a tile edge there
_TILE = tx_ops.tx_plan(1, 2, 5).tile  # rows a B5 tile at I = 2
_FOLDED_EDGES = [
    (19200, 4096 * 8, 0, "pm1"),
    (19200, 4096 * 8, 3 * _TILE, "pm1"),
    (19200, 4096 * 8, 77 * tx_ops.tx_plan(1, 2, 5).run, "pm1"),
    (19200, 4096 * 8, 10**6, "pm1"),
    (19200, _TILE, None, "zero"),
    (19200, _TILE - 1, None, "other"),
    (19200, _TILE + 1, None, "pm1"),
    (19200, 8 * _TILE, 8 * _TILE - 3, "zero"),
    (19200, 9 * _TILE, None, "zero"),
    (19200, 9 * _TILE + 8, 9 * _TILE - 1, "other"),
    (576000, 32768 * 8, None, "zero"),
    (576000, 700 * 8, 3 * tx_ops.tx_plan(1, 60, 5).tile, "other"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("fs,rows,n_valid,hist_kind", _FOLDED_EDGES)
def test_tx_folded_kernel_edges(cuda, fs, rows, n_valid, hist_kind):
    mod, rng = _tx_case(fs, rows)
    data = torch.from_numpy(rng.integers(0, 256, -(-rows // 8)).astype(np.uint8))
    nrz = tx_ops.bytes_to_nrz(data)[:rows].contiguous() if rows % 8 else data
    hist = _tx_hist(rng, hist_kind, mod.k - 1)
    args = (mod.taps, mod.interpolation, mod.config.sensitivity, 6.0)
    plan = tx_ops.tx_plan(rows, mod.interpolation, mod.k)
    n0 = tx_ops.folded_launches
    iq, ph = tx_ops.gfsk_tx_folded_iq(nrz.to(cuda), *args, hist.to(cuda), n_valid=n_valid)
    assert tx_ops.folded_launches == n0 + plan.launches
    iq_p, ph_p = tx_ops.gfsk_tx_folded_iq_plain(nrz, *args, hist, n_valid=n_valid)
    assert iq.shape == (rows * mod.interpolation,)
    torch.testing.assert_close(iq.cpu(), iq_p, rtol=0, atol=TX_ATOL)
    assert 0.0 <= ph.item() < 2 * np.pi
    assert _phase_gap(ph.item(), ph_p.item()) < TX_ATOL


# (lanes, NRZ rows, n_valid, history): 1 and 33 lanes; one launch (one
# tile of 128 rows) and two; n_valid at 0 and on a tile edge
_BATCHED_EDGES = [
    (1, 4096, 4096 - 3, "pm1"),
    (33, 128, 0, "zero"),
    (33, 512, 0, "zero"),
    (33, 8000, 3 * 128, "other"),
    (5, 9 * 128 + 1, 9 * 128, "zero"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("c,rows,n_valid,hist_kind", _BATCHED_EDGES)
def test_tx_batched_kernel_edges(cuda, c, rows, n_valid, hist_kind):
    mod, rng = _tx_case(19200, c + rows)
    nrz_tm = torch.from_numpy(rng.choice([-1.0, 1.0], (rows, c)).astype(np.float32))
    hist = _tx_hist(rng, hist_kind, (mod.k - 1, c))
    ph0 = torch.from_numpy(rng.uniform(0, 2 * np.pi, c))
    args = (mod.taps, mod.interpolation, mod.config.sensitivity)
    n0 = tx_ops.batched_launches
    out = tx_ops.gfsk_tx_call(nrz_tm.to(cuda), *args, ph0.to(cuda), hist.to(cuda), n_valid=n_valid)
    assert tx_ops.batched_launches == n0 + tx_ops.tx_plan(rows, mod.interpolation, mod.k, c).launches
    ref = tx_ops.gfsk_tx_call_plain(nrz_tm, *args, ph0, hist, n_valid=n_valid)
    for got, want in zip(out[:2], ref[:2]):
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=TX_ATOL)
    assert max(_phase_gap(a, b) for a, b in zip(out[2].tolist(), ref[2].tolist())) < TX_ATOL
    assert torch.equal(out[3].cpu(), ref[3])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["tx_folded", "tx"])
def test_tx_same_bits_twice(cuda, kernel):
    """Two identical calls give the same bits: every float64 sum of the
    prefix is taken in a fixed order, whatever order the blocks run in."""
    mod, rng = _tx_case(576000 if kernel == "tx_folded" else 19200, 3)
    if kernel == "tx_folded":
        data = torch.from_numpy(rng.integers(0, 256, 32768).astype(np.uint8)).to(cuda)
        hist = _tx_hist(rng, "pm1", mod.k - 1).to(cuda)
        call = lambda: tx_ops.gfsk_tx_folded_iq(data, mod.taps, mod.interpolation,
                                                 mod.config.sensitivity, 2.0, hist)
    else:
        nrz_tm = torch.from_numpy(rng.choice([-1.0, 1.0], (2048 * 8, 128)).astype(np.float32)).to(cuda)
        hist = _tx_hist(rng, "pm1", (mod.k - 1, 128)).to(cuda)
        ph0 = torch.from_numpy(rng.uniform(0, 2 * np.pi, 128)).to(cuda)
        call = lambda: tx_ops.gfsk_tx_call(nrz_tm, mod.taps, mod.interpolation,
                                           mod.config.sensitivity, ph0, hist)
    first = [t.clone() for t in call()]
    second = call()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _b4_args(c, n, device, seed):
    """A noisy two-level signal at sps 4.8 with a NaN stretch on lane 1,
    ragged n_valid and read starts."""
    rng = np.random.default_rng(seed)
    bits = np.repeat(rng.choice([-1.0, 1.0], (c, n // 4 + 8)), 5, axis=1)[:, :n]
    y = (bits + 0.2 * rng.standard_normal((c, n))).astype(np.float32)
    y[1, 700:740] = np.nan
    n_valid = np.full(c, n, np.int32)
    n_valid[::3] = n - rng.integers(1, 900, len(n_valid[::3]))
    ii0 = rng.integers(0, 9, c).astype(np.int32)
    p = mm_params(4.8)
    st = [torch.full((c,), p["omega"]), torch.full((c,), p["mu"]), torch.zeros(c)]
    args = [torch.from_numpy(n_valid), *st, torch.from_numpy(ii0)]
    kw = dict(omega_mid=p["omega"], omega_relative_limit=p["omega_relative_limit"],
              gain_omega=p["gain_omega"], gain_mu=p["gain_mu"], num_symbols=n // 4 + 2)
    return y, [a.to(device) for a in args], kw


@pytest.mark.cuda
@pytest.mark.parametrize("time_major", [False, True])
def test_b4_kernel_matches_plain(cuda, time_major):
    c, n = 37, 6000
    y, args, kw = _b4_args(c, n, cuda, 3)
    yt = torch.from_numpy(y.T.copy() if time_major else y).to(cuda)
    n0 = clock_ops.ragged_launches
    outs, counts, fin = clock_ops.clock_mm_tpu(yt, *args, time_major=time_major, **kw)
    assert clock_ops.ragged_launches == n0 + 1
    p_outs, p_counts, p_fin = clock_ops.clock_mm_tpu_plain(yt, *args, time_major=time_major, **kw)
    torch.cuda.synchronize()
    assert torch.equal(outs, p_outs) and torch.equal(counts, p_counts)
    for key in ("omega", "mu", "last", "ii", "overflow"):
        assert torch.equal(fin[key], p_fin[key])
    assert counts.min() > 1000 and (outs[1, 140:160] == 0).any()


B4_SLOT_CASES = ["scaled", "late_start", "short", "inf_nan_edge", "few_symbols", "lanes300"]


def _b4_slot_case(case, device):
    """_b4_args's inputs, changed so that at 64 staged rows a slot the walk
    meets each edge of the staging: a lane scaled by 1e4 (gain_mu * mm in
    the thousands, so strides run backwards and jump many slots), read
    starts past the first slot, n_valid below 8 and 0, a NaN stretch and
    an inf across slot edges, fewer steps than the lanes could take, and
    more lanes than the card has SMs."""
    c, n = (300, 2000) if case == "lanes300" else (37, 6000)
    y, args, kw = _b4_args(c, n, device, 11)
    n_valid, ii0 = args[0], args[4]
    if case == "scaled":
        y[2] *= 1e4
    elif case == "late_start":
        ii0[::2] = torch.arange(0, c, 2, device=device, dtype=torch.int32) * 37 + 64
    elif case == "short":
        n_valid[:4] = torch.tensor([0, 3, 7, 8], dtype=torch.int32, device=device)
        ii0[:4] = 0
    elif case == "inf_nan_edge":
        y[1, 60:70] = np.nan
        y[4, 127] = np.inf
        y[5, 190:200] = -np.inf
    elif case == "few_symbols":
        kw["num_symbols"] = 50
    return y, args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("case", B4_SLOT_CASES)
def test_b4_small_slots_match_plain(cuda, monkeypatch, case, time_major):
    """B4 with 64 rows a slot, so slot edges fall every dozen symbols,
    against its plain version bit for bit: outs, counts and final state.
    A window with a single inf sample sends a lane's state to NaN (the
    algorithm's own rule, the same on both sides), so NaN equals NaN."""
    monkeypatch.setattr(clock_ops, "RAGGED_SLOT_ROWS", 64)
    y, args, kw = _b4_slot_case(case, cuda)
    yt = torch.from_numpy(y.T.copy() if time_major else y).to(cuda)
    outs, counts, fin = clock_ops.clock_mm_tpu(yt, *args, time_major=time_major, **kw)
    p_outs, p_counts, p_fin = clock_ops.clock_mm_tpu_plain(yt, *args, time_major=time_major, **kw)
    torch.cuda.synchronize()
    pairs = [(outs, p_outs), (counts, p_counts)]
    pairs += [(fin[k], p_fin[k]) for k in ("omega", "mu", "last", "ii")]
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    if case == "short":
        assert counts[:3].tolist() == [0, 0, 0] and counts[3].item() == 1
    elif case == "few_symbols":
        assert (counts == 50).all()


@pytest.mark.cuda
def test_full_scan_backend_on_card_equals_b2(cuda):
    """clock_mm_batched_full through B4 chunk by chunk equals B2, a lane
    scaled by 1e4 among them."""
    c, block = 5, 8192
    pipe = DemodPipeline(FskDemodConfig(*CONFIGS["lucky7"]), block, device=cuda)
    p = pipe.config.clock_params()
    rng = np.random.default_rng(4)
    st = {b: pipe.init_full_state(c).clock for b in ("pallas", "scan")}
    for _ in range(2):
        y3 = np.sign(rng.standard_normal((block // 2, c))).astype(np.float32)
        y3[:, 2] *= 1e4  # strides run back past a chunk's first row
        y3 = torch.from_numpy(y3).to(cuda)
        n0 = (clock_ops.launches, clock_ops.ragged_launches)
        res = {}
        for b in st:
            o, cnt, st[b] = clock_mm_batched_full(y3, st[b], bank=pipe.bank, backend=b, **p)
            res[b] = (o, cnt)
        assert (clock_ops.launches, clock_ops.ragged_launches) == (n0[0] + 1, n0[1] + 2)
        assert torch.equal(res["pallas"][0], res["scan"][0])
        assert torch.equal(res["pallas"][1], res["scan"][1])
        for a, b in zip(st["pallas"], st["scan"]):
            assert torch.equal(a, b)


B2_SLOT_CASES = ["scaled", "jump", "ragged_block", "short_block", "inf_nan_edge", "few_symbols",
                 "lanes300"]


def _b2_slot_case(case, device, monkeypatch):
    """A noisy two-level signal at sps 4.8 (time-major y3, a carried suffix,
    mu and resid), changed so that B2's walk meets each edge of its chunks
    and slots: a lane scaled by 1e4 (strides run back past a chunk's first
    row), lanes whose read position jumps past several chunks (a lane
    scaled by 1e5, a negative resid), a block that is not a multiple of
    the chunk and one shorter than a chunk, NaN and inf across chunk and
    slot edges, K small enough that the slots fill (the resid clip to
    sfx - 1), and 300 lanes (more than the SMs; the chunk halves to 680).
    Chunks of 256 rows but at 300 lanes.  Returns (y3, suffix, omega, mu,
    last, resid, bank) on ``device`` and the plan."""
    c, n = (300, 4096) if case == "lanes300" else (5, 4096)
    if case != "lanes300":
        monkeypatch.setenv("SDRM_CLOCK_CHUNK", "256")
    n = {"ragged_block": 5 * 256 + 100, "short_block": 100}.get(case, n)
    rng = np.random.default_rng(9)
    bits = np.repeat(rng.choice([-1.0, 1.0], (n // 5 + 8, c)), 5, axis=0)[:n]
    y3 = (bits + 0.2 * rng.standard_normal((n, c))).astype(np.float32)
    p = mm_params(4.8)
    sfx = initial_full_state(p["omega"], 1, device="cpu").suffix.shape[0]
    suffix = rng.standard_normal((sfx, c)).astype(np.float32)
    resid = rng.integers(0, sfx - 1, c).astype(np.int32)
    if case in ("scaled", "ragged_block", "short_block"):
        y3[:, 2] *= 1e4
    elif case == "jump":
        y3[:, 1] *= 1e5
        resid[3] = -1500  # starts 1500 rows past its first window
    elif case == "inf_nan_edge":  # chunk edges at 256 and 512 rows of y3, slots at 768 too
        y3[250:262, 1] = np.nan
        y3[511, 2] = np.inf
        y3[760:775, 3] = -np.inf
        y3[1020:1030, 4] = np.nan
    plan = chunk_plan(n, c, sfx, **{k: p[k] for k in ("omega", "gain_omega", "gain_mu",
                                                          "omega_relative_limit")},
                      num_symbols=20 if case == "few_symbols" else None)
    mu = rng.random(c).astype(np.float32)
    state = [suffix, np.full(c, p["omega"], np.float32), mu, y3[0].copy(), resid]
    args = [torch.from_numpy(a).to(device) for a in (y3, *state)]
    return [*args, clock_ops.default_bank(device)], plan


@pytest.mark.cuda
@pytest.mark.parametrize("slot", ["default", "one_chunk"])
@pytest.mark.parametrize("case", B2_SLOT_CASES)
def test_b2_slots_match_plain(cuda, monkeypatch, case, slot):
    """B2 against its plain version bit for bit, outs, counts and final
    state, at its own slot size and at one chunk a slot (a barrier every
    chunk).  A window with a single inf sample sends a lane's state to NaN
    (the algorithm's own rule, the same on both sides), so NaN equals NaN."""
    args, plan = _b2_slot_case(case, cuda, monkeypatch)
    if slot == "one_chunk":
        monkeypatch.setattr(clock_ops, "CLOCK_SLOT_ROWS", plan["chunk"])
    n0 = clock_ops.launches
    outs, counts, fin = clock_ops.clock_mm_chunked(*args, **plan)
    assert clock_ops.launches == n0 + 1
    p_outs, p_counts, p_fin = clock_ops.clock_mm_chunked_plain(*args, **plan)
    torch.cuda.synchronize()
    for got, want in [(outs, p_outs), (counts, p_counts), *zip(fin, p_fin)]:
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    n_chunks = -(-args[0].shape[0] // plan["chunk"])
    assert counts.shape == (n_chunks, args[0].shape[1]) and counts.sum() > 0
    if case == "few_symbols":
        assert (counts == plan["num_symbols"]).float().mean() > 0.5
    elif case == "jump":
        assert fin[3][1] < 0 or (counts[:, 1] == 0).any()
        assert (counts[:5, 3] == 0).all() and counts[5, 3] > 0
    elif case == "lanes300":
        assert plan["chunk"] == 680


@pytest.mark.cuda
@pytest.mark.parametrize("t,stride,lanes", [(157, 1, 2), (57, 2, 1), (637, 1, 1), (637, 2, 130)])
def test_exact_fir_kernel_matches_plain(cuda, t, stride, lanes):
    rng = np.random.default_rng(t + lanes)
    rev = torch.from_numpy(rng.standard_normal(t).astype(np.float32) / t).to(cuda)
    n_out = 3000
    rows = (n_out - 1) * stride + t - 9  # the last windows run off the end
    x = torch.from_numpy(rng.standard_normal((rows, lanes)).astype(np.float32)).to(cuda)
    n0 = fir_ops.exact_launches
    y = fir_ops.conv1d_exact_tm(x, rev, stride, n_out)
    assert fir_ops.exact_launches == n0 + 1
    y_p = fir_ops.conv1d_exact_tm_plain(x, rev, stride, n_out)
    torch.cuda.synchronize()
    assert torch.equal(y, y_p)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lucky7", "nan"])
def test_exact_streamer_card_equals_cpu(cuda, name):
    import pathlib

    from sdrmodem_tpu_torch.utils.parity import GOLDEN_CASES, golden_report

    _, cfg, fin, fexp, _ = next(c for c in GOLDEN_CASES if c[0] == name)
    fixtures = pathlib.Path(__file__).resolve().parent / "fixtures"
    iq = np.fromfile(fixtures / fin, np.complex64)
    n0 = (clock_ops.ragged_launches, fir_ops.exact_launches, front_ops.launches, clock_ops.launches)
    card = DemodPipeline(cfg, 8192, exact=True, device=cuda).streamer().process(iq)
    blocks = -(-len(iq) // 8192)
    n_fir = 3 if cfg.use_dc_block else 2
    assert clock_ops.ragged_launches == n0[0] + blocks
    assert fir_ops.exact_launches == n0[1] + blocks * n_fir  # LPF1 takes I and Q as two lanes
    assert (front_ops.launches, clock_ops.launches) == n0[2:]
    host = DemodPipeline(cfg, 8192, exact=True, device="cpu").streamer().process(iq)
    assert np.array_equal(card, host)
    assert golden_report(card, np.fromfile(fixtures / fexp, np.int8))["max_lsb"] <= 2


def _step_flat(sym, cnt):
    """Each lane's symbols, concatenated over the chunks."""
    return [torch.cat([sym[lane, k, :n] for k, n in enumerate(cnt[lane].tolist())])
            for lane in range(cnt.shape[0])]


def _nan_blocks(block, c, n, seed):
    """n blocks of noise, lane 1's first block with a NaN stretch (which
    the quad demod's arctangent turns into 0, as the reference's does) and
    one infinite I sample, whose inf - inf sums carry NaN into y3 and the
    clock's NaN branch."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((block, 2 * c)).astype(np.float32) for _ in range(n)]
    xs[0][1000:1040, [1, c + 1]] = np.nan
    xs[0][3000, 1] = np.inf
    return xs


@pytest.mark.cuda
@pytest.mark.parametrize("name,chunk", [("lucky7", 1024), ("lucky7_nodc", 1024), ("nusat", 256)])
def test_step_kernel_matches_plain(cuda, name, chunk):
    c, block = 5, 8192
    pipe = DemodPipeline(FskDemodConfig(*CONFIGS[name]), block, device=cuda)
    p = pipe.config.clock_params()
    state = pipe.init_full_state(c)
    ck = state.clock
    kw = dict(chunk=chunk, omega_mid=p["omega"], omega_relative_limit=p["omega_relative_limit"],
              gain_omega=p["gain_omega"], gain_mu=p["gain_mu"], num_symbols=300)
    for blk, x in enumerate(_nan_blocks(block, c, 2, 3)):
        x = torch.from_numpy(x).to(cuda)
        args = (x, *state[:4], ck.suffix, ck.omega, ck.mu, ck.last_sample, ck.resid,
                pipe.front_taps, pipe.bank)
        n0 = step_ops.launches
        outs, counts, ovf, front, fin = step_ops.fused_step(*args, **kw)
        assert step_ops.launches == n0 + 1
        outs_p, counts_p, _, front_p, fin_p = step_ops.fused_step_plain(*args, **kw)
        torch.cuda.synchronize()
        assert outs.shape == (block // (pipe.config.decimation * chunk), 304, c)
        assert torch.equal(outs, outs_p) and torch.equal(counts, counts_p) and not ovf.any()
        for a, b in zip(front, front_p):
            assert (a is None and b is None) or torch.equal(a.view(torch.int32), b.view(torch.int32))
        for key in ("omega", "mu", "last", "resid", "suffix"):
            assert torch.equal(fin[key], fin_p[key])
        if blk == 0:  # lane 1's NaN stretch: the NaN branch emits zeros
            assert (outs[:, :, 1] == 0).sum() > (outs[:, :, 0] == 0).sum() + 20
        state = DemodStateFull(*front, ck._replace(
            omega=fin["omega"], mu=fin["mu"], last_sample=fin["last"], resid=fin["resid"],
            suffix=fin["suffix"]))
        ck = state.clock


@pytest.mark.cuda
@pytest.mark.parametrize("name,with_dop", [("lucky7", False), ("lucky7", True), ("lucky7_nodc", True),
                                           ("nusat", False)])
def test_step_kernel_equals_front_and_clock(cuda, name, with_dop):
    """B7 against B1 followed by B2 through the pipeline, three blocks."""
    c, block = 6, 8192
    pipe = DemodPipeline(FskDemodConfig(*CONFIGS[name]), block, device=cuda)
    kw = dict(layout="tm", doppler=with_dop)
    step = pipe.make_batched_step_full("pallas", front="step", **kw)
    pair = pipe.make_batched_step_full("pallas", front="fused", **kw)
    st_s = st_p = pipe.init_full_state(c)
    dops = _dop_blocks(block, 3, c, [0, 2, 5], cuda) if with_dop else [None] * 3
    for x, dop in zip(_nan_blocks(block, c, 3, 4), dops):
        x = torch.from_numpy(x).to(cuda)
        args = (dop,) if with_dop else ()
        n0 = (step_ops.launches, front_ops.launches, clock_ops.launches)
        st_s, sym_s, cnt_s = step(st_s, x, *args)
        assert (step_ops.launches, front_ops.launches, clock_ops.launches) == (n0[0] + 1, *n0[1:])
        st_p, sym_p, cnt_p = pair(st_p, x, *args)
        assert all(torch.equal(a, b) for a, b in zip(_step_flat(sym_s, cnt_s), _step_flat(sym_p, cnt_p)))
        for a, b in zip((*st_s[:4], *st_s.clock), (*st_p[:4], *st_p.clock)):
            assert (a is None and b is None) or torch.equal(a.view(torch.int32), b.view(torch.int32))


# quad gain 3820 (deviation 2 Hz): y3 runs in the thousands, so the clock's
# strides run back past a chunk's first row
STEEP = (48000, 4800, 2, 2, 2000, True)


@pytest.mark.cuda
def test_step_kernel_backward_strides(cuda):
    """B7 where strides run back past a chunk's first row and chunks fill
    their K slots: against its plain version, and against B1 followed by
    B2 at B7's chunk and K, every side walking each chunk in its own work
    buffer, bit for bit, two blocks with the state carried."""
    c, block, chunk = 6, 8192, 256
    pipe = DemodPipeline(FskDemodConfig(*STEEP), block, device=cuda)
    p = pipe.config.clock_params()
    consts = dict(omega_mid=p["omega"], omega_relative_limit=p["omega_relative_limit"],
                  gain_omega=p["gain_omega"], gain_mu=p["gain_mu"])
    clock_kw = dict(chunk=chunk, num_symbols=120, omega_mid=p["omega"],
                    omega_lim=clock_ops.omega_limit(p["omega"], p["omega_relative_limit"]),
                    gain_omega=p["gain_omega"], gain_mu=p["gain_mu"])
    st = pipe.init_full_state(c)
    ck = st.clock
    rng = np.random.default_rng(3)
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal((block, 2 * c)).astype(np.float32)).to(cuda)
        clock_in = (ck.suffix, ck.omega, ck.mu, ck.last_sample, ck.resid)
        args = (x, *st[:4], *clock_in, pipe.front_taps, pipe.bank)
        n0 = step_ops.launches
        outs, counts, _, front, fin = step_ops.fused_step(*args, chunk=chunk, num_symbols=120, **consts)
        assert step_ops.launches == n0 + 1
        p_outs, p_counts, _, p_front, p_fin = step_ops.fused_step_plain(
            *args, chunk=chunk, num_symbols=120, **consts)
        y3, f_pair = front_ops.fused_front(x, *st[:4], pipe.front_taps)
        n0 = clock_ops.launches
        o2, c2, fin2 = clock_ops.clock_mm_chunked(y3, *clock_in, pipe.bank, **clock_kw)
        assert clock_ops.launches == n0 + 1
        torch.cuda.synchronize()
        for o, cnt in ((p_outs, p_counts), (o2, c2)):
            assert torch.equal(outs, o) and torch.equal(counts, cnt)
        for key, b in zip(("omega", "mu", "last", "resid"), fin2):
            assert torch.equal(fin[key], p_fin[key]) and torch.equal(fin[key], b)
        assert torch.equal(fin["suffix"], p_fin["suffix"])
        assert torch.equal(fin["suffix"], y3[y3.shape[0] - ck.suffix.shape[0]:])
        for a, b, b2 in zip(front, p_front, f_pair):
            assert (a is None and b is None) or (torch.equal(a, b) and torch.equal(a, b2))
        assert (counts == 120).any() and y3.abs().max() > 1000
        st = DemodStateFull(*front, ck._replace(
            omega=fin["omega"], mu=fin["mu"], last_sample=fin["last"], resid=fin["resid"],
            suffix=fin["suffix"]))
        ck = st.clock


def _many_rows_tables(block, c, device):
    """(40, C) Doppler tables: lane 0 has 40 one-sample rows from row 0,
    more than a thread keeps for a tile and more than the kernel keeps for
    the block (it reads the whole table); lane 1 eight rows covering the
    block edge to edge; lane 2 six one-sample rows in its second tile (kept
    for the block, more than kept for the tile); the rest none."""
    tables = [np.zeros((40, c), np.float32) for _ in range(4)]
    tables[0][:, 0] = np.arange(40)
    tables[1][:, 0] = np.arange(1, 41)
    tables[2][:, 0] = 0.2
    tables[3][:, 0] = np.linspace(-3, 3, 40)
    if c > 2:
        cuts = np.linspace(0, block, 9).astype(np.float32)
        tables[0][:8, 1], tables[1][:8, 1] = cuts[:-1], cuts[1:]
        tables[2][:8, 1] = np.linspace(-0.01, 0.01, 8)
        tables[3][:8, 1] = 0.5
        tables[0][:6, 2] = block // 4 + np.arange(6)
        tables[1][:6, 2] = block // 4 + np.arange(1, 7)
        tables[2][:6, 2] = 0.3
        tables[3][:6, 2] = 1.0
    return doppler_tables_from_numpy(tables, c, device=device)


def _b1_b2(pipe, x, st, dop, chunk, k):
    """B1 (the banded front where B1 has no layout) followed by B2 at B7's
    chunk and K slots: (outs, counts, front tails, (omega, mu, last,
    resid), y3)."""
    p = pipe.config.clock_params()
    front = front_ops.fused_front if pipe.fused_front_available() else front_ops.banded_front
    y3, tails = front(x, *st[:4], pipe.front_taps, dop)
    ck = st.clock
    outs, counts, fin = clock_ops.clock_mm_chunked(
        y3, ck.suffix, ck.omega, ck.mu, ck.last_sample, ck.resid, pipe.bank, chunk=chunk, num_symbols=k,
        omega_mid=p["omega"], omega_lim=clock_ops.omega_limit(p["omega"], p["omega_relative_limit"]),
        gain_omega=p["gain_omega"], gain_mu=p["gain_mu"])
    return outs, counts, tails, fin, y3


# B7's edges: (config, lanes, block, input ("noise", "nan": _nan_blocks), Doppler)
STEP_EDGE_CASES = {
    "lanes_1": (CONFIGS["lucky7"], 1, 8192, "noise", False),
    "lanes_33": (CONFIGS["lucky7"], 33, 8192, "noise", False),
    "lanes_130": (CONFIGS["nusat"], 130, 4096, "nan", False),
    "lanes_140": (CONFIGS["lucky7"], 140, 4096, "noise", False),  # past the SMs: two blocks an SM
    "one_tile": (CONFIGS["lucky7"], 4, 2048, "noise", False),
    "nan_taps": (NAN_CONFIG, 5, 8192, "nan", False),
    "long_taps": (LONG_TAPS, 5, 8192, "nan", False),
    "many_doppler_rows": (CONFIGS["lucky7"], 4, 8192, "noise", True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STEP_EDGE_CASES))
def test_step_kernel_edges(cuda, name):
    """B7 at chunk 1024 against B1 followed by B2 (the banded front where
    B1 has no layout), two blocks with the kernel's state carried: bit for
    bit (NaN where NaN), outputs, tails and clock state.  Against its plain
    version: outputs, counts and the clock state bit for bit, the tails
    within the module's bounds; with Doppler, whose plain cos and sin are
    another library's, the counts equal and the int8 symbols within 1 LSB."""
    cfg, c, block, kind, with_dop = STEP_EDGE_CASES[name]
    pipe = DemodPipeline(FskDemodConfig(*cfg), block, device=cuda)
    assert pipe.fused_step_available(c)
    p = pipe.config.clock_params()
    chunk, k = step_ops.DEFAULT_CHUNK, 304
    kw = dict(chunk=chunk, omega_mid=p["omega"], omega_relative_limit=p["omega_relative_limit"],
              gain_omega=p["gain_omega"], gain_mu=p["gain_mu"], num_symbols=k)
    rng = np.random.default_rng(11)
    xs = (_nan_blocks(block, c, 2, 5) if kind == "nan"
          else [rng.standard_normal((block, 2 * c)).astype(np.float32) for _ in range(2)])
    st = pipe.init_full_state(c)
    for x in xs:
        x = torch.from_numpy(x).to(cuda)
        dop = _many_rows_tables(block, c, cuda) if with_dop else None
        ck = st.clock
        args = (x, *st[:4], ck.suffix, ck.omega, ck.mu, ck.last_sample, ck.resid, pipe.front_taps, pipe.bank)
        n0 = step_ops.launches
        outs, counts, _, front, fin = step_ops.fused_step(*args, dop=dop, **kw)
        assert step_ops.launches == n0 + 1
        o_p, c_p, _, f_p, fin_p = step_ops.fused_step_plain(*args, dop=dop, **kw)
        o2, c2, f2, fin2, y3 = _b1_b2(pipe, x, st, dop, chunk, k)
        torch.cuda.synchronize()
        assert torch.equal(outs, o2) and torch.equal(counts, c2)
        assert all(_same_bits(a, b) for a, b in zip(front, f2))
        assert all(_same_bits(fin[key], b) for key, b in zip(("omega", "mu", "last"), fin2[:3]))
        assert torch.equal(fin["resid"], fin2[3])
        assert _same_bits(fin["suffix"], y3[y3.shape[0] - ck.suffix.shape[0]:])
        if with_dop:
            assert torch.equal(counts, c_p)
            lsb = (float_to_int8(outs).int() - float_to_int8(o_p).int()).abs().max()
            assert lsb <= 1
        else:
            assert torch.equal(outs, o_p) and torch.equal(counts, c_p)
            assert all(_same_bits(fin[key], fin_p[key]) for key in ("omega", "mu", "last"))
            assert torch.equal(fin["resid"], fin_p["resid"])
            # the plain FIRs round each tap's sum through float64 (a tie can
            # round twice): the tails within the module's bounds
            assert _same_bits(front[0], f_p[0])
            for key, a, b in (("quad_prev", front[1], f_p[1]), ("lpf2", front[2], f_p[2]),
                              ("dc", front[3], f_p[3]), ("suffix", fin["suffix"], fin_p["suffix"])):
                assert (a is None and b is None) or torch.allclose(a, b, rtol=0, atol=1e-4, equal_nan=True), key
        assert int(counts.sum()) > 0.5 * c * block * cfg[1] / cfg[0]
        st = DemodStateFull(*front, ck._replace(
            omega=fin["omega"], mu=fin["mu"], last_sample=fin["last"], resid=fin["resid"],
            suffix=fin["suffix"]))


@pytest.mark.cuda
def test_step_route_on_partial_chunks_launches_the_pair(cuda):
    """front="step" on a block that is not whole chunks (1536 rows at d =
    2) runs B1 and B2, never B7, and gives front="fused"'s bits."""
    c, block = 4, 1536
    pipe = DemodPipeline(FskDemodConfig(*CONFIGS["lucky7"]), block, device=cuda)
    assert not pipe.fused_step_available(c)
    step = pipe.make_batched_step_full("pallas", layout="tm", front="step")
    pair = pipe.make_batched_step_full("pallas", layout="tm", front="fused")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((block, 2 * c)).astype(np.float32)).to(cuda)
    n0 = (step_ops.launches, front_ops.fused_launches, clock_ops.launches)
    st_s, sym_s, cnt_s = step(pipe.init_full_state(c), x)
    n1 = (step_ops.launches, front_ops.fused_launches, clock_ops.launches)
    assert n1[0] == n0[0] and n1[1] == n0[1] + 2 and n1[2] == n0[2] + 1  # B1's two launches, B2's one
    st_p, sym_p, cnt_p = pair(pipe.init_full_state(c), x)
    assert torch.equal(sym_s, sym_p) and torch.equal(cnt_s, cnt_p)
    for a, b in zip((*st_s[:4], *st_s.clock), (*st_p[:4], *st_p.clock)):
        assert _same_bits(a, b)


@pytest.mark.cuda
def test_step_plan_matches_kernel_layout(cuda):
    """ops/step.py:step_plan against the kernel's own Layout sum."""
    from sdrmodem_tpu_torch.ops import _build

    lib = _build.load("step", step_ops._SIGNATURES)
    for t1, t2, t3, d, chunk, sfx in ((157, 57, 637, 2, 1024, 64), (185, 231, 613, 1, 1024, 64),
                                      (589, 289, 3197, 1, 1024, 64), (707, 347, 1917, 2, 1024, 64),
                                      (157, 57, 0, 2, 256, 64), (4819, 2891, 12797, 2, 1024, 112),
                                      (33, 9, 5, 3, 64, 40)):
        assert lib.step_shared_bytes(t1, t2, t3, d, chunk, sfx) == step_ops.step_plan(t1, t2, t3, d, chunk, sfx)


@pytest.mark.cuda
def test_server_exact_client_and_fast_group_equal_direct_calls(cuda, tmp_path):
    """The port's server on the card: one exact-mode client's bytes equal
    the exact streamer run directly; a 4-client fast group's lanes, each
    with its own Doppler pass, equal the group's step run directly over the
    same blocks and tables, bit for bit."""
    import pathlib

    from sdrmodem_tpu_torch.server import wire
    from sdrmodem_tpu_torch.server.session import BatchedRxGroup, doppler_from_settings
    from tests.torch_server_helpers import rx_request, serve_rx

    fixtures = pathlib.Path(__file__).resolve().parent / "fixtures"
    cfg = FskDemodConfig(*CONFIGS["lucky7"])
    block = 8192

    iq = np.fromfile(fixtures / "lucky7.expected.cf32", np.complex64)[: 4 * block]
    direct = DemodPipeline(cfg, block, exact=True, device=cuda).streamer().process(iq)
    n0 = (clock_ops.ragged_launches, fir_ops.exact_launches)
    config = dict(buffer_size=block, read_timeout_seconds=5)
    (got,), _, where = serve_rx(tmp_path, {**config, "demod_mode": "exact"}, [rx_request()], [iq],
                                [[len(direct)]], timeout=300)
    assert where == [(-1, "cuda")]
    assert clock_ops.ragged_launches > n0[0] and fir_ops.exact_launches > n0[1]
    np.testing.assert_array_equal(got, direct)

    raw = np.fromfile(fixtures / "lucky7.cf32", np.complex64)[: 4 * block]
    settings = wire.DopplerSettings(tle=DOPPLER["tle_lines"], latitude=537200000,
                                    longitude=475700000, altitude=0)
    starts = [DOPPLER["start_time_seconds"] + k for k in range(4)]
    pipe = DemodPipeline(cfg, block, device=cuda)
    step = pipe.make_batched_step_full("pallas", doppler=True, layout="fanout")
    c = BatchedRxGroup.LANES
    state = pipe.init_full_state(c)
    dops = [doppler_from_settings(settings, 48000, 437525000, 0, s) for s in starts]
    want = [[] for _ in dops]
    for t in range(4):
        blk = raw[t * block : (t + 1) * block]
        x = torch.from_numpy(np.stack([blk.real, blk.imag]).astype(np.float32)).to(cuda)
        rows = {k: d.device_segments(block, +1) for k, d in enumerate(dops)}
        tables = doppler_tables_from_numpy(
            segment_tables(rows, Doppler.max_rows(block, 48000), c), c, device=cuda)
        state, sym, cnt = step(state, x, tables)
        sym, cnt = sym.cpu().numpy(), cnt.cpu().numpy()
        for k in range(len(dops)):
            want[k] += [sym[k, j, : cnt[k, j]] for j in range(cnt.shape[1])]
    want = [np.concatenate(w) for w in want]
    n0 = (front_ops.fused_launches, clock_ops.launches, step_ops.launches)
    got, _, where = serve_rx(tmp_path, {**config, "demod_mode": "fast"},
                             [rx_request(settings, s) for s in starts], [raw],
                             [[len(w)] for w in want], timeout=300)
    assert front_ops.fused_launches > n0[0] and clock_ops.launches > n0[1]
    assert step_ops.launches == n0[2]
    assert where == [(k, "cuda") for k in range(4)]  # client k is lane k of the direct run
    for k, g in enumerate(got):
        np.testing.assert_array_equal(g, want[k], err_msg=f"client {k}")


def _lane_streams(sym, cnt):
    """Each lane's symbols of a (C, n_chunks, K) step, its chunks joined."""
    sym, cnt = np.asarray(sym), np.asarray(cnt)
    valid = np.arange(sym.shape[2])[None, None, :] < cnt[:, :, None]
    return [sym[k][valid[k]] for k in range(sym.shape[0])]


def _unsharded(dev, streams, block, dopplers=None):
    """Each stream as a lane of one batch through the full-block step at
    ``block``, Doppler rows every 2000 samples where a lane has them."""
    from sdrmodem_tpu_torch.parallel.time_shard import DOPPLER_CADENCE

    s, n = streams.shape
    pipe = DemodPipeline(FskDemodConfig(*CONFIGS["lucky7"]), block, device=dev)
    step = pipe.make_batched_step_full(doppler=True)
    state, out = pipe.init_full_state(s), [[] for _ in range(s)]
    dops = {k: d for k, d in enumerate(dopplers or []) if d is not None}
    for t in range(n // block):
        part = streams[:, t * block : (t + 1) * block]
        x = torch.from_numpy(np.stack([part.real, part.imag], axis=1).astype(np.float32)).to(dev)
        tables = None
        if dops:
            rows = {k: d.device_segments(block, +1, max_batch=DOPPLER_CADENCE) for k, d in dops.items()}
            tables = doppler_tables_from_numpy(
                segment_tables(rows, Doppler.max_rows(block, 48000, DOPPLER_CADENCE), s), s, device=dev)
        state, sym, cnt = step(state, x, tables)
        for k, lane in enumerate(_lane_streams(sym.cpu(), cnt.cpu())):
            out[k].append(lane)
    return state, [np.concatenate(o) for o in out]


@pytest.mark.cuda
def test_sharded_channel_classes_on_card(cuda):
    """ShardedChannelDemodFull over two shards of the card (B1 and B2 a
    shard) equals the unsharded step, symbols and state, bit for bit; the
    ragged class (B3 and B4 a shard) equals make_batched_step("pallas")."""
    import pathlib

    from sdrmodem_tpu_torch.parallel.channels import ShardedChannelDemod, ShardedChannelDemodFull
    from sdrmodem_tpu_torch.parallel.mesh import Mesh

    cfg, block, c = FskDemodConfig(*CONFIGS["lucky7"]), 8192, 8
    iq = np.fromfile(pathlib.Path(__file__).resolve().parent / "fixtures" / "lucky7.expected.cf32", np.complex64)
    streams = np.stack([iq[k * 1000 : k * 1000 + 2 * block] for k in range(c)])
    sharded = ShardedChannelDemodFull(cfg, block, c, Mesh([cuda] * 2, "channel"))
    n0 = (front_ops.fused_launches, clock_ops.launches)
    state, got = sharded.init_state(), [[] for _ in range(c)]
    for t in range(2):
        state, sym, cnt = sharded.step(state, sharded.place_input(streams[:, t * block : (t + 1) * block]))
        for k, lane in enumerate(_lane_streams(sym, cnt)):
            got[k].append(lane)
    assert front_ops.fused_launches >= n0[0] + 4 and clock_ops.launches == n0[1] + 4
    ref_state, want = _unsharded(cuda, streams, block)
    for k in range(c):
        np.testing.assert_array_equal(np.concatenate(got[k]), want[k], err_msg=f"lane {k}")
    for i, st in enumerate(state):
        lo, hi = 4 * i, 4 * i + 4
        assert torch.equal(st.lpf1_hist, torch.cat([ref_state.lpf1_hist[:, lo:hi], ref_state.lpf1_hist[:, c + lo : c + hi]], 1))
        assert torch.equal(st.dc_hist, ref_state.dc_hist[:, lo:hi])
        for a, b in zip(st.clock, ref_state.clock):
            assert torch.equal(a, b[..., lo:hi])

    rag = ShardedChannelDemod(cfg, block, 4, Mesh([cuda] * 2, "channel"))
    n_valid = np.array([block, block - 123, block, 77], np.int32)
    n0 = (fir_ops.launches, clock_ops.ragged_launches)
    _, sym, cnt = rag.step(rag.init_state(), rag.place_input(streams[:4, :block]), n_valid)
    assert fir_ops.launches > n0[0] and clock_ops.ragged_launches > n0[1]
    pipe = DemodPipeline(cfg, block, device=cuda)
    x = torch.from_numpy(np.stack([streams[:4, :block].real, streams[:4, :block].imag], axis=1)).to(cuda)
    _, wsym, wcnt = pipe.make_batched_step("pallas")(pipe.init_state(channels=4), x.float(),
                                                     torch.from_numpy(n_valid).to(cuda))
    assert torch.equal(cnt, wcnt.cpu()) and torch.equal(sym, wsym.cpu())


@pytest.mark.cuda
def test_time_sharded_on_card(cuda):
    """demod_pipelined over four shards of the card: every stream equals
    the unsharded step at block N / 4 bit for bit, with Doppler tables on
    the raw pass too; the 2 x 2 grid equals it as well.  B3 and B2 launch."""
    import pathlib

    from sdrmodem_tpu_torch.parallel.mesh import Mesh
    from sdrmodem_tpu_torch.parallel.time_shard import demod_grid_sharded, demod_pipelined

    cfg = FskDemodConfig(*CONFIGS["lucky7"])
    fixtures = pathlib.Path(__file__).resolve().parent / "fixtures"
    iq = np.fromfile(fixtures / "lucky7.expected.cf32", np.complex64)
    rng = np.random.default_rng(7)
    n = 32768
    streams = np.stack([iq[s * 1024 : s * 1024 + n] + 0.001 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
                        for s in range(10)]).astype(np.complex64)
    n0 = (fir_ops.launches, clock_ops.launches)
    outs = demod_pipelined(streams, cfg, Mesh([cuda] * 4))
    assert fir_ops.launches >= n0[0] + 12 and clock_ops.launches >= n0[1] + 16
    _, ref = _unsharded(cuda, streams, n // 4)
    for s in range(10):
        np.testing.assert_array_equal(outs[s], ref[s], err_msg=f"stream {s}")

    raw = np.fromfile(fixtures / "lucky7.cf32", np.complex64)[:96000]
    pair = np.stack([raw, iq[:96000]]).astype(np.complex64)
    dop = [Doppler(**DOPPLER), None]
    outs = demod_pipelined(pair, cfg, Mesh([cuda] * 4), dopplers=dop)
    _, ref = _unsharded(cuda, pair, 24000, dopplers=[Doppler(**DOPPLER), None])
    for s in range(2):
        np.testing.assert_array_equal(outs[s], ref[s], err_msg=f"Doppler stream {s}")

    grid = demod_grid_sharded(streams[:4], cfg, [Mesh([cuda] * 2), Mesh([cuda] * 2)])
    _, ref = _unsharded(cuda, streams[:4], n // 2)
    for ch in range(4):
        np.testing.assert_array_equal(grid[ch], ref[ch], err_msg=f"grid channel {ch}")


@pytest.mark.cuda
def test_server_mesh_group_on_card(cuda, tmp_path, monkeypatch):
    """The server's fast group with its 256 lanes over two shards of the
    card: four clients with their own Doppler passes get the bytes of the
    unsharded 256-lane step run directly, and B2 launches once a shard a
    block."""
    import pathlib

    from sdrmodem_tpu_torch.server import wire
    from sdrmodem_tpu_torch.server.session import BatchedRxGroup, doppler_from_settings
    from tests.torch_server_helpers import rx_request, serve_rx

    monkeypatch.setattr(BatchedRxGroup, "LANES", 256)
    cfg, block, c = FskDemodConfig(*CONFIGS["lucky7"]), 8192, 256
    raw = np.fromfile(pathlib.Path(__file__).resolve().parent / "fixtures" / "lucky7.cf32", np.complex64)[: 4 * block]
    settings = wire.DopplerSettings(tle=DOPPLER["tle_lines"], latitude=537200000, longitude=475700000, altitude=0)
    starts = [DOPPLER["start_time_seconds"] + k for k in range(4)]
    pipe = DemodPipeline(cfg, block, device=cuda)
    step = pipe.make_batched_step_full("pallas", doppler=True, layout="fanout")
    state = pipe.init_full_state(c)
    dops = [doppler_from_settings(settings, 48000, 437525000, 0, s) for s in starts]
    want = [[] for _ in dops]
    for t in range(4):
        blk = raw[t * block : (t + 1) * block]
        x = torch.from_numpy(np.stack([blk.real, blk.imag]).astype(np.float32)).to(cuda)
        rows = {k: d.device_segments(block, +1) for k, d in enumerate(dops)}
        tables = doppler_tables_from_numpy(segment_tables(rows, Doppler.max_rows(block, 48000), c), c, device=cuda)
        state, sym, cnt = step(state, x, tables)
        for k, lane in enumerate(_lane_streams(sym.cpu(), cnt.cpu())[: len(dops)]):
            want[k].append(lane)
    want = [np.concatenate(w) for w in want]
    n0 = clock_ops.launches
    got, _, where = serve_rx(tmp_path, {"buffer_size": block, "read_timeout_seconds": 5, "demod_mode": "fast"},
                             [rx_request(settings, s) for s in starts], [raw], [[len(w)] for w in want],
                             timeout=300, server_kw={"device": cuda, "devices": [cuda, cuda]})
    assert clock_ops.launches == n0 + 2 * 4
    assert where == [(k, "cuda") for k in range(4)]
    for k, g in enumerate(got):
        np.testing.assert_array_equal(g, want[k], err_msg=f"client {k}")


# atan2f's maximum ulp error (CUDA C++ Programming Guide, single-precision
# mathematical functions)
ATAN2F_ULP = 3


def atan2_tolerance(gain: float) -> float:
    """Kernel vs plain in the atan2 form: each atan2f within ATAN2F_ULP
    ulps of |angle| <= pi (an ulp of pi is 2^-22), times the gain, and the
    product's rounding."""
    return gain * 2 * ATAN2F_ULP * 2.0**-22 + float(np.spacing(np.float32(gain * np.pi)))


@pytest.mark.cuda
def test_quad_kernel_atan2_form(cuda):
    """The quad-demod kernel with ``atan_lut=False`` against its plain
    version, (0, 0) products and NaN included, within ``atan2_tolerance``;
    the LUT form stays bit for bit."""
    taps = DemodPipeline(FskDemodConfig(*CONFIGS["lucky7"]), 4096, device=cuda).front_taps
    rng = np.random.default_rng(21)
    y1 = torch.from_numpy(rng.standard_normal((4096, 2 * 130)).astype(np.float32)).to(cuda)
    y1[100:104] = 0.0
    y1[200, 3] = float("nan")
    prev = torch.from_numpy(rng.standard_normal((1, 2 * 130)).astype(np.float32)).to(cuda)
    atan = taps._replace(atan_lut=False)
    n0 = front_ops.launches
    got = front_ops.quad_demod(y1, prev, atan)
    want = front_ops.quad_demod_plain(y1, prev, atan)
    assert front_ops.launches == n0 + 1
    assert torch.equal(torch.isnan(got), torch.isnan(want)) and torch.equal(got[100:103], want[100:103])
    ok = ~torch.isnan(want)
    assert (got[ok] - want[ok]).abs().max().item() <= atan2_tolerance(taps.quad_gain)
    assert torch.equal(front_ops.quad_demod(y1, prev, taps), front_ops.quad_demod_plain(y1, prev, taps))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [False, "atan2"])
def test_atan2_step_fronts_give_the_same_bytes(cuda, mode):
    """In the atan2 modes every front runs the banded route on the card:
    the same bytes, B1 and B7 never launched."""
    c, block = 130, 8192
    pipe = DemodPipeline(FskDemodConfig(*CONFIGS["lucky7"]), block, use_atan_lut=mode, device=cuda)
    iq = np.fromfile(pathlib.Path(__file__).resolve().parent / "fixtures" / "lucky7.expected.cf32", np.complex64)
    x = torch.from_numpy(np.stack([iq[:block].real, iq[:block].imag]).astype(np.float32)).to(cuda)
    runs = {}
    f0, s0 = front_ops.fused_launches, step_ops.launches
    for front in ("banded", "fused", "step"):
        step = pipe.make_batched_step_full("pallas", layout="fanout", front=front)
        state = pipe.init_full_state(c)
        out = []
        for _ in range(2):
            state, sym, cnt = step(state, x)
            out.append((sym.cpu(), cnt.cpu()))
        runs[front] = out
    assert front_ops.fused_launches == f0 and step_ops.launches == s0
    for front in ("fused", "step"):
        for (a, ca), (b, cb) in zip(runs[front], runs["banded"]):
            assert torch.equal(a, b) and torch.equal(ca, cb)
    assert int(runs["banded"][0][1].sum()) > 0


@pytest.mark.cuda
def test_dryrun_on_repeated_cards(cuda):
    """The dry run of ``tools/graft_entry.py`` on a mesh of 2 shards of the
    card, every case equal to the unsharded step."""
    from sdrmodem_tpu_torch.tools import graft_entry

    report = graft_entry.dryrun_multichip(2, devices=[cuda, cuda])
    assert report["d_pipelined"]["schedule"]["idle_device_rounds"] == 0
