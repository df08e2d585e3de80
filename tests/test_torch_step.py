"""The port's fused front+clock step (ops/step.py, the module holding the
B7 kernel) through ``make_batched_step_full(front="step")`` on the CPU.

(i) Against the JAX package's ``front="step"`` (``ops/pallas_step.py`` in
interpret mode, chunks of 256 rows by SDRM_STEP_CHUNK as
tests/test_fused_step.py sets it; the port's ``chunk=256``), 128 lanes of
real captures at lane offsets drawn from a seed: DC on at d = 2 over two
blocks, d = 1 with DC off, two Doppler segments a lane, and the reference's
NaN capture.  Tolerances: counts per chunk and the final resid equal and
omega within 1e-5, as the port's B2 is held to JAX's clock
(tests/test_torch_clock.py).  That test feeds both clocks one y3; here each
side runs its own front, whose y3 differ by f32 ulps
(tests/test_torch_front.py), so two bounds are wider than there: int8
symbols within ±2 LSB, the reference's own bound (test/test_fsk_demod.c:
43-48), not ±1 (one symbol of 25,000 is 2 LSB apart on nusat without DC,
the rest within 1); and mu within 5e-3, not 1e-5, since mu, the
fractional sample phase, integrates the difference (up to 1e-3 measured).
The suffix (y3's tail), lpf2_hist and dc_hist within
1e-4, quad_prev within 1e-6, lpf1_hist exact (2e-6 with Doppler): the
fused front's bounds (tests/test_torch_front.py).  On the NaN capture
the counts, resid and symbols hold; the carried state (omega, mu and the
front's) does not, by design: the JAX front zeroes the windows a NaN
reaches and the port keeps the NaN in them, so the clocks take different
branches there (tests/test_torch_clock.py::test_clock_nan_branch_counts_match_jax).

(ii) A JAX state after one block carries into the port
(``utils/convert.py:full_state_from_numpy``, 5 of the 128 lanes) and the
next block agrees with JAX's within the same tolerances.

(iii) Bit for bit against the port's own pair, ``front="fused"`` with the
chunked clock B2: the flattened symbols, the count totals and every state
field, for d = 1 and 2, DC on and off, a NaN stretch, Doppler, chunks of
256 and 1024, block-size invariance, on 3 lanes.

(iv) The lucky7 golden through ``front="step"`` within ±2 LSB, agreement
1.0.  The JAX references are computed once a module.
"""

import functools
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdrmodem_tpu.dsp.fsk_demod import FskDemodConfig as JaxConfig
from sdrmodem_tpu.dsp.pipeline import DemodPipeline as JaxPipeline
from sdrmodem_tpu_torch import DemodPipeline, FskDemodConfig
from sdrmodem_tpu_torch.ops import step as step_ops
from sdrmodem_tpu_torch.utils.convert import doppler_tables_from_numpy, full_state_from_numpy
from sdrmodem_tpu_torch.utils.parity import GOLDEN_CASES, demod_capture, golden_report
from tests.test_torch_fir import one_thread  # noqa: F401 (torch on one thread)
from tests.test_torch_front import gfsk_lanes

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
LUCKY7 = (48000, 4800, 5000, 2, 2000, True)
NODC = (48000, 4800, 5000, 2, 2000, False)
NUSAT = (192000, 40000, 5000, 1, 2000, True)
NAN = (240000, 9600, 5000, 1, 2000, True)
CHUNK = 256
LANES = 128
LSB = 2
MU_ATOL = 5e-3
OMEGA_ATOL = 1e-5
FRONT_ATOL = 1e-4  # y3's tail (the suffix), lpf2_hist, dc_hist
QUAD_ATOL = 1e-6
MIXED_ATOL = 2e-6  # lpf1_hist with Doppler: the mixed block's tail

# (config, block, capture, blocks, Doppler segments)
JAX_CASES = {
    "dc_d2": (LUCKY7, 1024, "lucky7.expected.cf32", 2, False),
    "nodc_d1": (NUSAT[:5] + (False,), 512, "nusat.cf32", 1, False),
    "doppler": (LUCKY7, 512, "lucky7.expected.cf32", 1, True),
    "nan": (NAN, 512, "inputnan.cf32", 1, False),
}


def _capture_blocks(capture, block, n_blocks, lanes, seed=0):
    """n_blocks (block, 2 * lanes) time-major float32 blocks: lane c reads
    the capture from an offset drawn from the seed."""
    iq = np.fromfile(FIXTURES / capture, np.complex64)
    offs = np.random.default_rng(seed).integers(0, len(iq) - n_blocks * block + 1, lanes)
    x = np.stack([iq[o : o + n_blocks * block] for o in offs], axis=1)
    x = np.concatenate([x.real, x.imag], axis=1).astype(np.float32)
    return [x[k * block : (k + 1) * block] for k in range(n_blocks)]


def _doppler(block, lanes):
    """Two segments a lane, each lane its own ramp (tests/test_fused_step.py)."""
    starts = np.zeros((2, lanes), np.float32)
    starts[1] = block // 2
    ends = np.full((2, lanes), block // 2, np.float32)
    ends[1] = block
    adjs = np.tile(np.linspace(1e-4, 3e-3, lanes, dtype=np.float32), (2, 1))
    ph0s = np.zeros((2, lanes), np.float32)
    ph0s[1] = 0.7
    return starts, ends, adjs, ph0s


@functools.lru_cache(maxsize=None)
def jax_reference(name):
    """JAX's front="step" over the case's blocks: a list of (state, symbols,
    counts) as numpy, one a block, computed once a module."""
    cfg, block, capture, n_blocks, dop = JAX_CASES[name]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SDRM_STEP_CHUNK", str(CHUNK))
        mp.setenv("SDRM_FIR_PRECISION", "highest")
        pipe = JaxPipeline(JaxConfig(*cfg), block, exact=False, use_atan_lut="free")
        assert pipe.fused_step_available(LANES)
        step = pipe.make_batched_step_full("pallas", layout="tm", front="step", jit=False,
                                           doppler=dop)
        state = pipe.init_full_state(LANES)
        out = []
        for x in _capture_blocks(capture, block, n_blocks, LANES):
            args = (tuple(map(jnp.asarray, _doppler(block, LANES))),) if dop else ()
            state, sym, cnt = step(state, jnp.asarray(x), *args)
            out.append((jax.tree.map(np.asarray, state), np.asarray(sym), np.asarray(cnt)))
    return out


def _port_step(cfg, block, dop, **kw):
    pipe = DemodPipeline(FskDemodConfig(*cfg), block, device="cpu")
    return pipe, pipe.make_batched_step_full("pallas", layout="tm", front="step", chunk=CHUNK,
                                             doppler=dop, **kw)


def _hold_to_jax(state, sym, cnt, jstate, jsym, jcnt, c, *, dop, carried=True):
    """The tolerances of the module's docstring, on the first c lanes;
    without ``carried``, the outputs and resid only."""
    jsym, jcnt = jsym[:c], jcnt[:c]
    assert sym.shape == jsym.shape and np.array_equal(cnt.numpy(), jcnt)
    assert np.abs(sym.numpy().astype(np.int32) - jsym.astype(np.int32)).max() <= LSB
    assert np.array_equal(state.clock.resid.numpy(), jstate.clock.resid[:c])
    if carried:
        _hold_state_to_jax(state, jstate, c, dop=dop)


def _hold_state_to_jax(state, jstate, c, *, dop):
    """The carried state's tolerances of the module's docstring."""
    np.testing.assert_allclose(state.clock.omega.numpy(), jstate.clock.omega[:c], rtol=0, atol=OMEGA_ATOL)
    np.testing.assert_allclose(state.clock.mu.numpy(), jstate.clock.mu[:c], rtol=0, atol=MU_ATOL)
    np.testing.assert_allclose(state.clock.suffix.numpy(), jstate.clock.suffix[:, :c], rtol=0,
                               atol=FRONT_ATOL)
    cp = jstate.quad_prev.shape[1] // 2
    iq = lambda a: np.concatenate([a[:, :c], a[:, cp : cp + c]], axis=1)  # noqa: E731
    np.testing.assert_allclose(state.lpf1_hist.numpy(), iq(jstate.lpf1_hist), rtol=0,
                               atol=MIXED_ATOL if dop else 0.0)
    np.testing.assert_allclose(state.quad_prev.numpy(), iq(jstate.quad_prev), rtol=0, atol=QUAD_ATOL)
    np.testing.assert_allclose(state.lpf2_hist.numpy(), jstate.lpf2_hist[:, :c], rtol=0, atol=FRONT_ATOL)
    if jstate.dc_hist is None:
        assert state.dc_hist is None
    else:
        np.testing.assert_allclose(state.dc_hist.numpy(), jstate.dc_hist[:, :c], rtol=0, atol=FRONT_ATOL)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_step_matches_jax_step(name):
    cfg, block, capture, n_blocks, dop = JAX_CASES[name]
    ref = jax_reference(name)
    pipe, step = _port_step(cfg, block, dop)
    state = pipe.init_full_state(LANES)
    before = step_ops.launches
    total = 0
    for x, (jstate, jsym, jcnt) in zip(_capture_blocks(capture, block, n_blocks, LANES), ref):
        args = (doppler_tables_from_numpy(_doppler(block, LANES), LANES, device="cpu"),) if dop else ()
        state, sym, cnt = step(state, torch.from_numpy(x), *args)
        assert sym.dtype == torch.int8 and cnt.dtype == torch.int32
        assert cnt.shape == (LANES, block // (cfg[3] * CHUNK))
        _hold_to_jax(state, sym, cnt, jstate, jsym, jcnt, LANES, dop=dop, carried=name != "nan")
        total += int(cnt.sum())
    assert total > 0.9 * LANES * n_blocks * block * cfg[1] / cfg[0]  # samples x baud / rate
    assert step_ops.launches == before  # the CPU runs the plain version


def test_jax_state_carries_into_the_step():
    """Block 1 on JAX, its state carried to the port on 5 lanes, block 2 on
    both."""
    cfg, block, capture, n_blocks, _ = JAX_CASES["dc_d2"]
    (jstate1, _, _), (jstate2, jsym2, jcnt2) = jax_reference("dc_d2")
    c = 5
    _, step = _port_step(cfg, block, False)
    state = full_state_from_numpy(jstate1, c, device="cpu")
    x = _capture_blocks(capture, block, n_blocks, LANES)[1]
    x = np.concatenate([x[:, :c], x[:, LANES : LANES + c]], axis=1)
    state, sym, cnt = step(state, torch.from_numpy(x))
    _hold_to_jax(state, sym, cnt, jstate2, jsym2, jcnt2, c, dop=False)
    assert int(cnt.sum()) > c * 90  # 1024 samples / d 2 / sps 5 ≈ 102 a lane


def _flat(sym, cnt, lane):
    return torch.cat([sym[lane, k, :n] for k, n in enumerate(cnt[lane].tolist())])


def _stream(step, state, xs, dops):
    """Each lane's symbols over the blocks, and the final state."""
    syms = []
    for x, dop in zip(xs, dops):
        state, sym, cnt = step(state, x, *((dop,) if dop is not None else ()))
        assert sym.shape[:2] == cnt.shape
        syms.append([_flat(sym, cnt, lane) for lane in range(cnt.shape[0])])
    return [torch.cat(parts) for parts in zip(*syms)], state


def _bits(t):
    """A float32 tensor's bits, so NaNs compare too."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_same_state(a, b):
    for x, y in zip((*a[:4], *a.clock), (*b[:4], *b.clock)):
        assert (x is None and y is None) or torch.equal(_bits(x), _bits(y))


# (config, block, chunk, blocks, NaN rows, Doppler)
PAIR_CASES = {
    "dc_d2": (LUCKY7, 1024, 256, 2, None, False),
    "nodc_d2": (NODC, 512, 256, 1, None, False),
    "dc_d1": (NUSAT, 512, 256, 2, None, False),
    "nan_d1": (NUSAT, 1024, 256, 1, (100, 140), False),
    "doppler": (LUCKY7, 1024, 256, 2, None, True),
    "chunk1024": (LUCKY7, 4096, 1024, 2, None, False),
}


@pytest.mark.parametrize("name", list(PAIR_CASES))
def test_step_equals_fused_front_and_clock(name):
    """front="step" against front="fused" with B2 (chunks of 2048 rows), 3
    lanes of noise: the same symbol stream and state, bit for bit."""
    cfg, block, chunk, n_blocks, nan, dop = PAIR_CASES[name]
    c = 3
    rng = np.random.default_rng(7)
    xs = [(rng.standard_normal((block, 2 * c)) * 0.3).astype(np.float32) for _ in range(n_blocks)]
    if nan is not None:  # a NaN stretch, and an infinite sample whose inf - inf reaches the clock
        xs[0][nan[0] : nan[1]] = np.nan
        xs[0][300, 0] = np.inf
    xs = [torch.from_numpy(x) for x in xs]
    dops = [doppler_tables_from_numpy(tuple(t * (1 + k) for t in _doppler(block, c)), c, device="cpu")
            if dop else None for k in range(n_blocks)]
    pipe = DemodPipeline(FskDemodConfig(*cfg), block, device="cpu")
    kw = dict(layout="tm", doppler=dop)
    step = pipe.make_batched_step_full("pallas", front="step", chunk=chunk, **kw)
    pair = pipe.make_batched_step_full("pallas", front="fused", **kw)
    a, sa = _stream(step, pipe.init_full_state(c), xs, dops)
    b, sb = _stream(pair, pipe.init_full_state(c), xs, dops)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert min(len(u) for u in a) > 0.9 * n_blocks * block * cfg[1] / cfg[0]
    _assert_same_state(sa, sb)
    if nan is not None:  # lane 0's NaN branch emitted its zeros
        assert (a[0] == 0).sum() > (a[2] == 0).sum() + 10


def test_step_block_size_invariant():
    """One stream as 2 blocks of B and as 1 block of 2B: the same symbols
    and state (the carried hand-off is exact)."""
    c = 3
    x = torch.from_numpy((np.random.default_rng(6).standard_normal((2048, 2 * c)) * 0.3).astype(np.float32))
    runs = []
    for block, parts in ((1024, (x[:1024], x[1024:])), (2048, (x,))):
        pipe = DemodPipeline(FskDemodConfig(*LUCKY7), block, device="cpu")
        step = pipe.make_batched_step_full("pallas", layout="tm", front="step", chunk=256)
        runs.append(_stream(step, pipe.init_full_state(c), parts, [None] * len(parts)))
    (a, sa), (b, sb) = runs
    assert all(torch.equal(u, v) for u, v in zip(a, b)) and len(a[0]) > 180
    _assert_same_state(sa, sb)


def test_step_lucky7_golden(resources_dir):
    name, cfg, fin, fexp, block = GOLDEN_CASES[0]
    assert name == "lucky7"
    iq = np.fromfile(resources_dir / fin, dtype=np.complex64)
    golden = np.fromfile(resources_dir / fexp, dtype=np.int8)
    rep = golden_report(demod_capture(DemodPipeline(cfg, block, device="cpu"), iq, front="step"), golden)
    assert rep["symbols"] >= 0.99 * len(golden)
    assert rep["hard_decision_agreement"] == 1.0
    assert rep["max_lsb"] <= 2, rep


def test_step_wrapper_checks():
    """The wrapper refuses what the kernel does not take; the pipeline's
    front="step" takes the fused front and B2 on a block that is not whole
    chunks (the same outputs and state as front="fused", bit for bit), and
    refuses a chunk B2 cannot take."""
    pipe = DemodPipeline(FskDemodConfig(*LUCKY7), 1536, device="cpu")
    assert not pipe.fused_step_available(3) and pipe.fused_step_available(3, chunk=256)
    assert not pipe.fused_step_available(3, chunk=60)  # below the carried suffix of 64
    x = torch.from_numpy((np.random.default_rng(5).standard_normal((1536, 6)) * 0.3).astype(np.float32))
    runs = [pipe.make_batched_step_full("pallas", layout="tm", front=f)(pipe.init_full_state(3), x)
            for f in ("step", "fused")]
    (sa, ya, ca), (sb, yb, cb) = runs
    assert torch.equal(ya, yb) and torch.equal(ca, cb) and int(ca.sum()) > 3 * 100
    _assert_same_state(sa, sb)
    with pytest.raises(ValueError, match="multiple of 8"):
        pipe.make_batched_step_full("pallas", front="step", chunk=252)
    state = pipe.init_full_state(2)
    x = torch.zeros((1536, 4))
    ck = state.clock
    with pytest.raises(ValueError, match="whole number of chunks"):
        step_ops.fused_step(
            x, *state[:4], ck.suffix, ck.omega, ck.mu, ck.last_sample, ck.resid, pipe.front_taps,
            pipe.bank, num_symbols=274, omega_mid=5.0, omega_relative_limit=0.01,
            gain_omega=0.157, gain_mu=0.0625,
        )


def _lane_streams(sym, cnt):
    """Each lane's symbols concatenated over the chunks, as numpy."""
    return [np.concatenate([np.asarray(sym[lane, k, :n]) for k, n in enumerate(np.asarray(cnt[lane]).tolist())])
            for lane in range(cnt.shape[0])]


# C2: front="step" where B7 does not take the block.  (config, block, blocks,
# GFSK input (fs, baud, deviation) or None for the lucky7 capture, whether
# the carried state is held to the module's tolerances)
ROUTE_CASES = {
    # 1536 rows at d = 2: not whole chunks of 1024 decimated rows
    "partial_chunks": (LUCKY7, 1536, 2, None, True),
    # whole chunks, but LPF1 4819, LPF2 2891 and DC 12797 taps: B7's layout
    # passes one block's shared memory (step_plan 242,912 bytes).  Held as
    # tests/test_torch_front.py::test_long_tap_step_matches_jax holds long
    # filters against JAX, on the outputs and resid: a quad gain of 64 turns
    # the two sides' f32 ulps of a 4819-tap LPF1 into up to 1e-3 on the
    # quad-demod tail
    "past_shared_memory": ((240000, 1200, 600, 2, 200, True), 2048, 2, (240000, 1200, 600), False),
}


@pytest.mark.parametrize("name", list(ROUTE_CASES))
def test_step_route_follows_jax_where_b7_does_not_take_the_block(name, monkeypatch):
    """Where ``fused_step_available`` is False the port's front="step" is
    built on the fused route (B1 or the banded front, then B2), as the JAX
    package's front="step" takes its fused front there
    (``sdrmodem_tpu/dsp/pipeline.py:643-650``): 3 lanes, two blocks with the
    state carried, against JAX's front="step" on the same numpy input.
    Count totals a lane equal, symbols within ±2 LSB, resid equal and,
    where the case says so, the state within the module's tolerances."""
    monkeypatch.setenv("SDRM_FIR_PRECISION", "highest")
    cfg, block, n_blocks, gfsk, carried = ROUTE_CASES[name]
    c = 3
    pipe = DemodPipeline(FskDemodConfig(*cfg), block, device="cpu")
    assert not pipe.fused_step_available(c)
    if gfsk is None:
        xs = [np.stack([x[:, :c], x[:, LANES : LANES + c]], axis=1).transpose(2, 1, 0).copy()
              for x in _capture_blocks("lucky7.expected.cf32", block, n_blocks, LANES)]
    else:
        taps = pipe.front_taps
        assert block % (cfg[3] * step_ops.DEFAULT_CHUNK) == 0
        assert step_ops.step_plan(taps.rev1.numel(), taps.rev2.numel(), taps.rev_dc.numel(), cfg[3],
                                  step_ops.DEFAULT_CHUNK, pipe.init_full_state(1).clock.suffix.shape[0]
                                  ) > step_ops.MAX_SHARED_BYTES
        x_all = gfsk_lanes(*gfsk, n_blocks * block, c, 13)
        xs = [x_all[:, :, k * block : (k + 1) * block].copy() for k in range(n_blocks)]
    step = pipe.make_batched_step_full("pallas", front="step")
    fused = pipe.make_batched_step_full("pallas", front="fused")
    jpipe = JaxPipeline(JaxConfig(*cfg), block, exact=False, use_atan_lut="free")
    jstep = jpipe.make_batched_step_full("pallas", front="step", jit=False)
    state, fstate, jstate = pipe.init_full_state(c), pipe.init_full_state(c), jpipe.init_full_state(c)
    for x in xs:
        state, sym, cnt = step(state, torch.from_numpy(x))
        fstate, fsym, fcnt = fused(fstate, torch.from_numpy(x))
        assert torch.equal(sym, fsym) and torch.equal(cnt, fcnt)  # the fused route, bit for bit
        jstate, jsym, jcnt = jstep(jstate, jnp.asarray(x))
        jsym, jcnt = np.asarray(jsym)[:c], np.asarray(jcnt)[:c]
        assert np.array_equal(cnt.sum(1).numpy(), jcnt.sum(1))
        for got, want in zip(_lane_streams(sym, cnt), _lane_streams(jsym, jcnt)):
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= LSB
        jnp_state = jax.tree.map(np.asarray, jstate)
        assert np.array_equal(state.clock.resid.numpy(), jnp_state.clock.resid[:c])
        if carried:
            _hold_state_to_jax(state, jnp_state, c, dop=False)
    _assert_same_state(state, fstate)
    assert int(cnt.sum()) > 0.9 * c * block * cfg[1] / cfg[0]


# (taps t1, t2, t3, d, sfx) -> csrc/step.cu's Layout summed by hand at
# chunk 1024, in floats: the bank 1032, the table 260, the three tap
# regions, the Doppler rows 5 x 32 + 1 -> 164, the staged tile 2 r,
# [4 | LPF1 history | r | 12 pad] twice, [LPF2 history | r | 5 d + 4],
# [DC history | 1024 | 9], qp 4, two slots of sfx + 1024; each region
# rounded up to 4 floats
PLAN_BY_HAND = {
    "lucky7": ((157, 57, 637, 2, 64),
               1032 + 260 + 160 + 60 + 640 + 164 + 4096 + 2 * 2220 + 2120 + 1672 + 4 + 2 * 1088),
    "nusat": ((185, 231, 613, 1, 64),
              1032 + 260 + 188 + 232 + 616 + 164 + 2048 + 2 * 1224 + 1264 + 1648 + 4 + 2 * 1088),
    "nan": ((589, 289, 3197, 1, 64),
            1032 + 260 + 592 + 292 + 3200 + 164 + 2048 + 2 * 1628 + 1324 + 4232 + 4 + 2 * 1088),
    "long_taps": ((707, 347, 1917, 2, 64),
                  1032 + 260 + 708 + 348 + 1920 + 164 + 4096 + 2 * 2772 + 2408 + 2952 + 4 + 2 * 1088),
    "lucky7_nodc": ((157, 57, 0, 2, 64),
                    1032 + 260 + 160 + 60 + 0 + 164 + 4096 + 2 * 2220 + 2120 + 0 + 4 + 2 * 1088),
}


@pytest.mark.parametrize("name", list(PLAN_BY_HAND))
def test_step_plan_matches_layout_by_hand(name):
    (t1, t2, t3, d, sfx), floats = PLAN_BY_HAND[name]
    assert step_ops.step_plan(t1, t2, t3, d, step_ops.DEFAULT_CHUNK, sfx) == 4 * floats
    assert 4 * floats <= step_ops.MAX_SHARED_BYTES


def test_step_plan_matches_pipeline_taps():
    """The hand sums' taps are the pipelines' own (lucky7, nusat, the nan
    fixture's and the long filters), and each takes B7 at its default
    chunk on a block of whole chunks."""
    for name, cfg in (("lucky7", LUCKY7), ("nusat", NUSAT), ("nan", NAN),
                      ("long_taps", (288000, 9600, 5000, 2, 2000, True)), ("lucky7_nodc", NODC)):
        pipe = DemodPipeline(FskDemodConfig(*cfg), 4 * step_ops.DEFAULT_CHUNK, device="cpu")
        t = pipe.front_taps
        t3 = t.rev_dc.numel() if t.rev_dc is not None else 0
        sfx = pipe.init_full_state(1).clock.suffix.shape[0]
        assert PLAN_BY_HAND[name][0] == (t.rev1.numel(), t.rev2.numel(), t3, t.d, sfx)
        assert pipe.fused_step_available(5)
