"""The port's front end (ops/front.py, the module holding the B1 kernel)
against the JAX fused front kernel (ops/pallas_front.py) in interpret mode,
without and with its Doppler stage, and the port's two fronts (fused and
banded on B3) against each other.

Same numpy inputs, 4 lanes, block 4096, three blocks with carried state.
The JAX FIRs run in their float32-exact mode (SDRM_FIR_PRECISION=highest):
the port's FIRs are plain float32, while the JAX default splits operands
into three bfloat16 products (~16 mantissa bits; measured up to 2.4e-3
apart on nusat's white-noise LPF2 tail).

Tolerances:
- lpf1_hist is the raw input tail: exact.
- quad_prev is an LPF1 output row: 1e-6, since the two FIRs sum the same
  products in another order (a few f32 ulps at this magnitude).
- y3, lpf2_hist and dc_hist: 1e-4 (≈ 0.013 int8 LSB), the bound of
  tests/test_fused_front.py.  The JAX kernel's arctangent evaluates the
  table from a polynomial (≤ 2 ulp off the table), and near-zero
  conjugate products magnify the FIRs' ulp-level differences in angle.
- With Doppler, lpf1_hist is the mixed block's tail: 2e-6, the NCO bound
  of tests/test_torch_doppler.py (cos and sin an ulp apart).
- The port's fused and banded fronts: bit for bit, with and without
  Doppler (the same arithmetic in the same order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdrmodem_tpu.dsp.doppler import Doppler as JaxDoppler
from sdrmodem_tpu.dsp.elementwise import nco_mix_pair_tm as jax_nco_mix
from sdrmodem_tpu.dsp.fsk_demod import FskDemodConfig as JaxConfig
from sdrmodem_tpu.dsp.pipeline import DemodPipeline as JaxPipeline
from sdrmodem_tpu.dsp.pipeline import DemodStateFull as JaxState
from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline, DemodStateFull
from sdrmodem_tpu_torch.ops import front as front_ops
from sdrmodem_tpu_torch.utils.convert import (
    doppler_tables_from_numpy,
    full_state_from_numpy,
    segment_tables,
)
from tests.test_torch_doppler import ARGS
from tests.test_torch_fir import one_thread  # noqa: F401 (torch on one thread)

CONFIGS = {
    "lucky7": (48000, 4800, 5000, 2, 2000, True),
    "lucky7_nodc": (48000, 4800, 5000, 2, 2000, False),
    "nusat": (192000, 40000, 5000, 1, 2000, True),
}
C, BLOCK, STEPS = 4, 4096, 3


def _pad_lanes(x: np.ndarray, cp: int = 128) -> np.ndarray:
    """(B, 2C) I|Q lanes -> the JAX package's (B, 2Cp)."""
    out = np.zeros((x.shape[0], 2 * cp), np.float32)
    out[:, :C] = x[:, :C]
    out[:, cp : cp + C] = x[:, C:]
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_front_plain_matches_jax(name, monkeypatch):
    monkeypatch.setenv("SDRM_FIR_PRECISION", "highest")
    jpipe = JaxPipeline(JaxConfig(*CONFIGS[name]), BLOCK, exact=False, use_atan_lut="free")
    pipe = DemodPipeline(FskDemodConfig(*CONFIGS[name]), BLOCK, device="cpu")
    jstate = jpipe.init_full_state(C)
    state = pipe.init_full_state(C)
    rng = np.random.default_rng(0)
    before = front_ops.launches
    for _ in range(STEPS):
        x = rng.standard_normal((BLOCK, 2 * C)).astype(np.float32)
        jfront, jy3 = jpipe._front_fused_full(jstate, jnp.asarray(_pad_lanes(x)), interpret=True)
        jstate = JaxState(*jfront, jstate.clock)
        y3, front = front_ops.fused_front(
            torch.from_numpy(x), state.lpf1_hist, state.quad_prev, state.lpf2_hist,
            state.dc_hist, pipe.front_taps,
        )
        state = DemodStateFull(*front, state.clock)

        want = full_state_from_numpy(jax.tree.map(np.asarray, jstate), C, device="cpu")
        assert y3.shape == (BLOCK // pipe.config.decimation, C)
        np.testing.assert_allclose(y3.numpy(), np.asarray(jy3)[:, :C], rtol=0, atol=1e-4)
        assert torch.equal(state.lpf1_hist, want.lpf1_hist)
        torch.testing.assert_close(state.quad_prev, want.quad_prev, rtol=0, atol=1e-6)
        torch.testing.assert_close(state.lpf2_hist, want.lpf2_hist, rtol=0, atol=1e-4)
        if CONFIGS[name][5]:
            torch.testing.assert_close(state.dc_hist, want.dc_hist, rtol=0, atol=1e-4)
        else:
            assert state.dc_hist is None and want.dc_hist is None
    # a CPU tensor runs the plain version: nothing was launched
    assert front_ops.launches == before


def test_front_rejects_other_devices():
    pipe = DemodPipeline(FskDemodConfig(*CONFIGS["lucky7"]), 256, device="cpu")
    state = pipe.init_full_state(2)
    x = torch.zeros((256, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        front_ops.fused_front(
            x, state.lpf1_hist, state.quad_prev, state.lpf2_hist, state.dc_hist,
            pipe.front_taps,
        )


def _doppler_rows(block, blocks, offsets):
    """Per block, {lane: device_segments rows} for lanes with a pass of
    their own (start time and constant offset per lane)."""
    dops = {
        lane: JaxDoppler(**{**ARGS, "start_time_seconds": ARGS["start_time_seconds"] + 30 * lane,
                            "constant_offset": off})
        for lane, off in offsets.items()
    }
    return [{lane: d.device_segments(block, +1) for lane, d in dops.items()} for _ in range(blocks)]


def _raw_lanes(resources_dir, block, blocks, lanes):
    """The raw lucky7 pass, lane k reading from k * 9000, as (B, 2C) blocks."""
    iq = np.fromfile(resources_dir / "lucky7.cf32", np.complex64)
    cols = np.stack([iq[k * 9000 : k * 9000 + block * blocks] for k in range(lanes)], axis=1)
    return [
        np.concatenate([cols[s : s + block].real, cols[s : s + block].imag], axis=1).astype(np.float32)
        for s in range(0, block * blocks, block)
    ]


def test_front_doppler_matches_jax(resources_dir, monkeypatch):
    """lucky7 raw pass, 4 lanes: rows on lanes 0-2, none on lane 3.

    The reference for the mixed lanes is JAX's ``nco_mix_pair_tm`` ahead
    of its fused front (the order of its banded route, pipeline.py:657-662).
    JAX's in-kernel Doppler stage (``_front_fused_full(dop=...)``), run in
    interpret mode on the CPU, has ``ph0 + m*adj`` contracted into a fused
    multiply-add: one ulp of a ~6000 rad phase, 2.7e-6 on the mixed block
    and 1.2e-4 on y3 on this input (a numpy emulation of the contracted
    ramp matches its mixed tail to 4.7e-10).  The port takes the ramp
    uncontracted, as ``nco_mix_pair_tm`` does.  The row-free lane 3 must
    match the in-kernel stage too."""
    monkeypatch.setenv("SDRM_FIR_PRECISION", "highest")
    cfg = CONFIGS["lucky7"]
    jpipe = JaxPipeline(JaxConfig(*cfg), BLOCK, exact=False, use_atan_lut="free")
    pipe = DemodPipeline(FskDemodConfig(*cfg), BLOCK, device="cpu")
    jstate = jstate_k = jpipe.init_full_state(C)
    state = pipe.init_full_state(C)
    s_rows = JaxDoppler.max_rows(BLOCK, ARGS["sampling_freq"])
    rows = _doppler_rows(BLOCK, STEPS, {0: 0, 1: 3000, 2: -2500})
    for x, lane_rows in zip(_raw_lanes(resources_dir, BLOCK, STEPS, C), rows):
        jtables = tuple(map(jnp.asarray, segment_tables(lane_rows, s_rows, 128)))
        x_p = jnp.asarray(_pad_lanes(x))
        jfront, jy3 = jpipe._front_fused_full(jstate, jax_nco_mix(x_p, *jtables), interpret=True)
        jstate = JaxState(*jfront, jstate.clock)
        kfront, ky3 = jpipe._front_fused_full(jstate_k, x_p, interpret=True, dop=jtables)
        jstate_k = JaxState(*kfront, jstate_k.clock)
        dop = doppler_tables_from_numpy(jtables, C, device="cpu")
        y3, front = front_ops.fused_front(torch.from_numpy(x), *state[:4], pipe.front_taps, dop)
        state = DemodStateFull(*front, state.clock)

        for want_y3, want, lanes in (
            (jy3, jstate, [0, 1, 2, 3]),
            (ky3, jstate_k, [3]),
        ):
            want = full_state_from_numpy(jax.tree.map(np.asarray, want), C, device="cpu")
            iq = lanes + [C + k for k in lanes]
            np.testing.assert_allclose(
                y3.numpy()[:, lanes], np.asarray(want_y3)[:, lanes], rtol=0, atol=1e-4
            )
            torch.testing.assert_close(state.lpf1_hist[:, iq], want.lpf1_hist[:, iq], rtol=0, atol=2e-6)
            torch.testing.assert_close(state.quad_prev[:, iq], want.quad_prev[:, iq], rtol=0, atol=1e-6)
            for got, ref in ((state.lpf2_hist, want.lpf2_hist), (state.dc_hist, want.dc_hist)):
                torch.testing.assert_close(got[:, lanes], ref[:, lanes], rtol=0, atol=1e-4)
        # lane 3 has no rows: its tail is the raw input's, bit for bit
        tail = x[-state.lpf1_hist.shape[0] :]
        assert torch.equal(state.lpf1_hist[:, [3, 3 + C]], torch.from_numpy(tail[:, [3, 3 + C]]))
        assert not torch.equal(state.lpf1_hist[:, :3], torch.from_numpy(tail[:, :3]))


@pytest.mark.parametrize("name", ["lucky7", "lucky7_nodc"])
@pytest.mark.parametrize("with_dop", [False, True])
def test_fused_and_banded_fronts_bit_equal(resources_dir, name, with_dop):
    block, blocks, c = 2048, 3, 3
    pipe = DemodPipeline(FskDemodConfig(*CONFIGS[name]), block, device="cpu")
    s_rows = JaxDoppler.max_rows(block, ARGS["sampling_freq"])
    rows = _doppler_rows(block, blocks, {0: 0, 2: 1200})
    st_f = st_b = pipe.init_full_state(c)
    for x, lane_rows in zip(_raw_lanes(resources_dir, block, blocks, c), rows):
        x = torch.from_numpy(x)
        dop = None
        if with_dop:
            dop = doppler_tables_from_numpy(segment_tables(lane_rows, s_rows, c), c, device="cpu")
        y3_f, f_f = front_ops.fused_front(x, *st_f[:4], pipe.front_taps, dop)
        y3_b, f_b = front_ops.banded_front(x, *st_b[:4], pipe.front_taps, dop)
        assert torch.equal(y3_f, y3_b)
        for a, b in zip(f_f, f_b):
            assert (a is None and b is None) or torch.equal(a, b)
        st_f = DemodStateFull(*f_f, st_f.clock)
        st_b = DemodStateFull(*f_b, st_b.clock)


NAN_CONFIG = (240000, 9600, 5000, 1, 2000, True)  # tests/fixtures/inputnan.cf32's


@pytest.mark.parametrize("name", [*CONFIGS, "nan"])
def test_front_plan_covers_every_row(name):
    """The fused kernel's host-side plan (ops/front.py:front_plan): its
    segments cover every row of the block once, in order; a segment's walk
    starts inside the block (its mixed-input history at or after the
    carried one's first row) and early enough to recompute every LPF2
    input of its first output; the layout fits one block's shared memory
    and is front.cu's sum; lane groups x segments make one wave."""
    cfg = FskDemodConfig(*(NAN_CONFIG if name == "nan" else CONFIGS[name]))
    t1, t2, d = len(cfg.lpf1_taps()), len(cfg.lpf2_taps()), cfg.decimation
    for block in (64, 4096, 262144, 1 << 20):
        for lanes in (5, 128, 300):
            plan = front_ops.front_plan(block, lanes, t1, t2, d)
            segs = plan.segment_rows(block)
            assert len(segs) == plan.segments and segs[0][0] == 0 and segs[-1][1] == block
            assert all(b0 == a1 for (_, b0, _), (a1, _, _) in zip(segs, segs[1:]))
            assert sum((b - a) // d for a, b, _ in segs) == block // d
            for a, b, start in segs:
                assert a < b and a % d == 0 and start % d == 0
                assert start >= 0 and (start == 0 or a - start >= t2)
            assert plan.tile % 16 == 0 and plan.tile % (d * front_ops.lpf2_rows(d)) == 0
            assert plan.warps == min(8, plan.tile // 16)
            assert plan.shared_bytes == front_ops.front_shared_bytes(t1, t2, plan.tile) <= 232448
            per_sm = 2 if plan.shared_bytes <= 232448 // 2 - 1024 else 1
            assert plan.segments * -(-lanes // 32) <= max(per_sm * 132, -(-lanes // 32))
            dc_rows = front_ops.dc_seg_rows(block // d, lanes)
            assert dc_rows % front_ops.DC_ROWS == 0 and -(-(block // d) // dc_rows) * -(-lanes // 32) <= 4 * 132


LONG_TAPS = (288000, 9600, 5000, 2, 2000, True)  # LPF1 707 taps, LPF2 347, DC 1917
ROUTES = {  # config, whether B1's layout takes its taps
    "lucky7": (CONFIGS["lucky7"], True),
    "lucky7_nodc": (CONFIGS["lucky7_nodc"], True),
    "nusat": (CONFIGS["nusat"], True),
    "nan": (NAN_CONFIG, True),
    "288k_9600": (LONG_TAPS, False),
    "480k_9600": ((480000, 9600, 5000, 2, 2000, True), False),
    "48k_1200": ((48000, 1200, 600, 2, 200, True), False),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_fused_front_available(name):
    """B1's layout takes the four fixture configurations' taps and not the
    long filters of the faster or slower radios: ``fused_front_available``
    answers from ``front_tile`` on the CPU, and ``front_plan`` raises where
    no tile fits."""
    cfg, fits = ROUTES[name]
    pipe = DemodPipeline(FskDemodConfig(*cfg), 4096, device="cpu")
    taps = pipe.front_taps
    t1, t2, d = taps.rev1.numel(), taps.rev2.numel(), taps.d
    assert pipe.fused_front_available() is fits
    assert (front_ops.front_tile(t1, t2, d) is not None) is fits
    if not fits:
        with pytest.raises(ValueError, match="do not fit shared memory"):
            front_ops.front_plan(4096, 4, t1, t2, d)
    assert not DemodPipeline(FskDemodConfig(*cfg), 4096, exact=True, device="cpu").fused_front_available()


def gfsk_lanes(fs, baud, deviation, n, lanes, seed):
    """(lanes, 2, n) float32: a GFSK signal a lane (random bits, Gaussian
    frequency pulse over four bits, deviation in Hz) with a little noise."""
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


def test_long_tap_step_matches_jax(monkeypatch):
    """288 kHz at 9600 Bd, where B1 has no layout: ``make_batched_step_full()``
    takes the banded front, chosen when the step is built (the fused front
    is never called), and its symbols follow the JAX package's step on the
    same numpy input: 3 lanes of GFSK, block 4096, two blocks with the state
    carried.  Counts equal and symbols within ±2 LSB: the JAX FIRs sum the
    same products in another order (SDRM_FIR_PRECISION=highest, float32-
    exact products)."""
    import sdrmodem_tpu_torch.dsp.pipeline as pipeline_mod

    monkeypatch.setenv("SDRM_FIR_PRECISION", "highest")
    c, block = 3, 4096
    calls = []

    def banded(*args):
        calls.append(len(calls))
        return front_ops.banded_front(*args)

    def fused(*args):
        raise AssertionError("the fused front has no layout for these taps")

    monkeypatch.setattr(pipeline_mod, "banded_front", banded)
    monkeypatch.setitem(pipeline_mod.FRONTS, "fused", fused)
    pipe = DemodPipeline(FskDemodConfig(*LONG_TAPS), block, device="cpu")
    step = pipe.make_batched_step_full()
    jpipe = JaxPipeline(JaxConfig(*LONG_TAPS), block, exact=False, use_atan_lut="free")
    jstep = jpipe.make_batched_step_full("scan")
    state, jstate = pipe.init_full_state(c), jpipe.init_full_state(c)
    x_all = gfsk_lanes(288000, 9600, 5000, 2 * block, c, 11)
    for k in range(2):
        x = x_all[:, :, k * block : (k + 1) * block].copy()
        state, sym, cnt = step(state, torch.from_numpy(x))
        jstate, jsym, jcnt = jstep(jstate, jnp.asarray(x))
        jsym, jcnt = np.asarray(jsym)[:c], np.asarray(jcnt)[:c]
        assert np.array_equal(cnt.sum(1).numpy(), jcnt.sum(1))
        for lane in range(c):
            got = np.concatenate([sym[lane, j, :n].numpy() for j, n in enumerate(cnt[lane].tolist())])
            want = np.concatenate([jsym[lane, j, :n] for j, n in enumerate(jcnt[lane].tolist())])
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 2
        assert jcnt.sum() > c * 0.9 * block / 2 / 15  # sps 15 after d = 2
    assert len(calls) == 2
