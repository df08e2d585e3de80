"""The port's M&M clock (ops/clock.py, the module holding the B2 kernel)
against the JAX package's table-indexed scan (clock_recovery.py
backend="scan", the plain reference of the chunked TPU kernel).

Both clocks get the same y3, from the JAX front on real captures.
Tolerances: counts per chunk and the final resid are equal; int8 symbols
within ±1 LSB and the final omega/mu within 1e-5, because the 8-tap
interpolator's dot product is summed in another order (≤ 1 ulp a symbol).

On lucky7_nodc the clock's lock at symbols ~6300-6400 turns on the last
ulp of y3 and of the interpolator's sum.  There the two clocks are crossed
with the two fronts: counts are equal, the port's clock holds the
reference's ±2 LSB (test/test_fsk_demod.c:43-48) on either front's y3, and
the JAX scan clock holds it on the port front's.  (On the JAX front's y3
the JAX scan clock re-locks over that stretch, as the JAX package records
for its TPU run, BASELINE.md:183-197; ``pytest -s`` prints both clocks'
scores.)
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdrmodem_tpu.dsp.clock_recovery import clock_mm_batched_full as jax_clock
from sdrmodem_tpu.dsp.clock_recovery import initial_full_state as jax_initial
from sdrmodem_tpu.dsp.fsk_demod import FskDemodConfig as JaxConfig
from sdrmodem_tpu.dsp.fsk_demod import float_to_int8 as jax_to_int8
from sdrmodem_tpu.dsp.pipeline import DemodPipeline as JaxPipeline
from sdrmodem_tpu.dsp.pipeline import DemodStateFull as JaxState
from sdrmodem_tpu_torch.dsp.clock_recovery import clock_mm_batched_full, initial_full_state
from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig, float_to_int8
from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline, DemodStateFull
from sdrmodem_tpu_torch.dsp.taps import mmse_interp_taps
from sdrmodem_tpu_torch.ops import clock as clock_ops
from sdrmodem_tpu_torch.ops import front as front_ops
from sdrmodem_tpu_torch.utils.parity import golden_report
from tests.test_torch_fir import one_thread  # noqa: F401 (torch on one thread)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
LUCKY7 = (48000, 4800, 5000, 2, 2000, True)
NODC = (48000, 4800, 5000, 2, 2000, False)
NAN = (240000, 9600, 5000, 1, 2000, True)
BANK = torch.from_numpy(mmse_interp_taps().copy())


def _jax_y3(cfg_args, iq_lanes: np.ndarray, block: int, monkeypatch) -> list[np.ndarray]:
    """y3 blocks of the JAX fused front (interpret mode) for (N, C) complex lanes."""
    monkeypatch.setenv("SDRM_FIR_PRECISION", "highest")
    pipe = JaxPipeline(JaxConfig(*cfg_args), block, exact=False, use_atan_lut="free")
    c = iq_lanes.shape[1]
    state = pipe.init_full_state(c)
    out = []
    for s in range(0, iq_lanes.shape[0], block):
        x = np.zeros((block, 256), np.float32)
        x[:, :c] = iq_lanes[s : s + block].real
        x[:, 128 : 128 + c] = iq_lanes[s : s + block].imag
        front, y3 = pipe._front_fused_full(state, jnp.asarray(x), interpret=True)
        state = JaxState(*front, state.clock)
        out.append(np.asarray(y3)[:, :c])
    return out


def _run_both(cfg_args, y3_blocks):
    """Both clocks over the same y3 blocks with carried state; yields each
    block's (jax, port) results."""
    p = JaxConfig(*cfg_args).clock_params()
    c = y3_blocks[0].shape[1]
    jstate = jax_initial(p["omega"], c, p["mu"])
    state = initial_full_state(p["omega"], c, p["mu"], device="cpu")
    for y3 in y3_blocks:
        jouts, jcounts, jstate = jax_clock(jnp.asarray(y3), jstate, backend="scan", **p)
        outs, counts, state = clock_mm_batched_full(torch.tensor(y3), state, bank=BANK, **p)
        yield (jouts, jcounts, jstate), (outs, counts, state)


def test_clock_plain_matches_jax_scan(monkeypatch):
    iq = np.fromfile(FIXTURES / "lucky7.expected.cf32", np.complex64)
    block, c = 8192, 4
    lanes = np.stack([iq[k * 9000 : k * 9000 + 2 * block] for k in range(c)], axis=1)
    y3_blocks = _jax_y3(LUCKY7, lanes, block, monkeypatch)
    before = clock_ops.launches
    total = 0
    for (jouts, jcounts, jstate), (outs, counts, state) in _run_both(LUCKY7, y3_blocks):
        jcounts = np.asarray(jcounts)
        assert counts.shape == jcounts.shape == (c, 2)  # 4096 rows in 2048-row chunks
        assert np.array_equal(counts.numpy(), jcounts)
        jsym = np.asarray(jax_to_int8(jouts)).astype(np.int32)
        sym = float_to_int8(outs).numpy().astype(np.int32)
        for lane in range(c):
            for k, n in enumerate(jcounts[lane]):
                assert n > 0
                assert np.abs(sym[lane, k, :n] - jsym[lane, k, :n]).max() <= 1
                total += n
        assert np.array_equal(state.resid.numpy(), np.asarray(jstate.resid))
        np.testing.assert_allclose(state.omega.numpy(), np.asarray(jstate.omega), rtol=0, atol=1e-5)
        np.testing.assert_allclose(state.mu.numpy(), np.asarray(jstate.mu), rtol=0, atol=1e-5)
        assert np.array_equal(state.suffix.numpy(), np.asarray(jstate.suffix))
        assert not state.overflow.any()
    assert total > 4 * 1500  # ~sps 5: every lane really emitted its symbols
    assert clock_ops.launches == before  # the CPU runs the plain version


def test_clock_nan_branch_counts_match_jax():
    """The NaN fixture's y3 from the port's front: its FIRs keep each NaN
    (and each inf - inf of the capture's 1e32-scale samples) to the
    windows that hold it, so most rows are NaN and the clock takes its NaN
    branch.  (The JAX fused front zeroes this capture instead: its banded
    matmul spreads a NaN over whole tiles, and its arctangent maps
    atan2(NaN, NaN) to 0.)"""
    iq = np.fromfile(FIXTURES / "inputnan.cf32", np.complex64)
    pipe = DemodPipeline(FskDemodConfig(*NAN), 4096, device="cpu")
    state = pipe.init_full_state(1)
    x = torch.from_numpy(np.stack([iq.real, iq.imag], axis=1).astype(np.float32))
    y3, _ = front_ops.fused_front(
        x, state.lpf1_hist, state.quad_prev, state.lpf2_hist, state.dc_hist, pipe.front_taps
    )
    y3_blocks = [y3.numpy()]
    assert 1000 < np.isnan(y3_blocks[0]).sum() < 4096
    for (jouts, jcounts, jstate), (outs, counts, state) in _run_both(NAN, y3_blocks):
        assert np.array_equal(counts.numpy(), np.asarray(jcounts))
        assert counts.sum() > 0
        assert np.array_equal(state.resid.numpy(), np.asarray(jstate.resid))
        jsym = np.asarray(jax_to_int8(jouts)).astype(np.int32)
        assert np.abs(float_to_int8(outs).numpy().astype(np.int32) - jsym).max() <= 1


@pytest.mark.parametrize("front", ["jax", "port"])
def test_nodc_clocks_agree_on_either_front(front, monkeypatch):
    """The witness for the nodc stretch: the JAX scan clock and the port's
    clock on one front's y3, over the capture's first 8 blocks of 8192
    (symbols 0-6550, past the stretch)."""
    block, n_blocks = 8192, 8
    iq = np.fromfile(FIXTURES / "lucky7.expected.cf32", np.complex64)[: n_blocks * block]
    golden = np.fromfile(FIXTURES / "lucky7.expected.nodc.s8", np.int8).astype(np.int32)
    if front == "jax":
        y3_blocks = _jax_y3(NODC, iq[:, None], block, monkeypatch)
    else:
        pipe = DemodPipeline(FskDemodConfig(*NODC), block, device="cpu")
        state = pipe.init_full_state(1)
        y3_blocks = []
        for k in range(n_blocks):
            x = iq[k * block : (k + 1) * block]
            x = torch.from_numpy(np.stack([x.real, x.imag], axis=1))
            y3, fr = front_ops.fused_front(x, *state[:4], pipe.front_taps)
            state = DemodStateFull(*fr, state.clock)
            y3_blocks.append(y3.numpy())
    jsyms, syms = [], []
    for (jouts, jcounts, _), (outs, counts, _) in _run_both(NODC, y3_blocks):
        jcounts = np.asarray(jcounts)
        assert np.array_equal(counts.numpy(), jcounts)
        jsym = np.asarray(jax_to_int8(jouts))[0].astype(np.int32)
        sym = float_to_int8(outs)[0].numpy().astype(np.int32)
        jsyms += [jsym[k, :n] for k, n in enumerate(jcounts[0])]
        syms += [sym[k, :n] for k, n in enumerate(jcounts[0])]
    jsyms, syms = np.concatenate(jsyms), np.concatenate(syms)
    assert len(syms) > 6400
    reports = {
        clock: golden_report(got.astype(np.int8), golden[: len(got)].astype(np.int8))
        for clock, got in (("port", syms), ("jax_scan", jsyms))
    }
    print(f"nodc, {front} front's y3: {reports}")
    assert reports["port"]["max_lsb"] <= 2
    if front == "port":
        assert reports["jax_scan"]["max_lsb"] <= 2
        assert np.abs(syms - jsyms).max() <= 1


def _symbols(outs, counts, lane=0):
    sym = float_to_int8(outs)[lane]
    return torch.cat([sym[k, :n] for k, n in enumerate(counts[lane].tolist())])


@pytest.mark.parametrize("small_chunk", ["512", "64"])
def test_clock_chunk_size_invariant(monkeypatch, small_chunk):
    """The chunk partition moves symbols between output rows, never changes
    them: the same stream and the same final state at any SDRM_CLOCK_CHUNK."""
    rng = np.random.default_rng(2)
    # a noisy two-level signal at sps 5, so the loop locks and strides vary
    bits = np.repeat(rng.choice([-1.0, 1.0], 900), 5)
    y3 = torch.from_numpy((bits + 0.3 * rng.standard_normal(bits.size)).astype(np.float32)[:, None].repeat(3, 1))
    p = JaxConfig(*LUCKY7).clock_params()
    results = []
    for chunk in ("2048", small_chunk):
        monkeypatch.setenv("SDRM_CLOCK_CHUNK", chunk)
        state = initial_full_state(p["omega"], 3, p["mu"], device="cpu")
        syms = []
        for half in (y3[:2250], y3[2250:]):
            outs, counts, state = clock_mm_batched_full(half, state, bank=BANK, **p)
            syms.append(_symbols(outs, counts))
        results.append((torch.cat(syms), state))
    (a, sa), (b, sb) = results
    assert len(a) > 800
    assert torch.equal(a, b)
    for x, y in zip(sa, sb):
        assert torch.equal(x, y)


def _scaled_lane_y3():
    """5 lanes x 4096 rows of a noisy two-level signal at sps 5, lane 2
    scaled by 1e4: there gain_mu * mm runs in the hundreds, so strides run
    backwards past a chunk's first row and jump past whole chunks."""
    rng = np.random.default_rng(0)
    bits = np.repeat(rng.choice([-1.0, 1.0], (4096 // 5 + 8, 5)), 5, axis=0)[:4096]
    y = (bits + 0.2 * rng.standard_normal((4096, 5))).astype(np.float32)
    y[:, 2] *= 1e4
    return y


def test_chunked_plain_equals_scan_backend_on_scaled_lane(monkeypatch):
    """B2's plain version (``clock_mm_batched_full`` "pallas" on the CPU)
    and the scan backend (B4's plain walk a chunk) walk each chunk in its
    own work buffer [suffix | chunk], so they agree bit for bit even where
    a stride runs back past the chunk's first row, read there as the
    buffer's first row.  The strides are recorded to show that lane 2
    reaches that row (a read position below 0 in its chunk's buffer) and
    the other lanes never do."""
    monkeypatch.setenv("SDRM_CLOCK_CHUNK", "256")
    y3 = torch.from_numpy(_scaled_lane_y3())
    p = JaxConfig(*LUCKY7).clock_params()
    state = initial_full_state(p["omega"], 5, p["mu"], device="cpu")
    strides, step = [], clock_ops._mm_step_plain

    def recorded(*args):
        out = step(*args)
        strides.append(out[1])
        return out

    monkeypatch.setattr(clock_ops, "_mm_step_plain", recorded)
    outs, counts, fin = clock_mm_batched_full(y3, state, bank=BANK, **p)
    monkeypatch.setattr(clock_ops, "_mm_step_plain", step)
    s_outs, s_counts, s_fin = clock_mm_batched_full(y3, state, bank=BANK, backend="scan", **p)
    assert torch.equal(outs, s_outs) and torch.equal(counts, s_counts)
    for a, b in zip(fin, s_fin):
        assert torch.equal(a, b)

    # each chunk's read positions in its own buffer, from the recorded strides
    sfx, k = state.suffix.shape[0], outs.shape[2]
    ii, lowest = sfx - state.resid.long(), []
    for t, chunk_strides in enumerate(torch.stack(strides).split(k)):
        pos = ii + chunk_strides.cumsum(0)
        lowest.append(torch.minimum(ii, pos.min(0).values))
        ii = sfx - torch.clamp(sfx + min(256, 4096 - 256 * t) - pos[-1], max=sfx - 1)
    lowest = torch.stack(lowest).min(0).values
    assert lowest[2] < 0 and (lowest[[0, 1, 3, 4]] >= 0).all()
    assert counts.shape == (5, 16) and counts.sum() > 4 * 700


def test_clock_matches_jax_scan_on_scaled_lane(monkeypatch):
    """The scaled-lane input through JAX's scan backend (``_clock_full_one``
    chunk by chunk) and the port's clock, held as in
    ``test_clock_plain_matches_jax_scan`` on the four lanes at their
    natural scale.  Lane 2 is not held to JAX: with gain_mu * mm in the
    hundreds a 1-ulp difference of the interpolator's sum order (JAX's dot,
    the port's tap order) flips rint(mu * 128) or floor(mu) within a few
    hundred symbols, and the two trajectories part (ROADMAP §C); the port's
    plain and scan backends, which share the arithmetic, agree on it bit
    for bit (the test above)."""
    monkeypatch.setenv("SDRM_CLOCK_CHUNK", "256")
    y3 = _scaled_lane_y3()
    (jouts, jcounts, jstate), (outs, counts, state) = next(_run_both(LUCKY7, [y3]))
    lanes = [0, 1, 3, 4]
    jcounts = np.asarray(jcounts)[lanes]
    assert np.array_equal(counts.numpy()[lanes], jcounts)
    jsym = np.asarray(jax_to_int8(jouts)).astype(np.int32)[lanes]
    sym = float_to_int8(outs).numpy().astype(np.int32)[lanes]
    for lane in range(len(lanes)):
        for k, n in enumerate(jcounts[lane]):
            assert np.abs(sym[lane, k, :n] - jsym[lane, k, :n]).max(initial=0) <= 1
    assert np.array_equal(state.resid.numpy()[lanes], np.asarray(jstate.resid)[lanes])
    for port, jax_v in ((state.omega, jstate.omega), (state.mu, jstate.mu)):
        np.testing.assert_allclose(port.numpy()[lanes], np.asarray(jax_v)[lanes], rtol=0, atol=1e-5)
    assert np.array_equal(state.suffix.numpy(), np.asarray(jstate.suffix))
    assert jcounts.sum() > 4 * 700
