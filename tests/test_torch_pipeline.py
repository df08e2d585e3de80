"""The slice as a whole: the port's ``make_batched_step_full`` on the CPU.

- The four golden fixtures, scored with the reference's own policy: ±2 LSB
  (test/test_fsk_demod.c:43-48) and hard-decision agreement 1.0.
- The three input layouts give identical symbols (the same arithmetic).
- Two block sizes give the same symbol stream (exact: every FIR output and
  every clock step sees the same operands in the same order).
- JAX -> port hand-off: a state built by the JAX step carries into the
  port mid-stream; counts equal and symbols within ±2 LSB of the JAX step
  continuing (the two fronts differ by f32 rounding, see test_torch_front),
  without and with Doppler.
- Doppler through the whole step: the raw lucky7 pass against the
  golden symbols, at least 99.5% within ±2 LSB (tests/test_doppler.py's
  policy: the correction's trajectory differs from the golden's by
  float-level noise that the M&M loop can amplify at a few symbols), with a
  row-free lane bit-equal to the step without Doppler.
- The server's own call, ``make_batched_step_full("pallas", doppler=True,
  layout="fanout")``.
- The atan2 arctangent modes (``use_atan_lut`` False or "atan2") on the
  full-block step, every front taking the banded route: against JAX's
  banded step in the same mode (``jnp.arctan2``), y3 within 1e-5 (f32 FIRs
  summed in another order, ~3e-6 seen; JAX's FIRs at
  SDRM_FIR_PRECISION=highest), symbols within +-1 LSB and counts equal;
  against JAX's fused step (its kernel's ``atan2_poly``, interpret mode)
  within +-2 LSB; the three fronts the same bytes; y3 not the LUT's.  The
  four goldens in "atan2": within +-2 LSB with hard decisions 1.0, but for
  lucky7_nodc, whose clock lock over symbols 6319-6389 turns on the last
  ulp of y3 (the golden was recorded with the table): there torch.atan2
  moves 71 symbols up to 19 LSB (JAX's banded "atan2" step stays within 1
  LSB, its fused step's ``atan2_poly`` moves the same 71), so only that
  stretch may leave the bound.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdrmodem_tpu.dsp.fsk_demod import FskDemodConfig as JaxConfig
from sdrmodem_tpu.dsp.pipeline import DemodPipeline as JaxPipeline
from sdrmodem_tpu_torch import DemodPipeline, FskDemodConfig
from sdrmodem_tpu_torch.dsp.doppler import Doppler
from sdrmodem_tpu_torch.dsp.pipeline import DemodStateFull
from sdrmodem_tpu_torch.ops import front as front_ops
from sdrmodem_tpu_torch.utils.convert import (
    doppler_tables_from_numpy,
    full_state_from_numpy,
    segment_tables,
)
from sdrmodem_tpu_torch.utils.parity import (
    GOLDEN_CASES,
    NODC_STRETCH,
    atan2_golden_failures,
    demod_capture,
    golden_report,
)
from tests.test_torch_doppler import ARGS
from tests.test_torch_fir import one_thread  # noqa: F401 (torch on one thread)

LUCKY7 = (48000, 4800, 5000, 2, 2000, True)


def test_pipeline_defaults_to_cuda():
    """Without a device the pipeline goes to CUDA, and with no card it
    fails rather than carrying on on the CPU."""
    if torch.cuda.is_available():
        assert DemodPipeline(FskDemodConfig(*LUCKY7), 1024).device.type == "cuda"
    else:
        # a CPU-only build raises AssertionError, a CUDA build with no card RuntimeError
        with pytest.raises((AssertionError, RuntimeError)):
            DemodPipeline(FskDemodConfig(*LUCKY7), 1024)


@pytest.mark.parametrize("name,cfg,fin,fexp,block", GOLDEN_CASES, ids=[c[0] for c in GOLDEN_CASES])
def test_golden_fixture(resources_dir, name, cfg, fin, fexp, block):
    iq = np.fromfile(resources_dir / fin, dtype=np.complex64)
    golden = np.fromfile(resources_dir / fexp, dtype=np.int8)
    got = demod_capture(DemodPipeline(cfg, block, device="cpu"), iq)
    rep = golden_report(got, golden)
    assert rep["symbols"] >= 0.99 * len(golden)
    assert rep["hard_decision_agreement"] == 1.0
    assert rep["max_lsb"] <= 2, rep


def _stream(step, state, xs):
    out = []
    for x in xs:
        state, sym, cnt = step(state, x)
        out.append((sym, cnt))
    return out


def test_layouts_identical():
    c, block = 3, 2048
    pipe = DemodPipeline(FskDemodConfig(*LUCKY7), block, device="cpu")
    rng = np.random.default_rng(4)
    iqs = [rng.standard_normal((2, block)).astype(np.float32) for _ in range(2)]
    inputs = {
        "fanout": [torch.from_numpy(iq) for iq in iqs],
        "cm": [torch.from_numpy(np.ascontiguousarray(np.broadcast_to(iq, (c, 2, block)))) for iq in iqs],
        "tm": [torch.from_numpy(np.repeat(iq.T, c, axis=1)) for iq in iqs],
    }
    runs = {
        layout: _stream(pipe.make_batched_step_full(layout=layout), pipe.init_full_state(c), xs)
        for layout, xs in inputs.items()
    }
    for layout in ("cm", "tm"):
        for (sa, ca), (sb, cb) in zip(runs["fanout"], runs[layout]):
            assert torch.equal(sa, sb) and torch.equal(ca, cb)
    sym, cnt = runs["fanout"][0]
    assert sym.dtype == torch.int8 and cnt.dtype == torch.int32
    assert sym.shape[:2] == cnt.shape == (c, 1)
    assert cnt.min() > 150
    with pytest.raises(ValueError, match="unknown layout"):
        pipe.make_batched_step_full(layout="xy")
    with pytest.raises(ValueError, match="layout 'tm' takes"):
        pipe.make_batched_step_full(layout="tm")(pipe.init_full_state(c), inputs["cm"][0])


def test_block_size_invariant(resources_dir):
    iq = np.fromfile(resources_dir / "lucky7.expected.cf32", np.complex64)[:32768]
    a = demod_capture(DemodPipeline(FskDemodConfig(*LUCKY7), 4096, device="cpu"), iq)
    b = demod_capture(DemodPipeline(FskDemodConfig(*LUCKY7), 8192, device="cpu"), iq)
    assert len(a) > 3000
    assert np.array_equal(a, b)


def test_jax_state_hands_off_to_port(resources_dir, monkeypatch):
    monkeypatch.setenv("SDRM_FIR_PRECISION", "highest")
    iq = np.fromfile(resources_dir / "lucky7.expected.cf32", np.complex64)
    c, block = 4, 8192
    lanes = np.stack([iq[k * 7000 : k * 7000 + 4 * block] for k in range(c)], axis=1)

    def x_tm(k, cp):
        x = np.zeros((block, 2 * cp), np.float32)
        x[:, :c] = lanes[k * block : (k + 1) * block].real
        x[:, cp : cp + c] = lanes[k * block : (k + 1) * block].imag
        return x

    jpipe = JaxPipeline(JaxConfig(*LUCKY7), block, exact=False, use_atan_lut="free")
    jstep = jpipe.make_batched_step_full("scan", layout="tm")
    jstate = jpipe.init_full_state(c)
    for k in range(2):
        jstate, _, _ = jstep(jstate, jnp.asarray(x_tm(k, 128)))

    pipe = DemodPipeline(FskDemodConfig(*LUCKY7), block, device="cpu")
    step = pipe.make_batched_step_full(layout="tm")
    state = full_state_from_numpy(jax.tree.map(np.asarray, jstate), c, device="cpu")
    for k in range(2, 4):
        jstate, jsym, jcnt = jstep(jstate, jnp.asarray(x_tm(k, 128)))
        state, sym, cnt = step(state, torch.from_numpy(x_tm(k, c)))
        jcnt = np.asarray(jcnt)[:c]  # the JAX step returns all 128 padded lanes
        assert np.array_equal(cnt.numpy(), jcnt)
        diff = np.abs(sym.numpy().astype(np.int32) - np.asarray(jsym)[:c].astype(np.int32))
        assert diff.max() <= 2
        assert jcnt.sum() > c * 800  # 8192 samples / d 2 / sps 5 ≈ 819 a lane


def _symbols(sym, cnt, lane):
    sym, cnt = sym[lane].numpy(), cnt[lane].numpy()
    return np.concatenate([sym[k, :n] for k, n in enumerate(cnt)])


def test_doppler_step_golden(resources_dir):
    """The raw pass through the Doppler step (layout "cm"): lane 0 mixed on
    the device by rows every 2000 samples (the goldens' buffer), lane 1 the
    pre-corrected capture with no rows."""
    iq = np.fromfile(resources_dir / "lucky7.cf32", dtype=np.complex64)
    pre = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)
    golden = np.fromfile(resources_dir / "lucky7.expected.s8", dtype=np.int8)
    block = 8000
    assert len(iq) % block == 0
    pipe = DemodPipeline(FskDemodConfig(*LUCKY7), block, device="cpu")
    step = pipe.make_batched_step_full("pallas", doppler=True, layout="cm")
    plain = pipe.make_batched_step_full("pallas", layout="cm")
    state = state_p = pipe.init_full_state(2)
    dop = Doppler(**ARGS)
    s_rows = Doppler.max_rows(block, ARGS["sampling_freq"], 2000)
    out0, out1, ref1 = [], [], []
    for i in range(0, len(iq), block):
        rows = dop.device_segments(block, +1, max_batch=2000)
        tables = doppler_tables_from_numpy(segment_tables({0: rows}, s_rows, 2), 2, device="cpu")
        x = np.stack([
            np.stack([iq[i : i + block].real, iq[i : i + block].imag]),
            np.stack([pre[i : i + block].real, pre[i : i + block].imag]),
        ]).astype(np.float32)
        state, sym, cnt = step(state, torch.from_numpy(x), tables)
        state_p, sym_p, cnt_p = plain(state_p, torch.from_numpy(x))
        out0.append(_symbols(sym, cnt, 0))
        out1.append(_symbols(sym, cnt, 1))
        ref1.append(_symbols(sym_p, cnt_p, 1))
    got = np.concatenate(out0)
    rep = golden_report(got, golden)
    n = min(len(got), len(golden))
    within = float((np.abs(got[:n].astype(np.int32) - golden[:n].astype(np.int32)) <= 2).mean())
    print(f"lucky7 raw pass through the Doppler step: {rep}, within ±2 LSB {within:.5f}")
    assert rep["symbols"] >= 0.99 * len(golden)
    assert within >= 0.995
    assert rep["hard_decision_agreement"] >= 0.99
    np.testing.assert_array_equal(np.concatenate(out1), np.concatenate(ref1))


def test_jax_state_hands_off_to_port_with_doppler(resources_dir, monkeypatch):
    """The raw pass on 2 lanes with their own Doppler rows (block 4096): two
    blocks through the JAX step, then the state and each block's tables
    carried into the port.  The JAX reference mixes with its in-kernel stage,
    whose ramp is one ulp of phase off the port's (test_torch_front), so
    this holds the slice, not the bits."""
    monkeypatch.setenv("SDRM_FIR_PRECISION", "highest")
    iq = np.fromfile(resources_dir / "lucky7.cf32", np.complex64)
    c, block = 2, 4096
    lanes = np.stack([iq[k * 5000 : k * 5000 + 4 * block] for k in range(c)], axis=1)
    dops = [Doppler(**{**ARGS, "constant_offset": 500 * k}) for k in range(c)]
    s_rows = Doppler.max_rows(block, ARGS["sampling_freq"])

    def x_tm(k, cp):
        x = np.zeros((block, 2 * cp), np.float32)
        x[:, :c] = lanes[k * block : (k + 1) * block].real
        x[:, cp : cp + c] = lanes[k * block : (k + 1) * block].imag
        return x

    tables = [
        segment_tables({lane: d.device_segments(block, +1) for lane, d in enumerate(dops)}, s_rows, 128)
        for _ in range(4)
    ]
    jpipe = JaxPipeline(JaxConfig(*LUCKY7), block, exact=False, use_atan_lut="free")
    jstep = jpipe.make_batched_step_full("scan", doppler=True, layout="tm")
    jstate = jpipe.init_full_state(c)
    for k in range(2):
        jstate, _, _ = jstep(jstate, jnp.asarray(x_tm(k, 128)), tuple(map(jnp.asarray, tables[k])))

    pipe = DemodPipeline(FskDemodConfig(*LUCKY7), block, device="cpu")
    step = pipe.make_batched_step_full("pallas", doppler=True, layout="tm")
    state = full_state_from_numpy(jax.tree.map(np.asarray, jstate), c, device="cpu")
    for k in range(2, 4):
        jstate, jsym, jcnt = jstep(jstate, jnp.asarray(x_tm(k, 128)), tuple(map(jnp.asarray, tables[k])))
        dop = doppler_tables_from_numpy(tables[k], c, device="cpu")
        state, sym, cnt = step(state, torch.from_numpy(x_tm(k, c)), dop)
        jcnt = np.asarray(jcnt)[:c]
        assert np.array_equal(cnt.numpy(), jcnt)
        diff = np.abs(sym.numpy().astype(np.int32) - np.asarray(jsym)[:c].astype(np.int32))
        assert diff.max() <= 2
        assert jcnt.sum() > c * 400  # 4096 samples / d 2 / sps 5 ≈ 410 a lane


def test_server_call_runs_on_the_port():
    """``BatchedRxGroup``'s pipeline and call as written (session.py:342,
    388-390): ``DemodPipeline(cfg, block, exact=False, use_atan_lut="free")``
    stepped with the shared (2, B) stream on 3 lanes, Doppler rows on lanes
    0 and 2.  ``clock_backend="scan"`` gives the same bits."""
    block, c = 2048, 3
    pipe = DemodPipeline(FskDemodConfig(*LUCKY7), block, exact=False, use_atan_lut="free", device="cpu")
    step = pipe.make_batched_step_full("pallas", doppler=True, layout="fanout")
    scan = pipe.make_batched_step_full("scan", doppler=True, layout="fanout")
    plain = pipe.make_batched_step_full("pallas", layout="fanout")
    s_rows = Doppler.max_rows(block, ARGS["sampling_freq"])
    dops = {0: Doppler(**ARGS), 2: Doppler(**{**ARGS, "constant_offset": 1500})}
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, block)).astype(np.float32))
    state = state_s = state_p = pipe.init_full_state(c)
    for _ in range(2):
        rows = {lane: d.device_segments(block, +1) for lane, d in dops.items()}
        dop = doppler_tables_from_numpy(segment_tables(rows, s_rows, c), c, device="cpu")
        state, sym, cnt = step(state, x, dop)
        state_s, sym_s, cnt_s = scan(state_s, x, dop)
        state_p, sym_p, cnt_p = plain(state_p, x)
        assert sym.dtype == torch.int8 and sym.shape[:2] == cnt.shape == (c, 1)
        assert torch.equal(sym, sym_s) and torch.equal(cnt, cnt_s)
        assert all(torch.equal(a, b) for a, b in zip(state.clock, state_s.clock))
        assert torch.equal(sym[1], sym_p[1]) and torch.equal(cnt[1], cnt_p[1])
        assert not torch.equal(sym[0], sym[1]) and not torch.equal(sym[0], sym[2])
    # front="step" (B7) takes blocks of whole clock chunks, d * 1024 = 2048
    # rows here; elsewhere, and with the scan clock, it runs "fused", as in
    # the JAX package
    uneven = DemodPipeline(FskDemodConfig(*LUCKY7), 3072, device="cpu")
    assert not uneven.fused_step_available(c)
    x3 = torch.from_numpy(np.random.default_rng(10).standard_normal((2, 3072)).astype(np.float32))
    for backend in ("pallas", "scan"):
        runs = [uneven.make_batched_step_full(backend, layout="fanout", front=f)(uneven.init_full_state(c), x3)
                for f in ("step", "fused")]
        assert torch.equal(runs[0][1], runs[1][1]) and torch.equal(runs[0][2], runs[1][2])
    with pytest.raises(ValueError, match="unknown front"):
        pipe.make_batched_step_full("pallas", front="xy")
    with pytest.raises(ValueError, match="ends"):
        bad = (dop[0], dop[1][:, :2].contiguous(), dop[2], dop[3])
        step(state, x, bad)
    cfg = FskDemodConfig(*LUCKY7)
    with pytest.raises(ValueError, match="float32-only"):
        DemodPipeline(cfg, block, exact=True, device="cpu").make_batched_step_full("pallas")
    # the atan2 modes run on every front (the banded route), as in the JAX package
    for mode in (False, "atan2"):
        atan = DemodPipeline(cfg, block, use_atan_lut=mode, device="cpu")
        for front in ("fused", "banded", "step"):
            _, sym_a, cnt_a = atan.make_batched_step_full(layout="fanout", front=front)(
                atan.init_full_state(c), x)
            assert sym_a.shape[0] == cnt_a.shape[0] == c and int(cnt_a.sum()) > 0
    with pytest.raises(ValueError, match="arctangent mode 'null'"):
        DemodPipeline(cfg, block, use_atan_lut="null", device="cpu")
    # the ragged path takes any block; the full-block path needs block % d == 0
    odd = DemodPipeline(cfg, 1001, device="cpu")
    assert odd.streamer().process(np.zeros(1500, np.complex64)).dtype == np.int8
    for make in (odd.init_full_state, lambda c: odd.make_batched_step_full()):
        with pytest.raises(ValueError, match="block % decimation"):
            make(2)


# ---- the atan2 arctangent modes on the full-block step

NAN_CFG = (240000, 9600, 5000, 1, 2000, True)
# config, capture, blocks, samples between lanes' starts: lucky7 over two
# blocks, lanes 1000 samples apart; the nan capture as its golden takes it,
# one block of 4096 on every lane (rolled, its ~3.4e38 samples overflow
# where the two packages' FIRs round apart, in either arctangent mode)
ATAN2_CASES = {"lucky7": (LUCKY7, "lucky7.expected.cf32", 2, 1000), "nan": (NAN_CFG, "inputnan.cf32", 1, 0)}
ATAN2_LANES, ATAN2_BLOCK = 4, 4096
ATAN2_Y3_ATOL = 1e-5


def _atan2_blocks(resources_dir, name, cp):
    """The case's time-major (B, 2cp) blocks, lanes past ATAN2_LANES zero
    (JAX pads to cp)."""
    _, fin, blocks, apart = ATAN2_CASES[name]
    iq = np.fromfile(resources_dir / fin, np.complex64)
    n = blocks * ATAN2_BLOCK
    lanes = np.stack([np.resize(np.roll(iq, -apart * k), n) for k in range(ATAN2_LANES)], axis=1)
    out = []
    for b in range(blocks):
        x = np.zeros((ATAN2_BLOCK, 2 * cp), np.float32)
        part = lanes[b * ATAN2_BLOCK : (b + 1) * ATAN2_BLOCK]
        x[:, :ATAN2_LANES], x[:, cp : cp + ATAN2_LANES] = part.real, part.imag
        out.append(x)
    return out


@pytest.fixture(scope="module")
def jax_atan2(resources_dir):
    """JAX's "atan2" runs, once: y3 of the banded front and the symbols of
    its banded and fused steps (``clock_backend="scan"``, interpret mode)."""
    refs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SDRM_FIR_PRECISION", "highest")
        for name, (cfg, *_) in ATAN2_CASES.items():
            jpipe = JaxPipeline(JaxConfig(*cfg), ATAN2_BLOCK, exact=False, use_atan_lut="atan2")
            xs = [jnp.asarray(x) for x in _atan2_blocks(resources_dir, name, 128)]
            st = jpipe.init_full_state(ATAN2_LANES)
            y3s = []
            for x in xs:
                front, y3 = jpipe._front_batched_full(st, x, interpret=True)
                st = st._replace(lpf1_hist=front[0], quad_prev=front[1], lpf2_hist=front[2], dc_hist=front[3])
                y3s.append(np.asarray(y3)[:, :ATAN2_LANES])
            runs = {}
            for front in ("banded", "fused"):
                step = jpipe.make_batched_step_full("scan", interpret=True, layout="tm", front=front)
                st = jpipe.init_full_state(ATAN2_LANES)
                runs[front] = []
                for x in xs:
                    st, sym, cnt = step(st, x)
                    runs[front].append((np.asarray(sym)[:ATAN2_LANES], np.asarray(cnt)[:ATAN2_LANES]))
            refs[name] = dict(y3=y3s, **runs)
    return refs


def _port_atan2_run(resources_dir, name, mode="atan2", front="banded"):
    """The port's step in ``mode`` over the case's blocks: (y3s, [(symbols,
    counts)]) with the banded front's y3 a block."""
    pipe = DemodPipeline(FskDemodConfig(*ATAN2_CASES[name][0]), ATAN2_BLOCK, use_atan_lut=mode, device="cpu")
    xs = [torch.from_numpy(x) for x in _atan2_blocks(resources_dir, name, ATAN2_LANES)]
    step = pipe.make_batched_step_full("scan", layout="tm", front=front)
    st = fst = pipe.init_full_state(ATAN2_LANES)
    y3s, runs = [], []
    for x in xs:
        y3, front_state = front_ops.banded_front(x, *fst[:4], pipe.front_taps)
        fst = DemodStateFull(*front_state, fst.clock)
        y3s.append(y3.numpy())
        st, sym, cnt = step(st, x)
        runs.append((sym.numpy(), cnt.numpy()))
    return y3s, runs


def _lanes_of(runs, lane):
    return np.concatenate([sym[lane, t, : cnt[lane, t]] for sym, cnt in runs for t in range(cnt.shape[1])])


@pytest.mark.parametrize("name", list(ATAN2_CASES))
def test_atan2_step_matches_jax_banded(resources_dir, jax_atan2, name):
    """The port's banded step in "atan2" against JAX's banded step in the
    same mode: y3 within ATAN2_Y3_ATOL where both are finite (lucky7's
    everywhere), counts equal, symbols within +-1 LSB; and y3 is not the
    LUT's, so the mode reaches the quad stage."""
    ref = jax_atan2[name]
    y3s, runs = _port_atan2_run(resources_dir, name)
    lut_y3s, _ = _port_atan2_run(resources_dir, name, mode=True)
    for y3, jy3, lut in zip(y3s, ref["y3"], lut_y3s):
        both = np.isfinite(y3) & np.isfinite(jy3)
        assert both.all() if name == "lucky7" else both.any()
        np.testing.assert_allclose(y3[both], jy3[both], rtol=0, atol=ATAN2_Y3_ATOL)
        assert not np.array_equal(y3[both], lut[both])
    for (sym, cnt), (jsym, jcnt) in zip(runs, ref["banded"]):
        np.testing.assert_array_equal(cnt, jcnt)
    for lane in range(ATAN2_LANES):
        got, want = _lanes_of(runs, lane), _lanes_of(ref["banded"], lane)
        assert len(got) > 0
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1, f"lane {lane}"


@pytest.mark.parametrize("name", list(ATAN2_CASES))
def test_atan2_step_within_two_lsb_of_jax_fused(resources_dir, jax_atan2, name):
    """Against JAX's fused step, whose kernel takes ``atan2_poly``: the same
    counts a lane and symbols within +-2 LSB."""
    _, runs = _port_atan2_run(resources_dir, name, front="fused")
    for lane in range(ATAN2_LANES):
        got, want = _lanes_of(runs, lane), _lanes_of(jax_atan2[name]["fused"], lane)
        assert len(got) == len(want) > 0
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 2, f"lane {lane}"


@pytest.mark.parametrize("mode", [False, "atan2"])
def test_atan2_fronts_take_the_banded_route(resources_dir, mode):
    """In either atan2 mode ``front="fused"`` and ``"step"`` run the banded
    front (B1 and B7 take the table only) and give its bytes; the fused
    kernels' wrappers refuse the mode."""
    pipe = DemodPipeline(FskDemodConfig(*LUCKY7), ATAN2_BLOCK, use_atan_lut=mode, device="cpu")
    assert not pipe.fused_front_available() and not pipe.fused_step_available(ATAN2_LANES, 256)
    runs = {front: _port_atan2_run(resources_dir, "lucky7", mode, front)[1] for front in ("banded", "fused", "step")}
    for front in ("fused", "step"):
        for (sym, cnt), (bsym, bcnt) in zip(runs[front], runs["banded"]):
            np.testing.assert_array_equal(sym, bsym)
            np.testing.assert_array_equal(cnt, bcnt)
    st = pipe.init_full_state(ATAN2_LANES)
    x = torch.zeros((ATAN2_BLOCK, 2 * ATAN2_LANES))
    with pytest.raises(ValueError, match="LUT arctangent only"):
        front_ops.fused_front(x, *st[:4], pipe.front_taps)


def test_quad_stage_carries_the_mode():
    """The quad stage's plain version is ``atan2_dispatch`` in the taps'
    mode: torch.atan2 with (0, 0) -> 0 where ``atan_lut`` is False, the
    table where it is True."""
    from sdrmodem_tpu_torch.dsp.elementwise import atan2_dispatch

    rng = np.random.default_rng(3)
    y1 = torch.from_numpy(rng.standard_normal((64, 2 * ATAN2_LANES)).astype(np.float32))
    y1[5:9] = 0.0  # (0, 0) products
    prev = torch.from_numpy(rng.standard_normal((1, 2 * ATAN2_LANES)).astype(np.float32))
    taps = DemodPipeline(FskDemodConfig(*LUCKY7), 64, device="cpu").front_taps
    c = ATAN2_LANES
    shifted = torch.cat([prev, y1[:-1]])
    re = y1[:, :c] * shifted[:, :c] + y1[:, c:] * shifted[:, c:]
    im = y1[:, c:] * shifted[:, :c] - y1[:, :c] * shifted[:, c:]
    for lut in (True, False):
        got = front_ops.quad_demod(y1, prev, taps._replace(atan_lut=lut))
        want = taps.quad_gain * atan2_dispatch(im, re, lut, taps.atan_table)
        assert torch.equal(got, want)
    atan = front_ops.quad_demod(y1, prev, taps._replace(atan_lut=False))
    assert torch.equal(atan[5:8], torch.zeros_like(atan[5:8]))
    assert torch.equal(atan, taps.quad_gain * torch.where((im == 0) & (re == 0), 0.0, torch.atan2(im, re)))
    assert not torch.equal(atan, front_ops.quad_demod(y1, prev, taps))


@pytest.mark.parametrize("name,cfg,fin,fexp,block", GOLDEN_CASES, ids=[c[0] for c in GOLDEN_CASES])
def test_atan2_golden_fixture(resources_dir, name, cfg, fin, fexp, block):
    """The goldens through the "atan2" step (the banded route): every
    fixture within +-2 LSB, hard decisions 1.0, but lucky7_nodc's
    ``NODC_STRETCH``."""
    iq = np.fromfile(resources_dir / fin, dtype=np.complex64)
    golden = np.fromfile(resources_dir / fexp, dtype=np.int8)
    rep = golden_report(demod_capture(DemodPipeline(cfg, block, use_atan_lut="atan2", device="cpu"), iq), golden)
    assert atan2_golden_failures(name, rep) == [], rep
    if name == "lucky7_nodc" and rep["beyond_tol_span"] is not None:
        assert rep["beyond_tol_rate"] <= (NODC_STRETCH[1] - NODC_STRETCH[0] + 1) / len(golden)
    bad = dict(rep, beyond_tol_span=[100, 120], max_lsb=5)
    assert atan2_golden_failures(name, bad)  # anywhere else the bound holds


def test_kernel_arguments_are_contiguous(monkeypatch):
    """What the wrappers hand a kernel is contiguous (the kernels read each
    tensor through its pointer; the plain versions would not notice): the
    "cm" layout at one channel, and a batched ``FskDemodulator``'s fresh
    clock state (expanded leaves) on its way to B4."""
    from sdrmodem_tpu_torch import FskDemodulator
    from sdrmodem_tpu_torch.dsp import clock_recovery

    pipe = DemodPipeline(FskDemodConfig(*LUCKY7), 2048, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 2, 2048)).astype(np.float32))
    assert pipe.to_time_major(x, 1, "cm").is_contiguous()
    real = clock_recovery.clock_mm_tpu
    seen = []

    def checked(*args, **kw):
        seen.extend(a.is_contiguous() for a in args if isinstance(a, torch.Tensor))
        return real(*args, **kw)

    monkeypatch.setattr(clock_recovery, "clock_mm_tpu", checked)
    iq = np.random.default_rng(0).standard_normal((4, 4096)) + 1j * np.random.default_rng(1).standard_normal((4, 4096))
    FskDemodulator(FskDemodConfig(*LUCKY7), exact=False, device="cpu").process(iq.astype(np.complex64))
    assert seen and all(seen)
