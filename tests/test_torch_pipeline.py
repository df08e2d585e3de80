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
from sdrmodem_tpu_torch.utils.convert import (
    doppler_tables_from_numpy,
    full_state_from_numpy,
    segment_tables,
)
from sdrmodem_tpu_torch.utils.parity import GOLDEN_CASES, demod_capture, golden_report
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
    for mode in (False, "atan2"):
        with pytest.raises(NotImplementedError, match="LUT arctangent only"):
            DemodPipeline(cfg, block, use_atan_lut=mode, device="cpu").make_batched_step_full()
    with pytest.raises(ValueError, match="arctangent mode 'null'"):
        DemodPipeline(cfg, block, use_atan_lut="null", device="cpu")
    # the ragged path takes any block; the full-block path needs block % d == 0
    odd = DemodPipeline(cfg, 1001, device="cpu")
    assert odd.streamer().process(np.zeros(1500, np.complex64)).dtype == np.int8
    for make in (odd.init_full_state, lambda c: odd.make_batched_step_full()):
        with pytest.raises(ValueError, match="block % decimation"):
            make(2)
