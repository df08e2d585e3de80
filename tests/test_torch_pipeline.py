"""The slice as a whole: the port's ``make_batched_step_full`` on the CPU.

- The four golden fixtures, scored with the reference's own policy: ±2 LSB
  (test/test_fsk_demod.c:43-48) and hard-decision agreement 1.0.
- The three input layouts give identical symbols (the same arithmetic).
- Two block sizes give the same symbol stream (exact: every FIR output and
  every clock step sees the same operands in the same order).
- JAX -> port hand-off: a state built by the JAX step carries into the
  port mid-stream; counts equal and symbols within ±2 LSB of the JAX step
  continuing (the two fronts differ by f32 rounding, see test_torch_front).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdrmodem_tpu.dsp.fsk_demod import FskDemodConfig as JaxConfig
from sdrmodem_tpu.dsp.pipeline import DemodPipeline as JaxPipeline
from sdrmodem_tpu_torch import DemodPipeline, FskDemodConfig
from sdrmodem_tpu_torch.utils.convert import full_state_from_numpy
from sdrmodem_tpu_torch.utils.parity import GOLDEN_CASES, demod_capture, golden_report

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
    state = full_state_from_numpy(jax.tree.map(np.asarray, jstate), c)
    for k in range(2, 4):
        jstate, jsym, jcnt = jstep(jstate, jnp.asarray(x_tm(k, 128)))
        state, sym, cnt = step(state, torch.from_numpy(x_tm(k, c)))
        jcnt = np.asarray(jcnt)[:c]  # the JAX step returns all 128 padded lanes
        assert np.array_equal(cnt.numpy(), jcnt)
        diff = np.abs(sym.numpy().astype(np.int32) - np.asarray(jsym)[:c].astype(np.int32))
        assert diff.max() <= 2
        assert jcnt.sum() > c * 800  # 8192 samples / d 2 / sps 5 ≈ 819 a lane
