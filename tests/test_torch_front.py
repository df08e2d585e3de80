"""The port's front end (ops/front.py, the module holding the B1 kernel)
against the JAX fused front kernel (ops/pallas_front.py) in interpret mode.

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
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdrmodem_tpu.dsp.fsk_demod import FskDemodConfig as JaxConfig
from sdrmodem_tpu.dsp.pipeline import DemodPipeline as JaxPipeline
from sdrmodem_tpu.dsp.pipeline import DemodStateFull as JaxState
from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline, DemodStateFull
from sdrmodem_tpu_torch.ops import front as front_ops
from sdrmodem_tpu_torch.utils.convert import full_state_from_numpy

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

        want = full_state_from_numpy(jax.tree.map(np.asarray, jstate), C)
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
