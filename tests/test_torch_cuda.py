"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and nvcc; without them they skip.  Run them
on a machine with the card: ``python -m pytest tests/test_torch_cuda.py``.
Small sizes; ``chip_smoke.py`` repeats the comparison at the main path's.

Tolerances: the front's y3 and FIR tails within 1e-4 (both sum each FIR
in tap order with one rounding a tap, the plain version through float64,
which can round a tie twice); lpf1_hist (a copy of the input) and
quad_prev (the last LPF1 row) exact.  The clock, fed the same y3, is
exact: both sum the interpolator in tap order and neither contracts a
multiply and an add.
"""

import numpy as np
import pytest
import torch

from sdrmodem_tpu_torch.dsp.clock_recovery import chunk_plan, clock_mm_batched_full
from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline, DemodStateFull
from sdrmodem_tpu_torch.ops import clock as clock_ops
from sdrmodem_tpu_torch.ops import front as front_ops

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
        # a FIR kernel for each of LPF1, LPF2 and the DC blocker, one quad demod
        assert front_ops.launches == n0 + (4 if CONFIGS[name][5] else 3)
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
