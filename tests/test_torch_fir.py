"""The port's strided FIR (ops/fir.py, the module holding the B3 kernel and
its B8 face) against the JAX package's Pallas kernels in interpret mode.

- ``conv1d_banded_tm`` vs JAX ``conv1d_banded_tm(precision=HIGHEST)`` at
  128 lanes, with the lucky7 LPF2, LPF1 and DC-blocker taps (57, 157 and
  637), strides 1 and 2, band offsets 0 and 99, and an input short of the
  last windows (rows past its end read as zeros): atol 1e-5.  Both are
  float32-exact FIRs that sum the same products in another order.
- ``fir_tpu`` vs JAX ``fir_tpu`` and ``fir_stream`` for decimations 1, 2
  and 4: atol 2e-5, the bound of tests/test_pallas.py.

Torch runs on one thread here.  The plain FIR is hundreds of small torch
ops, and on 8 threads each one is a parallel region: on a machine loaded
by other test workers its threads wait on one another, and a 637-tap case
took ~40 s instead of ~0.5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdrmodem_tpu.dsp import taps as jtaps
from sdrmodem_tpu.dsp.elementwise import dc_blocker_taps
from sdrmodem_tpu.dsp.fir import fir_stream
from sdrmodem_tpu.dsp.fsk_demod import FskDemodConfig as JaxConfig
from sdrmodem_tpu.ops.pallas_fir import conv1d_banded_tm as jax_conv1d
from sdrmodem_tpu.ops.pallas_fir import fir_tpu as jax_fir_tpu
from sdrmodem_tpu_torch.ops import fir as fir_ops

LUCKY7 = JaxConfig(48000, 4800, 5000, 2, 2000, True)
TAPS = {
    57: LUCKY7.lpf2_taps(),
    157: LUCKY7.lpf1_taps(),
    637: dc_blocker_taps(LUCKY7.dc_length),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread for the module (see the module's docstring);
    the other port test modules import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("col_offset", [0, 99])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("t", sorted(TAPS))
def test_conv1d_banded_tm_matches_jax(t, stride, col_offset):
    assert len(TAPS[t]) == t
    rev = np.asarray(TAPS[t], np.float32)[::-1].copy()
    n_out = 300
    rows = (n_out - 1) * stride + col_offset + t - 40  # the last windows run off the end
    x = np.random.default_rng(t * 4 + stride + col_offset).standard_normal((rows, 128))
    x = x.astype(np.float32)
    want = jax_conv1d(
        jnp.asarray(x), rev, stride, n_out, interpret=True,
        precision=jax.lax.Precision.HIGHEST, col_offset=col_offset,
    )
    before = (fir_ops.launches, fir_ops.fir_tpu_launches)
    got = fir_ops.conv1d_banded_tm(torch.from_numpy(x), torch.from_numpy(rev), stride, n_out,
                                   col_offset=col_offset)
    assert got.shape == (n_out, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert np.abs(got.numpy()[-1]).max() > 0
    # a CPU tensor runs the plain version: nothing was launched
    assert (fir_ops.launches, fir_ops.fir_tpu_launches) == before


@pytest.mark.parametrize("decim", [1, 2, 4])
def test_fir_tpu_matches_jax(decim):
    taps = jtaps.low_pass_taps(1.0, 48000, 7400, 740)
    x = np.random.default_rng(5).standard_normal((1500, 128)).astype(np.float32)
    ref = np.asarray(fir_stream(jnp.asarray(x.T), taps, decim)).T
    want = np.asarray(jax_fir_tpu(jnp.asarray(x), taps, decim, tile_k=256, interpret=True))
    got = fir_ops.fir_tpu(torch.from_numpy(x), taps, decim).numpy()
    assert got.shape == want.shape == (-(-1500 // decim), 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def test_fir_rejects_bad_arguments():
    x = torch.zeros((64, 4))
    rev = torch.ones(5)
    with pytest.raises(ValueError, match="unsupported device"):
        fir_ops.conv1d_banded_tm(x.to("meta"), rev, 1, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        fir_ops.fir_tpu(x.to("meta"), [1.0, 2.0], 2)
    with pytest.raises(ValueError, match="stride"):
        fir_ops.conv1d_banded_tm(x, rev, 0, 8)
    with pytest.raises(ValueError, match="rev_taps"):
        fir_ops.conv1d_banded_tm(x, torch.ones((2, 2)), 1, 8)


# the tap counts of the long-filter configurations (LPF1, LPF2, DC at fs,
# baud, deviation, d, transition width): lucky7, nan, 288000/9600,
# 480000/9600, 48000/1200 and 240000/1200, and MAX_SPS's DC FIR
# (4 * 32 * 512 - 3, dsp/clock_recovery.py:MAX_SPS)
PLAN_TAPS = [157, 57, 637, 589, 289, 3197, 707, 347, 1917, 1179, 579, 963, 2557, 4819, 2891, 12797, 65533]


@pytest.mark.parametrize("t", PLAN_TAPS)
def test_fir_plan_covers_tap_counts(t):
    """``fir_plan`` never raises: the wide form from 32 lanes, the narrow
    below; its tap parts cover [0, T) in order, none longer than ``part``;
    two stage buffers fit a block's 232,448 bytes (two blocks an SM); wide
    segments are whole tiles, at most 65535 a lane group; the narrow form
    cuts one stream of 262144 outputs into at least 132 blocks."""
    for lanes in (1, 2, 31, 32, 128, 256):
        for stride in (1, 2, 3):
            for n_out in (1, 1000, 262144, 1 << 20):
                plan = fir_ops.fir_plan(n_out, lanes, t, stride)
                assert plan.wide == (lanes >= 32)
                assert plan.lanes_a_block == (32 if plan.wide else 1)
                assert plan.parts[0][0] == 0 and plan.parts[-1][1] == t
                assert all(a1 == b0 for (_, a1), (b0, _) in zip(plan.parts, plan.parts[1:]))
                assert all(0 < j1 - j0 <= plan.part for j0, j1 in plan.parts)
                assert plan.shared_bytes == fir_ops.fir_shared_bytes(plan.wide, stride, plan.part)
                assert plan.shared_bytes <= 2 * fir_ops.FIR_BUFFER_BYTES <= 232448 // 2
                threads = fir_ops.FIR_WARPS if plan.wide else fir_ops.NARROW_THREADS
                assert plan.tile == plan.rows_a_thread * threads
                if plan.wide:
                    segs = -(-n_out // plan.seg)
                    assert plan.seg % plan.tile == 0 and segs <= 65535
                    assert plan.blocks == segs * -(-lanes // 32)
                else:
                    assert plan.seg == plan.tile and plan.blocks == lanes * -(-n_out // plan.tile)
                    if n_out == 262144 and stride == 1:
                        assert plan.blocks >= 132 * lanes
                # one part wherever the whole filter fits a buffer
                if 4 * fir_ops._buffer_floats(plan.wide, stride, t) <= fir_ops.FIR_BUFFER_BYTES:
                    assert len(plan.parts) == 1
