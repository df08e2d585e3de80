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
