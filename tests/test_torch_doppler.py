"""The port's host Doppler (dsp/doppler.py over its copy of orbit/) and its
NCO mix (dsp/elementwise.py:nco_mix_pair_tm, the plain version of
csrc/nco.cuh) against the JAX package and the reference's recorded-pass
goldens (tests/test_doppler.py).

Tolerances:
- ``device_segments`` rows and ``process_rx``: exact, the same numpy code
  on the same inputs;
- the NCO mix against the three goldens, and TX inverting RX: 0.01, the
  bound of tests/test_doppler.py;
- port vs JAX ``nco_mix_pair_tm`` on the same tables: 2e-6.  Both take the
  ramp in the same float32 order; only cos and sin differ, by an ulp of
  a phase of up to ~6000 rad (4.8e-7 measured at |x| up to ~5);
- lanes with no row: bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdrmodem_tpu.dsp.doppler import Doppler as JaxDoppler
from sdrmodem_tpu.dsp.elementwise import nco_mix_pair_tm as jax_nco_mix
from sdrmodem_tpu_torch.dsp.doppler import Doppler
from sdrmodem_tpu_torch.dsp.elementwise import nco_mix_pair_tm
from sdrmodem_tpu_torch.ops import front as front_ops
from sdrmodem_tpu_torch.utils.convert import doppler_tables_from_numpy, segment_tables
from tests.test_torch_fir import one_thread  # noqa: F401 (torch on one thread)

TLE = [
    "LUCKY-7",
    "1 44406U 19038W   20069.88080907  .00000505  00000-0  32890-4 0  9992",
    "2 44406  97.5270  32.5584 0026284 107.4758 252.9348 15.12089395 37524",
]
ARGS = dict(
    latitude=53.72,
    longitude=47.57,
    altitude_km=0.0,
    sampling_freq=48000,
    center_freq=437525000,
    tle_lines=TLE,
    constant_offset=0,
    start_time_seconds=1583840449,
)
GOLDENS = ["lucky7.expected.cf32", "lucky7.expected.47000.cf32", "lucky7.expected.95000.cf32"]


@pytest.mark.parametrize("max_batch", [None, 2000])
@pytest.mark.parametrize("block", [2000, 262144])
def test_device_segments_equal_jax(block, max_batch):
    jd, td = JaxDoppler(**ARGS), Doppler(**ARGS)
    bound = Doppler.max_rows(block, ARGS["sampling_freq"], max_batch)
    assert bound == JaxDoppler.max_rows(block, ARGS["sampling_freq"], max_batch)
    for _ in range(30):
        want = jd.device_segments(block, +1, max_batch=max_batch)
        got = td.device_segments(block, +1, max_batch=max_batch)
        assert got == want
        assert 0 < len(got) <= bound
    assert td.phase == jd.phase and td.current_fd == jd.current_fd


@pytest.mark.parametrize("block", [2000, 262144])
def test_process_rx_equal_jax(block):
    rng = np.random.default_rng(3)
    jd, td = JaxDoppler(**ARGS), Doppler(**ARGS)
    for _ in range(30):
        iq = (rng.standard_normal(block) + 1j * rng.standard_normal(block)).astype(np.complex64)
        assert np.array_equal(td.process_rx(iq), jd.process_rx(iq))


def _mix_stream(d, iq, chunk, direction, max_batch=None):
    """One lane through the port's plain NCO mix, ``chunk`` samples a call,
    with rows from ``device_segments``."""
    out = []
    for i in range(0, len(iq), chunk):
        blk = iq[i : i + chunk]
        rows = d.device_segments(len(blk), direction, max_batch=max_batch)
        s_rows = Doppler.max_rows(len(blk), ARGS["sampling_freq"], max_batch)
        dop = doppler_tables_from_numpy(segment_tables({0: rows}, s_rows, 1), 1, device="cpu")
        x = torch.from_numpy(np.stack([blk.real, blk.imag], axis=1).astype(np.float32))
        y = nco_mix_pair_tm(x, *dop).numpy()
        out.append(y[:, 0] + 1j * y[:, 1])
    return np.concatenate(out)


@pytest.mark.parametrize("chunk,max_batch", [(2000, None), (8000, 2000)])
@pytest.mark.parametrize("golden", GOLDENS)
def test_nco_mix_matches_goldens(resources_dir, golden, chunk, max_batch):
    """The device-side mix reproduces the reference goldens; 8000-sample
    blocks with rows every 2000 samples keep the goldens' cadence."""
    iq = np.fromfile(resources_dir / "lucky7.cf32", dtype=np.complex64)
    exp = np.fromfile(resources_dir / golden, dtype=np.complex64)
    before = front_ops.launches
    got = _mix_stream(Doppler(**ARGS), iq, chunk, +1, max_batch)
    assert np.abs(got.real - exp.real).max() < 0.01
    assert np.abs(got.imag - exp.imag).max() < 0.01
    assert front_ops.launches == before


def test_nco_mix_tx_inverts_rx(resources_dir):
    iq = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)
    exp = np.fromfile(resources_dir / "lucky7.cf32", dtype=np.complex64)
    got = _mix_stream(Doppler(**ARGS), iq, 2000, -1)
    assert np.abs(got.real - exp.real).max() < 0.01
    assert np.abs(got.imag - exp.imag).max() < 0.01


def test_nco_mix_matches_jax():
    """262144 samples x 4 lanes: lanes 0-2 each with their own pass (start
    time and constant offset), lane 3 with no rows."""
    block, lanes = 262144, 4
    s_rows = Doppler.max_rows(block, ARGS["sampling_freq"])
    rows = {
        k: Doppler(**{**ARGS, "start_time_seconds": ARGS["start_time_seconds"] + 40 * k,
                      "constant_offset": (0, 2500, -4000)[k]}).device_segments(block, +1)
        for k in range(3)
    }
    tables = segment_tables(rows, s_rows, lanes)
    rng = np.random.default_rng(7)
    x = (1.7 * rng.standard_normal((block, 2 * lanes))).astype(np.float32)
    want = np.asarray(jax_nco_mix(jnp.asarray(x), *map(jnp.asarray, tables)))
    got = nco_mix_pair_tm(torch.from_numpy(x), *doppler_tables_from_numpy(tables, lanes, device="cpu"))
    got = got.numpy()
    assert np.abs(got - want).max() <= 2e-6
    assert np.abs(x).max() > 5 and np.abs(got[:, :3] - x[:, :3]).max() > 1.0  # the mix did turn
    for col in (3, 3 + lanes):  # lane 3's I and Q
        assert np.array_equal(got[:, col], x[:, col])


def test_nco_mix_rejects_bad_tables():
    x = torch.zeros((64, 4))
    good = tuple(torch.zeros((2, 2)) for _ in range(4))
    assert torch.equal(front_ops.nco_mix(x, good), x)
    with pytest.raises(ValueError, match="starts"):
        front_ops.nco_mix(x, (torch.zeros((2, 3)),) + good[1:])
    with pytest.raises(ValueError, match="ph0s"):
        front_ops.nco_mix(x, good[:3] + (torch.zeros((2, 2), dtype=torch.float64),))
    with pytest.raises(ValueError, match="starts"):
        front_ops.nco_mix(x, tuple(torch.zeros((0, 2)) for _ in range(4)))
