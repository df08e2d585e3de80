"""The port's TX (GFSK modulation) against the JAX package, on the CPU.

Inputs are seeded numpy; the JAX side runs as ``tests/test_tx_kernel.py``
runs it (the Pallas kernels in interpret mode), the port on
``device="cpu"``, where each TX kernel's plain version runs.

Tolerances, and why:
- the pulse taps and ``bytes_to_nrz``: equal (the same numpy code);
- ``interp_fir_stream``: 1e-6 (the port sums the taps oldest first, the
  order of the JAX correlation, and gives its y bit for bit);
- the float64 VCO (``freq_mod_stream_pair``): 1e-5, and the two-level
  float32 one (``freq_mod_pair_fast``): 1e-4 (float32 cumsums in another
  order);
- the kernels' route (B5, B6) against JAX's float64 chain
  ``process_pair(exact=True)``: 1e-4 on I/Q and on the wrapped phase (the
  port carries the phase prefix in float64 too);
- against JAX's Pallas kernels in interpret mode: 1e-3, the JAX tests' own
  tolerance, since those carry the phase in float32 (~3e-4 off the float64
  chain at 2048 B);
- the reference's 320-sample golden: 0.01 (reference test/utils.c:134-140);
- chunk invariance: 1e-4; the JAX -> port hand-off: 1e-3;
- loopback through the port's RX: hard decisions agree >= 0.999.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdrmodem_tpu.dsp import taps as jtaps
from sdrmodem_tpu.dsp.elementwise import freq_mod_pair_fast as j_fast
from sdrmodem_tpu.dsp.elementwise import freq_mod_stream as j_fms
from sdrmodem_tpu.dsp.elementwise import freq_mod_stream_pair as j_fmsp
from sdrmodem_tpu.dsp.elementwise import nco_stream as j_nco_stream
from sdrmodem_tpu.dsp.fir import interp_fir_stream as j_interp
from sdrmodem_tpu.dsp.gfsk_mod import GfskModConfig as JaxModConfig
from sdrmodem_tpu.dsp.gfsk_mod import GfskModulator as JaxModulator
from sdrmodem_tpu.dsp.gfsk_mod import bytes_to_nrz as j_nrz
from sdrmodem_tpu.dsp.nco_host import HostNco as JaxHostNco
from sdrmodem_tpu.dsp.streaming import StreamingGfskMod as JaxStreaming
from sdrmodem_tpu.ops.pallas_tx import gfsk_tx_call as j_tx_call
from sdrmodem_tpu.ops.pallas_tx import gfsk_tx_call_folded as j_tx_folded
from sdrmodem_tpu_torch import GfskModConfig, GfskModulator
from sdrmodem_tpu_torch.dsp import taps as ttaps
from sdrmodem_tpu_torch.dsp.elementwise import (
    bytes_to_nrz,
    freq_mod_pair_fast,
    freq_mod_stream,
    freq_mod_stream_pair,
    nco_phases,
    nco_stream,
)
from sdrmodem_tpu_torch.dsp.fir import interp_fir_stream
from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
from sdrmodem_tpu_torch.dsp.nco_host import HostNco
from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
from sdrmodem_tpu_torch.dsp.streaming import StreamingGfskMod
from sdrmodem_tpu_torch.ops import tx as tx_ops
from sdrmodem_tpu_torch.utils.parity import demod_capture
from tests.test_torch_fir import one_thread  # noqa: F401 (torch on one thread)

PERF_FS, PLUTO_FS = 19200, 576000  # I = 2 (tools/perf.py:4) and I = 60 (tests/test_server.py:316)
CFG = (PERF_FS, 9600, 5000)
F64_TOL = 1e-4
KERNEL_TOL = 1e-3


def _mods(fs=PERF_FS):
    return JaxModulator(JaxModConfig.from_radio(fs, 9600, 5000)), GfskModulator(
        GfskModConfig.from_radio(fs, 9600, 5000), device="cpu")


def _bytes(n, seed, shape=None):
    return np.random.default_rng(seed).integers(0, 256, shape or n).astype(np.uint8)


def _phase_gap(a, b):
    """Largest distance on the circle between wrapped phases."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) % (2 * np.pi)
    return float(np.minimum(d, 2 * np.pi - d).max())


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("sps", [2, 5, 60])
def test_pulse_taps_equal_jax(sps):
    assert np.array_equal(ttaps.gaussian_taps(1.0, sps, 0.5, 4 * sps),
                          jtaps.gaussian_taps(1.0, sps, 0.5, 4 * sps))
    t, j = ttaps.gfsk_pulse_taps(sps, 0.5), jtaps.gfsk_pulse_taps(sps, 0.5)
    assert np.array_equal(t, j)
    assert np.array_equal(ttaps.polyphase_taps(t, sps), jtaps.polyphase_taps(j, sps))


def test_bytes_to_nrz_equal_jax():
    data = _bytes(0, 1, (3, 17))
    assert np.array_equal(_np(bytes_to_nrz(torch.from_numpy(data))), np.asarray(j_nrz(jnp.asarray(data))))


@pytest.mark.parametrize("fs", [PERF_FS, PLUTO_FS])
def test_interp_fir_stream_matches_jax(fs):
    jm, tm = _mods(fs)
    nrz = np.array(j_nrz(jnp.asarray(_bytes(0, fs, (2, 64)))))
    want = np.asarray(j_interp(jnp.asarray(nrz), jm.taps, jm.interpolation))
    got = _np(interp_fir_stream(torch.from_numpy(nrz), tm.taps, tm.interpolation))
    assert got.shape == want.shape == (2, 64 * 8 * tm.interpolation)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("vco", ["float64", "two-level float32"])
def test_vco_matches_jax(vco):
    jm, _ = _mods()
    nrz = j_nrz(jnp.asarray(_bytes(0, 3, (2, 512))))
    y = np.array(j_interp(nrz, jm.taps, jm.interpolation), np.float32)
    sens, ph0 = jm.config.sensitivity, 1.25
    if vco == "float64":
        want = j_fmsp(jnp.asarray(y), sens, ph0)
        got = freq_mod_stream_pair(torch.from_numpy(y), sens, ph0)
        wc, wp = j_fms(jnp.asarray(y), sens, ph0)
        gc, gp = freq_mod_stream(torch.from_numpy(y), sens, ph0)
        np.testing.assert_allclose(_np(gc), np.asarray(wc), rtol=0, atol=1e-5)
        assert _phase_gap(_np(gp), np.asarray(wp)) < 1e-9
        tol = 1e-5
    else:
        want = j_fast(jnp.asarray(y), sens, ph0)
        got = freq_mod_pair_fast(torch.from_numpy(y), sens, ph0)
        tol = 1e-4
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=tol)
    assert _phase_gap(_np(got[2]), np.asarray(want[2])) < tol


def test_host_nco_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 5000)).astype(np.float32)
    iq = (x[0] + 1j * x[1]).astype(np.complex64)
    t, j = HostNco(PLUTO_FS), JaxHostNco(PLUTO_FS)
    for chunk in (iq[:1234], iq[1234:]):  # the phase carries across calls
        np.testing.assert_allclose(t.mix(-25000, chunk), j.mix(-25000, chunk), rtol=0, atol=1e-6)
    assert t.phase == j.phase
    got, gp = nco_stream(1200, 3000, 48000, 0.5, 0.3, device="cpu")
    want, wp = j_nco_stream(1200, 3000, 48000, 0.5, 0.3)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-6)
    assert _phase_gap(_np(gp), np.asarray(wp)) < 1e-12


@pytest.mark.parametrize("route", ["process", "process_pair", "process_pair_kernel"])
def test_golden_320(fixtures_dir, route):
    """The reference's 320-float golden (10 bytes, 19200/9600/5000)."""
    vals = np.load(fixtures_dir / "gfsk_mod_expected320.npy")
    _, tm = _mods()
    data = np.arange(10, dtype=np.uint8)
    if route == "process":
        iq, _ = tm.process(data)
        i, q = iq.real, iq.imag
    else:
        i, q, _ = getattr(tm, route)(data)
    assert _np(i).shape == (160,)
    assert np.abs(_np(i) - vals[0::2]).max() < 0.01
    assert np.abs(_np(q) - vals[1::2]).max() < 0.01


@pytest.mark.parametrize("nbytes", [2048, 32768])
def test_b5_route_matches_jax_float64_chain(nbytes):
    """A single stream through the kernel route (B5's plain version) against
    JAX's float64 chain, up to a full 32 KiB TxData."""
    jm, tm = _mods()
    data = _bytes(nbytes, nbytes)
    i, q, ph = tm.process_pair_kernel(data)
    wi, wq, wph = jm.process_pair(jnp.asarray(data), exact=True)
    assert _np(i).shape == (nbytes * 16,)
    np.testing.assert_allclose(_np(i), np.asarray(wi), rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(_np(q), np.asarray(wq), rtol=0, atol=F64_TOL)
    assert _phase_gap(_np(ph), np.asarray(wph)) < F64_TOL


@pytest.mark.parametrize("fs", [PERF_FS, PLUTO_FS])
def test_b5_route_matches_jax_kernel(fs):
    jm, tm = _mods(fs)
    data = _bytes(2048, fs)
    i, q, ph = tm.process_pair_kernel(data, phase0=0.7)
    wi, wq, wph = jm.process_pair_kernel(jnp.asarray(data), phase0=0.7, interpret=True)
    np.testing.assert_allclose(_np(i), np.asarray(wi), rtol=0, atol=KERNEL_TOL)
    np.testing.assert_allclose(_np(q), np.asarray(wq), rtol=0, atol=KERNEL_TOL)
    assert _phase_gap(_np(ph), np.asarray(wph)) < KERNEL_TOL


@pytest.mark.parametrize("shape", [(5, 96), (128, 256)])
def test_b6_route_matches_jax(shape):
    """A batch through the kernel route (B6's plain version), per lane,
    against JAX's float64 chain and JAX's batched kernel."""
    jm, tm = _mods()
    data = _bytes(0, shape[0], shape)
    i, q, ph = tm.process_pair_kernel(data)
    assert _np(i).shape == (shape[0], shape[1] * 16) and _np(ph).shape == (shape[0],)
    for (wi, wq, wph), tol in (
        (jm.process_pair(jnp.asarray(data), exact=True), F64_TOL),
        (jm.process_pair_kernel(jnp.asarray(data), interpret=True), KERNEL_TOL),
    ):
        np.testing.assert_allclose(_np(i), np.asarray(wi), rtol=0, atol=tol)
        np.testing.assert_allclose(_np(q), np.asarray(wq), rtol=0, atol=tol)
        assert _phase_gap(_np(ph), np.asarray(wph)) < tol


def test_b6_route_takes_at_most_128_streams():
    _, tm = _mods()
    with pytest.raises(ValueError, match="128 streams"):
        tm.process_pair_kernel(np.zeros((129, 4), np.uint8))


def test_folded_call_matches_jax_with_carried_state():
    """gfsk_tx_call_folded with a carried phase and history and a ragged
    n_valid (the zero-padded tail adds no phase), float NRZ and packed
    bytes, against the JAX kernel in interpret mode."""
    jm, tm = _mods()
    rng = np.random.default_rng(7)
    data = _bytes(256, 7)
    nrz = np.unpackbits(data).astype(np.float32) * 2 - 1  # 2048 rows
    nv = 2000
    nrz[nv:] = 0.0
    hist = rng.choice([-1.0, 1.0], tm.k - 1).astype(np.float32)
    args = (jm.interpolation, jm.config.sensitivity, 2.5)
    wi, wq, wph = j_tx_folded(jnp.asarray(nrz), jm.taps, *args, jnp.asarray(hist),
                              n_valid=nv, interpret=True)
    for x in (torch.from_numpy(nrz), torch.from_numpy(data)):
        i, q, ph = tx_ops.gfsk_tx_call_folded(x, tm.taps, *args, torch.from_numpy(hist),
                                              n_valid=nv)
        np.testing.assert_allclose(_np(i), np.asarray(wi), rtol=0, atol=KERNEL_TOL)
        np.testing.assert_allclose(_np(q), np.asarray(wq), rtol=0, atol=KERNEL_TOL)
        assert _phase_gap(_np(ph), np.asarray(wph)) < KERNEL_TOL


def test_batched_call_matches_jax_with_carried_state():
    """gfsk_tx_call with per-lane phases and histories and a ragged n_valid;
    the exported history equals JAX's (padding rows included)."""
    jm, tm = _mods()
    rng = np.random.default_rng(8)
    nrz = rng.choice([-1.0, 1.0], (1024, 128)).astype(np.float32)
    nv = 1000
    nrz[nv:] = 0.0
    hist = rng.choice([-1.0, 1.0], (tm.k - 1, 128)).astype(np.float32)
    ph0 = rng.uniform(0, 2 * np.pi, 128).astype(np.float32)
    args = (jm.interpolation, jm.config.sensitivity)
    want = j_tx_call(jnp.asarray(nrz), jm.taps, *args, jnp.asarray(ph0), jnp.asarray(hist),
                     n_valid=nv, interpret=True)
    got = tx_ops.gfsk_tx_call(torch.from_numpy(nrz), tm.taps, *args, torch.from_numpy(ph0),
                              torch.from_numpy(hist), n_valid=nv)
    assert _np(got[0]).shape == (1024 * tm.interpolation, 128)
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), rtol=0, atol=KERNEL_TOL)
    np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]), rtol=0, atol=KERNEL_TOL)
    assert _phase_gap(_np(got[2]), np.asarray(want[2])) < KERNEL_TOL
    assert np.array_equal(_np(got[3]), np.asarray(want[3]))


@pytest.mark.parametrize("rows,interp,k,lanes,want", [
    # B5: the server's TxData, 2048 B and 32 KiB at I = 2, 32 KiB at I = 60
    (2048 * 8, 2, 5, None, (2, 512, 32, 32, 2, True)),
    (32768 * 8, 2, 5, None, (2, 512, 512, 512, 2, True)),
    (32768 * 8, 60, 5, None, (1, 256, 1024, 1024, 2, True)),
    # one tile (one launch, no scratch) and one either side
    (512, 2, 5, None, (2, 512, 1, 0, 1, True)),
    (511, 2, 5, None, (2, 512, 1, 0, 1, True)),
    (513, 2, 5, None, (2, 512, 2, 2, 2, True)),
    (8 * 512 + 1, 2, 5, None, (2, 512, 9, 9, 2, True)),
    # a run of one row once I passes the run's samples; odd I
    (1000, 17, 5, None, (1, 256, 4, 4, 2, True)),
    (1000, 3, 5, None, (1, 256, 4, 4, 2, True)),
    # the table: 2^k x I at most 65536 float64, k at most 8
    (100, 2048, 5, None, (1, 256, 1, 0, 1, True)),
    (100, 2049, 5, None, (1, 256, 1, 0, 1, False)),
    (100, 2, 8, None, (2, 512, 1, 0, 1, True)),
    (100, 2, 9, None, (2, 512, 1, 0, 1, False)),
    (2 * 512, 2, 9, None, (2, 512, 2, 2, 2, False)),
    # B6: 128 x 2048 B at I = 2 (path (e)), 32 KiB at I = 60, 1 and 33 lanes;
    # at I = 1 a run stops at 16 rows
    (2048 * 8, 2, 5, 128, (16, 128, 128, 128, 2, True)),
    (32768 * 8, 60, 5, 4, (1, 8, 32768, 32768, 2, True)),
    (4096, 2, 5, 1, (16, 128, 32, 32, 2, True)),
    (128, 2, 5, 33, (16, 128, 1, 0, 1, True)),
    (512, 2, 5, 33, (16, 128, 4, 4, 2, True)),
    (8 * 128, 48, 5, 33, (1, 8, 128, 128, 2, True)),
    (4096, 1, 5, 3, (16, 128, 32, 32, 2, True)),
])
def test_tx_plan(rows, interp, k, lanes, want):
    """tx_plan by hand: runs of min(16, max(1, 4 // I)) rows (B5, 256 runs
    a tile) or min(16, max(1, 32 // I)) (B6, 8 runs a lane a tile); one
    launch and no scratch for a stream of one tile, else two and a float64
    total a tile; the pattern table where k <= 8 and 2^k x I <= 65536."""
    plan = tx_ops.tx_plan(rows, interp, k, lanes)
    assert tuple(plan) == want
    assert plan.tiles * plan.tile >= rows > (plan.tiles - 1) * plan.tile


@pytest.mark.parametrize("fs", [PERF_FS, 48000, PLUTO_FS])
def test_pattern_table_equals_plain_increments(fs):
    """Every entry of the kernels' pattern table is the float64 prefix of
    its pattern's float32 increments as the plain version computes them
    (``polyphase_rows`` on the pattern's k rows of +-1, then sens * y):
    equal, bit for bit."""
    _, tm = _mods(fs)
    t2d = tx_ops.phase_taps(np.asarray(tm.taps, np.float32), tm.interpolation)
    k, ii = t2d.shape
    table = tx_ops.pattern_table(t2d, tm.config.sensitivity)
    assert table.shape == (1 << k, ii) and table.dtype == np.float64
    p = np.arange(1 << k)
    rows = np.where((p[None, :] >> np.arange(k - 1, -1, -1)[:, None]) & 1, 1.0, -1.0)  # (k, P)
    y = tx_ops.polyphase_rows(torch.from_numpy(rows.astype(np.float32)), torch.from_numpy(t2d), 1)
    sens = torch.tensor(float(np.float32(tm.config.sensitivity)), dtype=torch.float32)
    inc = (sens * y[0]).double().T  # (P, I)
    assert np.array_equal(table, torch.cumsum(inc, dim=1).numpy())
    assert np.abs(table).max() < 2 * np.pi  # the kernels take the table: one compare a sample


def _stream(mod, payload, chunks):
    out, i = [], 0
    for c in chunks:
        out.append(mod.process(payload[i : i + c]))
        i += c
    return np.concatenate(out)


def test_streaming_chunk_invariant_and_backends_agree():
    """Ragged TxData chunks equal the one-shot run, and the fused route
    (B5's plain version) equals the unfused chain."""
    cfg = GfskModConfig.from_radio(*CFG)
    payload = _bytes(700, 5)
    whole = _stream(StreamingGfskMod(cfg, device="cpu"), payload, [700])
    chunked = _stream(StreamingGfskMod(cfg, device="cpu"), payload, [100, 250, 350])
    xla = _stream(StreamingGfskMod(cfg, "xla", device="cpu"), payload, [100, 250, 350])
    assert whole.dtype == np.complex64 and whole.shape == (700 * 16,)
    assert np.abs(whole - chunked).max() < F64_TOL
    assert np.abs(whole - xla).max() < F64_TOL


def test_streaming_matches_jax_streaming():
    payload = _bytes(700, 5)
    want = _stream(JaxStreaming(JaxModConfig.from_radio(*CFG)), payload, [100, 250, 350])
    got = _stream(StreamingGfskMod(GfskModConfig.from_radio(*CFG), device="cpu"), payload,
                  [100, 250, 350])
    assert np.abs(got - want).max() < KERNEL_TOL


def test_streaming_sub_dispatch_matches_one_float64_pass():
    """A 40 000-byte burst is cut at 32 KiB with the state carried: the
    samples equal JAX's float64 chain over the whole payload."""
    payload = _bytes(40000, 9)
    m = StreamingGfskMod(GfskModConfig.from_radio(*CFG), device="cpu")
    got = m.process(payload)
    wi, wq, wph = JaxModulator(JaxModConfig.from_radio(*CFG)).process_pair(
        jnp.asarray(payload), exact=True)
    assert got.shape == (40000 * 16,)
    assert np.abs(got.real - np.asarray(wi)).max() < F64_TOL
    assert np.abs(got.imag - np.asarray(wq)).max() < F64_TOL
    assert _phase_gap(m.phase, np.asarray(wph)) < F64_TOL


def test_stream_hand_off_from_jax():
    """JAX's modulator starts a stream, the port carries on from its phase
    and history, and the samples follow JAX's own stream."""
    payload = _bytes(700, 6)
    jax_mod = JaxStreaming(JaxModConfig.from_radio(*CFG))
    want = _stream(jax_mod, payload, [300, 400])
    jax_mod = JaxStreaming(JaxModConfig.from_radio(*CFG))
    head = jax_mod.process(payload[:300])
    port = StreamingGfskMod(GfskModConfig.from_radio(*CFG), device="cpu")
    port.load_state(jax_mod.phase, jax_mod.hist)
    got = np.concatenate([head, port.process(payload[300:])])
    assert np.abs(got - want).max() < KERNEL_TOL


def test_mod_demod_loopback():
    """The port's TX into the port's RX (one lane, decimation 1, DC off)
    recovers the bits (tests/test_tx_kernel.py:76-97)."""
    fs, baud, dev = 48000, 9600, 5000
    payload = np.frombuffer(b"fused tx kernel loopback \x00\xff!!" * 8, dtype=np.uint8)
    m = StreamingGfskMod(GfskModConfig.from_radio(fs, baud, dev), device="cpu")
    iq = np.concatenate([m.process(payload[:100]), m.process(payload[100:])])
    soft = demod_capture(DemodPipeline(FskDemodConfig(fs, baud, dev, 1, 2000, False), 4096,
                                       device="cpu"), iq)
    bits_tx = np.unpackbits(payload).astype(np.int8) * 2 - 1
    hard = np.sign(soft).astype(np.int8)
    best = 0.0
    for off in range(0, 80):
        n = min(len(hard) - off, len(bits_tx))
        best = max(best, float((hard[off : off + n] == bits_tx[:n]).mean()))
    assert best > 0.999, f"loopback BER too high: {1 - best:.4f}"


def test_entry_points_default_to_the_card():
    """Without a device the modulators and the NCO go to the card; with no
    card they raise rather than carry on on the CPU."""
    cfg = GfskModConfig.from_radio(*CFG)
    makers = (lambda: GfskModulator(cfg).device, lambda: StreamingGfskMod(cfg).device,
              lambda: nco_phases(1200, 64, 48000)[0].device,
              lambda: nco_stream(1200, 64, 48000)[0].device)
    for make in makers:
        if torch.cuda.is_available():
            assert make().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
