"""The port's ragged path, module by module, against the JAX package.

- B4's plain version (``ops/clock.py:clock_mm_tpu`` on a CPU tensor)
  against JAX ``clock_mm_tpu(interpret=True)`` at the sizes of
  tests/test_pallas.py:38-76 (6 lanes x 2500, NaN rows 400-430 on lane 3),
  both layouts, with a nonzero ``ii0`` and a ragged ``n_valid``: counts
  within 2 and a long exact int8 prefix (the JAX kernel evaluates the bank
  as Farrow polynomials, the port indexes the table, and the chaotic loop
  can turn a sub-ulp difference into a flip far downstream).  Against JAX
  ``clock_mm_stream`` (the same table): counts equal and int8 within ±1
  (the XLA dot sums the 8 products in another order).
- ``clock_mm_batched_pallas`` over three chunks equals the whole-stream
  ``clock_mm_stream`` bit for bit (one walk, the same operands); across
  blocks at sps 25 the negative ``tail_len`` skip carries the stream on
  exactly.
- ``clock_mm_batched_full(backend="scan")`` equals ``backend="pallas"``
  (B2's plain version) bit for bit.
- ``_fir_ragged`` (both ``exact``), ``_quad_demod_ragged`` and
  ``_dc_cumsum_stage`` against JAX over a chain of blocks with ``n_valid``
  full, 0, one below the taps, and full again, at d = 1 and 2: the exact
  FIR within 1 float32 ulp (both sum in float64, in other orders), the
  float32 FIR within 1e-5, the DC stage within 1e-4 (the port takes its
  running sums in float64, JAX in float32), the quad demod within 2 ulp
  (the same contracted conjugate product and the same table, but under jit
  XLA also contracts the table's interpolation t0 + (t1 - t0) * frac into
  an FMA, which the port does not: an ulp of the angle, and one more from
  the gain's rounding); the carried ``hist_len`` equal.

Torch runs on one thread here (``tests/test_torch_fir.py:one_thread``).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrmodem_tpu.dsp import clock_recovery as jcr
from sdrmodem_tpu.dsp import pipeline as jpl
from sdrmodem_tpu.dsp.fsk_demod import FskDemodConfig as JaxConfig
from sdrmodem_tpu.ops.pallas_clock import clock_mm_tpu as jax_clock_mm_tpu
from sdrmodem_tpu_torch.dsp import clock_recovery as tcr
from sdrmodem_tpu_torch.dsp import pipeline as tpl
from sdrmodem_tpu_torch.dsp.elementwise import atan_table
from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
from sdrmodem_tpu_torch.dsp.taps import mmse_interp_taps
from sdrmodem_tpu_torch.ops import clock as clock_ops
from tests.test_torch_fir import one_thread  # noqa: F401 (torch on one thread)

LUCKY7 = (48000, 4800, 5000, 2, 2000, True)
BANK = torch.from_numpy(mmse_interp_taps().copy())


def _int8(x):
    return np.round(np.clip(np.asarray(x, np.float32) * 127, -128, 127)).astype(np.int32)


def _soft(c, n, sps, seed):
    """Smoothed random NRZ at ``sps`` samples a symbol (tests/test_pallas.py:30-35)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (c, int(n / sps) + 8)) * 2.0 - 1.0
    k9 = np.hanning(9) / 4.5
    reps = int(np.ceil(sps))
    return np.stack(
        [np.convolve(np.repeat(bits[i], reps)[:n], k9, mode="same") for i in range(c)]
    ).astype(np.float32)


# ---- B4 against the JAX kernel and the JAX scan

C, N = 6, 2500
P48 = jcr.mm_params(4.8)
II0 = np.array([0, 1, 3, 7, 4, 2], np.int32)
N_VALID = np.array([N, N, N - 211, N, N, N - 40], np.int32)


def _b4_input():
    y = _soft(C, N, 4.8, 7)
    y[3, 400:430] = np.nan
    return y


@pytest.fixture(scope="module")
def jax_b4():
    y = _b4_input()
    p = P48
    k = jcr.max_symbols(N, p["omega"], p["omega_relative_limit"], p["gain_mu"])
    outs, counts, _ = jax_clock_mm_tpu(
        jnp.asarray(y), jnp.asarray(N_VALID), jnp.full((C,), p["omega"], jnp.float32),
        jnp.full((C,), p["mu"], jnp.float32), jnp.zeros((C,), jnp.float32), jnp.asarray(II0),
        omega_mid=p["omega"], omega_relative_limit=p["omega_relative_limit"],
        gain_omega=p["gain_omega"], gain_mu=p["gain_mu"], num_symbols=k, interpret=True,
    )
    # the JAX scan (the same table) on each lane from the same start, in one
    # compiled program: a negative tail_len is a skip
    scan = jax.jit(lambda x, st, nv: jcr.clock_mm_stream(x, state=st, n_valid=nv, num_symbols=k, **p))
    st = jcr.initial_state(p["omega"], p["mu"])
    scans = [scan(jnp.asarray(y[ch]), st._replace(tail_len=jnp.int32(-II0[ch])), jnp.int32(N_VALID[ch]))
             for ch in range(C)]
    return y, k, np.asarray(outs), np.asarray(counts), [(np.asarray(o), int(c)) for o, c, _ in scans]


@pytest.mark.parametrize("time_major", [False, True])
def test_b4_plain_matches_jax_kernel_and_scan(jax_b4, time_major):
    y, k, jouts, jcounts, jscans = jax_b4
    p = P48
    yt = torch.from_numpy(y.T.copy() if time_major else y)
    before = clock_ops.ragged_launches
    outs, counts, fin = clock_ops.clock_mm_tpu(
        yt, torch.from_numpy(N_VALID), torch.full((C,), p["omega"]), torch.full((C,), p["mu"]),
        torch.zeros(C), torch.from_numpy(II0),
        omega_mid=p["omega"], omega_relative_limit=p["omega_relative_limit"],
        gain_omega=p["gain_omega"], gain_mu=p["gain_mu"], num_symbols=k, time_major=time_major,
    )
    assert clock_ops.ragged_launches == before  # a CPU tensor runs the plain version
    assert outs.shape == jouts.shape == (C, clock_ops.k_slots(k))
    assert counts.dtype == torch.int32 and not fin["overflow"].any()
    got, cnt = outs.numpy(), counts.numpy()
    assert np.abs(cnt - jcounts).max() <= 2
    for ch in range(C):
        n_cmp = min(cnt[ch], jcounts[ch])
        bad = np.abs(_int8(got[ch, :n_cmp]) - _int8(jouts[ch, :n_cmp])) > 2
        first_flip = int(np.argmax(bad)) if bad.any() else n_cmp
        assert first_flip > 100, f"lane {ch} diverges from the JAX kernel at symbol {first_flip}"
        assert not got[ch, cnt[ch]:].any()
        so, sc = jscans[ch]
        assert sc == cnt[ch] > 400
        assert np.abs(_int8(got[ch, : cnt[ch]]) - _int8(so[: cnt[ch]])).max() <= 1
    # the NaN stretch emits zeros and strides floor(omega)
    assert (got[3, 80:90] == 0).any()


def test_b4_plain_layouts_bit_equal():
    y = torch.from_numpy(_b4_input())
    p = P48
    kw = dict(omega_mid=p["omega"], omega_relative_limit=p["omega_relative_limit"],
              gain_omega=p["gain_omega"], gain_mu=p["gain_mu"], num_symbols=600)
    args = (torch.from_numpy(N_VALID), torch.full((C,), p["omega"]), torch.full((C,), p["mu"]),
            torch.zeros(C), torch.from_numpy(II0))
    cm = clock_ops.clock_mm_tpu(y, *args, **kw)
    tm = clock_ops.clock_mm_tpu(y.T.contiguous(), *args, time_major=True, **kw)
    assert torch.equal(cm[0], tm[0]) and torch.equal(cm[1], tm[1])
    for key in ("omega", "mu", "last", "ii"):
        assert torch.equal(cm[2][key], tm[2][key])
    with pytest.raises(ValueError, match="unsupported device"):
        clock_ops.clock_mm_tpu(y.to("meta"), *args, **kw)


def test_mm_scan_core_matches_jax():
    """``_mm_scan_core`` (B4's plain walk under the JAX scan's signature)
    against the JAX one on the NaN lane, from a nonzero read start and a
    short valid length: the same count and final read pointer, int8 within
    ±1 (the XLA dot sums the 8 products in another order)."""
    y = _b4_input()[3]
    p = P48
    k = 600
    kw = dict(omega_mid=float(np.float32(p["omega"])),
              omega_lim=clock_ops.omega_limit(p["omega"], p["omega_relative_limit"]),
              gain_omega=p["gain_omega"], gain_mu=p["gain_mu"], num_symbols=k)
    start = (int(N_VALID[3]), int(II0[3]), p["mu"], p["omega"], 0.0)
    (jii, _, jom, _, jc), jo = jcr._mm_scan_core(jnp.asarray(y), *start, **kw)
    (ii, _, om, _, cnt), o = tcr._mm_scan_core(torch.from_numpy(y), *start, **kw)
    assert o.shape == (k,) and cnt.dtype == torch.int32
    assert int(cnt) == int(jc) > 400 and int(ii) == int(jii)
    assert abs(float(om) - float(jom)) < 1e-3
    assert np.abs(_int8(o.numpy()) - _int8(np.asarray(jo))).max() <= 1
    assert not o[int(cnt):].any()


# ---- the stream clock and its hand-off


def _batched_state(c, omega, mu):
    st = tcr.initial_state(omega, mu, device="cpu")
    return tcr.ClockState(*(v.expand(c, *v.shape).clone() for v in st))


def test_batched_pallas_chunks_equal_whole_stream():
    """tests/test_pallas.py:79-109 on the port: three chunks through the
    batched kernel call carry the stream on bit for bit."""
    p = jcr.mm_params(5.0)
    c, n = 4, 3000
    y = _soft(c, n, 5.0, 3)
    whole = [tcr.clock_mm_stream(torch.from_numpy(y[ch]), **p) for ch in range(c)]
    state = _batched_state(c, p["omega"], p["mu"])
    pieces = [[] for _ in range(c)]
    for lo, hi in [(0, 1000), (1000, 2000), (2000, 3000)]:
        outs, counts, state = tcr.clock_mm_batched_pallas(
            torch.from_numpy(y[:, lo:hi].copy()), torch.full((c,), hi - lo, dtype=torch.int32),
            state, **p,
        )
        assert outs.shape[1] % 8 == 0
        for ch in range(c):
            pieces[ch].append(outs[ch, : int(counts[ch])])
    for ch in range(c):
        got = torch.cat(pieces[ch])
        o, cnt, _ = whole[ch]
        assert len(got) == int(cnt) > 550
        assert torch.equal(got, o[: int(cnt)])


def test_stream_skip_across_blocks_at_sps25():
    """At sps 25 (the nan fixture's 240 kHz / 9600 baud) a block's last
    stride can overshoot its end: tail_len goes negative and the next block
    starts its read pointer that far in.  Blocks of 97 samples carry the
    stream on exactly, and each block matches the JAX clock_mm_stream fed
    the same state, within ±1 LSB."""
    p = jcr.mm_params(25.0)
    n = 4000
    y = _soft(1, n, 25.0, 11)[0]
    o, cnt, _ = tcr.clock_mm_stream(torch.from_numpy(y), **p)
    # one compiled JAX step for every block (a fresh state is the initial one)
    jstep = jax.jit(lambda x, st, nv: jcr.clock_mm_stream(x, state=st, n_valid=nv, **p))
    state, jstate = None, jcr.initial_state(p["omega"], p["mu"])
    got, skips = [], 0
    for lo in range(0, n, 97):
        blk = y[lo : lo + 97]
        pad = np.zeros(97, np.float32)
        pad[: len(blk)] = blk
        so, sc, state = tcr.clock_mm_stream(torch.from_numpy(pad), state=state, n_valid=len(blk), **p)
        jo, jc, jstate = jstep(jnp.asarray(pad), jstate, jnp.int32(len(blk)))
        assert int(sc) == int(jc)
        assert np.abs(_int8(so[: int(sc)]) - _int8(np.asarray(jo)[: int(sc)])).max() <= 1
        assert int(state.tail_len) == int(jstate.tail_len)
        assert state.tail.shape == (tcr.tail_cap_for(p["omega"]),)
        skips += int(state.tail_len) < 0
        got.append(so[: int(sc)])
    assert skips > 3
    got = torch.cat(got)
    assert len(got) == int(cnt) > 150
    assert torch.equal(got, o[: int(cnt)])


def test_full_scan_backend_equals_pallas(monkeypatch):
    """The full-block clock through the chunked walk (B2's plain version)
    and chunk by chunk through the ragged walk: the same bits, symbols,
    counts and state, over three blocks with carried state and a NaN
    stretch."""
    monkeypatch.setenv("SDRM_CLOCK_CHUNK", "512")
    p = jcr.mm_params(4.8)
    c, n = 3, 1200
    y = _soft(c, 3 * n, 4.8, 5).T.copy()
    y[1500:1520, 1] = np.nan
    states = {b: tcr.initial_full_state(p["omega"], c, p["mu"], device="cpu") for b in ("pallas", "scan")}
    for blk in range(3):
        x = torch.from_numpy(y[blk * n : (blk + 1) * n].copy())
        res = {}
        for backend in states:
            outs, counts, states[backend] = tcr.clock_mm_batched_full(
                x, states[backend], bank=BANK, backend=backend, **p
            )
            res[backend] = (outs, counts)
        assert res["pallas"][1].shape == (c, 3)  # 512-row chunks
        assert torch.equal(res["pallas"][0], res["scan"][0])
        assert torch.equal(res["pallas"][1], res["scan"][1])
        for a, b in zip(states["pallas"], states["scan"]):
            assert torch.equal(a, b)
        assert res["scan"][1].sum() > 3 * 200
    with pytest.raises(ValueError, match="unknown clock backend"):
        tcr.clock_mm_batched_full(x, states["scan"], bank=BANK, backend="xy", **p)


# ---- the ragged front's stages

CHAIN = ("full", "zero", "below_taps", "full")


def _n_valid(kind, block, taps):
    return {"full": block, "zero": 0, "below_taps": taps - 2}[kind]


def _ulp_close(a, b, maxulp=1):
    np.testing.assert_array_max_ulp(np.asarray(a, np.float32), np.asarray(b, np.float32), maxulp)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("d", [1, 2])
def test_fir_ragged_matches_jax(monkeypatch, exact, d):
    monkeypatch.setenv("SDRM_FIR_PRECISION", "highest")
    cfg = JaxConfig(*LUCKY7)
    taps = np.asarray(cfg.lpf2_taps(), np.float32)
    rev = taps[::-1].copy()
    t, block, rows = len(taps), 700, 2
    cap = t - 1 + d - 1
    max_out = -(-block // d) + 1
    rng = np.random.default_rng(d + 2 * exact)
    jst = jpl.FirRaggedState(jnp.zeros((rows, cap), jnp.float32), jnp.int32(t - 1))
    tst = tpl.FirRaggedState(torch.zeros((rows, cap)), torch.tensor(t - 1, dtype=torch.int32))
    rev_t = torch.from_numpy(rev)
    for kind in CHAIN:
        x = rng.standard_normal((rows, block)).astype(np.float32)
        nv = _n_valid(kind, block, t)
        jst, jy, jn = jpl._fir_ragged(jst, jnp.asarray(x), jnp.int32(nv), rev, d, max_out, exact)
        tst, ty, tn = tpl._fir_ragged(tst, torch.from_numpy(x), torch.tensor(nv, dtype=torch.int32),
                                      rev_t, d, max_out, exact)
        assert int(tn) == int(jn) and int(tst.hist_len) == int(jst.hist_len), kind
        assert ty.shape == jy.shape
        if exact:
            _ulp_close(ty.numpy(), np.asarray(jy))
            _ulp_close(tst.hist.numpy(), np.asarray(jst.hist), 0)
        else:
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
            np.testing.assert_array_equal(tst.hist.numpy(), np.asarray(jst.hist))
        if kind == "full":
            assert int(tn) > 300


def test_quad_demod_ragged_matches_jax():
    rng = np.random.default_rng(8)
    n = 500
    prev_j, prev_t = jnp.zeros(2, jnp.float32), torch.zeros(2)
    table = atan_table("cpu")
    # jitted, as the JAX streamer runs it: XLA then contracts the conjugate
    # product's first multiply and add into an FMA, as the port takes it, and
    # the table's interpolation too, which the port does not
    jquad = jax.jit(lambda pv, xx, nv: jpl._quad_demod_ragged(pv, xx, nv, 2.5, True))
    for nv in (n, 0, 1, 317):
        x = rng.standard_normal((2, n)).astype(np.float32)
        prev_j, yj = jquad(prev_j, jnp.asarray(x), jnp.int32(nv))
        prev_t, yt = tpl._quad_demod_ragged(prev_t, torch.from_numpy(x),
                                            torch.tensor(nv, dtype=torch.int32), 2.5, True, table)
        _ulp_close(yt.numpy(), np.asarray(yj), 2)
        np.testing.assert_array_equal(prev_t.numpy(), np.asarray(prev_j))


@pytest.mark.parametrize("d", [1, 2])
def test_dc_cumsum_stage_matches_jax(d):
    args = (48000, 4800, 5000, d, 2000, True)
    jp = jpl.DemodPipeline(JaxConfig(*args), 2048, exact=False)
    tp = tpl.DemodPipeline(FskDemodConfig(*args), 2048, device="cpu")
    c = 2
    jst = jax.tree.map(lambda a: jnp.broadcast_to(a, (c,) + a.shape), jp.init_state().dc)
    tst = tp.init_state(channels=c).dc
    cap = tst.hist.shape[-1]
    rng = np.random.default_rng(d)
    for kind in CHAIN:
        x = (0.3 + rng.standard_normal((c, 1, jp.max_dec))).astype(np.float32)
        nv = np.array([_n_valid(kind, jp.max_dec - 1, cap + 1), jp.max_dec - 5], np.int32)
        jst, jy, jn = jp._dc_cumsum_stage(jst, jnp.asarray(x), jnp.asarray(nv))
        tst, ty, tn = tp._dc_cumsum_stage(tst, torch.from_numpy(x), torch.from_numpy(nv))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(tst.hist_len.numpy(), np.asarray(jst.hist_len))
        np.testing.assert_array_equal(tst.hist.numpy(), np.asarray(jst.hist))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-4)


def test_dc_cumsum_gap_at_full_length():
    """The DC stage over one block of the bench.py length (2^20 samples,
    2^19 after d = 2) of the lucky7 capture, repeated: the port's float64
    running sums against JAX's float32 ones, and both against the DC
    blocker's (4L-3)-tap FIR in float64 (the same LTI filter).  ``pytest -s``
    prints the gaps (ROADMAP §C)."""
    block = 1 << 20
    iq = np.resize(np.fromfile(pathlib.Path(__file__).parent / "fixtures" / "lucky7.expected.cf32",
                               np.complex64), block)
    tp = tpl.DemodPipeline(FskDemodConfig(*LUCKY7), block, device="cpu")
    jp = jpl.DemodPipeline(JaxConfig(*LUCKY7), block, exact=False)
    st = tp.init_state()
    x = torch.from_numpy(np.stack([iq.real, iq.imag]))
    _, y2, n2 = tp._stage_firs(st, x, torch.tensor(block, dtype=torch.int32))
    y2, n2 = y2[None], n2[None]  # one channel of the batched stage
    dc = tpl.FirRaggedState(st.dc.hist[None], st.dc.hist_len[None])
    _, y_port, n_port = tp._dc_cumsum_stage(dc, y2, n2)
    jdc = jax.tree.map(lambda a: jnp.asarray(a.numpy()), dc)
    _, y_jax, _ = jp._dc_cumsum_stage(jpl.FirRaggedState(*jdc), jnp.asarray(y2.numpy()), jnp.asarray(n2.numpy()))
    _, y_fir, n_fir = tpl._fir_ragged(dc, y2, n2, tp.front_taps.rev_dc, 1, tp.max_dec, True)
    n = int(n_port[0])
    assert n == int(n_fir[0]) > 500000
    y_port, y_jax, y_fir = y_port[0, 0, :n].numpy(), np.asarray(y_jax)[0, 0, :n], y_fir[0, 0, :n].numpy()
    gaps = {
        "port - jax": float(np.abs(y_port - y_jax).max()),
        "port - fir": float(np.abs(y_port - y_fir).max()),
        "jax - fir": float(np.abs(y_jax - y_fir).max()),
    }
    print(f"DC stage over {n} samples, max gaps: {gaps}")
    assert gaps["port - fir"] < 1e-6
    assert gaps["port - jax"] < 1e-4
