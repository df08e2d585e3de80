"""The slice as a whole: the server's per-client RX on the port, on the CPU.

- The four golden fixtures through the exact streamer
  (``DemodPipeline(cfg, 8192, exact=True).streamer()``, the server's
  default ``demod_mode``) and through ``FskDemodulator``: within ±2 LSB of
  the goldens (test/test_fsk_demod.c:43-48), hard-decision agreement 1.0,
  and exactly the golden's count.  Against the JAX package's exact
  ``FskDemodulator``: the fronts give the same y3 bit for bit (the same
  float64 FIRs, the same contracted conjugate product and table); the
  clock's 8-tap interpolator sum is taken in another order (the port's in
  tap order without FMAs, as its kernels take it; JAX's by the XLA dot),
  which moves a few symbols by 1 LSB, and on nusat, whose soft values
  reach ~3.8x the int8 range, 3 symbols by 2 (ROADMAP §C).
- The ``exact=False`` streamer (a fast-mode client demoted past the group
  cap) and ``make_batched_step("pallas")`` hold ±2 LSB.
- Invariance: the exact streamer gives the same bytes at blocks 4096 and
  8192 and when the stream comes in ``process`` calls cut at odd points
  (the shorter runs give the first symbols of the whole capture's run);
  in ``make_batched_step`` a lane with a ragged ``n_valid`` gives what its
  own streamer gives.
- Hand-off: the JAX streamer's state after k blocks carries into the port,
  whose symbols then equal the JAX streamer's continuation within ±1 LSB.
- Entry points default to the card and raise without one.

The runs of a fixture are made once and shared by the tests that read them.
Torch runs on one thread here (``tests/test_torch_fir.py:one_thread``).
"""

import dataclasses
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrmodem_tpu.dsp.fsk_demod import FskDemodConfig as JaxConfig
from sdrmodem_tpu.dsp.fsk_demod import FskDemodulator as JaxDemodulator
from sdrmodem_tpu.dsp.pipeline import DemodPipeline as JaxPipeline
from sdrmodem_tpu_torch import DemodPipeline, FskDemodConfig, FskDemodulator
from sdrmodem_tpu_torch.dsp.clock_recovery import initial_state, tail_cap_for
from sdrmodem_tpu_torch.ops import clock as clock_ops
from sdrmodem_tpu_torch.ops import fir as fir_ops
from sdrmodem_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
from sdrmodem_tpu_torch.utils.parity import GOLDEN_CASES, golden_report
from tests.test_torch_fir import one_thread  # noqa: F401 (torch on one thread)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
CASES = {c[0]: c for c in GOLDEN_CASES}
LUCKY7 = (48000, 4800, 5000, 2, 2000, True)
BLOCK = 8192


def _capture(name):
    _, cfg, fin, fexp, _ = CASES[name]
    return cfg, np.fromfile(FIXTURES / fin, np.complex64), np.fromfile(FIXTURES / fexp, np.int8)


@functools.lru_cache(maxsize=None)
def _runs(name):
    """The fixture through every route, once."""
    cfg, iq, golden = _capture(name)
    before = (clock_ops.ragged_launches, fir_ops.exact_launches, fir_ops.launches)
    sym, cnt, _ = FskDemodulator(cfg, device="cpu").process(iq)
    # the JAX chain as one compiled program (the same bytes as its eager
    # ``process`` on all four fixtures, in a tenth of the time)
    jsym, jcnt = JaxDemodulator(JaxConfig(*dataclasses.astuple(cfg))).jit_process(jnp.asarray(iq))
    runs = dict(
        golden=golden,
        exact=DemodPipeline(cfg, BLOCK, exact=True, device="cpu").streamer().process(iq),
        fsk_demodulator=sym[: int(cnt)].numpy(),
        float32=DemodPipeline(cfg, BLOCK, device="cpu").streamer().process(iq),
        jax_exact=np.asarray(jsym)[: int(jcnt)],
    )
    # the CPU runs the plain versions: nothing was launched
    assert (clock_ops.ragged_launches, fir_ops.exact_launches, fir_ops.launches) == before
    return runs


def _lsb(a, b):
    n = min(len(a), len(b))
    return np.abs(a[:n].astype(np.int32) - b[:n].astype(np.int32))


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("route", ["exact", "fsk_demodulator", "float32"])
def test_golden_fixture(name, route):
    runs = _runs(name)
    got, golden = runs[route], runs["golden"]
    rep = golden_report(got, golden)
    print(f"{name} {route}: {rep}")
    assert got.dtype == np.int8
    assert rep["max_lsb"] <= 2, rep
    assert rep["hard_decision_agreement"] == 1.0
    if route != "float32":
        assert len(got) == len(golden)


JAX_LSB = {"lucky7": 1, "lucky7_nodc": 1, "nusat": 2, "nan": 1}


@pytest.mark.parametrize("name", list(CASES))
def test_exact_matches_jax(name):
    runs = _runs(name)
    for route in ("exact", "fsk_demodulator"):
        d = _lsb(runs[route], runs["jax_exact"])
        print(f"{name} {route} vs JAX exact: {int((d > 0).sum())} of {len(d)} symbols differ, max {d.max()}")
        assert len(runs[route]) == len(runs["jax_exact"])
        assert d.max() <= JAX_LSB[name]
        assert (d > 1).sum() <= 3


def test_batched_step_pallas_golden():
    """tests/test_pallas.py:149-169 on the port: 3 lanes, block 8192."""
    cfg, iq, golden = _capture("lucky7")
    iq = iq[:24576]
    c = 3
    pipe = DemodPipeline(cfg, BLOCK, device="cpu")
    step = pipe.make_batched_step("pallas")
    state = pipe.init_state(channels=c)
    nv = torch.full((c,), BLOCK, dtype=torch.int32)
    out = []
    for i in range(0, len(iq), BLOCK):
        chunk = iq[i : i + BLOCK]
        x = np.stack([np.tile(chunk.real, (c, 1)), np.tile(chunk.imag, (c, 1))], axis=1)
        state, sym, cnt = step(state, torch.from_numpy(x.astype(np.float32)), nv)
        assert sym.shape[0] == cnt.shape[0] == c and torch.equal(sym[0], sym[2])
        out.append(sym[0, : int(cnt[0])].numpy())
    got = np.concatenate(out)
    assert len(got) > 2400
    assert _lsb(got, golden).max() <= 2


def test_exact_streamer_invariant_to_blocks_and_cuts():
    """The capture's first 16384 samples at block 4096, and in ``process``
    calls cut at odd points, give the first symbols of the whole capture's
    run at block 8192 (the shared run), byte for byte."""
    cfg, iq, _ = _capture("lucky7")
    whole = _runs("lucky7")["exact"]
    iq = iq[:16384]
    a = DemodPipeline(cfg, 4096, exact=True, device="cpu").streamer().process(iq)
    s = DemodPipeline(cfg, BLOCK, exact=True, device="cpu").streamer()
    cuts = [0, 1, 777, 5000, 13001, 13002, len(iq)]
    c = np.concatenate([s.process(iq[lo:hi]) for lo, hi in zip(cuts, cuts[1:])])
    assert len(a) > 1500
    assert np.array_equal(a, whole[: len(a)]) and np.array_equal(a, c)
    assert s.process(iq[:0]).shape == (0,)


@pytest.mark.parametrize("clock_backend", ["pallas", "scan"])
@pytest.mark.parametrize("exact", [True, False])
def test_batched_lane_equals_its_streamer(clock_backend, exact):
    """Lane 1 takes chunks of ragged length (lane 0 full blocks); each lane
    gives what its own streamer gives on the same chunks.  Without a DC
    blocker the float32 batched front is the streamer's front (with one,
    ``_front_batched`` takes the cascaded moving averages instead)."""
    args = LUCKY7 if exact else (48000, 4800, 5000, 2, 2000, False)
    cfg = FskDemodConfig(*args)
    _, iq, _ = _capture("lucky7")
    block = 2048
    pipe = DemodPipeline(cfg, block, exact=exact, device="cpu")
    step = pipe.make_batched_step(clock_backend)
    state = pipe.init_state(channels=2)
    lens = [block, 1500, 0, 100, block, 37, 1999]
    streams = [pipe.streamer(), pipe.streamer()]
    got, want = [[], []], [[], []]
    pos = [0, 0]
    for n1 in lens:
        x = np.zeros((2, 2, block), np.float32)
        for lane, n in enumerate((block, n1)):
            chunk = iq[pos[lane] : pos[lane] + n]
            x[lane, 0, :n], x[lane, 1, :n] = chunk.real, chunk.imag
            want[lane].append(streams[lane].process(chunk))
            pos[lane] += n
        nv = torch.tensor([block, n1], dtype=torch.int32)
        state, sym, cnt = step(state, torch.from_numpy(x), nv)
        for lane in range(2):
            got[lane].append(sym[lane, : int(cnt[lane])].numpy())
    for lane in range(2):
        g, w = np.concatenate(got[lane]), np.concatenate(want[lane])
        assert len(g) > 500 and np.array_equal(g, w)


def test_jax_streamer_hands_off_to_port():
    """Two blocks through the JAX exact streamer, its DemodState carried
    into the port, two more blocks in both."""
    cfg, iq, _ = _capture("lucky7")
    block = 4096
    jstream = JaxPipeline(JaxConfig(*LUCKY7), block, exact=True).streamer()
    for k in range(2):
        jstream.process(iq[k * block : (k + 1) * block])
    jstate = jax.tree.map(np.asarray, jstream.state)
    state = state_from_numpy(jstate, device="cpu")
    assert state.clock.tail.shape == (tail_cap_for(cfg.sps),)
    back = state_to_numpy(state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    stream = DemodPipeline(cfg, block, exact=True, device="cpu").streamer()
    stream.state = state
    rest = iq[2 * block : 4 * block]
    want, got = jstream.process(rest), stream.process(rest)
    assert len(got) == len(want) > 700
    assert _lsb(got, want).max() <= 1


def test_entry_points_default_to_the_card():
    """Without a device the streamer, FskDemodulator and initial_state go
    to the card; with no card they raise rather than carrying on on the
    CPU."""
    cfg = FskDemodConfig(*LUCKY7)
    makers = (
        lambda: DemodPipeline(cfg, 1024, exact=True).streamer().state.lpf1.hist,
        lambda: FskDemodulator(cfg)._lpf1,
        lambda: initial_state(cfg.sps).tail,
    )
    for make in makers:
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
