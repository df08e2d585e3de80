"""The port's tools and checkpoints on the CPU: ``tools/parity.py``,
``utils/checkpoint.py``, and the entry points' device choice (the twins of
the JAX tools among them; their reports: ``test_torch_tools_a6.py``).

- The parity tool's gate passes on the goldens in both modes, fails (exit
  1) on symbols beyond the bound, and its per-fixture numbers and gate are
  the JAX tool's (``tools/parity.py:_report``, ``evaluate_gate``) on the
  same symbols, key for key and value for value.
- Checkpoints round-trip as ``tests/test_full_path.py:139`` and
  ``tests/test_orbit.py:96`` have it for the JAX package: the resumed run
  emits exactly what the uninterrupted run emits.  A JAX snapshot resumes
  in the port where the leaves' shapes agree (a full-block state at 128
  lanes, a streamer's ragged state): every leaf equal, and the resumed
  symbols within +-2 LSB of JAX's own resumed run with counts equal (float32
  in another order).  Where they do not (fewer than 128 lanes: JAX pads
  them), loading raises, and ``utils/convert.py`` crosses first.
- Without ``device="cpu"`` the new entry points take the card, and raise
  here.
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdrmodem_tpu.dsp.fsk_demod import FskDemodConfig as JaxConfig
from sdrmodem_tpu.dsp.pipeline import DemodPipeline as JaxPipeline
from sdrmodem_tpu.utils import checkpoint as jax_checkpoint
from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
from sdrmodem_tpu_torch.tools import parity
from sdrmodem_tpu_torch.utils.checkpoint import load_state, save_state
from sdrmodem_tpu_torch.utils.convert import full_state_from_numpy
from tests.test_torch_fir import one_thread  # noqa: F401 (torch on one thread)

REPO = pathlib.Path(__file__).resolve().parents[1]
LUCKY7 = (48000, 4800, 5000, 2, 2000, True)


def jax_tool():
    """The JAX package's tools/parity.py (a script outside the package)."""
    spec = importlib.util.spec_from_file_location("jax_parity_tool", REPO / "tools" / "parity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- the parity tool


def test_parity_gate_passes_in_both_modes(tmp_path, capsys):
    out = tmp_path / "parity.json"
    rc = parity.main(["--device", "cpu", "--mode", "both", "--gate", "--cases", "lucky7,nan",
                      "--out", str(out)])
    assert rc == 0
    report = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == report
    assert {"fixtures", "gate", "fixtures_exact", "gate_exact"} <= set(report)
    assert report["platform"] == "cpu" and "card" not in report
    for key in ("fixtures", "fixtures_exact"):
        assert set(report[key]) == {"lucky7", "nan"}
        for rep in report[key].values():
            assert rep["beyond_tol_rate"] == 0.0 and rep["hard_decision_agreement"] == 1.0
            assert rep["missing"] == 0 and rep["max_lsb_diff"] <= 2
    assert report["gate"] == report["gate_exact"] == {"pass": True, "failures": []}
    # the exact streamer stops at the capture's end; the full-block step pads
    assert report["fixtures_exact"]["lucky7"]["produced"] == report["fixtures_exact"]["lucky7"]["n_symbols"]


def test_parity_report_and_gate_are_the_jax_tools():
    """The same symbols give the JAX tool's numbers and verdict, key for
    key; the port's gate is the reference's bound on every fixture, where
    the JAX tool lets lucky7_nodc past 0.005 on its TPU."""
    tool = jax_tool()
    rng = np.random.default_rng(0)
    golden = rng.integers(-60, 60, 4000).astype(np.int8)
    for got in (golden.copy(), (golden + rng.integers(-2, 3, 4000)).astype(np.int8),
                np.concatenate([golden[:1000], -golden[1000:1300], golden[1300:3900]])):
        assert parity.fixture_report(got, golden) == tool._report(got, golden)
        fixtures = {"lucky7": parity.fixture_report(got, golden)}
        assert parity.evaluate_gate(fixtures) == tool.evaluate_gate(fixtures, tool.GATE)
    assert parity.GATE == tool.GATE_EXACT_CPU
    assert [c[0] for c in parity.CASES] == [c[0] for c in tool.CASES]
    for (_, cfg, fin, fexp), (_, args, jfin, jfexp) in zip(parity.CASES, tool.CASES):
        assert (cfg, fin, fexp) == (FskDemodConfig(*args), jfin, jfexp)


def test_parity_gate_fails_beyond_the_bound(monkeypatch, tmp_path):
    """Symbols 3 LSB off everywhere: the gate fails and main returns 1."""
    real = parity.demod_capture
    monkeypatch.setattr(parity, "demod_capture",
                        lambda pipe, iq: np.clip(real(pipe, iq).astype(np.int16) + 3, -128, 127).astype(np.int8))
    assert parity.main(["--device", "cpu", "--mode", "exact", "--gate", "--cases", "nan"]) == 1
    report = parity.run(names=["nan"], modes=("exact",), device="cpu")
    assert report["gate_exact"]["pass"] is False and "beyond_tol_rate" in report["gate_exact"]["failures"][0]
    with pytest.raises(SystemExit):
        parity.main(["--device", "cpu", "--cases", "nosuch"])


# ---- checkpoints


def test_full_state_checkpoint_resume(tmp_path):
    """A full-block state snapshotted mid-stream, restored and stepped on,
    emits exactly what the uninterrupted run emits."""
    cfg = FskDemodConfig(*LUCKY7)
    channels, block = 2, 4096
    pipe = DemodPipeline(cfg, block, device="cpu")
    step = pipe.make_batched_step_full("scan")
    rng = np.random.default_rng(0)
    iq = (rng.standard_normal((channels, 3 * block)) + 1j * rng.standard_normal((channels, 3 * block)))
    x = np.stack([iq.real, iq.imag], axis=1).astype(np.float32)
    blocks = [torch.from_numpy(x[:, :, i * block : (i + 1) * block].copy()) for i in range(3)]

    state, _, _ = step(pipe.init_full_state(channels), blocks[0])
    save_state(state, tmp_path / "snap.npz", meta={"block_index": 1})
    state, s1, c1 = step(state, blocks[1])
    state, s2, c2 = step(state, blocks[2])

    restored, meta = load_state(pipe.init_full_state(channels), tmp_path / "snap.npz")
    assert meta == {"block_index": 1}
    restored, r1, rc1 = step(restored, blocks[1])
    restored, r2, rc2 = step(restored, blocks[2])
    for a, b in ((c1, rc1), (s1, r1), (c2, rc2), (s2, r2)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="different pipeline configuration"):
        load_state(pipe.init_full_state(3), tmp_path / "snap.npz")


def test_checkpoint_resume_demod(resources_dir, tmp_path):
    """A streamer restored from a snapshot continues identically."""
    iq = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)[:24576]
    pipe = DemodPipeline(FskDemodConfig(*LUCKY7), 8192, device="cpu")
    s = pipe.streamer()
    s.process(iq[:8192])
    s.process(iq[8192:16384])
    save_state(s.state, tmp_path / "snap.npz", meta={"blocks": 2})
    a3 = s.process(iq[16384:])
    r = pipe.streamer()
    r.state, meta = load_state(r.state, tmp_path / "snap.npz")
    assert meta["blocks"] == 2 and r.state.dc is not None
    np.testing.assert_array_equal(a3, r.process(iq[16384:]))


def test_sharded_states_checkpoint_resume(resources_dir, tmp_path):
    """A list of per-shard states (a sharded class's) snapshots as one file
    and resumes to the same symbols."""
    from sdrmodem_tpu_torch.parallel.channels import ShardedChannelDemodFull
    from sdrmodem_tpu_torch.parallel.mesh import Mesh

    iq = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)[:8192]
    sharded = ShardedChannelDemodFull(FskDemodConfig(*LUCKY7), 4096, 4, Mesh(["cpu"] * 2, "channel"))
    x = [sharded.place_input(np.tile(iq[i * 4096 : (i + 1) * 4096], (4, 1))) for i in range(2)]
    state, _, _ = sharded.step(sharded.init_state(), x[0])
    save_state(state, tmp_path / "snap.npz")
    _, want, _ = sharded.step(state, x[1])
    restored, _ = load_state(sharded.init_state(), tmp_path / "snap.npz")
    _, got, _ = sharded.step(restored, x[1])
    assert torch.equal(got, want)


def test_jax_snapshot_resumes_in_the_port(resources_dir, tmp_path):
    """JAX's full-block state at 128 lanes has the port's leaf shapes: its
    snapshot loads bit for bit into the port's template and the next block
    is within +-2 LSB of JAX's own next block.  At 2 lanes JAX pads to 128,
    so the snapshot does not load as it is and crosses through
    ``full_state_from_numpy``."""
    cfg, jcfg = FskDemodConfig(*LUCKY7), JaxConfig(*LUCKY7)
    iq = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)[:8192]
    block, channels = 4096, 128
    x = [np.broadcast_to(np.stack([iq[i * block : (i + 1) * block].real,
                                   iq[i * block : (i + 1) * block].imag]).astype(np.float32),
                         (channels, 2, block)).copy() for i in range(2)]
    jpipe = JaxPipeline(jcfg, block, exact=False, use_atan_lut=True)
    jstep = jpipe.make_batched_step_full("scan")
    jstate, _, _ = jstep(jpipe.init_full_state(channels), jnp.asarray(x[0]))
    jax_checkpoint.save_state(jstate, tmp_path / "jax.npz", meta={"from": "jax"})
    _, jsym, jcnt = jstep(jstate, jnp.asarray(x[1]))

    pipe = DemodPipeline(cfg, block, device="cpu")
    state, meta = load_state(pipe.init_full_state(channels), tmp_path / "jax.npz")
    assert meta == {"from": "jax"}
    for got, want in zip([t for t in jax.tree.leaves(state)], jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _, sym, cnt = pipe.make_batched_step_full("scan")(state, torch.from_numpy(x[1]))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    lane = np.concatenate([sym[0, t, : cnt[0, t]].numpy() for t in range(cnt.shape[1])])
    jlane = np.concatenate([np.asarray(jsym)[0, t, : int(jcnt[0, t])] for t in range(jcnt.shape[1])])
    assert np.abs(lane.astype(np.int32) - jlane.astype(np.int32)).max() <= 2

    # fewer lanes than JAX's 128: the leaves differ, so load raises and convert crosses
    jsmall = jpipe.init_full_state(2)
    jax_checkpoint.save_state(jsmall, tmp_path / "small.npz")
    with pytest.raises(ValueError, match="mismatch"):
        load_state(pipe.init_full_state(2), tmp_path / "small.npz")
    small = full_state_from_numpy(jax.tree.map(np.asarray, jsmall), 2, device="cpu")
    assert small.lpf1_hist.shape == pipe.init_full_state(2).lpf1_hist.shape


def test_jax_streamer_snapshot_resumes_in_the_port(resources_dir, tmp_path):
    """The streamer's ragged state has the same leaves in both packages: a
    JAX exact streamer's snapshot resumes in the port's exact streamer, its
    next symbols within +-2 LSB of JAX's with the same count."""
    iq = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)[:24576]
    js = JaxPipeline(JaxConfig(*LUCKY7), 8192, exact=True).streamer()
    js.process(iq[:16384])
    jax_checkpoint.save_state(js.state, tmp_path / "jax.npz", meta={"blocks": 2})
    want = np.asarray(js.process(iq[16384:]))
    s = DemodPipeline(FskDemodConfig(*LUCKY7), 8192, exact=True, device="cpu").streamer()
    s.state, meta = load_state(s.state, tmp_path / "jax.npz")
    got = s.process(iq[16384:])
    assert meta == {"blocks": 2} and len(got) == len(want)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 2


# ---- the card by default


def test_new_entry_points_take_the_card():
    """Without device="cpu" each new entry point takes the card; with no
    card it raises naming device='cpu', never carrying on on the CPU."""
    from sdrmodem_tpu_torch.parallel.channels import ShardedChannelDemod
    from sdrmodem_tpu_torch.parallel.mesh import Mesh
    from sdrmodem_tpu_torch.server.config import ServerConfig
    from sdrmodem_tpu_torch.server.tcp_server import SdrModemServer
    from sdrmodem_tpu_torch.tools import (
        ber_sweep,
        graft_entry,
        latency,
        multihost,
        perf,
        profile_front,
        profile_step,
        profile_variants,
        trace,
    )

    cfg = FskDemodConfig(*LUCKY7)
    if torch.cuda.is_available():
        assert Mesh().devices[0].type == "cuda"
        return
    calls = [
        lambda: Mesh(),
        lambda: Mesh(["cuda"] * 2),
        lambda: ShardedChannelDemod(cfg, 4096, 4, Mesh()),
        lambda: parity.run(names=["nan"]),
        lambda: parity.main(["--cases", "nan"]),
        lambda: multihost.main(["--streams", "4", "--samples", "16384"]),
        lambda: SdrModemServer(ServerConfig(), device="cpu", devices=["cuda", "cuda"]),
        lambda: graft_entry.entry(),
        lambda: graft_entry.dryrun_multichip(2),
    ]
    # each twin of the JAX tools, as ``python -m`` runs it without --device
    calls += [lambda tool=tool: tool.main(args) for tool, args in (
        (graft_entry, ["--devices", "2"]), (perf, ["--small"]), (latency, ["--reps", "1"]),
        (ber_sweep, ["--snrs", "0"]), (trace, ["--steps", "1"]), (profile_step, []), (profile_front, []),
        (profile_variants, []),
    )]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
