"""The twins of the JAX package's tools and of its dry run, on the CPU.

- ``tools/graft_entry.py``: ``entry(device="cpu")`` against the JAX
  package's ``__graft_entry__.entry()`` on the same (4, 4096) noise: counts
  equal, symbols within +-2 LSB (float32 summed in another order); the dry
  run on a mesh of 4 repeated CPU devices runs to its end, every case equal
  to the port's unsharded step.
- ``tools/ber_sweep.py``: the sweep and the per-point mode at 3 SNRs x 256
  B, seed 0, against the JAX tool's functions: the same bits counted and at
  most one bit error apart at each point (the channel is the same numpy at
  the same seed; TX and RX differ by float rounding).
- ``tools/latency.py``: the JAX tool's keys, and its ``symbols_last`` at
  4096 on both shapes (the same blocks, the state carried the same).
- ``perf``, ``trace`` and the three ``profile_*``: ``main([... "--device",
  "cpu"])`` at a tiny size prints each report line; ``trace`` writes its
  Chrome trace.
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from sdrmodem_tpu_torch.tools import (
    ber_sweep,
    graft_entry,
    latency,
    perf,
    profile_front,
    profile_step,
    profile_variants,
    trace,
)
from tests.test_torch_fir import one_thread  # noqa: F401 (torch on one thread)

REPO = pathlib.Path(__file__).resolve().parents[1]
SNRS = [0.0, 4.0, 8.0]
BER_BYTES = 256


def jax_script(path: str, name: str):
    """A script of the JAX side outside the package (``tools/``, the root)."""
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lsb(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


# ---- graft_entry


def test_entry_matches_the_jax_entry():
    jfn, (jiq,) = jax_script("__graft_entry__.py", "jax_graft_entry").entry()
    jsym, jcnt = (np.asarray(a) for a in jfn(jiq))
    fn, (iq,) = graft_entry.entry(device="cpu")
    assert iq.dtype == torch.complex64 and tuple(iq.shape) == (4, 4096)
    np.testing.assert_array_equal(iq.numpy(), np.asarray(jiq))
    sym, cnt = fn(iq)
    np.testing.assert_array_equal(cnt.numpy(), jcnt)
    for lane in range(4):
        n = int(cnt[lane])
        assert n > 300 and _lsb(sym[lane, :n], jsym[lane, :n]) <= 2


def test_dryrun_multichip_on_repeated_cpu_devices(capsys):
    report = graft_entry.dryrun_multichip(4, devices=["cpu"] * 4)
    assert report["devices"] == ["cpu"] * 4
    assert report["a_channel_sharded"]["channels"] == 8 and report["a_channel_sharded"]["symbols"] > 0
    assert report["b_time_sharded"]["symbols"] > 0
    assert report["c_full_sharded"]["pallas_lane0_symbols"] > 0
    sched = report["d_pipelined"]["schedule"]
    assert sched["idle_device_rounds"] == 0 and sched["streams_per_group"] == 2
    assert report["d_pipelined"]["samples"] == 4 * graft_entry.STREAM_BLOCK
    assert report["e_grid"]["grid"] == [2, 2]
    # the JAX stream length, 1024 a shard, leaves the DC stage short of its history
    with pytest.raises(ValueError, match="history"):
        from sdrmodem_tpu_torch.parallel import time_shard
        from sdrmodem_tpu_torch.parallel.mesh import Mesh

        time_shard.demod_pipelined(np.zeros((8, 4 * 1024), np.complex64), graft_entry.LUCKY7,
                                   Mesh(["cpu"] * 4), clock_backend="scan")
    with pytest.raises(ValueError, match="devices for a mesh"):
        graft_entry.dryrun_multichip(4, devices=["cpu"] * 2)
    assert graft_entry.main(["--devices", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("entry: FskDemodulator.process on (4, 4096)")
    assert json.loads(out[-1])["ok"] is True and "e_grid" not in json.loads(out[-1])


# ---- ber_sweep


@pytest.fixture(scope="module")
def jax_ber():
    tool = jax_script("tools/ber_sweep.py", "jax_ber_sweep")
    return (tool.run_sweep_batched(SNRS, 0.0, BER_BYTES, 0),
            [tool.run_point(snr, 0.0, BER_BYTES, 0) for snr in SNRS])


def _within_one_bit(got_ber, got_bits, want_ber, want_bits):
    assert got_bits == want_bits
    assert abs(round(got_ber * got_bits) - round(want_ber * want_bits)) <= 1


def test_ber_sweep_matches_the_jax_tool(jax_ber):
    points = ber_sweep.run_sweep_batched(SNRS, 0.0, BER_BYTES, 0, device="cpu")
    assert [p["snr_db"] for p in points] == SNRS
    for got, want in zip(points, jax_ber[0]):
        assert set(got) == set(want) == {"snr_db", "ber", "bits"}
        _within_one_bit(got["ber"], got["bits"], want["ber"], want["bits"])
    assert points[-1]["ber"] <= points[0]["ber"]


def test_ber_point_mode_matches_the_jax_tool(jax_ber, capsys):
    for snr, want in zip(SNRS, jax_ber[1]):
        _within_one_bit(*ber_sweep.run_point(snr, 0.0, BER_BYTES, 0, device="cpu"), *want)
    points = ber_sweep.main(["--snrs", "8", "--bytes", str(BER_BYTES), "--point-mode", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == points[0]
    ber_sweep.main(["--snrs", "8", "--bytes", str(BER_BYTES), "--device", "cpu"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["metric"] == "ber_sweep" and report["platform"] == "cpu" and len(report["points"]) == 1


# ---- latency


def test_latency_counts_match_the_jax_tool(tmp_path, capsys):
    jout = tmp_path / "jax.json"
    jax_script("tools/latency.py", "jax_latency").main(["--reps", "2", "--cpu", "--blocks", "4096",
                                                         "--out", str(jout)])
    want = json.loads(jout.read_text())
    out = tmp_path / "LATENCY.json"
    assert latency.main(["--reps", "2", "--blocks", "4096", "--out", str(out), "--device", "cpu"]) == 0
    got = json.loads(out.read_text())
    assert "host to host" in got["timing"] and got["platform"] == "cpu" and "card" not in got
    assert [r["shape"] for r in got["results"]] == [r["shape"] for r in want["results"]]
    for g, w in zip(got["results"], want["results"]):
        assert set(g) == set(w)
        assert g["symbols_last"] == w["symbols_last"] > 0 and g["reps"] == 2
        assert g["p10_ms"] <= g["median_ms"] <= g["p90_ms"]
    assert "host to host" in capsys.readouterr().out


# ---- perf, trace and the profiles, at a tiny size


def test_perf_prints_every_section(capsys):
    assert perf.main(["--small", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for words in ("timing: host clock", "gfsk_mod chain:", "gfsk_mod fused:", "-B TxData: 2 msgs",
                  "sustained stream", "COALESCED", "[reference M1: 74 Msamples/s]", "4ch x 256 bytes",
                  "fsk_demod: 2 x 4096 samples", "[reference M1: 0.037 s = 11.0 Msamples/s]",
                  "batched full path"):
        assert words in out, words


def test_trace_writes_a_chrome_trace(tmp_path, capsys):
    assert trace.main(["--block", "2048", "--channels", "2", "--steps", "1", "--out", str(tmp_path),
                       "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rep = json.loads(lines[-1])
    assert lines[0].startswith("traced 1 steps")
    assert {"kernels", "window_ms", "device_busy_ms", "host_share", "trace"} <= set(rep)
    assert rep["kernels"] == {} and rep["host_share"] == 1.0  # no device on the CPU
    assert json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    # the summary of a card's trace: launches, device time, the union of busy spans
    fake = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 50, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 300, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 1000},
    ]}
    s = trace.summarize(fake)
    assert s["kernels"] == {"k": {"launches": 2, "device_ms": 0.2}}
    assert s["window_ms"] == 1.0 and s["device_busy_ms"] == 0.25 and s["host_share"] == 0.75


@pytest.fixture
def tiny_bench(monkeypatch):
    for name, value in (("SDRM_BENCH_BLOCK", "4096"), ("SDRM_BENCH_CHANNELS", "4"), ("SDRM_BENCH_ITERS", "1")):
        monkeypatch.setenv(name, value)


@pytest.mark.parametrize("source", ["noise", "fixture"])
def test_profile_step_splits_the_step(tiny_bench, monkeypatch, capsys, source):
    monkeypatch.setenv("SDRM_PROFILE_INPUT", source)
    assert profile_step.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "not ported: TPU workaround: SDRM_FIR_PRECISION" in out
    for words in ("block=4096 channels=4 front=fused_front", "full step :", "healed chunks (one step): 0",
                  "front-end :", "clock only:", "other     :"):
        assert words in out, words


def test_profile_front_times_every_stage(tiny_bench, capsys):
    assert profile_front.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "not ported: TPU workaround: SDRM_CLOCK_SHIFT_MAX" in out
    for row in ("transpose", "lpf1 (B3)", "quad(lut)", "quad(atan2)", "lpf2 (B3)", "dc (B3)",
                "B1 both launches", "B1 first launch", "B1 DC launch", "clock(lockstep)", "clock(mixed)"):
        assert f"{row:16s}:" in out, row


def test_profile_variants_names_each_route(tiny_bench, capsys):
    times = profile_variants.main(["--device", "cpu"])
    assert times == 0
    out = capsys.readouterr().out
    assert 'not ported: TPU workaround: "null"' in out
    lines = {line.split(":")[0].strip(): line for line in out.splitlines() if "ms/step" in line}
    assert len(lines) == 8
    assert "route banded (B3, B2)" in lines["tm fused-front, atan2"]
    assert "route step (B7)" in lines["tm STEP (fused front+clock)"]
    assert "route fused (B1, B2)" in lines["tm fused-front (production)"]
    symbols = {name: line.split("symbols ")[1].split(";")[0] for name, line in lines.items() if "symbols" in line}
    # tm and cm read the same samples; the fused, banded and step fronts give the same symbols
    assert symbols["tm fused-front (production)"] == symbols["cm fused-front"] == symbols["tm BANDED front"]
    assert "M&M clock kernel share" in out
