"""The result line: its keys, its metrics by the trace flag, and no result
without a card."""

import subprocess
import sys

from benchmark import core
from benchmark.run import result_line

OUT = {"attempted": 12, "failed": 0, "memory_peak_bytes": 123,
       "numbers": {"off2_share": 0.0, "count_gap": 0, "symbols": 10},
       "setup_parts": {"import": 3.0, "context": 1.0, "traffic": 1.0, "program": 0.5, "warmup": 4.0},
       "metrics": {"rx_msps": 6000.5, "setup_s": 9.5, "served_msps": 1.0, "block_p95_ms": 2.0},
       "layer": {"steps": 4, "window_s": 1.0, "lanes": 128, "block": 262144, "symbols_per_step": 3.3e6,
                 "n_chunks": 64, "k": 536, "taps": (157, 57, 637), "d": 2, "s_rows": 7, "sfx": 64,
                 "fanout": True}}
SUMMARY = {"window_s": 1.0, "busy_s": 0.9, "gaps": {"bench.wait": 0.1},
           "kernels": {"front_kernel": {"launches": 4, "seconds": 0.004},
                       "fir_blocked_tm_kernel": {"launches": 4, "seconds": 0.002},
                       "mm_chunked_kernel": {"launches": 4, "seconds": 0.013},
                       "gpu_memcpy": {"launches": 8, "seconds": 0.001}}}


def test_end_to_end_line():
    cell = core.Cell("lucky7.fanout128")
    line = result_line(cell, OUT, None, "NVIDIA H100 80GB HBM3")
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert set(line["metrics"]) == {"rx_msps", "setup_s"}
    assert line["metrics"]["rx_msps"] == {"value": 6000.5, "unit": "Msamples/s"}
    assert line["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                              "memory_peak_bytes": 123}
    assert line["checks"]["off2_share"] == {"value": 0.0, "limit": cell.limits["off2_share"]}
    assert line["setup_parts"] == OUT["setup_parts"]


def test_traced_line_has_the_per_layer_metrics():
    cell = core.Cell("lucky7.fanout128")
    line = result_line(cell, OUT, SUMMARY, "NVIDIA H100 80GB HBM3")
    assert set(line["metrics"]) == {m["name"] for m in cell.per_layer}
    assert line["metrics"]["step.launches"]["value"] == 3.0
    assert line["device"]["busy_s"] == 0.9 and line["device"]["window_s"] == 1.0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["breakdown"]["device_ops"][0] == ["mm_chunked_kernel", 0.013]
    assert 0 < line["metrics"]["front.roofline_pct"]["value"] < 100


def test_a_number_over_its_limit_or_missing_is_not_correct():
    cell = core.Cell("lucky7.fanout128")
    bad = {**OUT, "numbers": {"off2_share": 2 * cell.limits["off2_share"]}}
    assert result_line(cell, bad, None, "x")["correct"] is False
    assert result_line(cell, {**OUT, "numbers": {}}, None, "x")["correct"] is False
    assert result_line(cell, {**OUT, "failed": 1}, None, "x")["correct"] is False


def test_no_card_no_result():
    r = subprocess.run([sys.executable, str(core.BENCH / "run.py"), "--workload", "lucky7.fanout128",
                        "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=core.ROOT,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert r.returncode != 0
    assert r.stdout.strip() == ""
