"""The trace's arithmetic on a hand-made Chrome trace: the window, the
device's busy time as the union of its work, the kernels by name and the
idle gaps by what the host was doing."""

import json

import pytest

from benchmark import tracing


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


@pytest.fixture
def trace(tmp_path):
    events = [
        ev(tracing.WINDOW, "user_annotation", 1000.0, 1000.0),
        ev("void front_kernel<2>(FrontParams)", "kernel", 900.0, 200.0),  # clipped to [1000, 1100]
        ev("mm_chunked_kernel", "kernel", 1050.0, 250.0),  # overlaps: busy [1000, 1300]
        ev("Memcpy DtoH", "gpu_memcpy", 1500.0, 100.0),  # busy [1500, 1600]
        ev("aten::cat", "cpu_op", 1350.0, 100.0),  # host, in the gap [1300, 1500]
        ev("bench.step", "user_annotation", 1600.0, 400.0),  # host, in the gap [1600, 2000]
        ev("mm_chunked_kernel", "kernel", 2100.0, 50.0),  # after the window
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_busy_window_and_kernels(trace):
    s = tracing.summarize(trace)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(400e-6)
    assert s["kernels"]["front_kernel<2>"] == {"launches": 1, "seconds": pytest.approx(100e-6)}
    assert s["kernels"]["mm_chunked_kernel"]["launches"] == 1
    assert s["kernels"]["gpu_memcpy"]["launches"] == 1
    assert s["gaps"] == {"aten::cat": pytest.approx(200e-6), "bench.step": pytest.approx(400e-6)}
    assert tracing.kernel_seconds(s, ["front_kernel", "mm_chunked"]) == (pytest.approx(350e-6), 2)


def test_the_innermost_span_names_a_gap(tmp_path):
    events = [
        ev(tracing.WINDOW, "user_annotation", 0.0, 1000.0),
        ev("bench.wait", "user_annotation", 0.0, 1000.0),  # the whole window
        ev("aten::copy_", "cpu_op", 150.0, 100.0),  # begun later, running at the first gap's middle
        ev("mm_chunked_kernel", "kernel", 300.0, 200.0),  # gaps [0, 300] and [500, 1000]
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = tracing.summarize(path)
    assert s["gaps"] == {"aten::copy_": pytest.approx(300e-6), "bench.wait": pytest.approx(500e-6)}
    b = tracing.breakdown(s)
    assert b["idle_gaps"][0] == ["bench.wait", pytest.approx(500e-6)]
    assert b["device_ops"][0] == ["mm_chunked_kernel", pytest.approx(200e-6)]


def test_front_patterns_take_the_staging_and_not_the_tables():
    from benchmark import core

    pats = tracing.read_patterns(core.BENCH / "metrics" / "front.roofline_pct.patterns.txt")
    staging = "at::native::CatArrayBatchedCopy<at::native::OpaqueType<4u>, unsigned int, 2, 64, 64>"
    stack = "at::native::CatArrayBatchedCopy_vectorized<at::native::OpaqueType<4u>, unsigned int, 1, 128, 1, 16, "
    summary = {"kernels": {"front_kernel<2>": {"launches": 2, "seconds": 0.004},
                           "fir_blocked_tm_kernel<float, 1, true>": {"launches": 2, "seconds": 0.002},
                           staging: {"launches": 2, "seconds": 0.001},
                           stack: {"launches": 2, "seconds": 0.5},
                           "mm_chunked_kernel": {"launches": 2, "seconds": 0.5}}}
    assert tracing.kernel_seconds(summary, pats) == (pytest.approx(0.007), 6)
