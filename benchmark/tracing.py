"""The traced run: ``torch.profiler`` over the measured window, and what
the per-layer metrics read from its trace.

The window is the benchmark's own span ``bench.window``; the device is
busy where a kernel, a copy or a set runs (the union of their spans), idle
elsewhere in the window.  Each idle gap is put down to what the host was
doing: the innermost host span of the profiler's own (a torch operator or
a benchmark span such as ``bench.wait``) running at the gap's middle.  The
busy and idle arithmetic follows the port's ``tools/trace.py``.
"""

from __future__ import annotations

import contextlib
import json
import re
from collections import defaultdict
from pathlib import Path

DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_SPANS = ("cpu_op", "user_annotation")
WINDOW = "bench.window"


def short_name(name: str) -> str:
    """A kernel's name without its namespace noise and argument list."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0][:100]


@contextlib.contextmanager
def traced(torch, enabled: bool, path: Path):
    """Profile the block (CPU and CUDA activity) when ``enabled`` and write
    its Chrome trace to ``path``."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    path.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
    prof.export_chrome_trace(str(path))


def span(torch, name: str, enabled: bool):
    """A benchmark span in the trace (nothing when not tracing)."""
    return torch.profiler.record_function(name) if enabled else contextlib.nullcontext()


def _union(spans):
    total, end = 0.0, float("-inf")
    merged = []
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            if merged and a <= merged[-1][1]:
                merged[-1][1] = b
            else:
                merged.append([a, b])
            end = b
    return total, merged


def summarize(path: Path) -> dict:
    """From a Chrome trace: the window (s), the device's busy time in it
    (s), each kernel's launches and seconds, and the idle gaps' seconds by
    the innermost host span running at each gap's middle."""
    events = [e for e in json.loads(Path(path).read_text()).get("traceEvents", [])
              if e.get("ph") == "X"]
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"no {WINDOW} span in {path}")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0].get("dur", 0.0))
    kernels = defaultdict(lambda: [0, 0.0])
    device = []
    host = []
    for e in events:
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        cat = e.get("cat")
        if cat in DEVICE_WORK:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            device.append((a, b))
            key = short_name(e["name"]) if cat == "kernel" else cat
            kernels[key][0] += 1
            kernels[key][1] += (b - a) / 1e6
        elif cat in HOST_SPANS and e.get("name") != WINDOW and b > w0 and a < w1:
            host.append((a, b, e["name"]))
    busy_us, merged = _union(device)
    gaps = defaultdict(float)
    host.sort()
    active: list = []  # host spans begun before the current gap, by start
    k = 0
    cursor = w0
    for a, b in merged + [[w1, w1]]:
        if a > cursor:
            mid = (cursor + a) / 2
            while k < len(host) and host[k][0] <= mid:
                active.append(host[k])
                k += 1
            while active and active[-1][1] < mid:
                active.pop()
            # the latest-begun span still running at the gap's middle
            inner = next((h for h in reversed(active) if h[1] >= mid), None)
            gaps[inner[2] if inner else "host: no span"] += (a - cursor) / 1e6
        cursor = max(cursor, b)
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "kernels": {k: {"launches": n, "seconds": s} for k, (n, s) in kernels.items()},
        "gaps": dict(gaps),
    }


def kernel_seconds(summary: dict, patterns: list[str]) -> tuple[float, int]:
    """Seconds and launches of the kernels any of ``patterns`` matches."""
    regs = [re.compile(p) for p in patterns]
    secs, n = 0.0, 0
    for name, k in summary["kernels"].items():
        if any(r.search(name) for r in regs):
            secs += k["seconds"]
            n += k["launches"]
    return secs, n


def read_patterns(path: Path) -> list[str]:
    """One regular expression a line; blank lines and ``#`` lines skipped."""
    return [ln.strip() for ln in Path(path).read_text().splitlines()
            if ln.strip() and not ln.lstrip().startswith("#")]


def breakdown(summary: dict) -> dict:
    """The ten device operations that took most time and the ten longest
    idle gaps by what the host was doing, [name, seconds] each."""
    ops = sorted(((k, v["seconds"]) for k, v in summary["kernels"].items()), key=lambda kv: -kv[1])
    gaps = sorted(summary["gaps"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [list(x) for x in ops[:10]], "idle_gaps": [list(x) for x in gaps[:10]]}
