"""Trace the production demod step with ``torch.profiler``.

The twin of the JAX package's ``tools/trace.py``: the full-block step
(``make_batched_step_full("pallas")``, B1 and B2 on the card) over
``--channels`` lanes x ``--block`` samples, ``--steps`` steps with the
state carried, the last one's counts fetched.  The warm-up (the kernels'
build, and one step under the profiler that it does not record, so the
profiler's own start stays out) is outside the trace.  It writes a Chrome
trace (``trace.json`` in ``--out``; open it in chrome://tracing or
Perfetto) and prints, from that trace, each kernel's launches and total
device time, the window (the trace's first event to its last), the
device's busy time in it (the union of its kernels and copies) and the
host's share of the window (the time no kernel or copy ran).  It does not
see inside a kernel.

Usage: python -m sdrmodem_tpu_torch.tools.trace [--out build/trace]
       [--block 65536] [--channels 128] [--steps 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from collections import defaultdict

import numpy as np
import torch

from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
from sdrmodem_tpu_torch.tools._common import LUCKY7, ROOT, add_device, start

DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def short_name(name: str) -> str:
    """A kernel's name without its namespace noise and argument list."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0][:100]


def summarize(trace: dict) -> dict:
    """Each kernel's launches and device ms, the window (first event to
    last), the device's busy ms in it (the union of its kernels, copies and
    sets) and the host's share of the window, from a Chrome trace of
    ``torch.profiler``."""
    kernels = defaultdict(lambda: [0, 0.0])
    spans = []
    first, last = float("inf"), float("-inf")
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        a = float(ev["ts"])
        b = a + float(ev.get("dur", 0.0))
        first, last = min(first, a), max(last, b)
        if ev.get("cat") not in DEVICE_WORK:
            continue
        spans.append((a, b))
        if ev["cat"] == "kernel":
            kernels[short_name(ev["name"])][0] += 1
            kernels[short_name(ev["name"])][1] += float(ev.get("dur", 0.0)) / 1e3
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy_ms = busy_us / 1e3
    window_ms = max(0.0, last - first) / 1e3
    return {
        "kernels": {name: {"launches": n, "device_ms": round(ms, 4)}
                    for name, (n, ms) in sorted(kernels.items(), key=lambda kv: -kv[1][1])},
        "window_ms": round(window_ms, 4),
        "device_busy_ms": round(busy_ms, 4),
        "host_share": round(max(0.0, 1.0 - busy_ms / window_ms), 4) if window_ms > 0 else None,
    }


def run(out: str, block: int, channels: int, steps: int, device=None) -> dict:
    from torch.profiler import ProfilerActivity, profile, schedule

    dev = start(device)
    pipe = DemodPipeline(LUCKY7, block, exact=False, use_atan_lut="free", device=dev)
    step = pipe.make_batched_step_full("pallas")
    state = pipe.init_full_state(channels)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((channels, 2, block)).astype(np.float32)).to(dev)

    # warm-up (and the kernels' build) outside the trace
    state, sym, cnt = step(state, x)
    int(cnt.sum())

    folder = pathlib.Path(out)
    folder.mkdir(parents=True, exist_ok=True)
    path = folder / "trace.json"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    # one step unrecorded (the profiler's start), then ``steps`` recorded
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=steps, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(path))) as prof:
        s = state
        for i in range(steps + 1):
            s, sym, cnt = step(s, x)
            if i == steps:
                total = int(cnt.sum())
            prof.step()
    report = summarize(json.loads(path.read_text()))
    report.update(steps=steps, channels=channels, block=block, symbols_last=total, trace=str(path),
                  platform=dev.type)
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=str(ROOT / "build" / "trace"))
    parser.add_argument("--block", type=int, default=65536)
    parser.add_argument("--channels", type=int, default=128)
    parser.add_argument("--steps", type=int, default=4)
    add_device(parser)
    args = parser.parse_args(argv)
    rep = run(args.out, args.block, args.channels, args.steps, args.device)
    print(f"traced {rep['steps']} steps ({rep['symbols_last']} symbols in the last) -> {rep['trace']}")
    for name, k in rep["kernels"].items():
        print(f"kernel {name}: {k['launches']} launches, {k['device_ms']:.4f} ms on the device")
    print(f"window {rep['window_ms']:.3f} ms (the trace's first event to its last), device busy "
          f"{rep['device_busy_ms']:.3f} ms, host share {rep['host_share']}")
    print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
