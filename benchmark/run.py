"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/``) and a traffic mix (``traffic/``), whose ``driver`` is a
module of ``drivers/``.  The driver sets the cell up, measures for
``--seconds`` and checks what the timed path produced against the plain
reference (``check.py``, ``reference/``), each number beside its limit
(``limits/<workload>.json``).  With ``--trace 1`` the window runs under
``torch.profiler`` and the line carries the cell's per-layer metrics
(``metrics/<name>.py``) in place of the end-to-end ones.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with ``--trace 1``
``breakdown``), ``setup_parts`` (set-up's seconds by phase), ``info``, the
comparison's numbers that are not compared, and last ``checks``, the
numbers compared and their limits, which also end standard error.
Without the cards the cell asks for, or with JAX or the JAX package
loaded, the run exits 1 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import core, tracing  # noqa: E402


def fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return 1


def result_line(cell, out: dict, summary: dict | None, kind: str) -> dict:
    """The run's result: ``correct`` from the numbers compared against the
    cell's limits, the end-to-end metrics (``summary`` None) or, from the
    trace's ``summary``, the per-layer ones, ``device``, then ``info`` and
    last ``checks``."""
    correct, checks = core.judge(out["numbers"], cell.limits)
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": bool(correct and out["failed"] == 0), "attempted": int(out["attempted"]),
            "failed": int(out["failed"])}
    if summary is not None:
        ctx = {**out["layer"], "summary": summary, "config": cell.config}
        metrics = {}
        for m in cell.per_layer:
            value = core.metric_reader(m["name"], cell.bench)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        line.update(metrics=metrics, device=device, breakdown=tracing.breakdown(summary))
    else:
        line.update(metrics={m["name"]: {"value": float(out["metrics"][m["name"]]), "unit": m["unit"]}
                             for m in cell.end_to_end}, device=device)
    if "setup_parts" in out:
        line["setup_parts"] = out["setup_parts"]
    line["info"] = {k: v for k, v in out["numbers"].items() if k not in checks}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    core.set_caches()
    try:
        cell = core.Cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        return fail(f"cannot read the cell {args.workload!r}: {e}")
    phases = core.Phases(T_START)
    import torch

    phases.mark("torch")  # python, the cell's files, torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        return fail(f"{args.workload} needs {cell.chips} CUDA device(s); "
                    f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    try:
        import sdrmodem_tpu_torch  # noqa: F401
    except ImportError as e:
        return fail(f"the port is not in this checkout: {e}")
    phases.mark("port")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phases.mark("cuda")  # the CUDA context
    trace_path = ROOT / "build" / "bench_trace" / f"{args.workload}.json"
    out = core.driver(cell.mix["driver"]).run(
        cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace), device=dev,
        t_start=T_START, trace_path=trace_path, phases=phases)

    loaded = core.forbidden_modules()
    if loaded:
        return fail(f"JAX or the JAX package is loaded: {', '.join(loaded)}")
    summary = None
    if args.trace:
        summary = tracing.summarize(trace_path)
    line = result_line(cell, out, summary, torch.cuda.get_device_name(dev))
    print(f"not compared: {json.dumps(line['info'])}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
