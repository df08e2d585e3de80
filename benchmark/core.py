"""What every driver shares: the cell's files found by name, the cache
directories, the result line and the checks around it."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# the JAX package and JAX itself, by whole top-level module names: the port
# (``sdrmodem_tpu_torch``) begins with the JAX package's name
FORBIDDEN = ("jax", "jaxlib", "flax", "sdrmodem_tpu")


def set_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The port builds its kernels into ``build/kernels/`` there already."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


class Cell:
    """One workload of ``BENCHMARK.json``: its configuration file, its
    traffic mix (``traffic/<name>.json``), its correctness limits
    (``limits/<workload>.json``) and the metrics it reports."""

    def __init__(self, name: str, root: Path = ROOT):
        root = Path(root)
        spec = read_json(root / "BENCHMARK.json")
        bench = root / "benchmark"
        work = {w["name"]: w for w in spec["workloads"]}
        if name not in work:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.work = work[name]
        conf = {c["name"]: c for c in spec["configs"]}[self.work["config"]]
        self.config = read_json(root / conf["file"])
        self.mix = read_json(bench / "traffic" / f"{self.work['traffic']}.json")
        self.limits = read_json(bench / "limits" / f"{name}.json")
        self.bench = bench
        self.chips = int(self.work["chips"])

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in spec["end_to_end"] if mine(m)]
        self.per_layer = [m for m in spec["per_layer"] if mine(m)]


def driver(kind: str, bench: Path = BENCH):
    """``drivers/<kind>.py``, the code that runs a mix's kind of traffic."""
    return load_module(Path(bench) / "drivers" / f"{kind}.py", f"benchmark_driver_{kind}")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench: Path = BENCH):
    """``metrics/<name>.py``'s ``read(ctx)``: the metric's value from the
    traced run, or None where it finds nothing to read."""
    path = Path(bench) / "metrics" / f"{name}.py"
    return load_module(path, "benchmark_metric_" + name.replace(".", "_")).read


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` of JAX or the JAX package."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Phases:
    """Set-up's seconds by phase, each from the end of the one before (the
    first from ``t_start``, the process's start), printed beside the
    result so that a change in ``setup_s`` can be put down to its part."""

    def __init__(self, t_start: float):
        self.t = t_start
        self.seconds: dict[str, float] = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self.t
        self.t = now


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number against its limit (a number passes at or under
    its limit; one without a reading fails)."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and np.isfinite(v) and v <= float(limit)
        ok &= bool(good)
        checks[name] = {"value": v, "limit": float(limit)}
    return ok, checks
