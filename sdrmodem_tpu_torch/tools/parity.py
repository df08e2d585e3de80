"""Golden parity on the port: replay the reference's demod fixtures and
record, for each, how far the symbols are from the recorded goldens.

The port's twin of the JAX package's ``tools/parity.py``.  The reference's
acceptance bound is int8 soft symbols within +-2 LSB of the goldens
(test/test_fsk_demod.c:43-48, tolerance in test/utils.c:156-161).  For each
fixture this measures:

- max_lsb_diff     the most |got - golden| over all symbols;
- mismatch_rate    the share of symbols with any difference;
- beyond_tol_rate  the share beyond the reference's +-2 LSB;
- hard_decision_agreement  sign agreement where |golden| >= 8.

Modes: "production", the server's fast path (the full-block step, B1 and
B2 on the card); "exact", the server's default RX (the exact streamer, the
float64 FIR kernel and B4); "both".  The gate is the reference's strict
bound on every fixture in both modes, beyond_tol_rate 0 and hard decisions
1.0: the port holds all four goldens there, lucky7_nodc included.  The JAX
tool's 0.005 ceiling for lucky7_nodc is a transient of its TPU, not the
port's, and is not carried over.

Usage: python -m sdrmodem_tpu_torch.tools.parity [--block 16384]
       [--cases lucky7,nan] [--mode production|exact|both] [--gate]
       [--out PARITY_GPU.json] [--device cpu]

It runs on the card unless given ``--device cpu`` (the kernels' plain
versions), and raises without a card.  On the card the report names the
card and its power limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
from sdrmodem_tpu_torch.ops._build import resolve_device
from sdrmodem_tpu_torch.tools._common import card
from sdrmodem_tpu_torch.utils.parity import GOLDEN_CASES, demod_capture

FIXTURES = pathlib.Path(__file__).resolve().parents[2] / "tests" / "fixtures"

# (name, config, input capture, golden): the JAX tool's CASES
# (tools/parity.py:40), the reference's test/test_fsk_demod.c:52-80
CASES = [(name, cfg, fin, fexp) for name, cfg, fin, fexp, _ in GOLDEN_CASES]

# the reference's bound on every fixture, in both modes
GATE = {name: {"beyond_tol_rate": 0.0, "hard_decision_agreement": 1.0} for name, *_ in CASES}
MODES = {"production": ("fixtures", "gate"), "exact": ("fixtures_exact", "gate_exact")}


def evaluate_gate(fixtures: dict, gate: dict = GATE) -> dict:
    """Each fixture's numbers against its limits: {"pass", "failures"}."""
    failures = []
    for name, limits in gate.items():
        rep = fixtures.get(name)
        if rep is None:
            continue
        if rep["beyond_tol_rate"] > limits["beyond_tol_rate"] + 1e-12:
            failures.append(f"{name}: beyond_tol_rate {rep['beyond_tol_rate']:.5f} > "
                            f"{limits['beyond_tol_rate']}")
        hda = rep.get("hard_decision_agreement", 0.0)
        if hda < limits["hard_decision_agreement"]:
            failures.append(f"{name}: hard_decision_agreement {hda:.5f} < "
                            f"{limits['hard_decision_agreement']}")
        if rep.get("missing", 0) > 0:
            failures.append(f"{name}: {rep['missing']} golden symbols not produced")
    return {"pass": not failures, "failures": failures}


def fixture_report(got: np.ndarray, golden: np.ndarray) -> dict:
    """The JAX tool's per-fixture numbers (``_report``).  Zero padding
    past the capture emits extra symbols; the golden is a causal prefix."""
    m = min(len(got), len(golden))
    diff = np.abs(got[:m].astype(np.int32) - golden[:m].astype(np.int32))
    rep = {
        "n_symbols": int(len(golden)),
        "produced": int(len(got)),
        "missing": int(len(golden) - m),
        "max_lsb_diff": int(diff.max()) if m else -1,
        "mismatch_rate": float((diff != 0).mean()) if m else 1.0,
        "beyond_tol_rate": float((diff > 2).mean()) if m else 1.0,
    }
    if m:
        confident = np.abs(golden[:m].astype(np.int32)) >= 8
        agree = np.sign(got[:m][confident]) == np.sign(golden[:m][confident])
        rep["hard_decision_agreement"] = float(agree.mean()) if confident.any() else 1.0
        bad = np.nonzero(diff > 2)[0]
        if len(bad):  # where the beyond-tolerance symbols lie: a transient, or all along
            rep["beyond_tol_span"] = [int(bad.min()), int(bad.max())]
            rep["tail_clean_symbols"] = int(m - 1 - bad.max())
    return rep


def replay_fixture(config, fin: str, fexp: str, block: int, *, exact: bool, device) -> dict:
    """One fixture through the production full-block step (``exact``
    False) or the exact streamer, at ``block`` rounded up to the
    decimation."""
    iq = np.fromfile(FIXTURES / fin, dtype=np.complex64)
    golden = np.fromfile(FIXTURES / fexp, dtype=np.int8)
    d = config.decimation
    pipe = DemodPipeline(config, -(-block // d) * d, exact=exact, device=device)
    return fixture_report(demod_capture(pipe, iq), golden)


def run(block: int = 16384, names=None, modes=("production",), device=None) -> dict:
    """The report: every chosen fixture in every chosen mode, each mode's
    gate beside its numbers."""
    device = resolve_device(device)
    cases = [c for c in CASES if not names or c[0] in names]
    report = {"platform": device.type, "device": str(device), "tolerance_lsb": 2, "block": block}
    if device.type == "cuda":
        import torch

        report["card"] = card()
        report["kind"] = torch.cuda.get_device_name(device)
    for mode in modes:
        results = {}
        for name, config, fin, fexp in cases:
            t0 = time.perf_counter()
            results[name] = replay_fixture(config, fin, fexp, block, exact=mode == "exact", device=device)
            results[name]["seconds"] = round(time.perf_counter() - t0, 3)
        key, gate_key = MODES[mode]
        report[key] = results
        report[gate_key] = evaluate_gate(results)
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--block", type=int, default=16384)
    parser.add_argument("--out", default=None, help="write the report here as well")
    parser.add_argument("--cases", default=None, help="comma-separated fixture names")
    parser.add_argument("--mode", default="production", choices=["production", "exact", "both"],
                        help="production = the full-block step; exact = the exact streamer")
    parser.add_argument("--gate", action="store_true",
                        help="exit 1 when a fixture leaves the reference's bound")
    parser.add_argument("--device", default=None, help="cpu for the plain versions (default: the card)")
    args = parser.parse_args(argv)
    names = args.cases.split(",") if args.cases else None
    if names:
        unknown = set(names) - {c[0] for c in CASES}
        if unknown:
            parser.error(f"unknown fixtures {sorted(unknown)}")
    modes = tuple(MODES) if args.mode == "both" else (args.mode,)
    report = run(args.block, names, modes, args.device)
    text = json.dumps(report, indent=2)
    print(text)
    if args.out:
        pathlib.Path(args.out).write_text(text + "\n")
    if args.gate and not all(report[g]["pass"] for _, g in (MODES[m] for m in modes)):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
