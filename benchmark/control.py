"""The readings the correctness limits are set from, on the card.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]
        [--seconds 3] [--control-seeds N] [--fault stale_state|half_batch|altered]

For each seed, one run of the cell at its own size with a short window
(the kernels built once, in this process), and a JSON line with the
comparison's numbers for the program (a sound reading) and, under
``control``, for the plain reference computed in bfloat16 put in the
program's place (the nearest precision below the configuration's float32).
With ``--fault`` the program runs with that fault planted
(``faults.py``).  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import core, faults  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Readings for the correctness limits.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="compute the control on the first N seeds only (default: all)")
    args = ap.parse_args(argv)
    core.set_caches()
    cell = core.Cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    run = core.driver(cell.mix["driver"]).run
    fault = faults.FAULTS[args.fault] if args.fault else None
    n_control = len(args.seeds) if args.control_seeds is None else args.control_seeds
    for i, seed in enumerate(args.seeds):
        t = time.perf_counter()
        out = run(cell, seed=seed, seconds=args.seconds, trace=False, device=dev, t_start=t,
                  fault=fault, control=fault is None and i < n_control)
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "seconds": time.perf_counter() - t, "attempted": out["attempted"],
                          "numbers": out["numbers"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
