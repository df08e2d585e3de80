"""Per-block end-to-end latency of the demod fast path on the port.

The twin of the JAX package's ``tools/latency.py``.  It measures the time
of one block host to host: the block copied from host memory to the card,
the step, and the symbol counts fetched to the host (the sync point), with
the carried state threading through, so every repeat continues the stream.
The shapes:

- the reference's real-time buffer (4096 samples,
  test/perf_fsk_modem.c:72): one ragged lane (B3, B4) and 128 lanes of the
  full-block step (B1, B2), layout ``tm``;
- the server's default buffer (262144) and the bench block (2^20), 128
  lanes, and 65536 between.

It reports median / p10 / p90 ms a block, the JAX tool's keys, on the
host's clock (the timing includes the copies and the fetch: it is host to
host on the card too, and the report says so).

Usage: python -m sdrmodem_tpu_torch.tools.latency [--reps 20]
       [--blocks 4096,65536,262144,1048576] [--out LATENCY.json]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
from sdrmodem_tpu_torch.tools._common import LUCKY7, add_device, card, start

LANES = 128


def measure(shape_name, step_fn, make_x, state, reps, dev):
    """``reps`` blocks host to host, the state threaded: (stats, state')."""
    times = []
    s = state
    total = 0
    for _ in range(reps):
        x = make_x()
        t0 = time.perf_counter()
        out = step_fn(s, torch.from_numpy(x).to(dev))
        s = out[0]
        total = int(out[2].sum())  # sync point
        times.append((time.perf_counter() - t0) * 1e3)
    times = sorted(times)
    n = len(times)
    return {
        "shape": shape_name,
        "median_ms": round(times[n // 2], 3),
        "p10_ms": round(times[n // 10], 3),
        "p90_ms": round(times[(9 * n) // 10], 3),
        "reps": reps,
        "symbols_last": total,
    }


def run(reps: int = 20, blocks=(4096, 65536, 262144, 1048576), device=None) -> dict:
    dev = start(device)
    rng = np.random.default_rng(0)
    results = []

    # one ragged lane at the reference's 4096-sample buffer
    pipe_r = DemodPipeline(LUCKY7, 4096, exact=False, use_atan_lut="free", device=dev)
    n_valid = torch.tensor(4096, dtype=torch.int32, device=dev)
    iq = rng.standard_normal((2, 4096)).astype(np.float32) * 0.3
    step = lambda s, x: pipe_r._step_impl(s, x, n_valid)  # noqa: E731
    st = pipe_r.init_state()
    int(step(st, torch.from_numpy(iq).to(dev))[2])  # warm-up, the state not carried on
    results.append(measure("ragged 1 lane x 4096", step, lambda: iq, st, reps, dev))

    # the full-block step at each block size, 128 lanes, layout tm
    for block in blocks:
        pipe = DemodPipeline(LUCKY7, block, exact=False, use_atan_lut="free", device=dev)
        stepf = pipe.make_batched_step_full("pallas", layout="tm")
        state = pipe.init_full_state(LANES)
        x = (rng.standard_normal((block, 2 * LANES)) * 0.3).astype(np.float32)
        int(stepf(state, torch.from_numpy(x).to(dev))[2].sum())  # warm-up
        results.append(measure(f"full {LANES} lanes x {block}", stepf, lambda: x, state, reps, dev))

    report = {"platform": dev.type, "device": str(dev), "timing": "host to host (copy in, step, counts out)",
              "results": results}
    if dev.type == "cuda":
        report["card"] = card()
        report["kind"] = torch.cuda.get_device_name(dev)
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--out", default=None)
    parser.add_argument("--blocks", default="4096,65536,262144,1048576",
                        help="comma-separated full-path block sizes")
    add_device(parser)
    args = parser.parse_args(argv)
    report = run(args.reps, [int(b) for b in args.blocks.split(",")], args.device)
    for r in report["results"]:
        print(f"{r['shape']:>28}: median {r['median_ms']:8.3f} ms "
              f"(p10 {r['p10_ms']:.3f} / p90 {r['p90_ms']:.3f}) host to host")
    text = json.dumps(report, indent=2)
    if args.out:
        pathlib.Path(args.out).write_text(text + "\n")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
