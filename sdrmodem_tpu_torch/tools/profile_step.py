"""Apportion the production full-block step's time between its stages.

The twin of the JAX package's ``tools/profile_step.py``.  Times (a) the
whole batched step (``make_batched_step_full("pallas")``, layout ``cm``),
(b) the front alone (B1 on the fused route, the banded front where the
pipeline takes that: ``fused_front_available``), and (c) the clock alone
(B2) on the front's y3, each over the same input: noise, or with
``SDRM_PROFILE_INPUT=fixture`` the lucky7 capture tiled over the lanes.
On the card each is timed with CUDA events around 4 calls after
one warm-up; ``--device cpu`` runs the plain versions on the host's clock.

Env: SDRM_BENCH_BLOCK (2^20), SDRM_BENCH_CHANNELS (128),
SDRM_PROFILE_INPUT (noise | fixture), as the JAX tool reads them.

Usage: python -m sdrmodem_tpu_torch.tools.profile_step [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from sdrmodem_tpu_torch.dsp.clock_recovery import clock_mm_batched_full, initial_full_state
from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
from sdrmodem_tpu_torch.ops.front import banded_front, fused_front
from sdrmodem_tpu_torch.tools._common import (
    LUCKY7, add_device, clock_name, env_int, pairs, start, tiled_capture, timed,
)

ITERS = 4  # timed calls a row, as the JAX tool's ``timeit``


def run(device=None) -> dict:
    dev = start(device, "SDRM_FIR_PRECISION")
    channels = env_int("SDRM_BENCH_CHANNELS", 128)
    block = env_int("SDRM_BENCH_BLOCK", 1 << 20)
    pipe = DemodPipeline(LUCKY7, block, exact=False, use_atan_lut="free", device=dev)
    if os.environ.get("SDRM_PROFILE_INPUT", "noise") == "fixture":
        x = pairs(tiled_capture(channels, block))
    else:
        x = np.random.default_rng(0).standard_normal((channels, 2, block)).astype(np.float32) * 0.1
    x = torch.from_numpy(x).to(dev)
    state = pipe.init_full_state(channels)
    step = pipe.make_batched_step_full("pallas")
    front = fused_front if pipe.fused_front_available() else banded_front
    p = pipe._clockp

    def full():
        s2, sym, cnt = step(state, x)
        full.overflow = s2.clock.overflow
        return cnt

    def front_only():
        y3, _ = front(pipe.to_time_major(x, channels, "cm"), *state[:4], pipe.front_taps)
        return y3

    def clock_only(y3):
        return clock_mm_batched_full(
            y3, initial_full_state(p["omega"], channels, p["mu"], device=dev), bank=pipe.bank,
            omega=p["omega"], gain_omega=p["gain_omega"], mu=p["mu"], gain_mu=p["gain_mu"],
            omega_relative_limit=p["omega_relative_limit"], backend="pallas",
        )[1]

    full()
    t_full, _ = timed(dev, full, ITERS)
    y3 = front_only()
    t_front, _ = timed(dev, front_only, ITERS)
    clock_only(y3)
    t_clock, _ = timed(dev, lambda: clock_only(y3), ITERS)
    return dict(block=block, channels=channels, front=front.__name__, full_ms=t_full, front_ms=t_front,
                clock_ms=t_clock, overflow=float(full.overflow.sum()), timing=clock_name(dev))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device(parser)
    args = parser.parse_args(argv)
    r = run(args.device)
    msps = r["channels"] * r["block"] / r["full_ms"] / 1e3
    print(f"block={r['block']} channels={r['channels']} front={r['front']} timing: {r['timing']}")
    print(f"full step : {r['full_ms']:8.2f} ms   ({msps:.0f} Msamples/s/chip)")
    print(f"clock window-overflow healed chunks (one step): {r['overflow']:.0f}")
    print(f"front-end : {r['front_ms']:8.2f} ms   ({100 * r['front_ms'] / r['full_ms']:.0f}%)")
    print(f"clock only: {r['clock_ms']:8.2f} ms   ({100 * r['clock_ms'] / r['full_ms']:.0f}%)")
    print(f"other     : {r['full_ms'] - r['front_ms'] - r['clock_ms']:8.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
