"""Differential full-step profiling: the whole production step timed once
for each variant, exactly one ingredient changed from the production one.

The twin of the JAX package's ``tools/profile_variants.py``.  The
production step is layout ``tm``, ``front="fused"`` (B1 then B2), the LUT
arctangent.  The variants: layout ``cm`` or ``fanout``; front ``banded``
(B3 and the stage kernels) or ``step`` (B7); the ``atan2`` arctangent
(which B1 and B7 do not take: it runs the banded route, printed beside
it); and the front alone, fused and banded, without the clock.  Input: the
lucky7 capture tiled over the lanes (``fanout``: lane 0's stream).  On the
card each variant is timed with CUDA events around ``SDRM_BENCH_ITERS``
steps after a warm-up, the state threaded; ``--device cpu`` runs the plain
versions on the host's clock.  The JAX tool's TPU variants (the FIRs'
bf16x3 / bf16x2 precision, the one-hot clock, the ``"null"`` arctangent)
have no counterpart and are named as such.

Env: SDRM_BENCH_BLOCK (2^20), SDRM_BENCH_CHANNELS (128), SDRM_BENCH_ITERS
(4), as the JAX tool reads them.

Usage: python -m sdrmodem_tpu_torch.tools.profile_variants [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline, DemodStateFull
from sdrmodem_tpu_torch.ops.front import banded_front, fused_front
from sdrmodem_tpu_torch.tools._common import (
    LUCKY7, add_device, clock_name, env_int, pairs, start, tiled_capture, timed,
)


def route(pipe: DemodPipeline, front: str, channels: int) -> str:
    """The route ``make_batched_step_full(front=front)`` takes on this
    pipeline, as it chooses it when the step is built."""
    if front == "step" and pipe.fused_step_available(channels):
        return "step (B7)"
    if front in ("fused", "step") and pipe.fused_front_available():
        return "fused (B1, B2)"
    return "banded (B3, B2)"


def run(device=None) -> dict:
    dev = start(device, "SDRM_FIR_PRECISION", "SDRM_CLOCK_SHIFT_MAX", '"null"')
    channels = env_int("SDRM_BENCH_CHANNELS", 128)
    block = env_int("SDRM_BENCH_BLOCK", 1 << 20)
    iters = env_int("SDRM_BENCH_ITERS", 4)
    tiled = tiled_capture(channels, block)
    inputs = {
        "cm": torch.from_numpy(pairs(tiled)).to(dev),
        "tm": torch.from_numpy(np.ascontiguousarray(np.concatenate([tiled.real.T, tiled.imag.T], axis=1))).to(dev),
        "fanout": torch.from_numpy(pairs(tiled[:1])[0]).to(dev),
    }
    pipes = {}
    print(f"block={block} channels={channels} iters={iters} timing: {clock_name(dev)}", flush=True)

    def run_one(name, layout="tm", atan=True, front="fused", front_only=False):
        if atan not in pipes:
            pipes[atan] = DemodPipeline(LUCKY7, block, exact=False, use_atan_lut=atan, device=dev)
        pipe = pipes[atan]
        if front_only:
            fe = fused_front if front == "fused" and pipe.fused_front_available() else banded_front
            taken = f"{fe.__name__}, no clock"

            def step(state, x):
                y3, fstate = fe(x, *state[:4], pipe.front_taps)
                return DemodStateFull(*fstate, state.clock), y3, y3.sum()
        else:
            step = pipe.make_batched_step_full("pallas", layout=layout, front=front)
            taken = route(pipe, front, channels)
        x = inputs[layout]
        carried = {"s": step(pipe.init_full_state(channels), x)[0]}  # warm-up

        def one():
            carried["s"], sym, cnt = step(carried["s"], x)
            return cnt

        ms, cnt = timed(dev, one, iters)
        check = f"checksum {float(cnt.sum()):.6g} (a float sum, no clock)" if front_only else f"symbols {int(cnt.sum())}"
        print(f"{name:34s}: {ms:8.2f} ms/step  ({channels * block / ms / 1e3:7.0f} Msamples/s)  "
              f"[{check}; route {taken}]", flush=True)
        return ms

    t = {
        "tm": run_one("tm fused-front (production)"),
        "cm": run_one("cm fused-front", layout="cm"),
        "fanout": run_one("fanout fused-front", layout="fanout"),
        "banded": run_one("tm BANDED front", front="banded"),
        "step": run_one("tm STEP (fused front+clock)", front="step"),
        "atan2": run_one("tm fused-front, atan2", atan="atan2"),
        "front_fused": run_one("tm fused FRONT-ONLY (no clk)", front_only=True),
        "front_banded": run_one("tm banded FRONT-ONLY (no clk)", front="banded", front_only=True),
    }
    print("\n--- attribution (deltas) ---")
    print(f"cm input transpose (cm - tm)      : {t['cm'] - t['tm']:8.2f} ms")
    print(f"front fusion win (banded - fused) : {t['banded'] - t['tm']:8.2f} ms")
    print(f"front+clock fusion (step - fused) : {t['step'] - t['tm']:8.2f} ms")
    print(f"atan2 on the banded route - fused : {t['atan2'] - t['tm']:8.2f} ms")
    print(f"fused front-end alone             : {t['front_fused']:8.2f} ms")
    print(f"banded front-end alone            : {t['front_banded']:8.2f} ms")
    print(f"M&M clock kernel share (tm - fr)  : {t['tm'] - t['front_fused']:8.2f} ms")
    return t


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device(parser)
    args = parser.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
