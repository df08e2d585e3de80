"""Per-stage timing of the production full-block step's front end.

The twin of the JAX package's ``tools/profile_front.py``.  Each stage of
the banded front runs alone on an input of its own shape, one launch a
call: the input transpose (channel-major to the kernels' time-major), LPF1
(B3), the quad demod (its kernel, the LUT form and the atan2 form), LPF2
(B3, stride d) and the DC FIR (B3).  Then B1 as wholes: both launches, the
first alone (the front without its DC stage) and the DC launch alone.  B1's
first launch has no stage split.  Last the clock (B2) on lockstep data
(every lane the same stream, the fan-out shape) and on mixed data, each the
front's y3.  On the card every row is timed with CUDA events around
3 calls after a warm-up; ``--device cpu`` runs the plain versions
on the host's clock.

Env: SDRM_BENCH_BLOCK (2^20), SDRM_BENCH_CHANNELS (128), as the JAX tool
reads them.

Usage: python -m sdrmodem_tpu_torch.tools.profile_front [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from sdrmodem_tpu_torch.dsp.clock_recovery import clock_mm_batched_full, initial_full_state
from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
from sdrmodem_tpu_torch.ops import front as front_ops
from sdrmodem_tpu_torch.ops.fir import conv1d_banded_tm
from sdrmodem_tpu_torch.tools._common import (
    LUCKY7, add_device, clock_name, env_int, pairs, start, tiled_capture, timed,
)

ITERS = 3  # timed calls a row, as the JAX tool's ``timeit``


def run(device=None) -> list:
    """[(row name, ms, samples)] of every row."""
    dev = start(device, "SDRM_FIR_PRECISION", "SDRM_CLOCK_SHIFT_MAX")
    channels = env_int("SDRM_BENCH_CHANNELS", 128)
    block = env_int("SDRM_BENCH_BLOCK", 1 << 20)
    cfg = LUCKY7
    pipe = DemodPipeline(cfg, block, exact=False, use_atan_lut="free", device=dev)
    taps = pipe.front_taps
    p = pipe._clockp
    d = cfg.decimation
    t1, t2, t3 = taps.rev1.numel(), taps.rev2.numel(), taps.rev_dc.numel()
    c = channels

    def noise(seed, shape):
        return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.1).to(dev)

    tiled = tiled_capture(c, block)
    x = torch.from_numpy(pairs(tiled)).to(dev)  # (C, 2, B)
    work1 = noise(1, (t1 - 1 + block, 2 * c))
    y1 = noise(2, (block, 2 * c))
    prev = torch.zeros((1, 2 * c), dtype=torch.float32, device=dev)
    work2 = noise(3, (t2 - 1 + block, c))
    work3 = noise(4, (t3 - 1 + block // d, c))
    state = pipe.init_full_state(c)
    x_tm = pipe.to_time_major(x, c, "cm")
    y2 = noise(5, (block // d, c))
    nodc = taps._replace(rev_dc=None)

    x_lock = torch.from_numpy(np.broadcast_to(pairs(tiled[:1]), (c, 2, block)).copy()).to(dev)
    y3_lock, _ = front_ops.fused_front(pipe.to_time_major(x_lock, c, "cm"), *state[:4], taps)
    y3_mix, _ = front_ops.fused_front(x_tm, *state[:4], taps)

    def clock(y3):
        return lambda: clock_mm_batched_full(
            y3, initial_full_state(p["omega"], c, p["mu"], device=dev), bank=pipe.bank,
            omega=p["omega"], gain_omega=p["gain_omega"], mu=p["mu"], gain_mu=p["gain_mu"],
            omega_relative_limit=p["omega_relative_limit"], backend="pallas",
        )[1]

    rows = [
        ("transpose", lambda: pipe.to_time_major(x, c, "cm"), c * block),
        ("lpf1 (B3)", lambda: conv1d_banded_tm(work1, taps.rev1, 1, block), c * block),
        ("quad(lut)", lambda: front_ops.quad_demod(y1, prev, taps), c * block),
        ("quad(atan2)", lambda: front_ops.quad_demod(y1, prev, taps._replace(atan_lut=False)), c * block),
        ("lpf2 (B3)", lambda: conv1d_banded_tm(work2, taps.rev2, d, block // d), c * block),
        ("dc (B3)", lambda: conv1d_banded_tm(work3, taps.rev_dc, 1, block // d), c * block // d),
        ("B1 both launches", lambda: front_ops.fused_front(x_tm, *state[:4], taps)[0], c * block),
        ("B1 first launch", lambda: front_ops.fused_front(x_tm, *state[:3], None, nodc)[0], c * block),
        ("B1 DC launch", lambda: front_ops.dc_fir(y2, state.dc_hist, taps), c * block // d),
        ("clock(lockstep)", clock(y3_lock), c * block),
        ("clock(mixed)", clock(y3_mix), c * block),
    ]
    print(f"block={block} channels={channels} timing: {clock_name(dev)}", flush=True)
    out = []
    for name, fn, samples in rows:
        fn()  # warm-up
        ms, _ = timed(dev, fn, ITERS)
        out.append((name, ms, samples))
        print(f"{name:16s}: {ms:8.3f} ms  ({samples / ms / 1e3:7.0f} Msamples/s)", flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device(parser)
    args = parser.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
