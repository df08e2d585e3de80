"""Micro-benchmark analog of reference test/perf_fsk_modem.c on the port.

The twin of the JAX package's ``tools/perf.py``:

- gfsk_mod: 100 x 2048 bytes at Fs=19200, baud=9600, dev=5000, BT=0.5,
  through the unfused chain (``GfskModulator.process_pair``) and B5
  (``process_pair_kernel``); then 8 TxData of 25600 B, a sustained stream
  of 16 with the phase carried, the server's coalesced bursts (6 x 16
  messages + 4), and 20 x 128 streams x 2048 B, chain and B6;
- fsk_demod: 100 x 4096 samples at Fs=48000, baud=4800, dev=5000, decim=2,
  DC on, one lane through the ragged step (B3, B4), then 6 steps of 128
  lanes x 65536 through the full-block step (B1, B2).

Each line has the JAX tool's words, with the reference's M1 figure beside
it where the JAX tool prints one.  On the card every section is timed with
CUDA events around its calls, the warm-up outside, the phase threaded
where the JAX tool threads it; ``--device cpu`` runs the plain versions on
the host's clock.  ``--small`` runs every section at a few calls and small
sizes (the CPU test's size).

Usage: python -m sdrmodem_tpu_torch.tools.perf [--device cpu] [--small]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from sdrmodem_tpu_torch.dsp.gfsk_mod import GfskModConfig, GfskModulator
from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
from sdrmodem_tpu_torch.tools._common import LUCKY7, add_device, clock_name, start, timed

# the JAX tool's sizes, and the CPU test's
FULL = dict(msgs=100, msg_bytes=2048, big=25600, big_msgs=8, sustained=16, group=16, groups=6, rem=4,
            channels=128, batched=20, demod_calls=100, demod_block=4096,
            lanes=128, block=65536, steps=6)
SMALL = dict(msgs=2, msg_bytes=256, big=1024, big_msgs=2, sustained=2, group=2, groups=2, rem=1,
             channels=4, batched=2, demod_calls=2, demod_block=4096, lanes=4, block=4096, steps=2)


def run(device=None, small: bool = False) -> list[str]:
    """Every section once; returns (and prints) the report lines."""
    dev = start(device)
    z = SMALL if small else FULL
    rng = np.random.default_rng(0)
    lines = []

    def say(line):
        lines.append(line)
        print(line, flush=True)

    say(f"timing: {clock_name(dev)}")
    mod = GfskModulator(GfskModConfig.from_radio(19200, 9600, 5000), device=dev)
    data = torch.from_numpy(rng.integers(0, 255, z["msg_bytes"]).astype(np.uint8)).to(dev)
    per_byte = 8 * 2  # samples a byte at 2 samples a bit

    def bench_tx(name, step):
        step(data)  # warm-up
        ms, _ = timed(dev, lambda: step(data), z["msgs"])
        dt = ms * z["msgs"] / 1e3
        out_samples = z["msgs"] * z["msg_bytes"] * per_byte
        say(f"gfsk_mod {name}: {z['msgs']} x {z['msg_bytes']} bytes in {dt:.6f} s "
            f"({out_samples / dt / 1e6:.1f} Msamples/s produced) "
            f"[reference M1: 0.044 s = 74 Msamples/s]")

    bench_tx("chain", lambda d: mod.process_pair(d)[:2])
    bench_tx("fused", lambda d: mod.process_pair_kernel(d)[:2])

    # full-size TxData, one B5 call a message (8 messages carry the 100 x
    # 2048 reference's bytes)
    data_big = torch.from_numpy(rng.integers(0, 255, z["big"]).astype(np.uint8)).to(dev)
    mod.process_pair_kernel(data_big)
    ms, _ = timed(dev, lambda: mod.process_pair_kernel(data_big)[:2], z["big_msgs"])
    dt = ms * z["big_msgs"] / 1e3
    n_out = z["big_msgs"] * z["big"] * per_byte
    say(f"gfsk_mod fused, {z['big']}-B TxData: {z['big_msgs']} msgs ({n_out / 1e6:.2f} Msamples) in "
        f"{dt:.6f} s ({n_out / dt / 1e6:.1f} Msamples/s produced, single stream)")

    # sustained single stream: each call starts from the last one's phase
    carried = {"ph": 0.0}

    def threaded(d):
        out = mod.process_pair_kernel(d, phase0=carried["ph"])
        carried["ph"] = out[2]
        return out

    threaded(data_big)
    carried["ph"] = 0.0
    ms, _ = timed(dev, lambda: threaded(data_big), z["sustained"])
    dt = ms * z["sustained"] / 1e3
    n_out = z["sustained"] * z["big"] * per_byte
    say(f"gfsk_mod fused, sustained stream ({z['sustained']} x {z['big']}-B TxData, "
        f"phase-threaded): {n_out / 1e6:.2f} Msamples in {dt:.6f} s "
        f"({n_out / dt / 1e6:.1f} Msamples/s, single stream)")

    # the server's coalesced path: queued TxData drained into bursts of 16
    # messages, one call a burst, the phase threading every call
    data16 = torch.from_numpy(rng.integers(0, 255, z["group"] * z["msg_bytes"]).astype(np.uint8)).to(dev)
    data4 = torch.from_numpy(rng.integers(0, 255, z["rem"] * z["msg_bytes"]).astype(np.uint8)).to(dev)
    threaded(data16)
    threaded(data4)
    carried["ph"] = 0.0

    def coalesced():
        for _ in range(z["groups"]):
            threaded(data16)
        return threaded(data4)

    ms, _ = timed(dev, coalesced, 1)
    dt = ms / 1e3
    msgs = z["groups"] * z["group"] + z["rem"]
    n_out = msgs * z["msg_bytes"] * per_byte
    say(f"gfsk_mod fused, COALESCED {msgs} x {z['msg_bytes']}-B TxData ({z['groups']} x "
        f"{z['group']}-msg bursts + {z['rem']}): {n_out / 1e6:.2f} Msamples in "
        f"{dt:.6f} s ({n_out / dt / 1e6:.1f} Msamples/s, single stream) "
        f"[reference M1: 74 Msamples/s]")

    # many streams a call: B6 on up to 128 lanes
    datab = torch.from_numpy(rng.integers(0, 255, (z["channels"], z["msg_bytes"])).astype(np.uint8)).to(dev)

    def bench_txb(name, stepb):
        stepb(datab)
        ms, _ = timed(dev, lambda: stepb(datab), z["batched"])
        dt = ms * z["batched"] / 1e3
        outb = z["batched"] * z["channels"] * z["msg_bytes"] * per_byte
        say(f"gfsk_mod {name}: {z['batched']} x {z['channels']}ch x {z['msg_bytes']} bytes in {dt:.6f} s "
            f"({outb / dt / 1e6:.1f} Msamples/s produced, batched)")

    bench_txb("chain", lambda d: mod.process_pair(d)[:2])
    bench_txb("fused", lambda d: mod.process_pair_kernel(d)[:2])

    # fsk_demod, one lane through the ragged step, the state threaded
    block = z["demod_block"]
    pipe = DemodPipeline(LUCKY7, block, use_atan_lut="free", device=dev)
    x = torch.from_numpy(rng.standard_normal((2, block)).astype(np.float32)).to(dev)
    n = torch.tensor(block, dtype=torch.int32, device=dev)
    st = {"s": pipe._step_impl(pipe.init_state(), x, n)[0]}

    def ragged():
        st["s"], sym, cnt = pipe._step_impl(st["s"], x, n)
        return cnt

    ms, cnt = timed(dev, ragged, z["demod_calls"])
    dt = ms * z["demod_calls"] / 1e3
    say(f"fsk_demod: {z['demod_calls']} x {block} samples in {dt:.6f} s "
        f"({z['demod_calls'] * block / dt / 1e6:.1f} Msamples/s, single lane = "
        f"per-dispatch latency bound) [reference M1: 0.037 s = 11.0 Msamples/s]")

    # the full-block step at the bench.py headline's lanes (B1, B2)
    lanes, block = z["lanes"], z["block"]
    pipef = DemodPipeline(LUCKY7, block, use_atan_lut="free", device=dev)
    stepf = pipef.make_batched_step_full("pallas")
    xf = torch.from_numpy(rng.standard_normal((lanes, 2, block)).astype(np.float32)).to(dev)
    stf = {"s": stepf(pipef.init_full_state(lanes), xf)[0]}

    def full():
        stf["s"], sym, cnt = stepf(stf["s"], xf)
        return cnt

    ms, cnt = timed(dev, full, z["steps"])
    dt = ms * z["steps"] / 1e3
    say(f"fsk_demod: {z['steps']} x {lanes}ch x {block} samples in {dt:.6f} s "
        f"({z['steps'] * lanes * block / dt / 1e6:.1f} Msamples/s, batched full path; "
        f"{int(cnt.sum())} symbols in the last step)")
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device(parser)
    parser.add_argument("--small", action="store_true", help="a few calls at small sizes")
    args = parser.parse_args(argv)
    run(args.device, args.small)
    return 0


if __name__ == "__main__":
    sys.exit(main())
