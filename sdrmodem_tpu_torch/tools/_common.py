"""What the port's tools share: the device choice, the card's name, the
timing clock, the lucky7 configuration and capture, and the TPU knobs that
have no counterpart.

Every tool runs on the card unless given ``--device cpu`` and raises
without one (``ops/_build.py:resolve_device``).  On the card a tool times
with CUDA events around the calls it times, the warm-up left out; on the
CPU with the host's clock, and it says which.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import subprocess
import time

import numpy as np
import torch

from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
from sdrmodem_tpu_torch.ops._build import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[2]
FIXTURES = ROOT / "tests" / "fixtures"
LUCKY7 = FskDemodConfig(48000, 4800, 5000, 2, 2000, True)

# the JAX tools' TPU-only knobs and variants: read by none of the twins
TPU_KNOBS = {
    "SDRM_FIR_PRECISION": "the FIRs' bf16x3 / bf16x2 MXU precision",
    "SDRM_CLOCK_SHIFT_MAX": "the one-hot clock",
    '"null"': "the placeholder arctangent",
}


def add_device(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default=None, help="cpu for the plain versions (default: the card)")


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def start(device, *knobs: str) -> torch.device:
    """The tool's device (raising without a card unless ``device`` is the
    CPU), its card printed on the card, and the JAX tool's TPU knobs that
    this twin drops named as such."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        print(f"card: {card()}", flush=True)
    for knob in knobs:
        print(f"not ported: TPU workaround: {knob} ({TPU_KNOBS[knob]})", flush=True)
    return dev


def clock_name(dev: torch.device) -> str:
    return "CUDA events" if dev.type == "cuda" else "host clock"


def timed(dev: torch.device, fn, reps: int):
    """(mean ms a call, last result) of ``reps`` calls of ``fn``: CUDA events
    around them on the card, the host's clock on the CPU.  Warm up first,
    outside the window; a call that threads state does so through ``fn``."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize(dev)
        return begin.elapsed_time(end) / reps, out
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) * 1e3 / reps, out


def env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def tiled_capture(channels: int, block: int) -> np.ndarray:
    """The lucky7 capture tiled over (channels, block) complex64, lane c
    reading it from c * block on (the JAX tools' bench shape)."""
    iq = np.fromfile(FIXTURES / "lucky7.expected.cf32", dtype=np.complex64)
    return np.resize(iq, channels * block).reshape(channels, block)


def pairs(iq: np.ndarray) -> np.ndarray:
    """(C, N) complex64 -> (C, 2, N) float32 I/Q pairs."""
    return np.stack([iq.real, iq.imag], axis=1).astype(np.float32)
