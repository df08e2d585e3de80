"""Golden-fixture parity: demodulate a capture and score it against the
reference's int8 output with the reference's own policy (±2 LSB,
test/test_fsk_demod.c:43-48) plus hard-decision agreement.
"""

from __future__ import annotations

import numpy as np
import torch

from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline

# (name, config, input capture, reference output, block) — the four fixtures
# of the JAX package's golden tests (tests/test_fused_front.py:117-128)
GOLDEN_CASES = [
    ("lucky7", FskDemodConfig(48000, 4800, 5000, 2, 2000, True),
     "lucky7.expected.cf32", "lucky7.expected.s8", 8192),
    ("lucky7_nodc", FskDemodConfig(48000, 4800, 5000, 2, 2000, False),
     "lucky7.expected.cf32", "lucky7.expected.nodc.s8", 8192),
    ("nusat", FskDemodConfig(192000, 40000, 5000, 1, 2000, True),
     "nusat.cf32", "processed.s8", 5120),
    ("nan", FskDemodConfig(240000, 9600, 5000, 1, 2000, True),
     "inputnan.cf32", "nan.s8", 4096),
]


def demod_capture(pipe: DemodPipeline, iq: np.ndarray, front: str = "fused") -> np.ndarray:
    """One channel of complex64 IQ through the pipeline; returns its int8
    symbols.  The full-block step (layout "tm", the given ``front``),
    zero-padded to whole blocks; with ``pipe.exact`` the exact streamer
    (the float64-accumulated FIRs and the ragged clock) over the capture as
    it is, the last block passed with its true length."""
    if pipe.exact:
        return pipe.streamer().process(iq)
    block = pipe.block
    padded = np.zeros(-(-len(iq) // block) * block, np.complex64)
    padded[: len(iq)] = iq
    step = pipe.make_batched_step_full(layout="tm", front=front)
    state = pipe.init_full_state(1)
    out = []
    for start in range(0, len(padded), block):
        chunk = padded[start : start + block]
        x = np.stack([chunk.real, chunk.imag], axis=1).astype(np.float32)
        state, sym, cnt = step(state, torch.from_numpy(x).to(pipe.device))
        sym, cnt = sym[0].cpu().numpy(), cnt[0].cpu().numpy()
        out += [sym[k, :c] for k, c in enumerate(cnt) if c]
    return np.concatenate(out) if out else np.zeros(0, np.int8)


def golden_report(got: np.ndarray, golden: np.ndarray) -> dict:
    """Symbols beyond ±2 LSB, their span, and hard-decision agreement on
    confidently sliced symbols (|golden| >= 8; 1.0 when there are none)."""
    m = min(len(got), len(golden))
    diff = np.abs(got[:m].astype(np.int32) - golden[:m].astype(np.int32))
    bad = np.nonzero(diff > 2)[0]
    confident = np.abs(golden[:m].astype(np.int32)) >= 8
    agree = np.sign(got[:m][confident]) == np.sign(golden[:m][confident])
    return dict(
        symbols=int(len(got)),
        golden_symbols=int(len(golden)),
        max_lsb=int(diff.max()) if m else -1,
        beyond_tol_rate=float((diff > 2).mean()) if m else 1.0,
        beyond_tol_span=[int(bad[0]), int(bad[-1])] if len(bad) else None,
        hard_decision_agreement=float(agree.mean()) if confident.any() else 1.0,
    )


# lucky7_nodc's symbols where the clock's lock turns on the last ulp of y3
# (ROADMAP §C): an arctangent other than the reference's table may move
# them past +-2 LSB, and nothing else
NODC_STRETCH = (6319, 6389)


def atan2_golden_failures(name: str, rep: dict) -> list[str]:
    """What fails the gate of a fixture demodulated with the atan2
    arctangent (``golden_report``'s numbers): 99% of the symbols, hard
    decisions 1.0 and +-2 LSB, but that lucky7_nodc's symbols beyond +-2
    LSB may lie in ``NODC_STRETCH`` (the golden was recorded with the
    table)."""
    fails = []
    if rep["symbols"] < 0.99 * rep["golden_symbols"]:
        fails.append(f"{name}: {rep['symbols']} symbols of {rep['golden_symbols']}")
    if rep["hard_decision_agreement"] != 1.0:
        fails.append(f"{name}: hard decisions {rep['hard_decision_agreement']}")
    span = rep["beyond_tol_span"]
    if span is not None and not (name == "lucky7_nodc" and NODC_STRETCH[0] <= span[0] <= span[1] <= NODC_STRETCH[1]):
        fails.append(f"{name}: {rep['max_lsb']} LSB from the golden over symbols {span}")
    return fails
