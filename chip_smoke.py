#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (sdrmodem_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. build  — nvcc compiles csrc/*.cu into build/kernels/, one process per
            source, all started together;
2. check  — each kernel against its plain PyTorch version on the card,
            128 lanes x 65536 samples, three configurations, three blocks
            with carried state;
3. golden — the four reference fixtures through the port's
            make_batched_step_full(layout="tm") on the card;
4. main   — the main path at full width: 128 lanes x 2^20 samples of the
            lucky7 configuration (the bench.py shape), layouts "tm" and
            "fanout", 5 timed steps each after a warm-up, with the launch
            counts read around the run; then each kernel timed alone and
            held against its plain version at that shape.

Prints the card's name and power limit, one JSON line describing each
kernel, and as its last line {"ok": true, "device": {...}}.  Exits non-zero
without a CUDA device, or where the port is not beside this script.
"""

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "fixtures"

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and f32 (non-tensor) rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

LUCKY7 = (48000, 4800, 5000, 2, 2000, True)
CHECK_CONFIGS = {
    "lucky7": LUCKY7,
    "lucky7_nodc": (48000, 4800, 5000, 2, 2000, False),
    "nusat": (192000, 40000, 5000, 1, 2000, True),
}
LANES = 128
CHECK_BLOCK = 65536
MAIN_BLOCK = 1 << 20
MAIN_STEPS = 5
FRONT_ATOL = 1e-4  # tests/test_fused_front.py:46


class SmokeError(Exception):
    pass


def need(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(msg):
    print(msg, flush=True)


def capture_lanes(torch, dev, n, lanes):
    """The lucky7 capture tiled into (n, 2*lanes) time-major IQ, lane c
    reading the tiled stream from c*n on (as bench.py tiles it)."""
    iq = np.fromfile(FIXTURES / "lucky7.expected.cf32", np.complex64)
    re = torch.from_numpy(iq.real.copy()).to(dev)
    im = torch.from_numpy(iq.imag.copy()).to(dev)
    idx = (torch.arange(n, device=dev)[:, None] + n * torch.arange(lanes, device=dev)[None, :]) % len(iq)
    return torch.cat([re[idx], im[idx]], dim=1).contiguous()


def cuda_ms(torch, fn, reps):
    """Mean device time of fn() over reps calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def phase_build():
    from sdrmodem_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[build] {sorted(logs)} built in {time.perf_counter() - t0:.3f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def phase_check(torch, dev):
    """Kernels vs plain versions at 128 x 65536, three blocks each."""
    from sdrmodem_tpu_torch.dsp.clock_recovery import chunk_plan, clock_mm_batched_full
    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig, float_to_int8
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline, DemodStateFull
    from sdrmodem_tpu_torch.ops.clock import clock_mm_chunked_plain
    from sdrmodem_tpu_torch.ops.front import fused_front, fused_front_plain

    x_all = capture_lanes(torch, dev, 3 * CHECK_BLOCK, LANES)
    for name, args in CHECK_CONFIGS.items():
        t0 = time.perf_counter()
        pipe = DemodPipeline(FskDemodConfig(*args), CHECK_BLOCK, device=dev)
        p = pipe.config.clock_params()
        st_k = st_p = pipe.init_full_state(LANES)
        err = dict(y3=0.0, lpf1=0.0, quad_prev=0.0, lpf2=0.0, dc=0.0, clock_lsb=0, clock_f32=0.0)
        symbols = 0
        for blk in range(3):
            x = x_all[blk * CHECK_BLOCK : (blk + 1) * CHECK_BLOCK]
            y3_k, f_k = fused_front(x, *st_k[:4], pipe.front_taps)
            y3_p, f_p = fused_front_plain(x, *st_p[:4], pipe.front_taps)
            torch.cuda.synchronize()
            need(torch.isfinite(y3_k).all().item(), f"{name}: front kernel gave non-finite y3")
            err["y3"] = max(err["y3"], (y3_k - y3_p).abs().max().item())
            err["lpf1"] = max(err["lpf1"], (f_k[0] - f_p[0]).abs().max().item())
            err["quad_prev"] = max(err["quad_prev"], (f_k[1] - f_p[1]).abs().max().item())
            err["lpf2"] = max(err["lpf2"], (f_k[2] - f_p[2]).abs().max().item())
            if f_p[3] is not None:
                err["dc"] = max(err["dc"], (f_k[3] - f_p[3]).abs().max().item())

            ck = st_k.clock
            o_k, c_k, ck_k = clock_mm_batched_full(y3_k, ck, bank=pipe.bank, **p)
            plan = chunk_plan(*y3_k.shape, ck.suffix.shape[0], **p)
            o_p, c_p, fin_p = clock_mm_chunked_plain(
                y3_k, ck.suffix, ck.omega, ck.mu, ck.last_sample, ck.resid, pipe.bank, **plan
            )
            torch.cuda.synchronize()
            need(torch.equal(c_k, c_p.T), f"{name} block {blk}: clock counts differ from plain")
            lsb = (float_to_int8(o_k).int() - float_to_int8(o_p.permute(2, 0, 1)).int()).abs().max().item()
            err["clock_lsb"] = max(err["clock_lsb"], lsb)
            err["clock_f32"] = max(err["clock_f32"], (o_k - o_p.permute(2, 0, 1)).abs().max().item())
            need(torch.equal(ck_k.resid, fin_p[3]), f"{name} block {blk}: clock resid differs")
            symbols += int(c_k.sum().item())
            st_k = DemodStateFull(*f_k, ck_k)
            st_p = DemodStateFull(*f_p, ck_k)
        log(f"[check] {name}: max |kernel - plain| {json.dumps(err)}; {symbols} symbols; "
            f"{time.perf_counter() - t0:.3f} s")
        need(err["y3"] <= FRONT_ATOL, f"{name}: y3 error {err['y3']} > {FRONT_ATOL}")
        need(err["lpf1"] == 0.0, f"{name}: lpf1_hist differs")
        need(err["quad_prev"] == 0.0, f"{name}: quad_prev differs by {err['quad_prev']}")
        need(max(err["lpf2"], err["dc"]) <= FRONT_ATOL, f"{name}: FIR tail error")
        need(err["clock_lsb"] <= 1, f"{name}: clock symbols {err['clock_lsb']} LSB apart")
        need(symbols > 0, f"{name}: the clock emitted no symbols")


def phase_golden(torch, dev):
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
    from sdrmodem_tpu_torch.utils.parity import GOLDEN_CASES, demod_capture, golden_report

    for name, cfg, fin, fexp, block in GOLDEN_CASES:
        iq = np.fromfile(FIXTURES / fin, np.complex64)
        golden = np.fromfile(FIXTURES / fexp, np.int8)
        rep = golden_report(demod_capture(DemodPipeline(cfg, block, device=dev), iq), golden)
        log(f"[golden] {name}: {json.dumps(rep)}")
        need(rep["symbols"] >= 0.99 * len(golden), f"{name}: too few symbols")
        need(rep["hard_decision_agreement"] == 1.0, f"{name}: hard decisions differ")
        need(rep["max_lsb"] <= 2, f"{name}: {rep['max_lsb']} LSB from the golden")


def front_cost(c, b, taps, d):
    """(bytes, flops) the front end must move and do at this shape: input
    block, histories and taps read once, y3 and the new tails written once;
    two flops a tap of LPF1 and LPF2, ~16 a quad-demod output (6 for the
    conjugate product, ~10 for the table arctangent and gain) and 13 a DC
    blocker output.  The DC blocker is four length-L moving averages and a
    delay line (dsp/elementwise.py:dc_blocker_taps), which running sums
    take at an add, a subtract and a scale each, and one subtract: the
    kernel's (4L-3)-tap FIR form of it is work beyond this bound."""
    t1, t2 = taps.rev1.numel(), taps.rev2.numel()
    t3 = taps.rev_dc.numel() if taps.rev_dc is not None else 0
    n2 = b // d
    hist_words = (t1 - 1) * 2 * c + 2 * c + (t2 - 1) * c + max(t3 - 1, 0) * c
    words = b * 2 * c + n2 * c + 2 * hist_words + t1 + t2 + t3 + 257
    flops = 2 * (b * 2 * c * t1 + n2 * c * t2) + 16 * b * c + (13 * n2 * c if t3 else 0)
    return 4 * words, flops


def clock_cost(n, c, sfx, n_chunks, k, symbols):
    """(bytes, flops): y3, suffix, state and bank read once, symbol slots,
    counts and state written once; ~30 flops a symbol this run emitted (8
    products and 7 sums of the interpolator, ~15 for the loop update)."""
    words = n * c + sfx * c + 4 * c + 129 * 8 + n_chunks * k * c + n_chunks * c + 4 * c
    return 4 * words, 30 * symbols


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_main(torch, dev):
    import torch.nn.functional as F

    from sdrmodem_tpu_torch.dsp.clock_recovery import chunk_plan, clock_mm_batched_full
    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
    from sdrmodem_tpu_torch.ops import clock as clock_ops
    from sdrmodem_tpu_torch.ops import front as front_ops

    c, b = LANES, MAIN_BLOCK
    pipe = DemodPipeline(FskDemodConfig(*LUCKY7), b, device=dev)
    p = pipe.config.clock_params()
    x_tm = capture_lanes(torch, dev, b, c)
    x_fan = torch.stack([x_tm[:, 0], x_tm[:, c]]).contiguous()  # lane 0's stream, shared
    inputs = {"tm": x_tm, "fanout": x_fan}
    torch.cuda.synchronize()

    # ---- the main path, counted
    front_ops.launches = 0
    clock_ops.launches = 0
    results = {}
    for layout, x in inputs.items():
        step = pipe.make_batched_step_full(layout=layout)
        state = pipe.init_full_state(c)
        state, sym, cnt = step(state, x)  # warm-up
        first = (sym, cnt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()

        def run(state=state):
            out = None
            for _ in range(MAIN_STEPS):
                state, sym, cnt = step(state, x)
                out = (state, sym, cnt)
            return out

        ms, (state, sym, cnt) = cuda_ms(torch, run, 1)
        wall = time.perf_counter() - t0
        ms_step = ms / MAIN_STEPS
        results[layout] = dict(first=first, last=(sym, cnt), ms_step=ms_step)
        log(f"[main] {layout}: {ms_step:.4f} ms/step (CUDA events), "
            f"{c * b / (ms_step * 1e-3) / 1e6:.1f} Msamples/s; wall {wall:.3f} s for {MAIN_STEPS} steps")
    launches = {"front": front_ops.launches, "clock": clock_ops.launches}
    log(f"[main] launches during the main path: {json.dumps(launches)}")
    need(launches["front"] > 0 and launches["clock"] > 0, "a kernel of the main path never ran")

    # ---- what came out
    n2 = b // pipe.config.decimation
    chunk = chunk_plan(n2, c, pipe.init_full_state(1).clock.suffix.shape[0], **p)["chunk"]
    per_chunk = chunk / p["omega"]
    for layout, res in results.items():
        for sym, cnt in (res["first"], res["last"]):
            need(sym.dtype == torch.int8 and cnt.shape == (c, n2 // chunk), f"{layout}: output shape")
            lo, hi = cnt.min().item(), cnt.max().item()
            need(0.9 * per_chunk <= lo and hi <= 1.1 * per_chunk + 2, f"{layout}: counts {lo}..{hi}")
            need(sym.abs().max().item() > 64, f"{layout}: symbols look empty")
    # lanes are independent: a one-lane run gives lane 0's symbols bit for bit
    one = DemodPipeline(FskDemodConfig(*LUCKY7), b, device=dev)
    _, sym1, cnt1 = one.make_batched_step_full(layout="fanout")(one.init_full_state(1), x_fan)
    sym_tm, cnt_tm = results["tm"]["first"]
    sym_fan, cnt_fan = results["fanout"]["first"]
    need(torch.equal(cnt1[0], cnt_tm[0]) and torch.equal(sym1[0], sym_tm[0]),
         "tm lane 0 differs from a one-lane run")
    need(torch.equal(cnt_fan, cnt1.expand(c, -1)) and torch.equal(sym_fan, sym1.expand(c, -1, -1)),
         "fanout lanes differ from a one-lane run")
    log("[main] lane 0 of tm and every fanout lane equal a one-lane run, bit for bit")

    # ---- each kernel alone at the main path's shape, against its plain version
    state = pipe.init_full_state(c)
    front_args = (x_tm, *state[:4], pipe.front_taps)
    front_ops.fused_front(*front_args)  # warm-up
    front_ms, (y3, f_k) = cuda_ms(torch, lambda: front_ops.fused_front(*front_args), 3)
    front_ops.fused_front_plain(*front_args)
    front_plain_ms, (y3_p, f_p) = cuda_ms(torch, lambda: front_ops.fused_front_plain(*front_args), 2)
    front_err = (y3 - y3_p).abs().max().item()
    need(front_err <= FRONT_ATOL and torch.equal(f_k[0], f_p[0]) and torch.equal(f_k[1], f_p[1]),
         f"front at full width: {front_err}")
    work = torch.cat([state.lpf1_hist, x_tm]).T.contiguous().unsqueeze(1)
    w1 = pipe.front_taps.rev1.view(1, 1, -1)
    with torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False):
        F.conv1d(work, w1)
        lib_ms, _ = cuda_ms(torch, lambda: F.conv1d(work, w1), 3)
    del work

    ck = state.clock
    clock_ms, (outs, counts, _) = cuda_ms(
        torch, lambda: clock_mm_batched_full(y3, ck, bank=pipe.bank, **p), 3
    )
    plan = chunk_plan(*y3.shape, ck.suffix.shape[0], **p)
    t0 = time.perf_counter()
    clock_plain_ms, (o_p, c_p, _) = cuda_ms(
        torch,
        lambda: clock_ops.clock_mm_chunked_plain(
            y3, ck.suffix, ck.omega, ck.mu, ck.last_sample, ck.resid, pipe.bank, **plan
        ),
        1,
    )
    log(f"[main] plain clock at full width took {time.perf_counter() - t0:.3f} s wall")
    need(torch.equal(counts, c_p.T), "clock at full width: counts differ from plain")
    clock_err = (outs - o_p.permute(2, 0, 1)).abs().max().item()
    need(clock_err * 127 <= 1.0, f"clock at full width: {clock_err}")
    symbols = int(counts.sum().item())

    fb, ff = front_cost(c, b, pipe.front_taps, pipe.config.decimation)
    n_chunks = counts.shape[1]
    cb, cf = clock_cost(y3.shape[0], c, ck.suffix.shape[0], n_chunks, plan["num_symbols"], symbols)
    f_bound, f_by = bound(fb, ff)
    c_bound, c_by = bound(cb, cf)
    log(f"[main] front {front_ms:.4f} ms (plain {front_plain_ms:.4f}, conv1d LPF1 {lib_ms:.4f}, "
        f"bound {f_bound:.4f} by {f_by}); clock {clock_ms:.4f} ms (plain {clock_plain_ms:.4f}, "
        f"bound {c_bound:.4f} by {c_by}); {symbols} symbols")
    return [
        dict(name="front", route="cuda", source="sdrmodem_tpu_torch/csrc/front.cu",
             replaces="sdrmodem_tpu/ops/pallas_front.py:118", launches=launches["front"],
             max_abs_err=front_err, ms=front_ms, plain_ms=front_plain_ms, bound_ms=f_bound,
             bound_by=f_by, library_ms=lib_ms),
        dict(name="clock", route="cuda", source="sdrmodem_tpu_torch/csrc/clock.cu",
             replaces="sdrmodem_tpu/ops/pallas_clock.py:326", launches=launches["clock"],
             max_abs_err=clock_err, ms=clock_ms, plain_ms=clock_plain_ms, bound_ms=c_bound,
             bound_by=c_by, library_ms=None),
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        import sdrmodem_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script: {exc}", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_all = time.perf_counter()
    try:
        for name, fn in (("build", phase_build), ("check", lambda: phase_check(torch, dev)),
                         ("golden", lambda: phase_golden(torch, dev))):
            t0 = time.perf_counter()
            fn()
            log(f"[{name}] passed in {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        kernels = phase_main(torch, dev)
        log(f"[main] passed in {time.perf_counter() - t0:.3f} s")
    except SmokeError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[total] {time.perf_counter() - t_all:.3f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
