"""Driver ``step``: the fast group's batched demod step alone, driven flat
out.

The entry is the step the server's fast group builds
(``server/session.py:BatchedRxGroup._build_step``):
``DemodPipeline(radio, block, exact=False, use_atan_lut=True)
.make_batched_step_full("pallas", doppler=True, layout="fanout")``, stepped
as ``step(state, x, dop)`` with one shared (2, block) IQ stream and each
lane's (S, lanes) Doppler tables.

Set-up makes a ring of ``ring`` blocks and their Doppler rows on the card
and warms the step up on a state of its own.  The window then steps the
ring over and over from a fresh state, the state carried, with up to
``in_flight`` steps queued: each step's symbols and counts are copied to
pinned host memory, and a step's buffers are reused once its copy has
landed.  ``rx_msps`` is the lane-samples of every step over the whole
window, the last copy included.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import check, core, gen, tracing
from benchmark.reference.fsk import Radio


def _tables(torch, dop, dev):
    return tuple(torch.from_numpy(np.ascontiguousarray(t)).to(dev) for t in dop)


def run(cell, *, seed: int, seconds: float, trace: bool, device, t_start: float, trace_path=None,
        fault=None, control: bool = False, phases=None) -> dict:
    import torch

    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline

    phases = core.Phases(t_start) if phases is None else phases
    cfg, mix = cell.config, cell.mix
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    lanes, block, ring = int(mix["lanes"]), int(mix["block"]), int(mix["ring"])
    r = cfg["radio"]
    fsk = FskDemodConfig(r["sampling_freq"], r["baud_rate"], r["deviation"], r["decimation"],
                         r["transition_width"], r["use_dc_block"])
    if cuda:
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)  # the context, before its counters are reset
        torch.cuda.reset_peak_memory_stats(dev)
    phases.mark("modules")  # the port's modules this driver takes

    # ---- set-up: the ring of inputs, the step, one warm-up
    blocks = gen.stream_blocks(cfg, mix, seed)
    xs = np.stack([blocks.real, blocks.imag], axis=1).astype(np.float32)  # (ring, 2, B)
    dops = gen.doppler_ring(cfg, mix, gen.client_starts(cfg, mix, seed))
    x_dev = torch.from_numpy(xs).to(dev)
    dop_dev = [_tables(torch, d, dev) for d in dops]
    phases.mark("traffic")
    pipe = DemodPipeline(fsk, block, exact=False, use_atan_lut=True, device=dev)
    step = pipe.make_batched_step_full("pallas", doppler=True, layout="fanout")
    if fault is not None:
        step = fault(step)
    phases.mark("program")
    warm = pipe.init_full_state(lanes)
    for j in range(int(mix["warmup_steps"])):
        warm, sym, cnt = step(warm, x_dev[j % ring], dop_dev[j % ring])
    slots = int(mix["in_flight"])
    pin = dict(pin_memory=cuda)
    host_sym = [torch.empty(tuple(sym.shape), dtype=sym.dtype, **pin) for _ in range(slots)]
    host_cnt = [torch.empty(tuple(cnt.shape), dtype=cnt.dtype, **pin) for _ in range(slots)]
    n_chunks = int(cnt.shape[1])
    k_slots = int(sym.shape[2])
    del warm, sym, cnt
    if cuda:
        torch.cuda.synchronize(dev)

    check_lanes = gen.sample_lanes(lanes, int(mix["check_lanes"]), seed)
    carry = int(mix["carry_chunks"])
    res = gen.Reservoir(int(mix["check_blocks"]), seed)
    kept_states: dict[int, tuple] = {}
    outputs: dict[int, list] = {}

    def wanted(j):
        return j < 2 or any(j in (k, k + 1) for k in res.items)

    def landed(j, slot):
        if wanted(j):
            outputs[j] = (host_sym[slot].numpy()[check_lanes], host_cnt[slot].numpy()[check_lanes])
        events[slot] = None
        return int(host_cnt[slot].numpy().sum())

    phases.mark("warmup")  # the kernels loaded (built on a checkout's first run), the warm-up steps
    setup_s = time.perf_counter() - t_start

    # ---- the window
    state = pipe.init_full_state(lanes)
    events = [None] * slots
    steps = symbols = 0
    prev_state = None
    with tracing.traced(torch, trace, trace_path):
        with tracing.span(torch, tracing.WINDOW, trace):
            t0 = time.perf_counter()
            while True:
                slot = steps % slots
                if events[slot] is not None:
                    with tracing.span(torch, "bench.wait", trace):
                        events[slot].synchronize()
                    symbols += landed(steps - slots, slot)
                if time.perf_counter() - t0 >= seconds:
                    break
                if steps >= 2:
                    _, old = res.offer(steps - 1)
                    if steps - 1 in res.items:
                        kept_states[steps - 1] = prev_state
                    if old is not None:
                        kept_states.pop(old, None)
                        for j in (old, old + 1):
                            if not wanted(j):
                                outputs.pop(j, None)
                prev_state = state
                with tracing.span(torch, "bench.step", trace):
                    state, sym, cnt = step(state, x_dev[steps % ring], dop_dev[steps % ring])
                    host_sym[slot].copy_(sym, non_blocking=True)
                    host_cnt[slot].copy_(cnt, non_blocking=True)
                    if cuda:
                        events[slot] = torch.cuda.Event()
                        events[slot].record()
                    else:
                        events[slot] = _Done()
                steps += 1
            for j in range(max(0, steps - slots), steps):
                slot = j % slots
                if events[slot] is not None:
                    events[slot].synchronize()
                    symbols += landed(j, slot)
            window_s = time.perf_counter() - t0
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    del state, prev_state, host_sym, host_cnt, x_dev, dop_dev, events
    kept = {k: check.ref_state(s, check_lanes) for k, s in kept_states.items()}
    kept_states.clear()
    if cuda:
        torch.cuda.empty_cache()

    # ---- the check: the reference over the sampled blocks
    starts = [None] + sorted(kept)
    segs, prog = [], []
    for k in starts:
        k0 = 0 if k is None else k
        if k0 + 1 >= steps:
            continue
        segs.append(check.Segment(
            [xs[k0 % ring], xs[(k0 + 1) % ring]],
            [tuple(t[:, check_lanes] for t in dops[k0 % ring]), tuple(t[:, check_lanes] for t in dops[(k0 + 1) % ring])],
            None if k is None else kept[k]))
        prog.append((check.program_symbols(*outputs[k0]), check.program_symbols(*outputs[k0 + 1])))
    radio = Radio.from_config(cfg)
    numbers = check.compare(radio, lanes, block, segs, prog, len(check_lanes), dev, carry, control)
    dc = radio.dc()
    return {
        "metrics": {"rx_msps": steps * lanes * block / window_s / 1e6, "setup_s": setup_s},
        "setup_parts": phases.seconds,
        "attempted": steps, "failed": 0, "numbers": numbers, "memory_peak_bytes": peak,
        "layer": {"steps": steps, "window_s": window_s, "lanes": lanes, "block": block,
                  "symbols_per_step": symbols / max(steps, 1), "n_chunks": n_chunks, "k": k_slots,
                  "taps": (len(radio.lpf1()), len(radio.lpf2()), 0 if dc is None else len(dc)),
                  "d": radio.decimation, "s_rows": int(dops[0][0].shape[0]), "sfx": radio.suffix,
                  "fanout": True},
    }


class _Done:
    """The event of a step on the CPU, which is done when it returns."""

    def synchronize(self):
        pass
