#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (sdrmodem_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. build   — nvcc compiles csrc/*.cu into build/kernels/, one process per
             source, all started together;
2. check   — each kernel against its plain PyTorch version on the card at
             128 lanes x 65536 samples: the quad-demod kernel's atan2 form
             (the banded front's stage in the "atan2" modes) on the lucky7
             capture and on the nan fixture tiled over 128 lanes, within
             atan2f's 3 ulp bound twice over times the gain, its LUT form
             bit for bit; the front and the clock (three
             configurations, three blocks with carried state; B2 bit for
             bit); B2 where its walk meets each edge of its chunks and
             slots (lanes scaled by 1e4 and 1e5, a late entry, NaN and inf
             across the edges, K filling, a block of 5 chunks and 100
             rows and one of 100 rows, 300 lanes), at its own slot size
             and at one chunk a slot, bit for bit; B3 and the float64 FIR
             in both of the kernel's forms (wide: 128 lanes; narrow: 2
             lanes and 1) over the lucky7 LPF2, LPF1 and DC taps at strides
             1 and 2 with a band offset, and a 12,797-tap FIR, taps in
             parts in both forms; B8; the front with Doppler tables from the raw
             lucky7 pass on 64 lanes (the other 64 without rows, which must
             equal a run without Doppler bit for bit); the fused and banded
             fronts bit for bit (y3 and the four tails), with and without
             Doppler, in the four configurations at 128 x 65536, lucky7 at
             300 lanes x 65536 and x 64 rows and nan at 130 lanes x 1000
             rows (blocks shorter than the DC history), with Doppler rows
             on the fused kernel's tile and segment edges and a NaN stretch
             across a segment edge; the TX kernels,
             B5 at 2048 B and 32 KiB at I = 2 and 60 and B6 at 5 and 128
             streams x 2048 B, with a carried phase and history and a
             ragged n_valid, then where their tiles, runs and launches
             meet the data (n_valid at 0, on a tile and a run edge and
             past the payload, one tile of rows and one either side, a
             zero and a non-+-1 history, B6 at 1 and 33 lanes), each
             call's launches as tx_plan gives them, and two identical
             calls of each at full width, which must give the same bits;
             B4 at 128 lanes x 65536 in both layouts (a NaN
             stretch, ragged n_valid and read starts), at its own slot size
             and at 64 rows a slot, and the float64 FIR at the exact
             streamer's shapes, bit for bit; B4 alone at 128, 512 and 1024
             lanes x 65536, each lane equal to the 128-lane run;
3. golden  — the four reference fixtures through the port's
             make_batched_step_full(layout="tm") with front "fused" and
             front "step" (B7), which must give the same bytes; the raw
             lucky7 pass
             through the server's call make_batched_step_full("pallas",
             doppler=True, layout="fanout"), on the card; the four
             fixtures through the exact and float32 streamers and
             FskDemodulator at block 262144, the exact streamer's bytes
             equal to the same run on the CPU; the four fixtures with
             use_atan_lut="atan2" (the banded route on every front: "fused"
             and "step" give its bytes, B1 and B7 never launch), within +-2
             LSB and hard decisions 1.0, lucky7_nodc's symbols 6319-6389
             (the lock that turns on the last ulp) excepted; the TX golden (320 samples),
             the card's TX into the card's RX, and 32 KiB at I = 60
             against the float64 chain;
4. main    — the paths, each driven with the launch counts set to 0 just
             before it and read just after: (a) 128 lanes x 2^20 samples of
             the lucky7 configuration (the bench.py shape), layouts "tm" and
             "fanout", then "tm" through front "step" (B7); (b) the server's
             step at its default shape, 128 lanes x 262144
             (server/config.py:76), layout "fanout", Doppler rows on every
             lane, front "fused", "banded" and "step".  Each "step" run must
             equal its "fused" run bit for bit: every step's symbols and
             counts, and the final state; (c) fir_tpu over
             128 lanes x 2^20 with the LPF2 taps, decimation 2.  One warm-up
             and 5 timed steps each (3 for fir_tpu), by CUDA events.  On
             each path's own inputs, outside the counted runs, the fronts
             and B3 are held against their plain versions, and the fused
             front against the banded front bit for bit.  (d) the
             server's TX chain (server/session.py:707-726): 100 TxData of
             2048 B through one StreamingGfskMod, then 8 of 32 KiB at I = 2
             and 2 at I = 60, each followed by Doppler.process_tx; wall
             time a call, then the same calls split into host prep, upload,
             kernel, download and process_tx.  (e) process_pair_kernel on
             128 streams x 2048 B (B6), one warm-up and 20 timed calls.
             (i) the server's step with long filters, 288 kHz / 9600 Bd
             (707 / 347 / 1917 taps, past B1's layout) at 128 x 262144,
             fanout, Doppler on: the banded front, B1 never launched, B3
             three times a step, and the front against its plain version.
             (f) one exact-mode client (the server's default RX): the
             lucky7 capture over 16 blocks of 262144 through the exact
             streamer, ms a block and Msamples/s, then its stages and B4
             alone; (g) the same in float32; (h) make_batched_step("pallas")
             at 128 x 2^20, every lane full and then half the lanes short.
             (j)-(l) the port's server in-process (SdrModemServer with its
             default device, the card, on 127.0.0.1:0, buffer_size
             262144), fed by a mock sdr-server and driven by wire clients
             (tests/torch_server_helpers.py): (j) demod_mode = exact, four
             clients on one stream of the corrected lucky7 capture over 4
             blocks, each client's bytes equal to the exact streamer run
             directly, the first pass within +-2 LSB of the golden; (k)
             demod_mode = fast, 128 clients (every lane of one group) on
             the raw lucky7 pass over 4 blocks, client k with the pass's
             Doppler from PASS_START + k, every lane equal to the group's
             step run directly with the same tables, B1 and B2 launched,
             B7 never, the pack kernel's two launches a block, and lane 0 of the same direct run with the
             Doppler interpolated every 2000 samples (the goldens'
             cadence) within +-2 LSB of the golden; (l) one TX client into a file device, 100 TxData of
             2048 B and 2 of the wire's largest, the dump equal to
             StreamingGfskMod's, B5 launched as tx_plan gives it.  Each
             prints ms a block from the mock to the last client's last
             symbol, or ms from a TxData to its response.
             (m)-(q) several shards, all on the one card (a mesh may
             repeat a device; no scaling is claimed): (m)
             ShardedChannelDemodFull over 4 shards, 512 lanes x 262144, two
             steps, its symbols and state equal to the unsharded 512-lane
             step's, both timed, and ShardedChannelDemod over 2 shards, 16
             channels, ragged, equal to make_batched_step("pallas"); (n)
             demod_pipelined over 4 shards, 128 streams x 2^20, each equal
             to the unsharded step at 262144, stream 0 within +-2 LSB of
             the golden; the raw pass with its Doppler tables and a
             corrected stream, each equal to the unsharded step with the
             same tables and within +-2 LSB of the golden; and
             demod_grid_sharded on 2 x 2 shards; (o) the server with
             LANES = 512 and its group's lanes over 4 shards
             (SdrModemServer(devices=...)), path (k)'s clients and blocks,
             every lane equal to the unsharded 512-lane step, B2 once and
             the pack kernel twice a shard a block; (p) python -m
             sdrmodem_tpu_torch.tools.multihost --backend gloo, 2
             processes x 2 shards, 16 streams x 32768, 0 symbols differing
             from one process; (q) the parity tool, both modes, its gate;
             (r) each twin of the JAX tools as python -m
             sdrmodem_tpu_torch.tools.<name> under its own timeout, which
             must exit 0: graft_entry --devices 4 (the dry run on 4
             repeated cards), perf, latency at 4096 and 262144, ber_sweep
             at 512 B, trace of 2 steps, and the three profiles at 128 x
             262144.  After (a), B4 over [suffix | y3] of its block, in both
             layouts, must equal B2's symbols; in (f) and (g), B4 at the
             streamer's one-lane buffer must equal its plain version;
5. kernels — each kernel alone at its path's shape: time, its plain
             version's time and error, its bound, and a PyTorch library
             call's time where one computes the same function.  B1 with
             Doppler, without, its first launch alone (lucky7_nodc) and its
             DC launch alone, which must give the front's y3 bit for bit;
             its row carries a second bound, the work of this design with
             the DC blocker as a FIR; the same DC FIR through B3's wide
             form, which must give the same bits.  B3 at the LPF1 shape
             and, with the float64 FIR, at one client's three shapes (2 x
             262300, 1 x 262200 at d = 2, 1 x 131708), each beside its
             bound, its plain version and cuDNN's conv1d.  B2 must
             equal its plain version bit for bit at 128 x 2^20; then B2
             alone at 128, 512, 1024 and 4096 lanes x 2^19 rows, each
             tiled lane equal to the 128-lane run, and path (b)'s step at
             128 and 512 lanes (ROADMAP P1), front "fused" and "step", each
             "step" run equal to its "fused" run bit for bit.  B7 at
             128 x 2^20 with Doppler must equal B1 followed by B2 bit for
             bit, timed beside the pair and beside B2 alone on the same y3
             (the clock chain's floor), and its plain version at 128 x
             65536.  The pack kernel (pack_lanes) on the server step's own
             output, the nusat capture at 128 and 512 lanes x 262144 with
             Doppler: bit for bit its plain version and the old per-chunk
             split, two launches a call.  Phase 1 prints every kernel's
             registers and spills, B7's (step: fused_step_kernel) among
             them.

Prints the card's name and power limit, one JSON line describing each
kernel, and as its last line {"ok": true, "device": {...}}.  Exits non-zero
without a CUDA device, or where the port is not beside this script.
"""

import functools
import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "fixtures"

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and f32 (non-tensor) rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12  # float64, non-tensor

LUCKY7 = (48000, 4800, 5000, 2, 2000, True)
CHECK_CONFIGS = {
    "lucky7": LUCKY7,
    "lucky7_nodc": (48000, 4800, 5000, 2, 2000, False),
    "nusat": (192000, 40000, 5000, 1, 2000, True),
}
FRONT_CONFIGS = {**CHECK_CONFIGS, "nan": (240000, 9600, 5000, 1, 2000, True)}  # inputnan.cf32's
LANES = 128
CHECK_BLOCK = 65536
TX_RADIO = (9600, 5000)  # baud, deviation
# the reference's perf config (tools/perf.py:4, I = 2) and the PlutoSDR one
# of the server's own test (tests/test_server.py:316, I = 60)
TX_FS = (19200, 576000)
TXDATA_MAX = 32768  # the wire's largest TxData (reference src/api_utils.c:8)
TX_ATOL = 1e-4
MAIN_BLOCK = 1 << 20
SERVER_BLOCK = 262144  # the server's default buffer_size (server/config.py:76)
STREAM_BLOCKS = 16  # blocks of one client's stream in paths (f) and (g)
MAIN_STEPS = 5
FRONT_ATOL = 1e-4  # tests/test_fused_front.py:46
MIXED_ATOL = 2e-6  # the NCO's cos and sin, an ulp apart (tests/test_torch_doppler.py)
BAND_OFFSET = 37
LONG_TAPS = (288000, 9600, 5000, 2, 2000, True)  # past B1's layout: the banded route (path (i))
LONG_FIR_TAPS = 12797  # the DC FIR at 240 kHz / 1200 Bd: tap parts in both FIR forms
SMALL_SLOT_ROWS = 64  # B4's staged rows a slot in the slot-edge gate
B4_LANES = (128, 512, 1024)  # lanes of B4's timing alone, ROADMAP P1
B2_EDGE_CHUNK = 256  # B2's chunk (SDRM_CLOCK_CHUNK) in its slot-edge gate
B2_LANES = (128, 512, 1024, 4096)  # lanes of B2's timing alone, ROADMAP P1
SERVER_LANES = (128, 512)  # lanes of path (b)'s step in the same sweep

# the lucky7 pass the Doppler goldens were recorded with (tests/test_doppler.py)
TLE = [
    "LUCKY-7",
    "1 44406U 19038W   20069.88080907  .00000505  00000-0  32890-4 0  9992",
    "2 44406  97.5270  32.5584 0026284 107.4758 252.9348 15.12089395 37524",
]
DOPPLER = dict(latitude=53.72, longitude=47.57, altitude_km=0.0, sampling_freq=48000,
               center_freq=437525000, tle_lines=TLE)
PASS_START = 1583840449


class SmokeError(Exception):
    pass


def need(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(msg):
    print(msg, flush=True)


def capture_lanes(torch, dev, n, lanes, name="lucky7.expected.cf32"):
    """A lucky7 capture tiled into (n, 2*lanes) time-major IQ, lane c
    reading the tiled stream from c*n on (as bench.py tiles it)."""
    iq = np.fromfile(FIXTURES / name, np.complex64)
    re = torch.from_numpy(iq.real.copy()).to(dev)
    im = torch.from_numpy(iq.imag.copy()).to(dev)
    idx = (torch.arange(n, device=dev)[:, None] + n * torch.arange(lanes, device=dev)[None, :]) % len(iq)
    return torch.cat([re[idx], im[idx]], dim=1).contiguous()


def lane_dopplers(lanes, fs=DOPPLER["sampling_freq"]):
    """One Doppler corrector per lane at sample rate fs, each on its own
    pass: even lanes start a second apart, odd lanes carry their own
    constant offset."""
    from sdrmodem_tpu_torch.dsp.doppler import Doppler

    return {
        k: Doppler(**{**DOPPLER, "sampling_freq": fs}, start_time_seconds=PASS_START + (k if k % 2 == 0 else 0),
                   constant_offset=0 if k % 2 == 0 else 50 * k)
        for k in lanes
    }


def doppler_tables(dops, block, lanes, dev, max_batch=None):
    """The next block's (S, lanes) tables on the card (rows from each
    lane's corrector; lanes without one have no rows)."""
    from sdrmodem_tpu_torch.dsp.doppler import Doppler
    from sdrmodem_tpu_torch.utils.convert import doppler_tables_from_numpy, segment_tables

    rows = {k: d.device_segments(block, +1, max_batch=max_batch) for k, d in dops.items()}
    fs = int(next(iter(dops.values())).fs) if dops else DOPPLER["sampling_freq"]
    s_rows = Doppler.max_rows(block, fs, max_batch)
    return doppler_tables_from_numpy(segment_tables(rows, s_rows, lanes), lanes, device=dev)


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


def graph_ms(torch, fn, reps):
    """Device time of one fn() alone: reps calls captured in one CUDA graph
    and replayed, so the host's work around each launch (allocations,
    checks, the ctypes call) is out of the window."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            out = fn()
    graph.replay()
    ms, _ = cuda_ms(torch, graph.replay, 3)
    return ms / reps, out


@functools.cache
def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def b4_time(ms, shape, counts, bnd):
    """One B4 time as the log gives each: its shape, the symbols a lane, us
    a symbol step along the longest lane's chain, its bound and the card."""
    most = max(int(counts.max().item()), 1)
    return (f"{ms:.4f} ms at {shape}, {counts.double().mean().item():.1f} symbols a lane (most "
            f"{most}), {ms * 1e3 / most:.4f} us a step, bound {bnd[0]:.6f} ms by {bnd[1]} [{card()}]")


def counters():
    from sdrmodem_tpu_torch.ops import clock as clock_ops
    from sdrmodem_tpu_torch.ops import fir as fir_ops
    from sdrmodem_tpu_torch.ops import front as front_ops
    from sdrmodem_tpu_torch.ops import pack as pack_ops
    from sdrmodem_tpu_torch.ops import step as step_ops
    from sdrmodem_tpu_torch.ops import tx as tx_ops

    return {"front": (front_ops, "launches"), "front_fused": (front_ops, "fused_launches"),
            "clock": (clock_ops, "launches"),
            "step": (step_ops, "launches"),
            "clock_ragged": (clock_ops, "ragged_launches"),
            "fir": (fir_ops, "launches"), "fir_tpu": (fir_ops, "fir_tpu_launches"),
            "fir_exact": (fir_ops, "exact_launches"),
            "tx_folded": (tx_ops, "folded_launches"), "tx": (tx_ops, "batched_launches"),
            "pack": (pack_ops, "launches")}


def counted(torch, path, want, fn, never=()):
    """Run one path of the main run with every launch count set to 0 just
    before it and read just after; fail if a kernel in ``want`` never ran,
    or one in ``never`` ran."""
    for mod, attr in counters().values():
        setattr(mod, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    counts = {name: getattr(mod, attr) for name, (mod, attr) in counters().items()}
    log(f"[main] {path}: launches {json.dumps(counts)}")
    for name in want:
        need(counts[name] > 0, f"{path}: kernel {name} was never launched")
    for name in never:
        need(counts[name] == 0, f"{path}: kernel {name} was launched off its path")
    return out, counts


def kernel_name(mangled):
    """A kernel's name and template arguments from its mangled name
    (``...12front_kernelILi2EE...`` -> ``front_kernel<ILi2E>``)."""
    for m in re.finditer(r"\d+", mangled):
        n, at = int(m.group()), m.end()
        name = mangled[at : at + n]
        if name.endswith("kernel") and len(name) == n:
            args = re.match(r"I\w*?E(?=E)", mangled[at + n :])
            return name + (f"<{args.group()}>" if args else "")
    return mangled


def phase_build():
    from sdrmodem_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[build] {sorted(logs)} built in {time.perf_counter() - t0:.3f} s")
    for name, text in logs.items():
        kernel, spills = "?", ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                kernel = kernel_name(line.split("'")[1])
            elif "spill" in line:
                spills = line.strip()
            elif "registers" in line:
                log(f"[build] {name}: {kernel}: {line.strip().removeprefix('ptxas info    : ')}; {spills}")


def check_front_and_clock(torch, dev):
    """Front and clock kernels vs plain at 128 x 65536, three blocks each."""
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
            need(torch.equal(o_k, o_p.permute(2, 0, 1)) and all(
                torch.equal(a, b) for a, b in zip((ck_k.omega, ck_k.mu, ck_k.last_sample, ck_k.resid), fin_p)),
                f"{name} block {blk}: B2 differs from its plain version")
            symbols += int(c_k.sum().item())
            st_k = DemodStateFull(*f_k, ck_k)
            st_p = DemodStateFull(*f_p, ck_k)
        log(f"[check] {name}: max |kernel - plain| {json.dumps(err)}; {symbols} symbols; "
            f"{time.perf_counter() - t0:.3f} s")
        need(err["y3"] <= FRONT_ATOL, f"{name}: y3 error {err['y3']} > {FRONT_ATOL}")
        need(err["lpf1"] == 0.0, f"{name}: lpf1_hist differs")
        need(err["quad_prev"] == 0.0, f"{name}: quad_prev differs by {err['quad_prev']}")
        need(max(err["lpf2"], err["dc"]) <= FRONT_ATOL, f"{name}: FIR tail error")
        need(symbols > 0, f"{name}: the clock emitted no symbols")


def lucky7_taps():
    """(name, reversed float32 taps) of the lucky7 LPF2, LPF1 and DC FIRs."""
    from sdrmodem_tpu_torch.dsp.elementwise import dc_blocker_taps
    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig

    cfg = FskDemodConfig(*LUCKY7)
    taps = {"lpf2": cfg.lpf2_taps(), "lpf1": cfg.lpf1_taps(), "dc": dc_blocker_taps(cfg.dc_length)}
    return {k: np.asarray(t, np.float32)[::-1].copy() for k, t in taps.items()}


def check_fir(torch, dev):
    """B3 and the float64 FIR against their plain versions in both of the
    kernel's forms: the wide one at 128 lanes x 65536 and the narrow one at
    two lanes and one (one client's stream), with the lucky7 LPF2, LPF1
    and DC taps (the DC FIR in tap parts in the wide form) at strides 1 and
    2 and a band offset, the last windows running off the end of the input
    (rows past it read as zeros); a 12,797-tap FIR (the DC blocker at 240
    kHz / 1200 Bd, in tap parts in both forms); B8 at d = 1 and 2.  float32
    within FRONT_ATOL, the float64 FIR bit for bit."""
    from sdrmodem_tpu_torch.ops import fir as fir_ops

    x = capture_lanes(torch, dev, CHECK_BLOCK, LANES)[:, :LANES].contiguous()
    rng = np.random.default_rng(12797)
    long_rev = (rng.standard_normal(LONG_FIR_TAPS) / np.sqrt(LONG_FIR_TAPS)).astype(np.float32)
    cases = [(name, rev, lanes, stride, CHECK_BLOCK // stride)
             for name, rev in lucky7_taps().items() for lanes in (LANES, 2, 1) for stride in (1, 2)]
    cases += [("long", long_rev, lanes, 1, CHECK_BLOCK // 4) for lanes in (LANES, 2)]
    err, forms = {}, {}
    for name, rev, lanes, stride, n_out in cases:
        xs = x[:, :lanes].contiguous()
        rev_t = torch.from_numpy(rev).to(dev)
        plan = fir_ops.fir_plan(n_out, lanes, len(rev), stride)
        tag = f"{name} T={len(rev)} lanes={lanes} stride={stride}"
        y = fir_ops.conv1d_banded_tm(xs, rev_t, stride, n_out, col_offset=BAND_OFFSET)
        y_p = fir_ops.conv1d_banded_tm_plain(xs, rev_t, stride, n_out, col_offset=BAND_OFFSET)
        y64 = fir_ops.conv1d_exact_tm(xs, rev_t, stride, n_out, col_offset=BAND_OFFSET)
        y64_p = fir_ops.conv1d_exact_tm_plain(xs, rev_t, stride, n_out, col_offset=BAND_OFFSET)
        torch.cuda.synchronize()
        need(y.shape == (n_out, lanes) and torch.isfinite(y).all().item(), f"fir {tag}: output")
        need(torch.equal(y64, y64_p), f"the float64 FIR ({tag}) differs from its plain version")
        err[f"conv1d_banded_tm {tag}"] = (y - y_p).abs().max().item()
        forms[tag] = f"{'wide' if plan.wide else 'narrow'}, {len(plan.parts)} part(s)"
    for form in ("wide", "narrow"):
        need(any(f.startswith(form) and not f.endswith(" 1 part(s)") for f in forms.values()),
             f"fir: no case of the {form} form walked its taps in parts: {forms}")
    taps = lucky7_taps()["lpf2"][::-1].copy()
    for d in (1, 2):
        y = fir_ops.fir_tpu(x, taps, d)
        y_p = fir_ops.fir_tpu_plain(x, taps, d)
        torch.cuda.synchronize()
        need(y.shape == (-(-CHECK_BLOCK // d), LANES), "fir_tpu: output shape")
        err[f"fir_tpu T={len(taps)} d={d}"] = (y - y_p).abs().max().item()
    log(f"[check] fir: max |kernel - plain| {json.dumps(err)} (band offset {BAND_OFFSET}); the float64 "
        f"FIR equal to its plain version bit for bit in every case; forms {json.dumps(forms)}")
    need(max(err.values()) <= FRONT_ATOL, f"fir kernels differ from plain by {max(err.values())}")


def check_doppler_front(torch, dev):
    """The front with Doppler tables, kernel vs plain, on the raw lucky7 pass
    (three blocks, state carried): rows on lanes 0-63, none on 64-127, which
    must equal a run without Doppler bit for bit.  Then fused vs banded,
    bit for bit, with and without Doppler."""
    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline, DemodStateFull
    from sdrmodem_tpu_torch.ops.front import banded_front, fused_front, fused_front_plain

    pipe = DemodPipeline(FskDemodConfig(*LUCKY7), CHECK_BLOCK, device=dev)
    taps = pipe.front_taps
    half = LANES // 2
    x_all = capture_lanes(torch, dev, 3 * CHECK_BLOCK, LANES, "lucky7.cf32")
    dops = lane_dopplers(range(half))
    st_k = st_p = st_0 = pipe.init_full_state(LANES)
    free = list(range(half, LANES))
    free_iq = free + [LANES + k for k in free]
    err = dict(y3=0.0, mixed_tail=0.0, quad_prev=0.0, lpf2=0.0, dc=0.0)
    for blk in range(3):
        x = x_all[blk * CHECK_BLOCK : (blk + 1) * CHECK_BLOCK]
        dop = doppler_tables(dops, CHECK_BLOCK, LANES, dev)
        y3_k, f_k = fused_front(x, *st_k[:4], taps, dop)
        y3_p, f_p = fused_front_plain(x, *st_p[:4], taps, dop)
        y3_0, f_0 = fused_front(x, *st_0[:4], taps)
        y3_b, f_b = banded_front(x, *st_k[:4], taps, dop)
        y3_b0, f_b0 = banded_front(x, *st_0[:4], taps)
        torch.cuda.synchronize()
        for key, a, b in (("y3", y3_k, y3_p), ("mixed_tail", f_k[0], f_p[0]),
                          ("quad_prev", f_k[1], f_p[1]), ("lpf2", f_k[2], f_p[2]), ("dc", f_k[3], f_p[3])):
            err[key] = max(err[key], (a - b).abs().max().item())
        need(not torch.equal(y3_k[:, :half], y3_0[:, :half]), "the Doppler rows changed nothing")
        need(torch.equal(y3_k[:, free], y3_0[:, free])
             and torch.equal(f_k[0][:, free_iq], f_0[0][:, free_iq])
             and torch.equal(f_k[1][:, free_iq], f_0[1][:, free_iq])
             and torch.equal(f_k[2][:, free], f_0[2][:, free])
             and torch.equal(f_k[3][:, free], f_0[3][:, free]),
             f"block {blk}: row-free lanes differ from the run without Doppler")
        need(torch.equal(y3_b, y3_k) and all(torch.equal(a, b) for a, b in zip(f_b, f_k)),
             f"block {blk}: banded front differs from fused with Doppler")
        need(torch.equal(y3_b0, y3_0) and all(torch.equal(a, b) for a, b in zip(f_b0, f_0)),
             f"block {blk}: banded front differs from fused without Doppler")
        st_k = DemodStateFull(*f_k, st_k.clock)
        st_p = DemodStateFull(*f_p, st_p.clock)
        st_0 = DemodStateFull(*f_0, st_0.clock)
    log(f"[check] doppler front: max |kernel - plain| {json.dumps(err)}; row-free lanes equal "
        "the run without Doppler; fused == banded with and without Doppler, bit for bit")
    need(err["y3"] <= FRONT_ATOL, f"doppler front: y3 error {err['y3']}")
    need(err["mixed_tail"] <= MIXED_ATOL, f"doppler front: mixed tail error {err['mixed_tail']}")
    need(err["quad_prev"] <= 1e-6 and max(err["lpf2"], err["dc"]) <= FRONT_ATOL,
         "doppler front: tail error")


def edge_tables(torch, block, c, plan, rng, dev):
    """(S, C) Doppler tables whose rows start and end on the fused front's
    tile and segment edges and one row off them, on the even lanes; lane 3
    has S rows of one sample each from row 0 (more rows meet its first
    tile than the kernel keeps); the other lanes have no rows."""
    edges = {e + k for step in (plan.tile, plan.seg_rows) for e in range(step, block, step)
             for k in (-1, 0, 1)}
    cuts = sorted({0, *(e for e in edges if 0 < e < block), block})
    s_rows = min(len(cuts) - 1, 24)
    tables = [np.zeros((s_rows, c), np.float32) for _ in range(4)]
    for lane in range(0, c, 2):
        picks = np.sort(rng.choice(len(cuts) - 1, s_rows, replace=False))
        for s, k in enumerate(picks):
            tables[0][s, lane] = cuts[k]
            tables[1][s, lane] = cuts[k + 1]
            tables[2][s, lane] = rng.uniform(-0.3, 0.3)
            tables[3][s, lane] = rng.uniform(-np.pi, np.pi)
    tables[0][:, 3] = np.arange(s_rows)
    tables[1][:, 3] = np.arange(1, s_rows + 1)
    tables[2][:, 3] = 0.1
    tables[3][:, 3] = 1.0
    return tuple(torch.from_numpy(t).to(dev) for t in tables)


def same_front(torch, got, want):
    """Whether two fronts' (y3, tails) are equal bit for bit, NaN equal to NaN."""
    return same_bits(torch, got[0], want[0]) and all(
        (a is None and b is None) or same_bits(torch, a, b) for a, b in zip(got[1], want[1]))


def check_front_banded(torch, dev):
    """The fused front (B1) against the banded front bit for bit, y3 and
    the four tails, three blocks with the state carried, without and with
    Doppler rows on the fused kernel's tile and segment edges, a NaN
    stretch across a segment edge in the second block: the four
    configurations at 128 lanes x 65536, lucky7 at 300 lanes x 65536 and x
    64 rows, and nan at 130 lanes x 1000 rows (blocks shorter than the DC
    history)."""
    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
    from sdrmodem_tpu_torch.ops import front as front_ops

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = [(name, LANES, CHECK_BLOCK) for name in FRONT_CONFIGS]
    cases += [("lucky7", 300, CHECK_BLOCK), ("lucky7", 300, 64), ("nan", 130, 1000)]
    res = {}
    for name, c, block in cases:
        pipe = DemodPipeline(FskDemodConfig(*FRONT_CONFIGS[name]), block, device=dev)
        taps = pipe.front_taps
        plan = front_ops.front_plan(block, c, taps.rev1.numel(), taps.rev2.numel(), taps.d, sms)
        rng = np.random.default_rng(block + c)
        x_all = capture_lanes(torch, dev, 3 * block, c)
        edge = plan.seg_rows if plan.segments > 1 else block // 2
        x_all[block + max(0, edge - 5) : block + edge + 5, [1, c + 1]] = float("nan")
        for with_dop in (False, True):
            st_f = st_b = pipe.init_full_state(c)
            for blk in range(3):
                x = x_all[blk * block : (blk + 1) * block]
                dop = edge_tables(torch, block, c, plan, rng, dev) if with_dop else None
                fused = front_ops.fused_front(x, *st_f[:4], taps, dop)
                banded = front_ops.banded_front(x, *st_b[:4], taps, dop)
                torch.cuda.synchronize()
                need(same_front(torch, fused, banded),
                     f"{name} {c} x {block} block {blk} (Doppler {with_dop}): fused front differs from banded")
                st_f = st_f._replace(lpf1_hist=fused[1][0], quad_prev=fused[1][1], lpf2_hist=fused[1][2],
                                     dc_hist=fused[1][3])
                st_b = st_b._replace(lpf1_hist=banded[1][0], quad_prev=banded[1][1],
                                     lpf2_hist=banded[1][2], dc_hist=banded[1][3])
        res[f"{name} {c} x {block}"] = dict(tile=plan.tile, segments=plan.segments, seg_rows=plan.seg_rows)
    log(f"[check] fused front == banded front bit for bit (y3 and the four tails, with and without "
        f"Doppler rows on the tile and segment edges, NaN across a segment edge): {json.dumps(res)}")


def tx_mod(fs, dev):
    from sdrmodem_tpu_torch.dsp.gfsk_mod import GfskModConfig, GfskModulator

    return GfskModulator(GfskModConfig.from_radio(fs, *TX_RADIO), device=dev)


def phase_gap(a, b):
    """Largest distance on the circle between wrapped phases (tensors)."""
    d = (a.double() - b.double()).abs().remainder(2 * np.pi)
    return d.minimum(2 * np.pi - d).max().item()


def check_tx(torch, dev):
    """B5 and B6 against their plain versions on the card, with a carried
    phase and history and a ragged n_valid: I/Q and the wrapped phase
    within TX_ATOL, B6's exported history exact.  Returns the largest error
    of each kernel."""
    from sdrmodem_tpu_torch.ops import tx as tx_ops

    rng = np.random.default_rng(11)
    err = {"tx_folded": 0.0, "tx": 0.0}
    log_err = {}
    for fs in TX_FS:
        mod = tx_mod(fs, dev)
        args = (mod.taps, mod.interpolation, mod.config.sensitivity)
        for nbytes in (2048, TXDATA_MAX):
            data = torch.from_numpy(rng.integers(0, 256, nbytes).astype(np.uint8)).to(dev)
            hist = torch.from_numpy(rng.choice([-1.0, 1.0], mod.k - 1).astype(np.float32)).to(dev)
            nv = nbytes * 8 - 29
            iq, ph = tx_ops.gfsk_tx_folded_iq(data, *args, 5.0, hist, n_valid=nv)
            iq_p, ph_p = tx_ops.gfsk_tx_folded_iq_plain(data, *args, 5.0, hist, n_valid=nv)
            torch.cuda.synchronize()
            need(iq.shape == (nbytes * 8 * mod.interpolation,) and torch.isfinite(
                torch.view_as_real(iq)).all().item(), f"tx_folded {nbytes} B I={mod.interpolation}: output")
            e = max((iq - iq_p).abs().max().item(), phase_gap(ph, ph_p))
            log_err[f"tx_folded {nbytes} B I={mod.interpolation}"] = e
            err["tx_folded"] = max(err["tx_folded"], e)
    # float NRZ through the JAX call's signature (i, q, phase')
    mod = tx_mod(TX_FS[0], dev)
    nrz = torch.from_numpy(rng.choice([-1.0, 1.0], 2048 * 8).astype(np.float32)).to(dev)
    hist = torch.from_numpy(rng.choice([-1.0, 1.0], mod.k - 1).astype(np.float32)).to(dev)
    args = (nrz, mod.taps, mod.interpolation, mod.config.sensitivity, 2.0, hist)
    got = tx_ops.gfsk_tx_call_folded(*args, n_valid=2048 * 8 - 5)
    ref = tx_ops.gfsk_tx_call_folded_plain(*args, n_valid=2048 * 8 - 5)
    torch.cuda.synchronize()
    e = max((got[0] - ref[0]).abs().max().item(), (got[1] - ref[1]).abs().max().item(),
            phase_gap(got[2], ref[2]))
    log_err[f"tx_folded float NRZ 2048 B I={mod.interpolation}"] = e
    err["tx_folded"] = max(err["tx_folded"], e)
    mod = tx_mod(TX_FS[0], dev)
    args = (mod.taps, mod.interpolation, mod.config.sensitivity)
    for c in (5, LANES):
        nrz = torch.from_numpy(rng.choice([-1.0, 1.0], (2048 * 8, c)).astype(np.float32)).to(dev)
        hist = torch.from_numpy(rng.choice([-1.0, 1.0], (mod.k - 1, c)).astype(np.float32)).to(dev)
        ph0 = torch.from_numpy(rng.uniform(0, 2 * np.pi, c)).to(dev)
        nv = 2048 * 8 - 13
        got = tx_ops.gfsk_tx_call(nrz, *args, ph0, hist, n_valid=nv)
        ref = tx_ops.gfsk_tx_call_plain(nrz, *args, ph0, hist, n_valid=nv)
        torch.cuda.synchronize()
        need(torch.equal(got[3], ref[3]), f"tx {c} streams: exported history differs from plain")
        e = max((got[0] - ref[0]).abs().max().item(), (got[1] - ref[1]).abs().max().item(),
                phase_gap(got[2], ref[2]))
        log_err[f"tx {c} x 2048 B I={mod.interpolation}"] = e
        err["tx"] = max(err["tx"], e)
    for name, e in check_tx_edges(torch, dev, rng).items():
        log_err[name] = e
        key = "tx" if name.startswith("tx ") else "tx_folded"
        err[key] = max(err[key], e)
    log(f"[check] tx: max |kernel - plain| on I/Q and the phase {json.dumps(log_err)}; "
        "B6's history exact; two identical calls the same bits")
    need(max(err.values()) <= TX_ATOL, f"tx kernels differ from plain by {max(err.values())}")
    return err


def tx_history(torch, rng, kind, shape, dev):
    """A carried history: +-1, zeros (a stream's first call) or other floats."""
    if kind == "zero":
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    vals = rng.choice([-1.0, 1.0], shape) if kind == "pm1" else rng.uniform(-1.5, 1.5, shape)
    return torch.from_numpy(vals.astype(np.float32)).to(dev)


def check_tx_edges(torch, dev, rng):
    """B5 and B6 where their tiles, runs and launches meet the data: n_valid
    at 0, on a tile edge, on a run edge and past the payload; one tile of
    rows and one either side; a zero and a non-+-1 history; 1 and 33 lanes;
    each call's launches as tx_plan gives them; then two identical calls of
    each at full width, which must give the same bits.  Returns the largest
    error of each case against the plain version."""
    from sdrmodem_tpu_torch.ops import tx as tx_ops

    out = {}
    mod = tx_mod(TX_FS[0], dev)
    args = (mod.taps, mod.interpolation, mod.config.sensitivity)
    tile = tx_ops.tx_plan(1, mod.interpolation, mod.k).tile
    for rows, nv, kind in ((8 * 4096, 0, "pm1"), (8 * 4096, 3 * tile, "pm1"), (8 * 4096, 77 * 8, "zero"),
                           (8 * 4096, 10**6, "other"), (tile, None, "zero"), (tile - 1, None, "other"),
                           (tile + 1, None, "pm1"), (9 * tile + 8, 9 * tile - 1, "other")):
        nrz = torch.from_numpy(rng.choice([-1.0, 1.0], rows).astype(np.float32)).to(dev)
        x = nrz if rows % 8 else torch.from_numpy(np.packbits(nrz.cpu().numpy() > 0)).to(dev)
        hist = tx_history(torch, rng, kind, mod.k - 1, dev)
        before = tx_ops.folded_launches
        iq, ph = tx_ops.gfsk_tx_folded_iq(x, *args, 3.0, hist, n_valid=nv)
        launched = tx_ops.folded_launches - before
        iq_p, ph_p = tx_ops.gfsk_tx_folded_iq_plain(x, *args, 3.0, hist, n_valid=nv)
        torch.cuda.synchronize()
        need(launched == tx_ops.tx_plan(rows, mod.interpolation, mod.k).launches,
             f"tx_folded {rows} rows: {launched} launches")
        need(0.0 <= ph.item() < 2 * np.pi, f"tx_folded {rows} rows: phase {ph.item()} outside [0, 2 pi)")
        out[f"tx_folded {rows} rows n_valid={nv} {kind} history"] = max(
            (iq - iq_p).abs().max().item(), phase_gap(ph, ph_p))
    for c, rows, nv, kind in ((1, 4096, 4093, "pm1"), (33, 512, 0, "zero"), (33, 8000, 384, "other")):
        nrz = torch.from_numpy(rng.choice([-1.0, 1.0], (rows, c)).astype(np.float32)).to(dev)
        hist = tx_history(torch, rng, kind, (mod.k - 1, c), dev)
        ph0 = torch.from_numpy(rng.uniform(0, 2 * np.pi, c)).to(dev)
        before = tx_ops.batched_launches
        got = tx_ops.gfsk_tx_call(nrz, *args, ph0, hist, n_valid=nv)
        launched = tx_ops.batched_launches - before
        ref = tx_ops.gfsk_tx_call_plain(nrz, *args, ph0, hist, n_valid=nv)
        torch.cuda.synchronize()
        need(launched == tx_ops.tx_plan(rows, mod.interpolation, mod.k, c).launches,
             f"tx {c} lanes: {launched} launches")
        need(torch.equal(got[3], ref[3]), f"tx {c} lanes x {rows} rows: exported history differs from plain")
        out[f"tx {c} lanes x {rows} rows n_valid={nv} {kind} history"] = max(
            (got[0] - ref[0]).abs().max().item(), (got[1] - ref[1]).abs().max().item(), phase_gap(got[2], ref[2]))
    # the same bits twice: B5 at 32 KiB, I = 60; B6 at 128 x 2048 B
    big = tx_mod(TX_FS[1], dev)
    data = torch.from_numpy(rng.integers(0, 256, TXDATA_MAX).astype(np.uint8)).to(dev)
    hist = tx_history(torch, rng, "pm1", big.k - 1, dev)
    call = lambda: tx_ops.gfsk_tx_folded_iq(data, big.taps, big.interpolation, big.config.sensitivity, 1.5, hist)
    first = [t.clone() for t in call()]
    need(all(torch.equal(a, b) for a, b in zip(first, call())), "tx_folded: two identical calls differ")
    nrz = torch.from_numpy(rng.choice([-1.0, 1.0], (2048 * 8, LANES)).astype(np.float32)).to(dev)
    hist = tx_history(torch, rng, "pm1", (mod.k - 1, LANES), dev)
    ph0 = torch.from_numpy(rng.uniform(0, 2 * np.pi, LANES)).to(dev)
    call = lambda: tx_ops.gfsk_tx_call(nrz, *args, ph0, hist)
    first = [t.clone() for t in call()]
    need(all(torch.equal(a, b) for a, b in zip(first, call())), "tx: two identical calls differ")
    return out


def check_ragged(torch, dev):
    """B4 against its plain version at 128 lanes x 65536 of the lucky7 y3,
    both layouts, with a NaN stretch, ragged n_valid and read starts; the
    float64 FIR against its plain version at the exact streamer's three
    shapes and at 256 lanes.  Bit for bit.  Returns B4's times at this size
    (its plain version is timed only here: at the main path's size it would
    take minutes)."""
    from sdrmodem_tpu_torch.dsp.clock_recovery import max_symbols
    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
    from sdrmodem_tpu_torch.ops import clock as clock_ops
    from sdrmodem_tpu_torch.ops import fir as fir_ops
    from sdrmodem_tpu_torch.ops.front import fused_front

    c = LANES
    pipe = DemodPipeline(FskDemodConfig(*LUCKY7), 2 * CHECK_BLOCK, device=dev)
    st = pipe.init_full_state(c)
    y3, _ = fused_front(capture_lanes(torch, dev, 2 * CHECK_BLOCK, c), *st[:4], pipe.front_taps)
    y3[1000:1040, 5] = float("nan")
    n = y3.shape[0]
    p = pipe.config.clock_params()
    n_valid = torch.full((c,), n, dtype=torch.int32, device=dev)
    n_valid[1::2] -= torch.arange(c // 2, dtype=torch.int32, device=dev) * 97 + 1
    args = (n_valid, torch.full((c,), p["omega"], device=dev), torch.full((c,), p["mu"], device=dev),
            torch.zeros(c, device=dev), (torch.arange(c, device=dev) % 9).to(torch.int32))
    kw = dict(omega_mid=p["omega"], omega_relative_limit=p["omega_relative_limit"],
              gain_omega=p["gain_omega"], gain_mu=p["gain_mu"],
              num_symbols=max_symbols(n, p["omega"], p["omega_relative_limit"], p["gain_mu"]))
    times = {}
    slot_rows = clock_ops.RAGGED_SLOT_ROWS
    for layout, y in (("time-major", y3), ("channel-major", y3.T.contiguous())):
        tm = layout == "time-major"
        clock_ops.clock_mm_tpu(y, *args, time_major=tm, **kw)  # warm-up
        ms, got = cuda_ms(torch, lambda: clock_ops.clock_mm_tpu(y, *args, time_major=tm, **kw), 3)
        plain_ms, want = cuda_ms(torch, lambda: clock_ops.clock_mm_tpu_plain(y, *args, time_major=tm, **kw), 1)
        need(same_ragged(torch, got, want), f"B4 ({layout}) differs from its plain version")
        err = (got[0] - want[0]).abs().max().item()
        need(got[1].min().item() > 0.9 * (n - 97 * c // 2) / p["omega"], f"B4 ({layout}): too few symbols")
        need((got[0][5, : got[1][5]] == 0).sum().item() >= 6, "B4: the NaN stretch emitted no zeros")
        # slot edges every dozen symbols: the hand-off and the read starts,
        # the NaN stretch and the ragged ends across them
        clock_ops.RAGGED_SLOT_ROWS = SMALL_SLOT_ROWS
        try:
            small_ms, small = cuda_ms(
                torch, lambda: clock_ops.clock_mm_tpu(y, *args, time_major=tm, **kw), 1)
        finally:
            clock_ops.RAGGED_SLOT_ROWS = slot_rows
        need(same_ragged(torch, small, want),
             f"B4 ({layout}) at {SMALL_SLOT_ROWS} rows a slot differs from its plain version")
        times[layout] = dict(ms=ms, plain_ms=plain_ms, symbols=int(got[1].sum().item()),
                             max_abs_err=err, small_slot_ms=small_ms)
        bnd = bound(*ragged_clock_cost(c, y3.shape[0], got[0].shape[1], times[layout]["symbols"]))
        log(f"[check] B4 {layout}: {b4_time(ms, f'{c} x {n}', got[1], bnd)}; at "
            f"{SMALL_SLOT_ROWS} rows a slot {small_ms:.4f} ms")
    log(f"[check] B4 at {c} x {n} against its plain version: equal bit for bit in both layouts, "
        f"at {slot_rows} and at {SMALL_SLOT_ROWS} rows a slot (NaN stretch, ragged n_valid, read "
        f"starts); kernel and plain ms at this size {json.dumps(times)}")
    lanes = b4_lanes(torch, y3.T.contiguous(), args[1:4], kw)

    x = capture_lanes(torch, dev, SERVER_BLOCK, 128)
    taps = lucky7_taps()
    b, n2 = SERVER_BLOCK, SERVER_BLOCK // 2 + 1
    shapes = {  # the exact streamer's LPF1 (I and Q), LPF2 and DC, and 256 lanes
        "lpf1": (x[:, [0, 128]].contiguous(), 1, b),
        "lpf2": (x[:, :1].contiguous(), 2, n2),
        "dc": (x[: n2 + 636, :1].contiguous(), 1, n2),
        "lpf1 256 lanes": (x, 1, b),
    }
    for name, (xs, stride, n_out) in shapes.items():
        rev = torch.from_numpy(taps[name.split()[0]]).to(dev)
        xw = torch.cat([xs.new_zeros((rev.numel() - 1, xs.shape[1])), xs])
        y = fir_ops.conv1d_exact_tm(xw, rev, stride, n_out)
        y_p = fir_ops.conv1d_exact_tm_plain(xw, rev, stride, n_out)
        torch.cuda.synchronize()
        need(torch.isfinite(y).all().item() and torch.equal(y, y_p),
             f"the float64 FIR ({name}) differs from its plain version")
    log(f"[check] the float64 FIR at {json.dumps({k: list(v[0].shape) for k, v in shapes.items()})}: "
        "equal to its plain version bit for bit")
    return times, lanes


def same_ragged(torch, got, want):
    """B4's results equal bit for bit: symbols, counts, final state."""
    return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and all(
        torch.equal(got[2][key], want[2][key]) for key in ("omega", "mu", "last", "ii"))


def b4_lanes(torch, y_cm, state, kw):
    """B4 alone, channel-major, on the check's 128 lanes tiled to 512 and
    1024 lanes, every lane full from 0: whether lanes past the card's
    132 SMs are free.  Each tiled lane must equal its 128-lane original
    bit for bit.  Returns {lanes: ms}."""
    from sdrmodem_tpu_torch.ops import clock as clock_ops

    c0, n = y_cm.shape
    res, base = {}, None
    for lanes in B4_LANES:
        y = y_cm.repeat(lanes // c0, 1)
        dev = y.device
        args = (torch.full((lanes,), n, dtype=torch.int32, device=dev),
                *(v.repeat(lanes // c0) for v in state),
                torch.zeros(lanes, dtype=torch.int32, device=dev))
        clock_ops.clock_mm_tpu(y, *args, **kw)  # warm-up
        ms, got = cuda_ms(torch, lambda: clock_ops.clock_mm_tpu(y, *args, **kw), 3)
        if base is None:
            base = got
        tiled = (base[0].repeat(lanes // c0, 1), base[1].repeat(lanes // c0),
                 {k: v.repeat(lanes // c0) for k, v in base[2].items()})
        need(same_ragged(torch, got, tiled), f"B4 at {lanes} lanes differs from the {c0}-lane run")
        bnd = bound(*ragged_clock_cost(lanes, n, got[0].shape[1], int(got[1].sum().item())))
        res[lanes] = ms
        log(f"[check] B4 lanes (channel-major, full lanes): {b4_time(ms, f'{lanes} x {n}', got[1], bnd)}")
        del y, got
    return res


def same_bits(torch, a, b):
    """Whether two tensors are equal bit for bit, NaN equal to NaN."""
    if a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def check_b2_slots(torch, dev):
    """B2 against its plain version bit for bit (symbols, counts, final
    state; NaN equal to NaN) where its walk meets each edge of its chunks
    and slots: the check's lucky7 y3, 128 lanes x 32768 rows in chunks of
    B2_EDGE_CHUNK, lane 2 scaled by 1e4 (strides run back past a chunk's
    first row), lane 3 by 1e5 and lane 4 entering 1500 rows in (reads jump
    past whole chunks), NaN and inf across chunk and slot edges on lanes
    5-7; the same with K = 20 (the slots fill and the hand-off clips resid
    to sfx - 1), a block of 5 chunks and 100 rows, one of 100 rows, and 300
    lanes at their own chunk (680 rows).  Each at B2's own slot size and
    at one chunk a slot."""
    import os

    from sdrmodem_tpu_torch.dsp.clock_recovery import chunk_plan
    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
    from sdrmodem_tpu_torch.ops import clock as clock_ops
    from sdrmodem_tpu_torch.ops.front import fused_front

    c = LANES
    pipe = DemodPipeline(FskDemodConfig(*LUCKY7), CHECK_BLOCK, device=dev)
    p = pipe.config.clock_params()
    st = pipe.init_full_state(c)
    y3, _ = fused_front(capture_lanes(torch, dev, CHECK_BLOCK, c), *st[:4], pipe.front_taps)
    y3[:, 2] *= 1e4
    y3[:, 3] *= 1e5
    y3[250:262, 5] = float("nan")
    y3[511, 6] = float("inf")
    y3[760:775, 7] = float("-inf")
    y3[1020:1030, 5] = float("nan")
    ck = st.clock
    resid = ck.resid.clone()
    resid[4] = -1500
    state = (ck.suffix, ck.omega, ck.mu, ck.last_sample, resid)
    r = -(-300 // c)
    wide = (y3.repeat(1, r)[:, :300].contiguous(), ck.suffix.repeat(1, r)[:, :300].contiguous(),
            *(v.repeat(r)[:300].contiguous() for v in state[1:]))
    cases = [(f"{c} x {y3.shape[0]}", y3, state, B2_EDGE_CHUNK, None),
             ("K = 20", y3, state, B2_EDGE_CHUNK, 20),
             ("5 chunks and 100 rows", y3[: 5 * B2_EDGE_CHUNK + 100], state, B2_EDGE_CHUNK, None),
             ("100 rows", y3[:100], state, B2_EDGE_CHUNK, None),
             ("300 lanes", wide[0], wide[1:], None, None)]
    slot_rows, env = clock_ops.CLOCK_SLOT_ROWS, os.environ.get("SDRM_CLOCK_CHUNK")
    res = {}
    try:
        for name, y, args, chunk, k in cases:
            if chunk is None:
                os.environ.pop("SDRM_CLOCK_CHUNK", None)
            else:
                os.environ["SDRM_CLOCK_CHUNK"] = str(chunk)
            plan = chunk_plan(*y.shape, ck.suffix.shape[0], **p, num_symbols=k)
            want = clock_ops.clock_mm_chunked_plain(y, *args, pipe.bank, **plan)
            for rows in (slot_rows, plan["chunk"]):
                clock_ops.CLOCK_SLOT_ROWS = rows
                got = clock_ops.clock_mm_chunked(y, *args, pipe.bank, **plan)
                torch.cuda.synchronize()
                need(all(same_bits(torch, a, b) for a, b in [*zip(got[:2], want[:2]), *zip(got[2], want[2])]),
                     f"B2 ({name}, {rows} rows a slot) differs from its plain version")
            res[name] = dict(chunk=plan["chunk"], k=plan["num_symbols"], symbols=int(want[1].sum().item()),
                             full_chunks=int((want[1] == plan["num_symbols"]).sum().item()))
    finally:
        clock_ops.CLOCK_SLOT_ROWS = slot_rows
        if env is None:
            os.environ.pop("SDRM_CLOCK_CHUNK", None)
        else:
            os.environ["SDRM_CLOCK_CHUNK"] = env
    log(f"[check] B2 at its slot edges, equal to its plain version bit for bit at {slot_rows} rows a "
        f"slot and at one chunk a slot: {json.dumps(res)}")


# atan2f's maximum ulp error (CUDA C++ Programming Guide, single-precision
# mathematical functions)
ATAN2F_ULP = 3


def atan2_tolerance(gain):
    """The quad kernel's atan2 form against its plain version (torch.atan2
    on the card): each within ATAN2F_ULP ulps of an angle |a| <= pi (an ulp
    of pi is 2^-22), times the gain, and the product's rounding."""
    return gain * 2 * ATAN2F_ULP * 2.0**-22 + float(np.spacing(np.float32(gain * np.pi)))


def check_quad_atan2(torch, dev):
    """The quad-demod kernel's atan2 form (the banded front's stage in the
    "atan2" modes) against its plain version on the card: the lucky7
    capture at 128 x 65536, and the nan fixture tiled over 128 lanes (NaN,
    ~1e38 and denormal samples, products that round to (0, 0) -> 0), within
    ``atan2_tolerance``, NaN where the plain version has NaN; the LUT form
    bit for bit."""
    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
    from sdrmodem_tpu_torch.ops import front as front_ops

    res = {}
    for name, fin, rows, cfg in (("lucky7", "lucky7.expected.cf32", CHECK_BLOCK, LUCKY7),
                                 ("nan", "inputnan.cf32", 4096, FRONT_CONFIGS["nan"])):
        taps = DemodPipeline(FskDemodConfig(*cfg), rows, device=dev).front_taps
        y = capture_lanes(torch, dev, rows + 1, LANES, fin)
        prev, y1 = y[:1].contiguous(), y[1:].contiguous()
        atan = taps._replace(atan_lut=False)
        got = front_ops.quad_demod(y1, prev, atan)
        want = front_ops.quad_demod_plain(y1, prev, atan)
        torch.cuda.synchronize()
        nan = torch.isnan(want)
        need(torch.equal(torch.isnan(got), nan), f"quad atan2 {name}: NaN where the plain version has none")
        err = (got[~nan] - want[~nan]).abs().max().item()
        tol = atan2_tolerance(taps.quad_gain)
        res[name] = dict(max_abs_err=err, tol=tol, nan=int(nan.sum().item()), zeros_out=int((got == 0).sum().item()),
                         lut_equal=same_bits(torch, front_ops.quad_demod(y1, prev, taps),
                                             front_ops.quad_demod_plain(y1, prev, taps)))
        need(err <= tol, f"quad atan2 {name}: |kernel - plain| {err} > {tol}")
        need(res[name]["lut_equal"], f"quad LUT {name}: kernel differs from its plain version")
    log(f"[check] quad demod, atan2 form vs plain (tolerance gain * 2 * {ATAN2F_ULP} ulp of pi + an ulp of the "
        f"result), LUT form bit for bit: {json.dumps(res)}")
    return max(r["max_abs_err"] for r in res.values())


def phase_check(torch, dev):
    err_quad = check_quad_atan2(torch, dev)
    check_front_and_clock(torch, dev)
    check_b2_slots(torch, dev)
    check_fir(torch, dev)
    check_doppler_front(torch, dev)
    check_front_banded(torch, dev)
    err = check_tx(torch, dev)
    err["ragged"], err["b4_lanes"] = check_ragged(torch, dev)
    err["quad_atan2"] = err_quad
    return err


def phase_golden(torch, dev):
    from sdrmodem_tpu_torch.dsp.doppler import Doppler
    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
    from sdrmodem_tpu_torch.utils.parity import GOLDEN_CASES, demod_capture, golden_report

    for name, cfg, fin, fexp, block in GOLDEN_CASES:
        iq = np.fromfile(FIXTURES / fin, np.complex64)
        golden = np.fromfile(FIXTURES / fexp, np.int8)
        got = {front: demod_capture(DemodPipeline(cfg, block, device=dev), iq, front=front)
               for front in ("fused", "step")}
        for front, sym in got.items():
            rep = golden_report(sym, golden)
            log(f"[golden] {name} front={front}: {json.dumps(rep)}")
            need(rep["symbols"] >= 0.99 * len(golden), f"{name} front={front}: too few symbols")
            need(rep["hard_decision_agreement"] == 1.0, f"{name} front={front}: hard decisions differ")
            need(rep["max_lsb"] <= 2, f"{name} front={front}: {rep['max_lsb']} LSB from the golden")
        need(np.array_equal(got["fused"], got["step"]), f"{name}: front=step differs from fused")
    golden_atan2(torch, dev)

    # the raw pass through the server's call, rows every 2000 samples (the
    # buffer the goldens were recorded with)
    iq = np.fromfile(FIXTURES / "lucky7.cf32", np.complex64)
    golden = np.fromfile(FIXTURES / "lucky7.expected.s8", np.int8)
    block = 8000
    pipe = DemodPipeline(FskDemodConfig(*LUCKY7), block, device=dev)
    step = pipe.make_batched_step_full("pallas", doppler=True, layout="fanout")
    state = pipe.init_full_state(1)
    dops = {0: Doppler(**DOPPLER, start_time_seconds=PASS_START)}
    out = []
    for i in range(0, len(iq), block):
        dop = doppler_tables(dops, block, 1, dev, max_batch=2000)
        blk = iq[i : i + block]
        x = torch.from_numpy(np.stack([blk.real, blk.imag]).astype(np.float32)).to(dev)
        state, sym, cnt = step(state, x, dop)
        sym, cnt = sym[0].cpu().numpy(), cnt[0].cpu().numpy()
        out += [sym[k, :n] for k, n in enumerate(cnt)]
    got = np.concatenate(out)
    rep = golden_report(got, golden)
    m = min(len(got), len(golden))
    within = float((np.abs(got[:m].astype(np.int32) - golden[:m].astype(np.int32)) <= 2).mean())
    rep["within_2_lsb"] = within
    log(f"[golden] lucky7 raw pass, server's Doppler step (fanout): {json.dumps(rep)}")
    need(rep["symbols"] >= 0.99 * len(golden), "doppler golden: too few symbols")
    need(within >= 0.995, f"doppler golden: only {within} within ±2 LSB")
    golden_ragged(torch, dev)
    golden_tx(torch, dev)


def golden_atan2(torch, dev):
    """The four fixtures through make_batched_step_full(layout="tm") with
    use_atan_lut="atan2": the banded route on every front (the quad kernel's
    atan2f form), "fused" and "step" giving the banded bytes with B1 and B7
    never launched; each fixture within +-2 LSB with hard decisions 1.0, but
    lucky7_nodc's symbols 6319-6389, whose lock turns on the last ulp of y3
    (utils/parity.py:atan2_golden_failures)."""
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
    from sdrmodem_tpu_torch.ops import front as front_ops
    from sdrmodem_tpu_torch.ops import step as step_ops
    from sdrmodem_tpu_torch.utils.parity import GOLDEN_CASES, atan2_golden_failures, demod_capture, golden_report

    for name, cfg, fin, fexp, block in GOLDEN_CASES:
        iq = np.fromfile(FIXTURES / fin, np.complex64)
        golden = np.fromfile(FIXTURES / fexp, np.int8)
        pipe = DemodPipeline(cfg, block, use_atan_lut="atan2", device=dev)
        b1, b7, fronts = front_ops.fused_launches, step_ops.launches, front_ops.launches
        got = {front: demod_capture(pipe, iq, front=front) for front in ("banded", "fused", "step")}
        torch.cuda.synchronize()
        need(front_ops.fused_launches == b1 and step_ops.launches == b7,
             f"{name} atan2: B1 or B7 launched ({front_ops.fused_launches - b1}, {step_ops.launches - b7})")
        need(front_ops.launches > fronts, f"{name} atan2: the quad kernel was never launched")
        rep = golden_report(got["banded"], golden)
        log(f"[golden] {name} use_atan_lut=atan2 (banded route): {json.dumps(rep)}")
        fails = atan2_golden_failures(name, rep)
        need(not fails, f"atan2 goldens: {fails}")
        for front in ("fused", "step"):
            need(np.array_equal(got[front], got["banded"]), f"{name} atan2: front={front} differs from banded")


def exact_stage_gap(torch, dev, cfg, iq):
    """Where the exact streamer's first block parts between the card and
    the CPU: y3 of the front, then the clock fed the CPU's y3."""
    from sdrmodem_tpu_torch.dsp.clock_recovery import clock_mm_stream
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline

    buf = np.zeros((2, SERVER_BLOCK), np.float32)
    blk = iq[:SERVER_BLOCK]
    buf[0, : len(blk)], buf[1, : len(blk)] = blk.real, blk.imag
    res = {}
    for d in (dev, torch.device("cpu")):
        pipe = DemodPipeline(cfg, SERVER_BLOCK, exact=True, device=d)
        st = pipe.init_state()
        nv = torch.tensor(len(blk), dtype=torch.int32, device=d)
        _, y3, n3 = pipe._front_impl(st, torch.from_numpy(buf).to(d), nv)
        res[d.type] = (st, y3.cpu(), n3.cpu(), pipe)
    (st_k, y3_k, n3_k, pk), (st_c, y3_c, n3_c, pc) = res["cuda"], res["cpu"]
    kw = pc._clock_kw()
    o_k, c_k, _ = clock_mm_stream(y3_c.to(dev), state=st_k.clock, n_valid=n3_c.to(dev), **kw)
    o_c, c_c, _ = clock_mm_stream(y3_c, state=st_c.clock, n_valid=n3_c, **kw)
    return dict(y3_max_gap=(y3_k - y3_c).abs().max().item(), n3_equal=bool(torch.equal(n3_k, n3_c)),
                clock_on_cpu_y3_equal=bool(torch.equal(o_k.cpu(), o_c) and int(c_k) == int(c_c)))


def golden_ragged(torch, dev):
    """The four fixtures through the server's per-client RX on the card at
    its default block (the exact streamer, FskDemodulator, the float32
    streamer); the exact streamer's bytes must equal the same on the CPU."""
    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodulator
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
    from sdrmodem_tpu_torch.utils.parity import GOLDEN_CASES, golden_report

    for name, cfg, fin, fexp, _ in GOLDEN_CASES:
        iq = np.fromfile(FIXTURES / fin, np.complex64)
        golden = np.fromfile(FIXTURES / fexp, np.int8)
        sym, cnt, _ = FskDemodulator(cfg, device=dev).process(iq)
        routes = {
            "exact streamer": DemodPipeline(cfg, SERVER_BLOCK, exact=True, device=dev).streamer().process(iq),
            "FskDemodulator": sym[: int(cnt)].cpu().numpy(),
            "float32 streamer": DemodPipeline(cfg, SERVER_BLOCK, device=dev).streamer().process(iq),
        }
        reps = {}
        for route, got in routes.items():
            rep = golden_report(got, golden)
            reps[route] = {k: rep[k] for k in ("symbols", "max_lsb", "hard_decision_agreement")}
            need(rep["symbols"] >= 0.99 * len(golden), f"{name} {route}: too few symbols")
            need(rep["hard_decision_agreement"] == 1.0, f"{name} {route}: hard decisions differ")
            need(rep["max_lsb"] <= 2, f"{name} {route}: {rep['max_lsb']} LSB from the golden")
        host = DemodPipeline(cfg, SERVER_BLOCK, exact=True, device="cpu").streamer().process(iq)
        same = bool(np.array_equal(routes["exact streamer"], host))
        log(f"[golden] {name} at block {SERVER_BLOCK} on the card: {json.dumps(reps)}; "
            f"exact streamer card == CPU: {same}")
        if not same:
            log(f"[golden] FINDING {name}: the exact streamer parts between card and CPU: "
                f"{json.dumps(exact_stage_gap(torch, dev, cfg, iq))}")
        need(same, f"{name}: the exact streamer's bytes on the card differ from the CPU's")


def loopback_agreement(payload, soft):
    """Hard-decision agreement of RX symbols with the sent bits at the best
    offset (tests/test_golden_demod.py:91-110)."""
    bits = np.unpackbits(payload).astype(np.int8) * 2 - 1
    hard = np.sign(soft).astype(np.int8)
    best = 0.0
    for off in range(80):
        n = min(len(hard) - off, len(bits))
        best = max(best, float((hard[off : off + n] == bits[:n]).mean()))
    return best


def golden_tx(torch, dev):
    """The reference's 320-sample TX golden through B5 and B6's route and
    the streaming modulator; the card's TX into the card's RX; a 32 KiB
    TxData at I = 60 against the float64 chain."""
    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
    from sdrmodem_tpu_torch.dsp.gfsk_mod import GfskModConfig
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
    from sdrmodem_tpu_torch.dsp.streaming import StreamingGfskMod
    from sdrmodem_tpu_torch.utils.parity import demod_capture

    vals = np.load(FIXTURES / "gfsk_mod_expected320.npy")
    want = vals[0::2] + 1j * vals[1::2]
    mod = tx_mod(TX_FS[0], dev)
    ten = np.arange(10, dtype=np.uint8)
    i, q, _ = mod.process_pair_kernel(ten)
    ib, qb, _ = mod.process_pair_kernel(np.stack([ten, ten]))
    got = {
        "B5 (process_pair_kernel)": i.cpu().numpy() + 1j * q.cpu().numpy(),
        "B6 (two streams)": ib.cpu().numpy() + 1j * qb.cpu().numpy(),
        "StreamingGfskMod": StreamingGfskMod(mod.config, device=dev).process(ten),
    }
    err = {k: float(np.abs(v - want).max()) for k, v in got.items()}
    log(f"[golden] TX 320 samples, max |I/Q - golden| {json.dumps(err)} (tolerance 0.01)")
    need(max(err.values()) < 0.01, "TX golden: beyond 0.01")

    fs, baud, deviation = 48000, 9600, 5000
    payload = np.frombuffer(b"fused tx kernel loopback \x00\xff!!" * 8, dtype=np.uint8)
    m = StreamingGfskMod(GfskModConfig.from_radio(fs, baud, deviation), device=dev)
    iq = np.concatenate([m.process(payload[:100]), m.process(payload[100:])])
    pipe = DemodPipeline(FskDemodConfig(fs, baud, deviation, 1, 2000, False), 4096, device=dev)
    agree = loopback_agreement(payload, demod_capture(pipe, iq))
    log(f"[golden] TX -> RX loopback on the card ({fs}/{baud}/{deviation}): hard decisions "
        f"agree {agree:.6f} at the best offset")
    need(agree >= 0.999, f"loopback agreement {agree}")

    mod = tx_mod(TX_FS[1], dev)
    data = np.random.default_rng(13).integers(0, 256, TXDATA_MAX).astype(np.uint8)
    i, q, ph = mod.process_pair_kernel(data)
    wi, wq, wph = mod.process_pair(data, exact=True)
    e = max((i - wi).abs().max().item(), (q - wq).abs().max().item(), phase_gap(ph, wph))
    log(f"[golden] TX 32 KiB at I = {mod.interpolation} ({i.numel()} samples): max |B5 - float64 "
        f"chain| {e:.3e} on I/Q and the phase")
    need(e <= TX_ATOL, f"TX at I = 60: {e} off the float64 chain")


def front_cost(c, b, taps, d, dop=None):
    """(bytes, flops) the front end must move and do at this shape: input
    block, histories, taps and Doppler tables read once, y3 and the new
    tails written once; two flops a tap of LPF1 and LPF2, ~16 a quad-demod
    output (6 for the conjugate product, ~10 for the table arctangent and
    gain) and 13 a DC blocker output.  The DC blocker is four length-L
    moving averages and a delay line (dsp/elementwise.py:dc_blocker_taps),
    which running sums take at an add, a subtract and a scale each, and one
    subtract: the kernel's (4L-3)-tap FIR form of it is work beyond this
    bound.  With Doppler, the tables are read once and the NCO's flops are
    those of ``nco_cost``."""
    t1, t2 = taps.rev1.numel(), taps.rev2.numel()
    t3 = taps.rev_dc.numel() if taps.rev_dc is not None else 0
    n2 = b // d
    hist_words = (t1 - 1) * 2 * c + 2 * c + (t2 - 1) * c + max(t3 - 1, 0) * c
    words = b * 2 * c + n2 * c + 2 * hist_words + t1 + t2 + t3 + 257
    flops = 2 * (b * 2 * c * t1 + n2 * c * t2) + 16 * b * c + (13 * n2 * c if t3 else 0)
    if dop is not None:
        words += 4 * dop[0].numel()
        flops += nco_cost(b, c, dop)[1]
    return 4 * words, flops


def front_fir_cost(c, b, taps, d, dop=None):
    """(bytes, flops) of the work this design does: ``front_cost`` with
    the DC blocker taken as its (4L-3)-tap FIR (two flops a tap, not 13 an
    output) and y2 written and read once between the two launches."""
    nbytes, flops = front_cost(c, b, taps, d, dop)
    if taps.rev_dc is None:
        return nbytes, flops
    n2 = b // d
    return nbytes + 2 * 4 * n2 * c, flops - 13 * n2 * c + 2 * n2 * c * taps.rev_dc.numel()


def nco_cost(rows, c, dop):
    """(bytes, flops) of the Doppler stage alone: the (rows, 2C) block read
    and written once and the four tables read once.  Each lane-sample that
    a table row covers takes that one row's ramp (~10 flops: the row offset
    and the two-level ramp), ~40 for the sincos and 6 for the rotation; a
    sample no row covers passes through.  The rows are disjoint
    (Doppler.device_segments), so the kernel's compare-and-select over every
    row at every sample (the TPU kernel's gather-free form) is work beyond
    this bound."""
    starts, ends = dop[0], dop[1]
    covered = (ends.clamp(max=rows) - starts.clamp(min=0)).clamp(min=0).double().sum().item()
    return 4 * (2 * rows * 2 * c + 4 * starts.numel()), 56 * covered


def fir_cost(rows, lanes, n_out, t):
    """(bytes, flops): the input and taps read once, the output written
    once; a multiply-add a tap an output."""
    return 4 * (rows * lanes + n_out * lanes + t), 2 * n_out * lanes * t


def clock_cost(n, c, sfx, n_chunks, k, symbols):
    """(bytes, flops): y3, suffix, state and bank read once, symbol slots,
    counts and state written once; ~30 flops a symbol this run emitted (8
    products and 7 sums of the interpolator, ~15 for the loop update)."""
    words = n * c + sfx * c + 4 * c + 129 * 8 + n_chunks * k * c + n_chunks * c + 4 * c
    return 4 * words, 30 * symbols


def step_cost(c, b, taps, d, dop, sfx, n_chunks, k, symbols):
    """(bytes, flops) of the fused step: the front's (``front_cost``) less
    y3, which stays on the chip, plus the clock's state in and out, the
    bank, and the symbol slots and counts written once; ~30 flops a symbol
    this run emitted."""
    front_bytes, front_flops = front_cost(c, b, taps, d, dop)
    words = front_bytes // 4 - (b // d) * c
    words += 2 * sfx * c + 8 * c + 129 * 8 + n_chunks * k * c + n_chunks * c
    return 4 * words, front_flops + 30 * symbols


def bound(nbytes, flops, flop_rate=F32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def drive(torch, step, state, inputs):
    """One warm-up step on inputs[0], then the rest timed as one CUDA-event
    window.  Returns (ms a timed step, first outputs, every timed output,
    the final state)."""
    state, sym, cnt = step(state, *inputs[0])
    first = (sym, cnt)
    torch.cuda.synchronize()

    def run(state=state):
        outs = []
        for args in inputs[1:]:
            state, sym, cnt = step(state, *args)
            outs.append((sym, cnt))
        return outs, state

    ms, (outs, state) = cuda_ms(torch, run, 1)
    return ms / (len(inputs) - 1), first, outs, state


def same_stream(torch, a, b):
    """Whether two steps' (symbols (C, n_chunks, K), counts (C, n_chunks))
    give every lane the same symbols, whatever their chunk partitions."""
    (sa, ca), (sb, cb) = a, b
    if not torch.equal(ca.sum(1), cb.sum(1)):
        return False
    flat = [s[torch.arange(s.shape[2], device=s.device)[None, None, :] < c[:, :, None]]
            for s, c in ((sa, ca), (sb, cb))]
    return torch.equal(*flat)


def same_state(torch, a, b):
    """Whether two DemodStateFull are equal, field by field, bit for bit."""
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip((*a[:4], *a.clock), (*b[:4], *b.clock)))


def hold_step(torch, what, got, pair):
    """Gate front="step" against front="fused" with B2 on the same inputs:
    every step's symbol stream and counts, and the final state, bit for
    bit.  ``got`` and ``pair`` are drive()'s (first, outs, state)."""
    (f1, o1, s1), (f2, o2, s2) = got, pair
    steps = [f1, *o1]
    need(len(steps) == len(o2) + 1, f"{what}: step counts differ")
    for k, (a, b) in enumerate(zip(steps, [f2, *o2])):
        need(same_stream(torch, a, b), f"{what}: step {k}'s symbols differ from the fused pair's")
    need(same_state(torch, s1, s2), f"{what}: the final state differs from the fused pair's")
    symbols = sum(int(c.sum().item()) for _, c in steps)
    log(f"[main] {what}: equal to front=\"fused\" with B2 bit for bit over {len(steps)} steps "
        f"({symbols} symbols) and the final state")


def hold_front(what, got, plain, doppler):
    """Gate a front's (y3, tails) against its plain version's: y3 and the
    FIR tails within FRONT_ATOL; lpf1_hist and quad_prev bit for bit without
    Doppler, and within the NCO's ulps (the mixed tail) with it.  Returns
    y3's error."""
    (y3, f), (y3_p, f_p) = got, plain
    err = dict(y3=(y3 - y3_p).abs().max().item())
    for key, a, b in zip(("lpf1", "quad_prev", "lpf2", "dc"), f, f_p):
        if b is not None and b.numel():
            err[key] = (a - b).abs().max().item()
    log(f"[main] {what}: max |kernel - plain| {json.dumps(err)}")
    need(err["y3"] <= FRONT_ATOL, f"{what}: y3 error {err['y3']} > {FRONT_ATOL}")
    need(err["lpf1"] <= (MIXED_ATOL if doppler else 0.0), f"{what}: lpf1_hist error {err['lpf1']}")
    need(err["quad_prev"] <= (1e-6 if doppler else 0.0), f"{what}: quad_prev error {err['quad_prev']}")
    need(max(err["lpf2"], err.get("dc", 0.0)) <= FRONT_ATOL, f"{what}: FIR tail error")
    return err["y3"]


def check_outputs(torch, what, sym, cnt, c, n_chunks, per_chunk):
    need(sym.dtype == torch.int8 and cnt.shape == (c, n_chunks), f"{what}: output shape")
    lo, hi = cnt.min().item(), cnt.max().item()
    need(0.9 * per_chunk <= lo and hi <= 1.1 * per_chunk + 2, f"{what}: counts {lo}..{hi}")
    need(sym.abs().max().item() > 64, f"{what}: symbols look empty")


def server_breakdown(torch, pipe, x, dop, step_ms):
    """Where the server-shape step's time goes: the fanout staging, the
    NCO stage, the fused front (NCO included) and the clock, each timed
    alone on the step's own inputs (not counted as main-path launches)."""
    from sdrmodem_tpu_torch.dsp.clock_recovery import clock_mm_batched_full
    from sdrmodem_tpu_torch.ops import front as front_ops

    c = LANES
    state = pipe.init_full_state(c)
    x_tm = pipe.to_time_major(x, c, "fanout")
    front_args = (x_tm, *state[:4], pipe.front_taps, dop)
    front_ops.fused_front(*front_args)  # warm-up
    parts = {
        "fanout staging": cuda_ms(torch, lambda: pipe.to_time_major(x, c, "fanout"), 5)[0],
        "nco stage": cuda_ms(torch, lambda: front_ops.nco_mix(x_tm, dop), 5)[0],
        "front with nco": cuda_ms(torch, lambda: front_ops.fused_front(*front_args), 5)[0],
    }
    y3, _ = front_ops.fused_front(*front_args)
    p = pipe.config.clock_params()
    parts["clock"] = cuda_ms(
        torch, lambda: clock_mm_batched_full(y3, state.clock, bank=pipe.bank, **p), 3
    )[0]
    rest = step_ms - parts["fanout staging"] - parts["front with nco"] - parts["clock"]
    shares = {k: f"{v:.4f} ms ({100 * v / step_ms:.1f}%)" for k, v in parts.items()}
    log(f"[main] (b) server step {step_ms:.4f} ms, parts timed alone: {json.dumps(shares)}; "
        f"the rest (tails, int8, host) {rest:.4f} ms by subtraction")


def tx_calls():
    """Path (d)'s TxData in order: (sampling rate, bytes, through Doppler)."""
    return ([(TX_FS[0], 2048, False)] * 100 + [(TX_FS[0], TXDATA_MAX, True)] * 8
            + [(TX_FS[1], TXDATA_MAX, True)] * 2)


def tx_session(fs, dev):
    """A TX client's state as TxSession keeps it: the streaming modulator
    and the Doppler corrector of the lucky7 pass at this sampling rate."""
    from sdrmodem_tpu_torch.dsp.doppler import Doppler
    from sdrmodem_tpu_torch.dsp.gfsk_mod import GfskModConfig
    from sdrmodem_tpu_torch.dsp.streaming import StreamingGfskMod

    mod = StreamingGfskMod(GfskModConfig.from_radio(fs, *TX_RADIO), device=dev)
    return mod, Doppler(**{**DOPPLER, "sampling_freq": fs}, start_time_seconds=PASS_START)


def stats(xs):
    """(median, p90) of a list of seconds, in ms."""
    return float(np.median(xs) * 1e3), float(np.percentile(xs, 90) * 1e3)


def path_tx_server(torch, dev):
    """(d) the server's TX chain: every TxData through StreamingGfskMod.process
    (B5), the 32 KiB ones then through Doppler.process_tx, as
    TxSession.handle_tx_data runs them.  Counted: each call launches B5's
    kernels as tx_plan gives them (two a call at these sizes) and never
    runs the plain version.  Then the same calls
    again, split into their steps (not counted)."""
    from sdrmodem_tpu_torch.ops import tx as tx_ops

    calls = tx_calls()
    rng = np.random.default_rng(12)
    payloads = [rng.integers(0, 256, nb).astype(np.uint8) for _, nb, _ in calls]
    for fs in TX_FS:  # load the library and warm each configuration up
        tx_session(fs, dev)[0].process(payloads[0])
    groups = {(fs, nb): f"{nb} B at I = {int(fs // TX_RADIO[0])}" for fs, nb, _ in calls}

    def run():
        sessions = {fs: tx_session(fs, dev) for fs in TX_FS}
        walls = {g: [] for g in groups}
        dop_walls, outs = [], []
        for (fs, nb, with_dop), data in zip(calls, payloads):
            mod, dop = sessions[fs]
            t0 = time.perf_counter()
            iq = mod.process(data)
            t1 = time.perf_counter()
            walls[(fs, nb)].append(t1 - t0)
            if with_dop:
                iq = dop.process_tx(iq)
                dop_walls.append(time.perf_counter() - t1)
            need(iq.shape == (nb * 8 * mod.mod.interpolation,) and np.isfinite(iq).all()
                 and abs(np.abs(iq) - 1.0).max() < 1e-5, f"(d) TxData of {nb} B: output")
            if len(outs) < 100:
                outs.append(iq)
        return walls, dop_walls, np.concatenate(outs)

    (walls, dop_walls, stream), counts = counted(torch, "(d) TX, 100 x 2048 B + 8 + 2 x 32 KiB",
                                                  ("tx_folded",), run)
    want = sum(tx_ops.tx_plan(nb * 8, int(fs // TX_RADIO[0]), tx_mod(fs, dev).k).launches
               for fs, nb, _ in calls)
    need(counts["tx_folded"] == want, f"(d) {counts['tx_folded']} TX launches for "
         f"{len(calls)} TxData, {want} planned: a call did not run B5 as planned")
    # the 100 x 2048 B stream against the float64 chain over the whole payload
    mod = tx_mod(TX_FS[0], dev)
    wi, wq, _ = mod.process_pair(np.concatenate(payloads[:100]), exact=True)
    err = max(np.abs(stream.real - wi.cpu().numpy()).max(), np.abs(stream.imag - wq.cpu().numpy()).max())
    log(f"[main] (d) the 100 x 2048 B stream against one float64 pass: max {err:.3e}")
    need(err <= TX_ATOL, f"(d) TX stream {err} off the float64 chain")
    res = {}
    for g, name in groups.items():
        n_out = g[1] * 8 * int(g[0] // TX_RADIO[0])
        med, p90 = stats(walls[g])
        res[name] = dict(calls=len(walls[g]), median_ms=med, p90_ms=p90,
                         msamples_s=n_out * len(walls[g]) / sum(walls[g]) / 1e6)
    res["process_tx"] = dict(zip(("median_ms", "p90_ms"), stats(dop_walls)))
    log(f"[main] (d) StreamingGfskMod.process wall a TxData: {json.dumps(res)}")

    split = {name: {k: [] for k in ("prep", "upload", "launch_wall", "kernel", "download",
                                    "process_tx")} for name in groups.values()}
    sessions = {fs: tx_session(fs, dev) for fs in TX_FS}
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for (fs, nb, with_dop), data in zip(calls, payloads):
        mod, dop = sessions[fs]
        part = split[groups[(fs, nb)]]
        t0 = time.perf_counter()
        buf = mod.stage(data)
        t1 = time.perf_counter()
        dev_buf = mod.upload(buf)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        e0.record()
        launched = mod.launch(dev_buf)
        e1.record()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        iq = mod.fetch(launched, data)
        t4 = time.perf_counter()
        if with_dop:
            dop.process_tx(iq)
            part["process_tx"].append(time.perf_counter() - t4)
        for k, v in (("prep", t1 - t0), ("upload", t2 - t1), ("launch_wall", t3 - t2),
                     ("kernel", e0.elapsed_time(e1) * 1e-3), ("download", t4 - t3)):
            part[k].append(v)
    table = {name: {k: "%.4f / %.4f" % stats(v) for k, v in parts.items() if v}
             for name, parts in split.items()}
    log(f"[main] (d) a TxData split (median / p90 ms; kernel by CUDA events around the launch "
        f"call, the host's enqueue included; the rest wall, synchronised after each step): "
        f"{json.dumps(table)}")
    return res, counts


def path_tx_batched(torch, dev):
    """(e) process_pair_kernel on 128 streams x 2048 B (B6): one warm-up
    and 20 timed calls, the bytes already on the card."""
    from sdrmodem_tpu_torch.ops import tx as tx_ops

    mod = tx_mod(TX_FS[0], dev)
    data = torch.from_numpy(
        np.random.default_rng(14).integers(0, 256, (LANES, 2048)).astype(np.uint8)).to(dev)

    def run():
        mod.process_pair_kernel(data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms, out = cuda_ms(torch, lambda: mod.process_pair_kernel(data), 20)
        return ms, (time.perf_counter() - t0) / 20, out

    (ms, wall, (i, q, ph)), counts = counted(torch, "(e) TX batched 128 x 2048 B", ("tx",), run)
    want = 21 * tx_ops.tx_plan(2048 * 8, mod.interpolation, mod.k, LANES).launches
    need(counts["tx"] == want, f"(e) {counts['tx']} TX launches for 21 calls, {want} planned")
    wi, wq, wph = mod.process_pair(data, exact=True)
    err = max((i - wi).abs().max().item(), (q - wq).abs().max().item(), phase_gap(ph, wph))
    need(i.shape == (LANES, 2048 * 16) and err <= TX_ATOL, f"(e) batched TX: {err} off the float64 chain")
    rate = i.numel() / (ms * 1e-3) / 1e6
    log(f"[main] (e) process_pair_kernel 128 x 2048 B: {ms:.4f} ms a call (CUDA events), "
        f"{wall * 1e3:.4f} ms wall, {rate:.1f} Msamples/s; max {err:.3e} off the float64 chain")
    return dict(ms=ms, wall_ms=wall * 1e3, msamples_s=rate), counts


def phase_main(torch, dev):
    """The main-path runs (a) to (q), each counted on its own."""
    from sdrmodem_tpu_torch.dsp.clock_recovery import chunk_plan
    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
    from sdrmodem_tpu_torch.ops import fir as fir_ops
    from sdrmodem_tpu_torch.ops import front as front_ops

    c, b = LANES, MAIN_BLOCK
    pipe = DemodPipeline(FskDemodConfig(*LUCKY7), b, device=dev)
    p = pipe.config.clock_params()
    sfx = pipe.init_full_state(1).clock.suffix.shape[0]
    x_tm = capture_lanes(torch, dev, b, c)
    x_fan = torch.stack([x_tm[:, 0], x_tm[:, c]]).contiguous()  # lane 0's stream, shared
    torch.cuda.synchronize()
    totals = {name: 0 for name in counters()}
    results = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] += v

    # ---- (a) the bench.py shape
    for layout, x in {"tm": x_tm, "fanout": x_fan}.items():
        step = pipe.make_batched_step_full(layout=layout)
        t0 = time.perf_counter()
        (ms, first, outs, fin), counts = counted(
            torch, f"(a) {layout} 128 x 2^20", ("front_fused", "clock"),
            lambda: drive(torch, step, pipe.init_full_state(c), [(x,)] * (MAIN_STEPS + 1)),
            never=("step", "fir"),
        )
        add(counts)
        results[layout] = dict(first=first, last=outs[-1], ms_step=ms, run=(first, outs, fin))
        log(f"[main] (a) {layout}: {ms:.4f} ms/step (CUDA events), "
            f"{c * b / (ms * 1e-3) / 1e6:.1f} Msamples/s; wall {time.perf_counter() - t0:.3f} s")
    # the same block through the fused step (B7), layout tm
    step = pipe.make_batched_step_full(layout="tm", front="step")
    (ms, first, outs, fin), counts = counted(
        torch, "(a) tm 128 x 2^20 front=step", ("step",),
        lambda: drive(torch, step, pipe.init_full_state(c), [(x_tm,)] * (MAIN_STEPS + 1)),
        never=("front", "clock"),
    )
    add(counts)
    step_ms = {"a": ms}
    log(f"[main] (a) tm front=step: {ms:.4f} ms/step (CUDA events), "
        f"{c * b / (ms * 1e-3) / 1e6:.1f} Msamples/s; fused {results['tm']['ms_step']:.4f}")
    hold_step(torch, "(a) tm front=step", (first, outs, fin), results["tm"]["run"])
    for res in results.values():
        del res["run"]
    del first, outs, fin
    n2 = b // pipe.config.decimation
    chunk = chunk_plan(n2, c, sfx, **p)["chunk"]
    for layout, res in results.items():
        for sym, cnt in (res["first"], res["last"]):
            check_outputs(torch, layout, sym, cnt, c, n2 // chunk, chunk / p["omega"])
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
    # the front on path (a)'s own input and configuration (no Doppler) against plain
    st = pipe.init_full_state(c)
    fused = front_ops.fused_front(x_tm, *st[:4], pipe.front_taps)
    front_errs = [hold_front("(a) front 128 x 2^20, no Doppler", fused,
                             front_ops.fused_front_plain(x_tm, *st[:4], pipe.front_taps), doppler=False)]
    need(same_front(torch, fused, front_ops.banded_front(x_tm, *st[:4], pipe.front_taps)),
         "(a): the fused front differs from the banded front")
    log("[main] (a) front 128 x 2^20: fused == banded bit for bit (y3 and the four tails)")
    del fused
    b4_b2 = b4_against_b2(torch, pipe, x_tm)
    del x_tm, x_fan, one, st

    # ---- (b) the server's step at its default shape, Doppler on every lane
    bs = SERVER_BLOCK
    spipe = DemodPipeline(FskDemodConfig(*LUCKY7), bs, device=dev)
    raw = capture_lanes(torch, dev, bs, 1, "lucky7.cf32")
    x_srv = torch.stack([raw[:, 0], raw[:, 1]]).contiguous()  # one shared (2, B) stream
    t0 = time.perf_counter()
    dops = lane_dopplers(range(c))
    tables = [doppler_tables(dops, bs, c, dev) for _ in range(MAIN_STEPS + 1)]
    torch.cuda.synchronize()
    log(f"[main] (b) Doppler tables for {MAIN_STEPS + 1} steps x {c} lanes "
        f"({tables[0][0].shape[0]} rows a step) built on the host in {time.perf_counter() - t0:.3f} s, "
        "outside the timed window")
    server = {}
    for front, want, never in (("fused", ("front_fused", "clock"), ("step", "fir")),
                               ("banded", ("front", "fir", "clock"), ("step", "front_fused")),
                               ("step", ("step",), ("front", "fir", "clock"))):
        step = spipe.make_batched_step_full("pallas", doppler=True, layout="fanout", front=front)
        (ms, first, outs, fin), counts = counted(
            torch, f"(b) server 128 x 262144 fanout doppler front={front}", want,
            lambda: drive(torch, step, spipe.init_full_state(c), [(x_srv, t) for t in tables]),
            never=never,
        )
        add(counts)
        server[front] = dict(ms_step=ms, outs=[first, *outs], run=(first, outs, fin))
        log(f"[main] (b) server step, front={front}: {ms:.4f} ms/step (CUDA events), "
            f"{c * bs / (ms * 1e-3) / 1e6:.1f} Msamples/s")
    step_ms["b"] = server["step"]["ms_step"]
    hold_step(torch, "(b) server step front=step", server.pop("step")["run"], server["fused"]["run"])
    for res in server.values():
        del res["run"]
    n2 = bs // spipe.config.decimation
    chunk = chunk_plan(n2, c, sfx, **p)["chunk"]
    for (sf, cf), (sb, cb) in zip(server["fused"]["outs"], server["banded"]["outs"]):
        check_outputs(torch, "server step", sf, cf, c, n2 // chunk, chunk / p["omega"])
        need(torch.equal(sf, sb) and torch.equal(cf, cb), "server step: fused and banded differ")
    log("[main] (b) fused and banded server steps give the same symbols and counts, bit for bit")
    # both fronts and B3 on path (b)'s own inputs (fanout staging, the first
    # step's tables and a fresh state) against their plain versions
    st = spipe.init_full_state(c)
    xs_tm = spipe.to_time_major(x_srv, c, "fanout")
    front_args = (xs_tm, *st[:4], spipe.front_taps, tables[0])
    plain = front_ops.fused_front_plain(*front_args)
    fronts = {}
    for name, fn in (("fused", front_ops.fused_front), ("banded", front_ops.banded_front)):
        fronts[name] = fn(*front_args)
        front_errs.append(hold_front(f"(b) {name} front 128 x 262144, Doppler", fronts[name],
                                     plain, doppler=True))
    need(same_front(torch, fronts["fused"], fronts["banded"]), "(b): the fused front differs from the banded front")
    log("[main] (b) front 128 x 262144 with Doppler: fused == banded bit for bit (y3 and the four tails)")
    del plain, fronts
    fir_errs = {}

    def fir_both(xw, rev, stride, n_out):
        y = fir_ops.conv1d_banded_tm(xw, rev, stride, n_out)
        y_p = fir_ops.conv1d_banded_tm_plain(xw, rev, stride, n_out)
        fir_errs[f"({xw.shape[0]}, {xw.shape[1]}) T={rev.numel()} stride={stride}"] = (
            (y - y_p).abs().max().item())
        return y

    front_ops._front_stages(*front_args, mix=front_ops.nco_mix, fir=fir_both, quad=front_ops.quad_demod)
    log(f"[main] (b) fir at the banded front's three shapes: max |kernel - plain| {json.dumps(fir_errs)}")
    need(max(fir_errs.values()) <= FRONT_ATOL, f"(b) fir differs from plain by {max(fir_errs.values())}")
    del st, xs_tm, front_args
    server_breakdown(torch, spipe, x_srv, tables[0], server["fused"]["ms_step"])

    # ---- (c) fir_tpu at a real width: the LPF2 stage's stream, decimation 2
    x_fir = capture_lanes(torch, dev, b, c)[:, :c].contiguous()
    lpf2 = lucky7_taps()["lpf2"][::-1].copy()

    def fir_path():
        fir_ops.fir_tpu(x_fir, lpf2, 2)  # warm-up
        return cuda_ms(torch, lambda: fir_ops.fir_tpu(x_fir, lpf2, 2), 3)

    (fir_tpu_ms, y_fir), counts = counted(torch, "(c) fir_tpu 128 x 2^20 d=2", ("fir_tpu",), fir_path)
    add(counts)
    need(y_fir.shape == (b // 2, c) and torch.isfinite(y_fir).all().item(), "fir_tpu: output")
    log(f"[main] (c) fir_tpu: {fir_tpu_ms:.4f} ms a call")
    tx_server, counts = path_tx_server(torch, dev)
    add(counts)
    tx_batched, counts = path_tx_batched(torch, dev)
    add(counts)
    streams = {}
    for exact in (True, False):
        streams["exact" if exact else "float32"], counts = path_streamer(torch, dev, exact)
        add(counts)
    ragged, counts = path_ragged_step(torch, dev)
    add(counts)
    long_taps, counts = path_long_taps(torch, dev)
    add(counts)
    server_paths = {}
    for name, fn in (("j", path_server_exact), ("k", path_server_fast), ("l", path_server_tx)):
        server_paths[name], counts = fn(torch, dev)
        add(counts)
    sharded_paths = {}
    for name, fn in (("m", path_channel_sharded), ("n", path_time_sharded), ("o", path_server_mesh),
                     ("p", path_multihost), ("q", path_parity), ("r", path_tools)):
        t0 = time.perf_counter()
        out = fn(torch, dev)
        if name in ("p", "r"):  # their kernels launch in the tools' own processes
            sharded_paths[name] = out
        else:
            sharded_paths[name], counts = out
            add(counts)
        log(f"[main] ({name}) took {time.perf_counter() - t0:.3f} s")
    log(f"[main] launches over every main-path run: {json.dumps(totals)}")
    return dict(totals=totals, fir_tpu_ms=fir_tpu_ms, x_fir=x_fir, y_fir=y_fir, lpf2=lpf2,
                tx_server=tx_server, tx_batched=tx_batched, streams=streams, ragged=ragged, long_taps=long_taps,
                server_paths=server_paths, sharded_paths=sharded_paths,
                b4_b2=b4_b2, server_ms={k: v["ms_step"] for k, v in server.items()}, step_ms=step_ms,
                front_err=max(front_errs), fir_err=max(fir_errs.values()))


def b4_against_b2(torch, pipe, x_tm):
    """B4 over [suffix | y3] of path (a)'s first block, from sfx - resid,
    in both layouts (channel-major is path (h)'s layout, at its width),
    against B2's symbols on the same y3 (outside the counted runs).  The
    walks are one stream, B2's cut into chunks: each lane's symbols must be
    equal.  A difference is logged with its lane and symbol, then fails the
    run.  Returns (B4's time-major ms at this shape, its bound)."""
    from sdrmodem_tpu_torch.dsp.clock_recovery import clock_mm_batched_full, max_symbols
    from sdrmodem_tpu_torch.ops import clock as clock_ops
    from sdrmodem_tpu_torch.ops.front import fused_front

    c = x_tm.shape[1] // 2
    st = pipe.init_full_state(c)
    p = pipe.config.clock_params()
    y3, _ = fused_front(x_tm, *st[:4], pipe.front_taps)
    outs2, counts2, _ = clock_mm_batched_full(y3, st.clock, bank=pipe.bank, **p)
    ck = st.clock
    sfx = ck.suffix.shape[0]
    work = torch.cat([ck.suffix, y3]).contiguous()
    w = work.shape[0]
    dev = y3.device
    args = (torch.full((c,), w, dtype=torch.int32, device=dev), ck.omega, ck.mu,
            ck.last_sample, (sfx - ck.resid).to(torch.int32))
    kw = dict(omega_mid=p["omega"], omega_relative_limit=p["omega_relative_limit"],
              gain_omega=p["gain_omega"], gain_mu=p["gain_mu"],
              num_symbols=max_symbols(w, p["omega"], p["omega_relative_limit"], p["gain_mu"]))
    ms, tm = cuda_ms(torch, lambda: clock_ops.clock_mm_tpu(work, *args, time_major=True, **kw), 1)
    work_cm = work.T.contiguous()
    ms_cm, cm = cuda_ms(torch, lambda: clock_ops.clock_mm_tpu(work_cm, *args, **kw), 1)
    del work_cm
    k2 = outs2.shape[2]
    seq2 = outs2[torch.arange(k2, device=dev)[None, None, :] < counts2[:, :, None]]
    total2 = counts2.sum(1).to(torch.int32)
    for layout, (outs4, counts4, _) in (("time-major", tm), ("channel-major", cm)):
        k4 = outs4.shape[1]
        seq4 = outs4[torch.arange(k4, device=dev)[None, :] < counts4[:, None]]
        same_counts = torch.equal(total2, counts4)
        equal = same_counts and torch.equal(seq2, seq4)
        if not equal:
            lane = None if same_counts else int((total2 != counts4).nonzero()[0, 0])
            log(f"[main] (a) FINDING: B4 ({layout}) over [suffix | y3] differs from B2: counts "
                f"{total2[:4].tolist()} vs {counts4[:4].tolist()}, first lane with other counts {lane}; "
                f"max |diff| over the common prefix "
                f"{(seq2[: len(seq4)] - seq4[: len(seq2)]).abs().max().item()}")
        need(equal, f"(a) B4 ({layout}) over [suffix | y3] differs from B2's symbols")
    symbols = int(tm[1].sum().item())
    bnd = bound(*ragged_clock_cost(c, w, tm[0].shape[1], symbols))
    log(f"[main] (a) B4 over [suffix | y3] of the first block equals B2's symbols, bit for bit, "
        f"in both layouts ({symbols} symbols over {c} lanes); B4 time-major "
        f"{b4_time(ms, f'{c} x {w}', tm[1], bnd)}; channel-major "
        f"{b4_time(ms_cm, f'{c} x {w}', cm[1], bnd)}")
    return ms, bnd


def stream_split(torch, pipe, iq_block):
    """Each stage of one streamer block alone, by CUDA events: the three
    FIRs, the quad demod and the clock (on the front's own outputs); and
    B4 alone inside the clock, on the work buffer the clock assembles.
    B4 is held bit for bit against its plain version on that buffer.
    Returns (stage ms, B4's ms, plain ms, shape and bound)."""
    from sdrmodem_tpu_torch.dsp.clock_recovery import (
        ClockState, _ragged_work, clock_mm_stream, max_symbols)
    from sdrmodem_tpu_torch.dsp.pipeline import _fir_ragged, _quad_demod_ragged
    from sdrmodem_tpu_torch.ops import clock as clock_ops

    dev, taps, cfg = pipe.device, pipe.front_taps, pipe.config
    st = pipe.init_state()
    x = torch.from_numpy(np.stack([iq_block.real, iq_block.imag]).astype(np.float32)).to(dev)
    nv = torch.tensor(len(iq_block), dtype=torch.int32, device=dev)
    stages = {
        "lpf1": lambda: _fir_ragged(st.lpf1, x, nv, taps.rev1, 1, pipe.max_mid, pipe.exact),
    }
    _, y1, n1 = stages["lpf1"]()
    stages["quad demod"] = lambda: _quad_demod_ragged(st.quad_prev, y1, n1, cfg.quad_gain,
                                                      pipe.use_atan_lut, taps.atan_table)
    _, yq = stages["quad demod"]()
    stages["lpf2"] = lambda: _fir_ragged(st.lpf2, yq[None, :], n1, taps.rev2, cfg.decimation,
                                         pipe.max_dec, pipe.exact)
    _, y3, n3 = stages["lpf2"]()
    if taps.rev_dc is not None:
        stages["dc"] = lambda: _fir_ragged(st.dc, y3, n3, taps.rev_dc, 1, pipe.max_dec, pipe.exact)
        _, y3, n3 = stages["dc"]()
    stages["clock"] = lambda: clock_mm_stream(y3[0], state=st.clock, n_valid=n3, **pipe._clock_kw())
    stages["clock"]()
    split = {k: cuda_ms(torch, f, 5)[0] for k, f in stages.items()}
    ck = ClockState(*(v[None] for v in st.clock))
    work, base_valid, ii0 = _ragged_work(y3, n3[None], ck)
    p = cfg.clock_params()
    kw = dict(omega_mid=p["omega"], omega_relative_limit=p["omega_relative_limit"],
              gain_omega=p["gain_omega"], gain_mu=p["gain_mu"],
              num_symbols=max_symbols(y3.shape[1] + ck.tail.shape[-1], p["omega"],
                                      p["omega_relative_limit"], p["gain_mu"]))
    args = (work, base_valid, ck.omega, ck.mu, ck.last_sample, ii0)
    b4 = lambda: clock_ops.clock_mm_tpu(*args, **kw)
    b4()
    b4_ms, got = cuda_ms(torch, b4, 5)
    # held bit for bit against its plain version at this shape (one lane)
    plain_ms, want = cuda_ms(torch, lambda: clock_ops.clock_mm_tpu_plain(*args, **kw), 1)
    shape = f"1 x {work.shape[1]}"
    need(same_ragged(torch, got, want), f"B4 at the streamer's {shape} differs from its plain version")
    outs, counts, _ = got
    b4_bound = bound(*ragged_clock_cost(1, work.shape[1], outs.shape[1], int(counts.sum().item())))
    return split, dict(ms=b4_ms, plain_ms=plain_ms, note=b4_time(b4_ms, shape, counts, b4_bound))


def path_streamer(torch, dev, exact):
    """(f)/(g) one client of the server's per-client RX: the lucky7 capture
    repeated over STREAM_BLOCKS blocks of 262144 through one streamer,
    ``process`` a block, the symbols back in numpy each time."""
    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
    from sdrmodem_tpu_torch.utils.parity import golden_report

    tag = "(f) exact" if exact else "(g) float32"
    b = SERVER_BLOCK
    iq = np.resize(np.fromfile(FIXTURES / "lucky7.expected.cf32", np.complex64), STREAM_BLOCKS * b)
    pipe = DemodPipeline(FskDemodConfig(*LUCKY7), b, exact=exact, device=dev)
    pipe.streamer().process(iq[:b])  # warm-up: the libraries loaded

    def run():
        s = pipe.streamer()
        walls, out = [], []
        for k in range(STREAM_BLOCKS):
            t0 = time.perf_counter()
            out.append(s.process(iq[k * b : (k + 1) * b]))
            walls.append(time.perf_counter() - t0)
        return walls, np.concatenate(out)

    (walls, sym), counts = counted(
        torch, f"{tag} streamer, one client, {STREAM_BLOCKS} x {b}",
        ("clock_ragged", "fir_exact" if exact else "fir"), run,
        never=("front", "clock", "step", "fir" if exact else "fir_exact"))
    need(counts["clock_ragged"] == STREAM_BLOCKS, f"{tag}: {counts['clock_ragged']} B4 launches")
    golden = np.fromfile(FIXTURES / "lucky7.expected.s8", np.int8)
    rep = golden_report(sym[: len(golden)], golden)
    need(rep["max_lsb"] <= 2 and rep["hard_decision_agreement"] == 1.0,
         f"{tag}: the capture's first pass is {rep['max_lsb']} LSB from the golden")
    per_pass = len(sym) / (STREAM_BLOCKS * b / 96000)
    need(abs(per_pass - len(golden)) < 0.01 * len(golden), f"{tag}: {len(sym)} symbols")
    ms = float(np.median(walls) * 1e3)
    rate = STREAM_BLOCKS * b / sum(walls) / 1e6
    split, b4 = stream_split(torch, pipe, iq[:b])
    log(f"[main] {tag} streamer: {ms:.4f} ms a block (median wall, numpy in and out), "
        f"{rate:.3f} Msamples/s over {STREAM_BLOCKS} blocks, {len(sym)} symbols; stages alone "
        f"(CUDA events, ms): {json.dumps(split)}; the rest (glue, copies, int8) "
        f"{ms - sum(split.values()):.4f} ms by subtraction; B4 alone inside the clock "
        f"{b4['note']}, equal to its plain version bit for bit (plain {b4['plain_ms']:.1f} ms)")
    return dict(ms_block=ms, msamples_s=rate, split=split, b4_ms=b4["ms"]), counts


def path_ragged_step(torch, dev):
    """(h) make_batched_step("pallas") at the bench.py shape, 128 x 2^20,
    every lane full and then half the lanes 12345 short; then B4 alone at
    this step's shape (channel-major, 128 x (2^19 + 2 cap))."""
    from sdrmodem_tpu_torch.dsp.clock_recovery import _ragged_work, max_symbols
    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
    from sdrmodem_tpu_torch.ops import clock as clock_ops

    c, b = LANES, MAIN_BLOCK
    pipe = DemodPipeline(FskDemodConfig(*LUCKY7), b, device=dev)
    x_tm = capture_lanes(torch, dev, b, c)
    x = torch.stack([x_tm[:, :c].T, x_tm[:, c:].T], dim=1).contiguous()  # (C, 2, B)
    del x_tm
    step = pipe.make_batched_step("pallas")
    full = torch.full((c,), b, dtype=torch.int32, device=dev)
    ragged = full.clone()
    ragged[c // 2 :] -= 12345
    res, total = {}, {}
    omega = pipe.config.clock_params()["omega"]
    for name, nv in (("full", full), ("ragged", ragged)):
        (ms, first, _, _), counts = counted(
            torch, f"(h) ragged step 128 x 2^20, n_valid {name}", ("clock_ragged", "fir"),
            lambda: drive(torch, step, pipe.init_state(channels=c), [(x, nv)] * (MAIN_STEPS + 1)),
            never=("front", "clock", "fir_exact", "step"))
        sym, cnt = first
        want = nv.double() / pipe.config.decimation / omega
        need(sym.dtype == torch.int8 and cnt.shape == (c,) and sym.abs().max().item() > 64,
             f"(h) {name}: outputs")
        need(((cnt.double() - want).abs() < 0.02 * want).all().item(), f"(h) {name}: counts {cnt[:4].tolist()}")
        res[name] = ms
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        log(f"[main] (h) ragged step, n_valid {name}: {ms:.4f} ms/step (CUDA events), "
            f"{c * b / (ms * 1e-3) / 1e6:.1f} Msamples/s")
    state = pipe.init_state(channels=c)
    _, y3, n3 = pipe._front_batched(state, x, full)
    work, base_valid, ii0 = _ragged_work(y3, n3, state.clock)
    p = pipe.config.clock_params()
    kw = dict(omega_mid=p["omega"], omega_relative_limit=p["omega_relative_limit"],
              gain_omega=p["gain_omega"], gain_mu=p["gain_mu"],
              num_symbols=max_symbols(y3.shape[1] + state.clock.tail.shape[-1], p["omega"],
                                      p["omega_relative_limit"], p["gain_mu"]))
    ck = state.clock
    ms, (outs, counts, _) = cuda_ms(
        torch, lambda: clock_ops.clock_mm_tpu(work, base_valid, ck.omega, ck.mu, ck.last_sample, ii0, **kw), 3)
    res["b4_ms"] = ms
    res["b4_bound"] = bound(*ragged_clock_cost(c, work.shape[1], outs.shape[1], int(counts.sum().item())))
    res["b4_shape"] = f"{c} x {work.shape[1]}"
    log(f"[main] (h) B4 alone (channel-major): {b4_time(ms, res['b4_shape'], counts, res['b4_bound'])}")
    return res, total


def gfsk_stream(fs, baud, deviation, n, seed):
    """(2, n) float32 I and Q on the host: a GFSK signal (random bits, a
    Gaussian frequency pulse over four bits, ``deviation`` Hz) with a
    little noise."""
    rng = np.random.default_rng(seed)
    sps = fs // baud
    nrz = np.repeat(rng.integers(0, 2, n // sps + 1) * 2.0 - 1.0, sps)[:n]
    pulse = np.exp(-0.5 * (np.arange(-2 * sps, 2 * sps + 1) / (0.5 * sps)) ** 2)
    freq = np.convolve(nrz, pulse / pulse.sum(), mode="same")
    iq = np.exp(1j * np.cumsum(2 * np.pi * deviation / fs * freq))
    iq += 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return np.stack([iq.real, iq.imag]).astype(np.float32)


def path_long_taps(torch, dev):
    """(i) the server's step with long filters: 288 kHz at 9600 Bd (LPF1
    707 taps, LPF2 347, DC 1917), past B1's shared-memory layout, so
    make_batched_step_full(front="fused") takes the banded front, chosen
    when the step is built: 128 lanes x 262144, one shared GFSK stream,
    each lane's Doppler rows.  B1 must never launch, B3 three times a step.
    Then the banded front on the first step's inputs against its plain
    version."""
    from sdrmodem_tpu_torch.dsp.clock_recovery import chunk_plan
    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
    from sdrmodem_tpu_torch.ops import front as front_ops

    c, bs = LANES, SERVER_BLOCK
    fs, baud, deviation = LONG_TAPS[:3]
    pipe = DemodPipeline(FskDemodConfig(*LONG_TAPS), bs, device=dev)
    taps = pipe.front_taps
    need(not pipe.fused_front_available(), "(i): B1 takes these taps; no long-filter route is driven")
    x = torch.from_numpy(gfsk_stream(fs, baud, deviation, (MAIN_STEPS + 1) * bs, 21)).to(dev)
    dops = lane_dopplers(range(c), fs)
    tables = [doppler_tables(dops, bs, c, dev) for _ in range(MAIN_STEPS + 1)]
    inputs = [(x[:, k * bs : (k + 1) * bs].contiguous(), t) for k, t in enumerate(tables)]
    step = pipe.make_batched_step_full("pallas", doppler=True, layout="fanout")
    (ms, first, outs, _), counts = counted(
        torch, f"(i) server {c} x {bs} fanout doppler, {fs} Hz / {baud} Bd (taps {taps.rev1.numel()} / "
        f"{taps.rev2.numel()} / {taps.rev_dc.numel()})", ("front", "fir", "clock"),
        lambda: drive(torch, step, pipe.init_full_state(c), inputs), never=("front_fused", "step"))
    need(counts["fir"] == 3 * len(inputs), f"(i): {counts['fir']} B3 launches over {len(inputs)} steps")
    p = pipe.config.clock_params()
    sfx = pipe.init_full_state(1).clock.suffix.shape[0]
    n2 = bs // pipe.config.decimation
    chunk = chunk_plan(n2, c, sfx, **p)["chunk"]
    for sym, cnt in (first, outs[-1]):
        check_outputs(torch, "(i)", sym, cnt, c, n2 // chunk, chunk / p["omega"])
    st = pipe.init_full_state(c)
    front_args = (pipe.to_time_major(inputs[0][0], c, "fanout"), *st[:4], taps, tables[0])
    err = hold_front(f"(i) banded front {c} x {bs}, Doppler", front_ops.banded_front(*front_args),
                     front_ops.fused_front_plain(*front_args), doppler=True)
    log(f"[main] (i) long filters through the banded front: {ms:.4f} ms/step (CUDA events), "
        f"{c * bs / (ms * 1e-3) / 1e6:.1f} Msamples/s [{card()}]")
    return dict(ms_step=ms, front_err=err), counts


SERVER_CLIENTS = 4  # path (j): exact clients sharing one sdr-server stream
SERVER_BLOCKS = 4  # blocks of 262144 the mock sends in paths (j) and (k)
PACK_LAUNCHES = 2  # csrc/pack.cu's launches a pack_lanes call: the count scan, then the packing
TX_SERVER_SMALL = 100  # path (l): tools/perf.py:4's 100 TxData of 2048 B, then 2 of the wire's largest


def wire_doppler():
    """DOPPLER's observer and TLE as the wire carries them (lat/lon x 1e7,
    altitude x 1e4: server/session.py:doppler_from_settings)."""
    from sdrmodem_tpu_torch.server import wire

    return wire.DopplerSettings(tle=TLE, latitude=round(DOPPLER["latitude"] * 1e7),
                                longitude=round(DOPPLER["longitude"] * 1e7),
                                altitude=round(DOPPLER["altitude_km"] * 1e4))


def serve_rx(mode, requests, blocks, cumulative, **server_kw):
    """``tests/torch_server_helpers.py:serve_rx`` on the default ServerConfig
    (buffer_size SERVER_BLOCK) in ``demod_mode`` ``mode``, writing under
    build/; ``server_kw`` goes to SdrModemServer."""
    import tempfile

    from sdrmodem_tpu_torch.server.config import ServerConfig
    from tests.torch_server_helpers import serve_rx as serve

    need(ServerConfig().buffer_size == SERVER_BLOCK, f"the server's buffer_size is {ServerConfig().buffer_size}")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as base:
        return serve(base, {"demod_mode": mode}, requests, blocks, cumulative, timeout=900,
                     server_kw=server_kw)


def path_server_exact(torch, dev):
    """(j) the default server: demod_mode = exact, buffer_size 262144, four
    clients sharing one mock sdr-server stream of the corrected lucky7
    capture repeated over SERVER_BLOCKS blocks.  Each client's bytes must
    equal the exact streamer run directly on the card over the same blocks,
    and its first pass lie within +-2 LSB of the golden, hard decisions
    equal; the float64 FIR and B4 must launch, on the card."""
    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
    from sdrmodem_tpu_torch.utils.parity import golden_report
    from tests.torch_server_helpers import rx_request

    b = SERVER_BLOCK
    iq = np.resize(np.fromfile(FIXTURES / "lucky7.expected.cf32", np.complex64), SERVER_BLOCKS * b)
    blocks = [iq[t * b : (t + 1) * b] for t in range(SERVER_BLOCKS)]
    streamer = DemodPipeline(FskDemodConfig(*LUCKY7), b, exact=True, device=dev).streamer()
    direct = [streamer.process(blk) for blk in blocks]
    cumulative = [np.cumsum([len(d) for d in direct])] * SERVER_CLIENTS
    (got, ms, where), counts = counted(
        torch, f"(j) server, exact, {SERVER_CLIENTS} clients x {SERVER_BLOCKS} blocks of {b}",
        ("fir_exact", "clock_ragged"),
        lambda: serve_rx("exact", [rx_request()] * SERVER_CLIENTS, blocks, cumulative),
        never=("front", "front_fused", "clock", "step", "fir", "pack"))
    need(all(d == "cuda" for _, d in where), "(j): a client's DSP is not on the card")
    want = np.concatenate(direct)
    golden = np.fromfile(FIXTURES / "lucky7.expected.s8", np.int8)
    for k, g in enumerate(got):
        need(np.array_equal(g, want), f"(j) client {k}: bytes differ from the exact streamer's")
    rep = golden_report(got[0][: len(golden)], golden)
    need(rep["max_lsb"] <= 2 and rep["hard_decision_agreement"] == 1.0,
         f"(j) first pass {rep['max_lsb']} LSB from the golden, agreement {rep['hard_decision_agreement']}")
    log(f"[main] (j) server, exact: every client's {len(want)} bytes equal the exact streamer's; "
        f"golden {json.dumps(rep)}; ms a block of {b} from the mock to the last client's last "
        f"symbol: {json.dumps([round(m, 3) for m in ms])}, median {np.median(ms):.3f} [{card()}]")
    return dict(ms_blocks=ms, median_ms=float(np.median(ms))), counts


def path_server_fast(torch, dev):
    """(k) the fast group at full width: demod_mode = fast, LANES clients
    (every lane of one group), buffer_size 262144, the raw lucky7 pass
    repeated over SERVER_BLOCKS blocks, client k with DOPPLER's observer
    and TLE from PASS_START + k.  Every lane's bytes must equal the group's
    step run directly at LANES lanes over the same blocks, with tables from
    device_segments of Dopplers built by the port's doppler_from_settings
    with the same settings; B1 and B2 must launch, B7 never, and the pack
    kernel PACK_LAUNCHES times a block.  The same
    direct run with the Doppler interpolated every 2000 samples (the
    goldens' cadence) must bring lane 0's first pass within +-2 LSB of the
    golden for 99.5% of its symbols."""
    from sdrmodem_tpu_torch.server.session import BatchedRxGroup
    from sdrmodem_tpu_torch.utils.parity import golden_report
    from tests.torch_server_helpers import rx_request

    b, c = SERVER_BLOCK, BatchedRxGroup.LANES
    need(c == LANES, f"the group has {c} lanes")
    iq = np.resize(np.fromfile(FIXTURES / "lucky7.cf32", np.complex64), SERVER_BLOCKS * b)
    blocks = [iq[t * b : (t + 1) * b] for t in range(SERVER_BLOCKS)]
    settings, starts = wire_doppler(), [PASS_START + k for k in range(c)]

    def run_direct(max_batch):
        return fast_direct(torch, dev, blocks, settings, starts, c, max_batch)

    # the same step, blocks and settings at the goldens' 2000-sample Doppler
    # cadence: lane 0's first pass must meet the golden, as phase 3's does
    golden = np.fromfile(FIXTURES / "lucky7.expected.s8", np.int8)

    def first_pass(sym):
        rep = golden_report(sym[: len(golden)], golden)
        m = min(len(sym), len(golden))
        rep["within_2_lsb"] = float((np.abs(sym[:m].astype(np.int32) - golden[:m].astype(np.int32)) <= 2).mean())
        return rep

    cadenced = first_pass(np.concatenate(run_direct(2000)[0]))
    need(cadenced["symbols"] >= 0.99 * len(golden), "(k) cadenced direct step: too few symbols")
    need(cadenced["within_2_lsb"] >= 0.995, f"(k) cadenced direct step: only {cadenced['within_2_lsb']} "
         "of lane 0 within +-2 LSB of the golden")
    need(cadenced["hard_decision_agreement"] >= 0.99,
         f"(k) cadenced direct step: hard decisions {cadenced['hard_decision_agreement']}")
    direct = run_direct(None)
    cumulative = [np.cumsum([len(d) for d in lane]) for lane in direct]
    requests = [rx_request(settings, s) for s in starts]
    (got, ms, where), counts = counted(
        torch, f"(k) server, fast, {c} clients x {SERVER_BLOCKS} blocks of {b}, Doppler on every lane",
        ("front_fused", "clock", "pack"), lambda: serve_rx("fast", requests, blocks, cumulative),
        never=("step", "fir", "clock_ragged", "fir_exact"))
    need(counts["pack"] == PACK_LAUNCHES * SERVER_BLOCKS, f"(k): {counts['pack']} pack launches, "
         f"{PACK_LAUNCHES * SERVER_BLOCKS} expected (two a block)")
    need([lane for lane, _ in where] == list(range(c)), "(k): client k is not lane k")
    need(all(d == "cuda" for _, d in where), "(k): the group is not on the card")
    for k, g in enumerate(got):
        need(np.array_equal(g, np.concatenate(direct[k])), f"(k) lane {k}: bytes differ from the direct step's")
    rep = first_pass(got[0])
    log(f"[main] (k) server, fast: all {c} lanes' bytes ({sum(len(g) for g in got)} in all) equal the "
        f"direct step's, bit for bit; lane 0's first pass against the golden, the Doppler shift held "
        f"a second at a time as the group's blocks give it, as the JAX package's group does "
        f"(tests/test_torch_server_doppler.py): {json.dumps(rep)}; the direct step at the goldens' "
        f"2000-sample cadence: {json.dumps(cadenced)}; ms a block of {b} from the mock to the last "
        f"lane's last symbol: {json.dumps([round(x, 3) for x in ms])}, median {np.median(ms):.3f} [{card()}]")
    return dict(ms_blocks=ms, median_ms=float(np.median(ms)), golden_first_pass=rep,
                golden_cadenced=cadenced), counts


def path_server_tx(torch, dev):
    """(l) TX through the server: one client, tx_sdr_type = file, 100
    TxData of 2048 B then 2 of the wire's largest (a 32 KiB message less
    its framing: 32764 B) at 19200 Hz / 9600 Bd, each awaited.
    The dump must equal StreamingGfskMod run directly on the card over the
    same payloads, bit for bit, and B5 launch as tx_plan gives it."""
    import asyncio
    import tempfile

    from sdrmodem_tpu_torch.dsp.gfsk_mod import GfskModConfig
    from sdrmodem_tpu_torch.dsp.streaming import StreamingGfskMod
    from sdrmodem_tpu_torch.ops import tx as tx_ops
    from sdrmodem_tpu_torch.server import wire
    from sdrmodem_tpu_torch.server.config import TxSdrType
    from sdrmodem_tpu_torch.server.tcp_server import SdrModemServer
    from tests.torch_server_helpers import ModemClient, server_config

    fs, (baud, deviation) = TX_FS[0], TX_RADIO
    largest = wire.MAX_MESSAGE_LENGTH
    while len(wire.TxData(bytes(largest)).encode()) > wire.MAX_MESSAGE_LENGTH:
        largest -= 1
    rng = np.random.default_rng(15)
    payloads = [rng.integers(0, 256, n).astype(np.uint8).tobytes()
                for n in [2048] * TX_SERVER_SMALL + [largest] * 2]
    mod = StreamingGfskMod(GfskModConfig.from_radio(fs, baud, deviation), device=dev)
    want = np.concatenate([mod.process(p) for p in payloads])

    async def body(base):
        server = SdrModemServer(server_config(base, tx_sdr_type=TxSdrType.FILE))
        need(server.device.type == "cuda", f"the server chose {server.device}")
        await server.start()
        c = await ModemClient.connect("127.0.0.1", server.port)
        resp = await c.tx_request(wire.TxRequest(
            tx_center_freq=DOPPLER["center_freq"], tx_sampling_freq=fs, tx_dump_file=True,
            mod_type=wire.ModemType.GMSK, mod_baud_rate=baud,
            fsk_settings=wire.FskModulationSettings(deviation),
            file_settings=wire.FileSettings(str(pathlib.Path(base) / "sink.cf32"))))
        need(resp.status == 0, f"tx request refused: {resp}")
        walls = []
        for p in payloads:
            t0 = time.perf_counter()
            ack = await c.tx_data(p)
            walls.append(time.perf_counter() - t0)
            need(ack.status == 0, f"TxData of {len(p)} B: {ack}")
        await c.shutdown()
        await asyncio.sleep(0.2)
        c.close()
        await server.stop()
        dump = np.fromfile(next(pathlib.Path(base).glob("tx.mod2sdr.*.cf32")), np.complex64)
        sink = np.fromfile(pathlib.Path(base) / "sink.cf32", np.complex64)
        return walls, dump, sink

    def run():
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as base:
            return asyncio.run(asyncio.wait_for(body(base), 600))

    (walls, dump, sink), counts = counted(
        torch, f"(l) server, TX, {len(payloads)} TxData", ("tx_folded",), run,
        never=("tx", "front", "front_fused", "clock", "clock_ragged", "step", "fir", "fir_exact"))
    k = mod.k
    plan = sum(tx_ops.tx_plan(len(p) * 8, int(fs // baud), k).launches for p in payloads)
    need(counts["tx_folded"] == plan, f"(l) {counts['tx_folded']} B5 launches, {plan} planned")
    need(np.array_equal(dump, want) and np.array_equal(sink, want),
         "(l): the server's TX differs from StreamingGfskMod's, bit for bit")
    med, p90 = stats(walls[:TX_SERVER_SMALL])
    big = stats(walls[TX_SERVER_SMALL:])
    log(f"[main] (l) server, TX: the dump ({len(dump)} samples) equals StreamingGfskMod's bit for bit; "
        f"a 2048-B TxData to its response: median {med:.4f} ms, p90 {p90:.4f}; {largest} B: median "
        f"{big[0]:.4f} ms [{card()}]")
    return dict(median_ms=med, p90_ms=p90, ms_32k=big[0]), counts


SHARDS = 4  # shards of paths (m)-(o), every one on the one card
SHARDED_LANES = SHARDS * LANES  # path (m)'s channels and path (o)'s group width
RAGGED_SHARDS, RAGGED_CHANNELS = 2, 16  # path (m)'s ragged class
RAGGED_SHORT = 12345  # samples the odd channels of path (m)'s ragged step lack
TIME_STREAMS = 128  # path (n): streams x MAIN_BLOCK samples, over SHARDS
GRID_CHANNELS, GRID_SAMPLES = 8, 1 << 19  # path (n)'s grid, 2 channel shards x 2 time shards
# path (p): the JAX record's 16 streams x 32768 (MULTIHOST.json), 2 processes x 2 shards
MULTIHOST_ARGS = ["--backend", "gloo", "--procs", "2", "--shards", "2", "--streams", "16",
                  "--samples", "32768"]


def lane_slice(torch, state, lo, hi):
    """Lanes [lo, hi) of a DemodStateFull: both halves of the I/Q leaves."""
    from sdrmodem_tpu_torch.dsp.clock_recovery import ClockFullState
    from sdrmodem_tpu_torch.dsp.pipeline import DemodStateFull

    c = state.quad_prev.shape[1] // 2

    def iq(t):
        return torch.cat([t[:, lo:hi], t[:, c + lo : c + hi]], dim=1)

    def lanes(t):
        return None if t is None else t[..., lo:hi]

    return DemodStateFull(iq(state.lpf1_hist), iq(state.quad_prev), lanes(state.lpf2_hist),
                          lanes(state.dc_hist), ClockFullState(*(lanes(t) for t in state.clock)))


def timed_ms(torch, fn):
    """fn()'s result and its wall ms, the card idle before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def path_channel_sharded(torch, dev):
    """(m) channel sharding at full width: ShardedChannelDemodFull over
    SHARDS shards of the one card, SHARDED_LANES lanes (128 a shard) x
    262144, the lucky7 capture on every lane (lane l from l x 2 blocks into
    the tiled capture), two steps with the state carried.  Its symbols and
    final state must equal the unsharded SHARDED_LANES-lane step's bit for
    bit, each step timed beside it (one card: the cost of sharding, no
    scaling).  Then ShardedChannelDemod over RAGGED_SHARDS shards, 16
    channels x 262144, the odd channels RAGGED_SHORT samples short, equal
    to the unsharded make_batched_step("pallas")."""
    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
    from sdrmodem_tpu_torch.parallel.channels import ShardedChannelDemod, ShardedChannelDemodFull
    from sdrmodem_tpu_torch.parallel.mesh import Mesh

    cfg, b, c = FskDemodConfig(*LUCKY7), SERVER_BLOCK, SHARDED_LANES
    x_tm = capture_lanes(torch, dev, 2 * b, c)
    blocks = [torch.stack([x_tm[t * b : (t + 1) * b, :c].T, x_tm[t * b : (t + 1) * b, c:].T], dim=1).contiguous()
              for t in range(2)]
    del x_tm
    sharded = ShardedChannelDemodFull(cfg, b, c, Mesh([dev] * SHARDS, "channel"))
    shards = [[blk[i * sharded.local : (i + 1) * sharded.local] for i in range(SHARDS)] for blk in blocks]

    def run_sharded():
        state, outs, ms = sharded.init_state(), [], []
        for x in shards:
            (state, sym, cnt), t = timed_ms(torch, lambda: sharded.step(state, x))
            outs.append((sym, cnt))
            ms.append(t)
        return state, outs, ms

    (state, outs, ms), counts = counted(
        torch, f"(m) ShardedChannelDemodFull, {SHARDS} shards x {sharded.local} lanes x {b}, 2 steps",
        ("front_fused", "clock"), run_sharded, never=("step", "fir", "clock_ragged"))
    pipe = DemodPipeline(cfg, b, device=dev)
    step = pipe.make_batched_step_full()

    def ref_step(state, blk):  # symbols to the host, as the sharded class gives them
        state, sym, cnt = step(state, blk)
        return state, sym.cpu(), cnt.cpu()

    ref, ref_ms = pipe.init_full_state(c), []
    for t, blk in enumerate(blocks):
        (ref, sym, cnt), t_ms = timed_ms(torch, lambda: ref_step(ref, blk))
        ref_ms.append(t_ms)
        need(same_stream(torch, outs[t], (sym, cnt)), f"(m) step {t}: a lane's symbols differ from the unsharded step's")
    for i, st in enumerate(state):
        need(same_state(torch, st, lane_slice(torch, ref, i * sharded.local, (i + 1) * sharded.local)),
             f"(m) shard {i}: its state differs from the unsharded step's lanes")
    symbols = int(sum(cnt.sum().item() for _, cnt in outs))
    # the card's share of a step: the same calls from a fresh state, no copy to the host, by CUDA events
    shard_steps = [p.make_batched_step_full() for p in sharded.pipes]
    fresh, ref_fresh = sharded.init_state(), pipe.init_full_state(c)
    dev_ms, _ = cuda_ms(torch, lambda: [f(st, x) for f, st, x in zip(shard_steps, fresh, shards[1])], 3)
    ref_dev_ms, _ = cuda_ms(torch, lambda: step(ref_fresh, blocks[1]), 3)

    # the ragged class: B3 and B4 a shard
    rag = ShardedChannelDemod(cfg, b, RAGGED_CHANNELS, Mesh([dev] * RAGGED_SHARDS, "channel"))
    x = blocks[0][:RAGGED_CHANNELS]
    n_valid = np.where(np.arange(RAGGED_CHANNELS) % 2, b - RAGGED_SHORT, b).astype(np.int32)
    xr = [x[i * rag.local : (i + 1) * rag.local] for i in range(RAGGED_SHARDS)]
    ((_, rsym, rcnt), rag_ms), rcounts = counted(
        torch, f"(m) ShardedChannelDemod, {RAGGED_SHARDS} shards x {rag.local} channels x {b}, ragged",
        ("fir", "clock_ragged"), lambda: timed_ms(torch, lambda: rag.step(rag.init_state(), xr, n_valid)),
        never=("front_fused", "clock", "step"))
    rpipe = DemodPipeline(cfg, b, device=dev)
    (_, want, wcnt), rag_ref_ms = timed_ms(torch, lambda: rpipe.make_batched_step("pallas")(
        rpipe.init_state(channels=RAGGED_CHANNELS), x, torch.from_numpy(n_valid).to(dev)))
    need(torch.equal(rcnt, wcnt.cpu()) and torch.equal(rsym, want.cpu()),
         "(m) ragged: the sharded class differs from the unsharded make_batched_step")
    for k, v in rcounts.items():
        counts[k] += v
    log(f"[main] (m) channels over {SHARDS} shards of one card: {c} lanes x {b}, every lane's {symbols} "
        f"symbols and the final state equal the unsharded step's bit for bit; ms a step, symbols to the "
        f"host: sharded {json.dumps([round(m, 3) for m in ms])}, unsharded "
        f"{json.dumps([round(m, 3) for m in ref_ms])}; the card's share (CUDA events, no copy to the host): "
        f"sharded {dev_ms:.3f}, unsharded {ref_dev_ms:.3f}; ragged, {RAGGED_CHANNELS} channels over "
        f"{RAGGED_SHARDS} shards: equal to make_batched_step, {rag_ms:.3f} ms against {rag_ref_ms:.3f} [{card()}]")
    return dict(ms=ms, unsharded_ms=ref_ms, device_ms=dev_ms, unsharded_device_ms=ref_dev_ms, ragged_ms=rag_ms,
                ragged_unsharded_ms=rag_ref_ms), counts


def time_streams(n_streams, n):
    """tests/test_parallel.py:158's streams: the corrected capture at
    offsets 1024 apart, each with 0.01 of noise from seed 7, except stream
    0, the capture as it is, which path (n) gates on the golden (the
    capture's mean amplitude is 0.0024, so the noise buries the others)."""
    iq = np.resize(np.fromfile(FIXTURES / "lucky7.expected.cf32", np.complex64), (n_streams - 1) * 1024 + n)
    rng = np.random.default_rng(7)
    streams = np.empty((n_streams, n), np.complex64)
    streams[0] = iq[:n]
    for s in range(1, n_streams):
        streams[s] = iq[s * 1024 : s * 1024 + n]
        streams[s].real += 0.01 * rng.standard_normal(n, dtype=np.float32)
        streams[s].imag += 0.01 * rng.standard_normal(n, dtype=np.float32)
    return streams


def unsharded_streams(torch, dev, streams, block, dopplers=None):
    """Each stream alone, as a lane of one batch, through the full-block
    step (layout tm) at ``block``, with each lane's Doppler tables every
    2000 samples where it has a corrector: every stream's symbols."""
    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
    from sdrmodem_tpu_torch.parallel.time_shard import DOPPLER_CADENCE

    s, n = streams.shape
    pipe = DemodPipeline(FskDemodConfig(*LUCKY7), block, device=dev)
    step = pipe.make_batched_step_full(doppler=True, layout="tm")
    state, out = pipe.init_full_state(s), []
    dops = {k: d for k, d in enumerate(dopplers or []) if d is not None}
    for t in range(-(-n // block)):
        part = np.zeros((s, block), np.complex64)
        part[:, : min(block, n - t * block)] = streams[:, t * block : (t + 1) * block]
        x = torch.from_numpy(np.ascontiguousarray(np.concatenate([part.real.T, part.imag.T], axis=1))).to(dev)
        tables = doppler_tables(dops, block, s, dev, max_batch=DOPPLER_CADENCE) if dops else None
        state, sym, cnt = step(state, x, tables)
        out.append((sym.cpu().numpy(), cnt.cpu().numpy()))
    return [np.concatenate([sym[k][np.arange(sym.shape[2])[None, :] < cnt[k][:, None]] for sym, cnt in out])
            for k in range(s)]


def path_time_sharded(torch, dev):
    """(n) time sharding at full width: demod_pipelined over SHARDS shards
    of the one card, TIME_STREAMS streams x 2^20 (block 262144): every
    stream equal to the unsharded full-block step at block 262144 bit for
    bit, stream 0's first pass within +-2 LSB of the golden with hard
    decisions 1.0.  Then the raw lucky7 pass with its Doppler tables and a
    pre-corrected stream without, on SHARDS shards (tests/test_parallel.py:288):
    both equal the unsharded step fed the same tables and within +-2 LSB of
    the golden.  Then demod_grid_sharded on 2 x 2 shards, GRID_CHANNELS x
    GRID_SAMPLES, equal to the unsharded step."""
    from sdrmodem_tpu_torch.dsp.doppler import Doppler
    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
    from sdrmodem_tpu_torch.parallel.mesh import Mesh
    from sdrmodem_tpu_torch.parallel.time_shard import demod_grid_sharded, demod_pipelined
    from sdrmodem_tpu_torch.utils.parity import golden_report

    cfg, n = FskDemodConfig(*LUCKY7), MAIN_BLOCK
    golden = np.fromfile(FIXTURES / "lucky7.expected.s8", np.int8)
    t0 = time.perf_counter()
    streams = time_streams(TIME_STREAMS, n)
    host_s = time.perf_counter() - t0
    mesh = Mesh([dev] * SHARDS)
    (outs, ms), counts = counted(
        torch, f"(n) demod_pipelined, {TIME_STREAMS} streams x {n} over {SHARDS} shards",
        ("front", "fir", "clock"), lambda: timed_ms(torch, lambda: demod_pipelined(streams, cfg, mesh)),
        never=("front_fused", "step", "clock_ragged"))
    ref = unsharded_streams(torch, dev, streams, n // SHARDS)
    for s in range(TIME_STREAMS):
        need(np.array_equal(outs[s], ref[s]), f"(n) stream {s}: differs from the unsharded step at {n // SHARDS}")
    rep = golden_report(outs[0][: len(golden)], golden)
    need(rep["symbols"] >= len(golden) and rep["max_lsb"] <= 2 and rep["hard_decision_agreement"] == 1.0,
         f"(n) stream 0's first pass against the golden: {json.dumps(rep)}")

    raw = np.fromfile(FIXTURES / "lucky7.cf32", np.complex64)
    pre = np.fromfile(FIXTURES / "lucky7.expected.cf32", np.complex64)
    nd = (len(raw) // (SHARDS * cfg.decimation)) * SHARDS * cfg.decimation
    pair = np.stack([raw[:nd], pre[:nd]]).astype(np.complex64)

    def dops():
        return [Doppler(**DOPPLER, start_time_seconds=PASS_START), None]

    dop_outs, c2 = counted(torch, f"(n) demod_pipelined, the raw pass with Doppler and a corrected lane, {SHARDS} shards",
                           ("front", "fir", "clock"), lambda: demod_pipelined(pair, cfg, mesh, dopplers=dops()),
                           never=("front_fused", "step", "clock_ragged"))
    dop_ref = unsharded_streams(torch, dev, pair, nd // SHARDS, dopplers=dops())
    dop_reps = []
    for s in range(2):
        need(np.array_equal(dop_outs[s], dop_ref[s]), f"(n) Doppler stream {s}: differs from the unsharded step")
        r = golden_report(dop_outs[s][: len(golden)], golden)
        need(r["symbols"] >= len(golden) - 2 and r["max_lsb"] <= 2 and r["hard_decision_agreement"] == 1.0,
             f"(n) Doppler stream {s} against the golden: {json.dumps(r)}")
        dop_reps.append(r)

    grid_in = streams[:GRID_CHANNELS, :GRID_SAMPLES]
    meshes = [Mesh([dev] * 2), Mesh([dev] * 2)]
    grid, c3 = counted(torch, f"(n) demod_grid_sharded, {GRID_CHANNELS} channels x {GRID_SAMPLES} on 2 x 2 shards",
                       ("front", "fir", "clock"), lambda: demod_grid_sharded(grid_in, cfg, meshes),
                       never=("front_fused", "step", "clock_ragged"))
    grid_ref = unsharded_streams(torch, dev, grid_in, GRID_SAMPLES // 2)
    for ch in range(GRID_CHANNELS):
        need(np.array_equal(grid[ch], grid_ref[ch]), f"(n) grid channel {ch}: differs from the unsharded step")
    for part in (c2, c3):
        for k, v in part.items():
            counts[k] += v
    log(f"[main] (n) time over {SHARDS} shards of one card: {TIME_STREAMS} streams x {n}, every stream's "
        f"symbols ({sum(len(o) for o in outs)}) equal to the unsharded step at {n // SHARDS} bit for bit, "
        f"{ms:.3f} ms host to host (the streams' host staging {host_s:.3f} s before it); stream 0 against "
        f"the golden {json.dumps(rep)}; the raw pass with Doppler and the corrected lane {json.dumps(dop_reps)}; "
        f"the 2 x 2 grid equal to the unsharded step [{card()}]")
    return dict(ms=ms, golden=rep, doppler=dop_reps), counts


def path_server_mesh(torch, dev):
    """(o) the server with its fast group's lanes sharded: LANES =
    SHARDED_LANES, SdrModemServer(devices=[card] * SHARDS), the clients and
    blocks of path (k).  Every client's bytes must equal the unsharded
    SHARDED_LANES-lane step run directly with the same tables (what the
    one-device group runs); B2 launches once a shard a block, the pack
    kernel PACK_LAUNCHES times a shard a block."""
    from sdrmodem_tpu_torch.server.session import BatchedRxGroup
    from tests.torch_server_helpers import rx_request

    b, c = SERVER_BLOCK, LANES
    iq = np.resize(np.fromfile(FIXTURES / "lucky7.cf32", np.complex64), SERVER_BLOCKS * b)
    blocks = [iq[t * b : (t + 1) * b] for t in range(SERVER_BLOCKS)]
    settings, starts = wire_doppler(), [PASS_START + k for k in range(c)]
    direct = fast_direct(torch, dev, blocks, settings, starts, SHARDED_LANES, None)
    cumulative = [np.cumsum([len(d) for d in lane]) for lane in direct]
    requests = [rx_request(settings, s) for s in starts]
    lanes = BatchedRxGroup.LANES
    BatchedRxGroup.LANES = SHARDED_LANES
    try:
        (got, ms, where), counts = counted(
            torch, f"(o) server, fast, {SHARDED_LANES} lanes over {SHARDS} shards, {c} clients x "
            f"{SERVER_BLOCKS} blocks of {b}", ("front_fused", "clock", "pack"),
            lambda: serve_rx("fast", requests, blocks, cumulative, devices=[dev] * SHARDS),
            never=("step", "fir", "clock_ragged", "fir_exact"))
    finally:
        BatchedRxGroup.LANES = lanes
    need(counts["clock"] == SHARDS * SERVER_BLOCKS, f"(o): {counts['clock']} B2 launches, "
         f"{SHARDS * SERVER_BLOCKS} expected (one a shard a block)")
    need(counts["pack"] == PACK_LAUNCHES * SHARDS * SERVER_BLOCKS, f"(o): {counts['pack']} pack "
         f"launches, {PACK_LAUNCHES * SHARDS * SERVER_BLOCKS} expected (two a shard a block)")
    need([lane for lane, _ in where] == list(range(c)), "(o): client k is not lane k")
    for k, g in enumerate(got):
        need(np.array_equal(g, np.concatenate(direct[k])), f"(o) lane {k}: bytes differ from the unsharded step's")
    log(f"[main] (o) server, fast, {SHARDED_LANES} lanes over {SHARDS} shards: all {c} clients' bytes equal "
        f"the unsharded {SHARDED_LANES}-lane step's bit for bit; ms a block of {b} from the mock to the "
        f"last lane's last symbol: {json.dumps([round(x, 3) for x in ms])}, median {np.median(ms):.3f} [{card()}]")
    return dict(ms_blocks=ms, median_ms=float(np.median(ms))), counts


def path_multihost(torch, dev):
    """(p) several processes: ``python -m sdrmodem_tpu_torch.tools.multihost``
    with MULTIHOST_ARGS on the card (gloo: every hop staged through host
    memory), which must find 0 symbols differing from the one-process run.
    Its kernels launch in its own processes, outside this one's counts."""
    import tempfile

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as base:
        out = pathlib.Path(base) / "multihost.json"
        t0 = time.perf_counter()
        # its own session, so a timeout here stops the tool's workers with it
        proc = subprocess.Popen([sys.executable, "-m", "sdrmodem_tpu_torch.tools.multihost", *MULTIHOST_ARGS,
                                 "--out", str(out), "--timeout", "300"],
                                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                start_new_session=True)
        try:
            _, err = proc.communicate(timeout=420)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        wall = time.perf_counter() - t0
        need(proc.returncode == 0 and out.exists(), f"(p) multihost exited {proc.returncode}: {err[-2000:]}")
        record = json.loads(out.read_text())
    need(record["ok"] and record["mismatched_symbols"] == 0 and record["symbols_compared"] > 0,
         f"(p) {record['mismatched_symbols']} of {record['symbols_compared']} symbols differ across processes")
    log(f"[main] (p) {json.dumps(record)}; {wall:.3f} s in all, three processes started")
    return record


def path_parity(torch, dev):
    """(q) the parity tool, both modes, gated: every fixture within the
    reference's bound (beyond_tol_rate 0, hard decisions 1.0) on the
    production step (B1, B2) and the exact streamer (the float64 FIR, B4)."""
    from sdrmodem_tpu_torch.tools import parity

    report, counts = counted(torch, "(q) parity tool, --mode both", ("front_fused", "clock", "fir_exact", "clock_ragged"),
                             lambda: parity.run(modes=("production", "exact"), device=dev))
    summary = {mode: {name: [r["max_lsb_diff"], r["beyond_tol_rate"], r["hard_decision_agreement"]]
                      for name, r in report[key].items()}
               for mode, key in (("production", "fixtures"), ("exact", "fixtures_exact"))}
    log(f"[main] (q) parity, fixture: [max LSB, beyond +-2 LSB, hard decisions]: {json.dumps(summary)}; "
        f"gates {json.dumps([report['gate'], report['gate_exact']])} [{card()}]")
    need(report["gate"]["pass"] and report["gate_exact"]["pass"],
         f"(q) the parity gate failed: {report['gate']['failures'] + report['gate_exact']['failures']}")
    return report, counts


# path (r): each twin of the JAX tools as ``python -m`` runs it, at a small
# size: (module, arguments, environment, seconds allowed)
PROFILE_ENV = {"SDRM_BENCH_BLOCK": str(SERVER_BLOCK), "SDRM_BENCH_CHANNELS": str(LANES)}
TOOL_RUNS = [
    ("graft_entry", ["--devices", "4"], {}, 180),
    ("perf", [], {}, 180),
    ("latency", ["--reps", "5", "--blocks", "4096,262144"], {}, 180),
    ("ber_sweep", ["--bytes", "512"], {}, 180),
    ("trace", ["--steps", "2", "--out", "{tmp}/trace"], {}, 180),
    ("profile_step", [], PROFILE_ENV, 180),
    ("profile_front", [], PROFILE_ENV, 180),
    ("profile_variants", [], PROFILE_ENV, 180),
]


def run_tool(module, args, env, timeout, tmp):
    """One tool in its own process (its own session, so a timeout stops
    it and its children): (exit code, stdout, stderr, wall seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", f"sdrmodem_tpu_torch.tools.{module}",
                             *(a.format(tmp=tmp) for a in args)],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env={**os.environ, **env}, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        out, err = "", f"timed out after {timeout} s"
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    return proc.returncode, out, err, time.perf_counter() - t0


def path_tools(torch, dev):
    """(r) the twins of the JAX tools and of the dry run, each as ``python -m
    sdrmodem_tpu_torch.tools.<name>`` on the card at a small size under its
    own timeout (TOOL_RUNS): each must exit 0; its report lines and wall
    time are printed.  The dry run runs on 4 repeated cards; the profiles
    at 128 x 262144.  Their kernels launch in the tools' own processes."""
    import tempfile

    (ROOT / "build").mkdir(exist_ok=True)
    walls = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for module, args, env, timeout in TOOL_RUNS:
            rc, out, err, wall = run_tool(module, args, env, timeout, tmp)
            for line in out.strip().splitlines():
                log(f"[main] (r) {module}: {line[:2000]}")
            need(rc == 0, f"(r) {module} exited {rc}: {err[-2000:]}")
            walls[module] = round(wall, 3)
            log(f"[main] (r) {module}: exit 0 in {wall:.3f} s")
    log(f"[main] (r) tools, wall s each: {json.dumps(walls)} [{card()}]")
    return walls


def fast_direct(torch, dev, blocks, settings, starts, lanes, max_batch):
    """Each client's symbols a block from the server's step run directly at
    ``lanes`` lanes, client k on lane k with the Doppler of
    doppler_from_settings(settings, ..., starts[k]), its rows every
    ``max_batch`` samples (None: once a block, as the group steps them)."""
    from sdrmodem_tpu_torch.dsp.doppler import Doppler
    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
    from sdrmodem_tpu_torch.server.session import doppler_from_settings
    from sdrmodem_tpu_torch.utils.convert import doppler_tables_from_numpy, segment_tables

    b, fs = len(blocks[0]), LUCKY7[0]
    pipe = DemodPipeline(FskDemodConfig(*LUCKY7), b, device=dev)
    step = pipe.make_batched_step_full("pallas", doppler=True, layout="fanout")
    dops = {k: doppler_from_settings(settings, fs, DOPPLER["center_freq"], 0, s) for k, s in enumerate(starts)}
    state, out = pipe.init_full_state(lanes), [[] for _ in starts]
    for blk in blocks:
        rows = {k: d.device_segments(b, +1, max_batch=max_batch) for k, d in dops.items()}
        tables = doppler_tables_from_numpy(segment_tables(rows, Doppler.max_rows(b, fs, max_batch), lanes), lanes,
                                           device=dev)
        x = torch.from_numpy(np.stack([blk.real, blk.imag]).astype(np.float32)).to(dev)
        state, sym, cnt = step(state, x, tables)
        sym, cnt = sym.cpu().numpy(), cnt.cpu().numpy()
        for k in range(len(starts)):
            out[k].append(np.concatenate([sym[k, j, : cnt[k, j]] for j in range(cnt.shape[1])]))
    return out


def ragged_clock_cost(c, w, k, symbols):
    """(bytes, flops) of B4: the work buffer, n_valid, ii0, the state and
    the bank read once, the symbol slots, counts and final state written
    once; ~30 flops a symbol this run emitted."""
    words = c * w + 5 * c + 129 * 8 + c * k + c + 4 * c
    return 4 * words, 30 * symbols



def tx_cost(rows, interp, lanes, k, packed):
    """(bytes, flops) of TX over ``rows`` NRZ rows of ``lanes`` streams at
    interpolation I: the NRZ read once (a bit a row packed, else float32),
    the history, taps and float64 phases read once, the complex64 samples
    (and B6's history) written once; a sample needs ~2k + 1 float32 flops
    of FIR and increment, ~40 of sincos and ~6 float64 operations (the
    prefix add and the mod-2-pi wrap), which count here as float32 flops
    scaled by the two rates."""
    samples = rows * interp * lanes
    nrz = rows * lanes // 8 if packed else 4 * rows * lanes
    state = 4 * (k - 1) * lanes * (1 if packed else 2) + 16 * lanes + 4 * k * interp
    f32 = samples * (2 * k + 41)
    f64 = samples * 6
    return 8 * samples + nrz + state, f32 + f64 * F32_FLOP_PER_S / F64_FLOP_PER_S


def tx_kernels(torch, dev, main, check_err):
    """B5 alone at 2048 B and 32 KiB (I = 2) and 32 KiB (I = 60), its row at
    the last; B6 alone at 128 x 2048 B: each against its plain version.
    ``ms`` is the kernels' device time (``graph_ms``); ``wrapper_ms`` the
    time a call of back-to-back wrapper calls, which the host sets at the
    small sizes."""
    from sdrmodem_tpu_torch.ops import tx as tx_ops

    rng = np.random.default_rng(15)
    folded = {}
    for fs, nb in ((TX_FS[0], 2048), (TX_FS[0], TXDATA_MAX), (TX_FS[1], TXDATA_MAX)):
        mod = tx_mod(fs, dev)
        data = torch.from_numpy(rng.integers(0, 256, nb).astype(np.uint8)).to(dev)
        hist = torch.from_numpy(rng.choice([-1.0, 1.0], mod.k - 1).astype(np.float32)).to(dev)
        args = (data, mod.taps, mod.interpolation, mod.config.sensitivity, 1.0, hist)
        tx_ops.gfsk_tx_folded_iq(*args)
        wrapper_ms, _ = cuda_ms(torch, lambda: tx_ops.gfsk_tx_folded_iq(*args), 20)
        ms, (iq, ph) = graph_ms(torch, lambda: tx_ops.gfsk_tx_folded_iq(*args), 20)
        tx_ops.gfsk_tx_folded_iq_plain(*args)
        plain_ms, (iq_p, ph_p) = cuda_ms(torch, lambda: tx_ops.gfsk_tx_folded_iq_plain(*args), 2)
        err = max((iq - iq_p).abs().max().item(), phase_gap(ph, ph_p))
        b, by = bound(*tx_cost(nb * 8, mod.interpolation, 1, mod.k, packed=True))
        folded[f"{nb} B at I = {mod.interpolation}"] = dict(
            ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
            max_abs_err=err, launches_a_call=tx_ops.tx_plan(nb * 8, mod.interpolation, mod.k).launches)
    mod = tx_mod(TX_FS[0], dev)
    nrz = torch.from_numpy(rng.choice([-1.0, 1.0], (2048 * 8, LANES)).astype(np.float32)).to(dev)
    hist = torch.zeros((mod.k - 1, LANES), dtype=torch.float32, device=dev)
    ph0 = torch.zeros(LANES, dtype=torch.float64, device=dev)
    args = (nrz, mod.taps, mod.interpolation, mod.config.sensitivity, ph0, hist)
    tx_ops.gfsk_tx_call(*args)
    wrapper_ms, _ = cuda_ms(torch, lambda: tx_ops.gfsk_tx_call(*args), 20)
    ms, got = graph_ms(torch, lambda: tx_ops.gfsk_tx_call(*args), 20)
    tx_ops.gfsk_tx_call_plain(*args)
    plain_ms, ref = cuda_ms(torch, lambda: tx_ops.gfsk_tx_call_plain(*args), 2)
    need(torch.equal(got[3], ref[3]), "tx at 128 x 2048 B: history differs from plain")
    err = max((got[0] - ref[0]).abs().max().item(), (got[1] - ref[1]).abs().max().item(),
              phase_gap(got[2], ref[2]))
    b, by = bound(*tx_cost(2048 * 8, mod.interpolation, LANES, mod.k, packed=False))
    batched = dict(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                   max_abs_err=err, launches_a_call=tx_ops.tx_plan(2048 * 8, mod.interpolation, mod.k,
                                                                   LANES).launches)
    log(f"[kernels] tx_folded (B5) alone: {json.dumps(folded)}; tx (B6) at 128 x 2048 B: "
        f"{json.dumps(batched)}")
    need(max(err, *(v["max_abs_err"] for v in folded.values())) <= TX_ATOL, "tx kernels at full width")
    row5 = folded[f"{TXDATA_MAX} B at I = {TX_FS[1] // TX_RADIO[0]}"]
    launches = main["totals"]
    return [
        dict(name="tx_folded", route="cuda", source="sdrmodem_tpu_torch/csrc/tx.cu",
             replaces="sdrmodem_tpu/ops/pallas_tx.py:163", launches=launches["tx_folded"],
             max_abs_err=max(check_err["tx_folded"], *(v["max_abs_err"] for v in folded.values())),
             ms=row5["ms"], plain_ms=row5["plain_ms"], bound_ms=row5["bound_ms"],
             bound_by=row5["bound_by"], library_ms=None),
        dict(name="tx", route="cuda", source="sdrmodem_tpu_torch/csrc/tx.cu",
             replaces="sdrmodem_tpu/ops/pallas_tx.py:61", launches=launches["tx"],
             max_abs_err=max(check_err["tx"], err), ms=ms, plain_ms=plain_ms, bound_ms=b,
             bound_by=by, library_ms=None),
    ]


def ragged_kernels(main, check_err):
    """B4's row: its time alone at the ragged step's shape (path (h)), its
    launches over the main paths, its plain version's time at the check
    size (128 x 65536; at the main path's size it would take minutes)."""
    rg, chk = main["ragged"], check_err["ragged"]
    log(f"[kernels] clock_ragged (B4): {rg['b4_ms']:.4f} ms at {rg['b4_shape']} (bound "
        f"{rg['b4_bound'][0]:.4f} ms); at the check size {json.dumps(chk)}; time-major over path "
        f"(a)'s block {main['b4_b2'][0]:.4f} ms (bound {main['b4_b2'][1][0]:.4f} ms), equal to B2; "
        f"at the streamer's block {main['streams']['exact']['b4_ms']:.4f} ms; by lanes x "
        f"{CHECK_BLOCK} {json.dumps(check_err['b4_lanes'])} ms [{card()}]")
    return [dict(
        name="clock_ragged", route="cuda", source="sdrmodem_tpu_torch/csrc/clock.cu",
        replaces="sdrmodem_tpu/ops/pallas_clock.py:104", launches=main["totals"]["clock_ragged"],
        max_abs_err=max(v["max_abs_err"] for v in chk.values()), ms=rg["b4_ms"],
        plain_ms=chk["channel-major"]["plain_ms"], plain_at="128 x 65536, the check size",
        bound_ms=rg["b4_bound"][0], bound_by=rg["b4_bound"][1], library_ms=None,
    )]


PACK_LANES = (128, 512)  # the fast group's widths: pack_lanes' two shapes in phase 5


def pack_cost(c, n, total):
    """(bytes, flops) of pack_lanes on (c, n, K) symbols with ``total``
    valid: the valid symbols read and written once, the counts read by
    both launches, the chunks' offsets written and read, the lanes' totals
    and offsets; no arithmetic worth counting."""
    return 2 * total + 2 * 4 * c * n + 2 * 8 * c * n + 3 * 8 * c, 0


def old_split(sym, cnt):
    """Each lane's symbols as the fast group split them before pack_lanes:
    the valid slots of each chunk, concatenated on the host."""
    return [np.concatenate([sym[k, t, : cnt[k, t]] for t in range(cnt.shape[1])]) for k in range(cnt.shape[0])]


def pack_kernels(torch, dev, main):
    """pack_lanes alone on the server step's own output: the nusat capture
    (its long FIRs and 2.1x LUCKY-7's symbols) through the group's call at
    each of PACK_LANES lanes x SERVER_BLOCK, Doppler rows on every lane.
    The kernel must equal its plain version bit for bit, flat and offsets,
    each lane's run must equal the old per-chunk split of the same output,
    and a call must launch PACK_LAUNCHES kernels.  ``ms`` is the kernels'
    device time (``graph_ms``); ``wrapper_ms`` the time a call of
    back-to-back wrapper calls."""
    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
    from sdrmodem_tpu_torch.ops import pack as pack_ops

    cfg = CHECK_CONFIGS["nusat"]
    pipe = DemodPipeline(FskDemodConfig(*cfg), SERVER_BLOCK, device=dev)
    step = pipe.make_batched_step_full("pallas", doppler=True, layout="fanout")
    iq = np.resize(np.fromfile(FIXTURES / "nusat.cf32", np.complex64), SERVER_BLOCK)
    x = torch.from_numpy(np.stack([iq.real, iq.imag]).astype(np.float32)).to(dev)
    rows = {}
    for c in PACK_LANES:
        tables = doppler_tables(lane_dopplers(range(c), fs=cfg[0]), SERVER_BLOCK, c, dev)
        _, symbols, counts = step(pipe.init_full_state(c), x, tables)
        before = pack_ops.launches
        flat, offsets = pack_ops.pack_lanes(symbols, counts)
        torch.cuda.synchronize()
        launched = pack_ops.launches - before
        need(launched == PACK_LAUNCHES, f"pack at {c} lanes: {launched} launches a call")
        plain_ms, (want, want_off) = cuda_ms(torch, lambda: pack_ops.pack_lanes_plain(symbols, counts), 3)
        total = int(want_off[-1].item())
        need(torch.equal(offsets, want_off) and torch.equal(flat[:total], want),
             f"pack at {c} lanes: the kernel differs from its plain version")
        flat_h, off_h = flat[:total].cpu().numpy(), offsets.cpu().numpy()
        old = old_split(symbols.cpu().numpy(), counts.cpu().numpy())
        need(all(np.array_equal(flat_h[off_h[k] : off_h[k + 1]], old[k]) for k in range(c)),
             f"pack at {c} lanes: a lane's run differs from the old per-chunk split")
        wrapper_ms, _ = cuda_ms(torch, lambda: pack_ops.pack_lanes(symbols, counts), 200)
        ms, _ = graph_ms(torch, lambda: pack_ops.pack_lanes(symbols, counts), 200)
        b, by = bound(*pack_cost(c, counts.shape[1], total))
        rows[c] = dict(shape=list(symbols.shape), strides=list(symbols.stride()), symbols=total,
                       ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                       launches_a_call=launched)
        del symbols, counts, flat, offsets, want, want_off
    log(f"[kernels] pack on the nusat step's output, bit for bit against its plain version and "
        f"the old per-chunk split: {json.dumps(rows)} [{card()}]")
    row = rows[PACK_LANES[0]]
    return [dict(
        name="pack", route="cuda", source="sdrmodem_tpu_torch/csrc/pack.cu",
        replaces="sdrmodem_tpu/server/session.py:555 (a host loop; no TPU kernel)",
        launches=main["totals"]["pack"], launches_a_call=row["launches_a_call"], max_abs_err=0.0,
        ms=row["ms"], wrapper_ms=row["wrapper_ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=None, shape=row["shape"],
        lanes_ms={str(c): r["ms"] for c, r in rows.items()},
        lanes_bound_ms={str(c): r["bound_ms"] for c, r in rows.items()},
    )]


def step_args(state, taps, bank, p, dop=None):
    """fused_step's arguments for a fresh pipeline state, chunk 1024."""
    from sdrmodem_tpu_torch.dsp.clock_recovery import max_symbols
    from sdrmodem_tpu_torch.ops.step import DEFAULT_CHUNK

    ck = state.clock
    kw = dict(chunk=DEFAULT_CHUNK, omega_mid=p["omega"], omega_relative_limit=p["omega_relative_limit"],
              gain_omega=p["gain_omega"], gain_mu=p["gain_mu"], dop=dop,
              num_symbols=max_symbols(DEFAULT_CHUNK + ck.suffix.shape[0], p["omega"],
                                      p["omega_relative_limit"], p["gain_mu"]))
    return (*state[:4], ck.suffix, ck.omega, ck.mu, ck.last_sample, ck.resid, taps, bank), kw


def check_step_plain(torch, dev):
    """B7 against its plain version at 128 lanes x 65536: one block of the
    lucky7 capture without Doppler, bit for bit (outputs and state), and one
    of the raw pass with each lane's Doppler rows, where the mixed block's
    cos and sin come from two libraries (an ulp apart): the counts equal,
    int8 symbols within 1 LSB, the front's tails within B1's bounds.
    Returns (the plain version's ms without Doppler, the largest symbol
    error)."""
    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig, float_to_int8
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
    from sdrmodem_tpu_torch.ops import step as step_ops

    pipe = DemodPipeline(FskDemodConfig(*LUCKY7), CHECK_BLOCK, device=dev)
    p = pipe.config.clock_params()
    state = pipe.init_full_state(LANES)
    err, plain_ms = {}, None
    for capture, dop in (("lucky7.expected.cf32", None),
                         ("lucky7.cf32", doppler_tables(lane_dopplers(range(LANES)), CHECK_BLOCK, LANES, dev))):
        x = capture_lanes(torch, dev, CHECK_BLOCK, LANES, capture)
        args, kw = step_args(state, pipe.front_taps, pipe.bank, p, dop)
        got = step_ops.fused_step(x, *args, **kw)
        ms, want = cuda_ms(torch, lambda: step_ops.fused_step_plain(x, *args, **kw), 1)
        (o, c, _, f, ck), (o_p, c_p, _, f_p, ck_p) = got, want
        tag = "doppler" if dop is not None else "no doppler"
        err[tag] = (o - o_p).abs().max().item() if torch.equal(c, c_p) else float("inf")
        lsb = (float_to_int8(o).int() - float_to_int8(o_p).int()).abs().max().item()
        if dop is None:
            plain_ms = ms
            need(torch.equal(o, o_p) and torch.equal(c, c_p)
                 and all(torch.equal(a, b) for a, b in zip(f, f_p))
                 and all(torch.equal(ck[k], ck_p[k]) for k in ck),
                 "step: the kernel differs from its plain version without Doppler")
        else:
            tails = dict(mixed_tail=(f[0] - f_p[0]).abs().max().item(),
                         quad_prev=(f[1] - f_p[1]).abs().max().item(),
                         lpf2=(f[2] - f_p[2]).abs().max().item(), dc=(f[3] - f_p[3]).abs().max().item(),
                         suffix=(ck["suffix"] - ck_p["suffix"]).abs().max().item())
            log(f"[kernels] step vs plain with Doppler: int8 symbols {lsb} LSB apart, tails "
                f"{json.dumps(tails)}, resid equal {bool(torch.equal(ck['resid'], ck_p['resid']))}")
            need(torch.equal(c, c_p) and lsb <= 1, f"step with Doppler: counts or symbols ({lsb} LSB) "
                 "differ from the plain version")
            need(tails["mixed_tail"] <= MIXED_ATOL and tails["quad_prev"] <= 1e-6
                 and max(tails["lpf2"], tails["dc"], tails["suffix"]) <= FRONT_ATOL,
                 f"step with Doppler: tails {tails}")
    log(f"[kernels] step (B7) against its plain version at {LANES} x {CHECK_BLOCK}: without Doppler "
        f"equal bit for bit (plain {plain_ms:.1f} ms); max |kernel - plain| on the symbols {json.dumps(err)}")
    return plain_ms, max(err.values())


def b2_lanes(torch, pipe, y3):
    """B2 alone on phase 5's y3 (2^19 rows of 128 lanes, with Doppler)
    tiled to each of B2_LANES, from a fresh state, each at the JAX
    package's chunk for its lanes (2048, 512, 256 and 64 rows): whether
    lanes past the card's 132 SMs are free.  Every tiled lane's symbols
    must equal its 128-lane original's bit for bit (on this y3 no stride
    runs back past a chunk's first row and no chunk fills its slots, so
    the partition only moves symbols between rows).  Returns {lanes: ms}."""
    from sdrmodem_tpu_torch.dsp.clock_recovery import clock_mm_batched_full

    p = pipe.config.clock_params()
    c0, n = y3.shape[1], y3.shape[0]
    res, base = {}, None
    for lanes in B2_LANES:
        y = y3.repeat(1, lanes // c0)
        st = pipe.init_full_state(lanes).clock
        clock_mm_batched_full(y, st, bank=pipe.bank, **p)  # warm-up
        ms, (outs, counts, _) = cuda_ms(torch, lambda: clock_mm_batched_full(y, st, bank=pipe.bank, **p), 3)
        k = outs.shape[2]
        flat = outs[torch.arange(k, device=y.device)[None, None, :] < counts[:, :, None]]
        totals = counts.sum(1)
        if base is None:
            base = (flat, totals)
        r = lanes // c0
        need(torch.equal(totals, base[1].repeat(r)) and torch.equal(flat, base[0].repeat(r)),
             f"B2 at {lanes} lanes differs from the {c0}-lane run")
        symbols = int(totals.sum().item())
        bnd = bound(*clock_cost(n, lanes, st.suffix.shape[0], counts.shape[1], k, symbols))
        res[lanes] = ms
        log(f"[kernels] B2 lanes (chunk {n // counts.shape[1]}): {b4_time(ms, f'{lanes} x {n}', totals, bnd)}")
        del y, outs, counts, flat
    return res


def server_lanes(torch, dev):
    """Path (b)'s step (Doppler rows on every lane) at each of SERVER_LANES,
    front "fused" and then "step" (B7) on the same tables, one warm-up and
    MAIN_STEPS timed steps each, outside the counted runs; every "step" run
    must equal its "fused" run bit for bit.  Returns ({lanes: ms a step}
    with "fused", {lanes: ms a step} with "step")."""
    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline

    bs = SERVER_BLOCK
    spipe = DemodPipeline(FskDemodConfig(*LUCKY7), bs, device=dev)
    raw = capture_lanes(torch, dev, bs, 1, "lucky7.cf32")
    x_srv = torch.stack([raw[:, 0], raw[:, 1]]).contiguous()
    res = {"fused": {}, "step": {}}
    for lanes in SERVER_LANES:
        dops = lane_dopplers(range(lanes))
        tables = [doppler_tables(dops, bs, lanes, dev) for _ in range(MAIN_STEPS + 1)]
        runs = {}
        for front in res:
            step = spipe.make_batched_step_full("pallas", doppler=True, layout="fanout", front=front)
            ms, first, outs, fin = drive(torch, step, spipe.init_full_state(lanes), [(x_srv, t) for t in tables])
            need(int(first[1].sum().item()) > 0.9 * lanes * (bs // 2) / 5,
                 f"(b) {front} at {lanes} lanes: too few symbols")
            res[front][lanes] = ms
            runs[front] = (first, outs, fin)
            log(f"[kernels] (b) server step, front={front}, at {lanes} lanes x {bs}: {ms:.4f} ms/step (CUDA "
                f"events), {lanes * bs / (ms * 1e-3) / 1e6:.1f} Msamples/s [{card()}]")
        hold_step(torch, f"(b) front=step at {lanes} lanes", runs["step"], runs["fused"])
        del runs
    return res["fused"], res["step"]


def phase_kernels(torch, dev, main):
    """Each kernel alone at its path's shape, against its plain version."""
    import torch.nn.functional as F

    from sdrmodem_tpu_torch.dsp.clock_recovery import chunk_plan, clock_mm_batched_full
    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
    from sdrmodem_tpu_torch.ops import _build
    from sdrmodem_tpu_torch.ops import clock as clock_ops
    from sdrmodem_tpu_torch.ops import fir as fir_ops
    from sdrmodem_tpu_torch.ops import front as front_ops
    from sdrmodem_tpu_torch.ops import step as step_ops

    c, b = LANES, MAIN_BLOCK
    pipe = DemodPipeline(FskDemodConfig(*LUCKY7), b, device=dev)
    p = pipe.config.clock_params()
    taps = pipe.front_taps
    x_tm = capture_lanes(torch, dev, b, c, "lucky7.cf32")
    state = pipe.init_full_state(c)
    dop = doppler_tables(lane_dopplers(range(c)), b, c, dev)
    s_rows = dop[0].shape[0]
    torch.cuda.synchronize()

    # ---- front (B1) with its Doppler stage, 128 x 2^20
    front_args = (x_tm, *state[:4], taps, dop)
    front_ops.fused_front(*front_args)  # warm-up
    front_ms, (y3, f_k) = cuda_ms(torch, lambda: front_ops.fused_front(*front_args), 3)
    nodop_ms, (y3_0, _) = cuda_ms(torch, lambda: front_ops.fused_front(*front_args[:-1]), 3)
    front_ops.fused_front_plain(*front_args)
    front_plain_ms, (y3_p, f_p) = cuda_ms(torch, lambda: front_ops.fused_front_plain(*front_args), 2)
    front_err = (y3 - y3_p).abs().max().item()
    mixed_err = (f_k[0] - f_p[0]).abs().max().item()
    need(front_err <= FRONT_ATOL and mixed_err <= MIXED_ATOL,
         f"front with Doppler at full width: y3 {front_err}, mixed tail {mixed_err}")
    nco = {}
    for rows in (SERVER_BLOCK, MAIN_BLOCK):
        xs = x_tm[:rows]
        dop_s = dop if rows == b else doppler_tables(lane_dopplers(range(c)), rows, c, dev)
        front_ops.nco_mix(xs, dop_s)
        nco[rows], _ = cuda_ms(torch, lambda: front_ops.nco_mix(xs, dop_s), 5)
        nco[f"{rows}_rows"] = dop_s[0].shape[0]
        nco[f"{rows}_bound"] = bound(*nco_cost(rows, c, dop_s))
    # its first launch alone (lucky7_nodc: NCO to LPF2, y2 out) and the DC launch alone on that y2
    nodc = DemodPipeline(FskDemodConfig(*CHECK_CONFIGS["lucky7_nodc"]), b, device=dev)
    nodc_args = (x_tm, *nodc.init_full_state(c)[:4], nodc.front_taps, dop)
    front_ops.fused_front(*nodc_args)
    nodc_ms, (y2, _) = cuda_ms(torch, lambda: front_ops.fused_front(*nodc_args), 3)
    front_ops.dc_fir(y2, state.dc_hist, taps)
    dc_ms, y3_dc = cuda_ms(torch, lambda: front_ops.dc_fir(y2, state.dc_hist, taps), 3)
    need(torch.equal(y3_dc, y3), "the DC launch on lucky7_nodc's output differs from lucky7's y3")
    # the same FIR through B3's wide form on [dc_hist | y2]: the same order, so the same bits
    dc_work = torch.cat([state.dc_hist, y2])
    n2 = y2.shape[0]
    fir_ops.conv1d_banded_tm(dc_work, taps.rev_dc, 1, n2)
    dc_wide_ms, y3_w = cuda_ms(torch, lambda: fir_ops.conv1d_banded_tm(dc_work, taps.rev_dc, 1, n2), 3)
    need(torch.equal(y3_w, y3), "B3's wide form at the DC launch's shape differs from B1's DC launch")
    dc_bound = bound(*fir_cost(dc_work.shape[0], c, n2, taps.rev_dc.numel()))
    log(f"[kernels] the DC FIR at {c} x {n2} ({taps.rev_dc.numel()} taps): B1's DC launch "
        f"(fir_blocked_tm_kernel) {dc_ms:.4f} ms, B3's wide form {dc_wide_ms:.4f} ms, equal bit for bit; "
        f"bound {dc_bound[0]:.4f} ms by {dc_bound[1]} [{card()}]")
    del dc_work, y3_w
    log(f"[kernels] front (B1) at {c} x {b}: with Doppler ({s_rows} rows) {front_ms:.4f} ms, without "
        f"{nodop_ms:.4f} ms; lucky7_nodc with Doppler (launch 1 alone) {nodc_ms:.4f} ms; the DC launch "
        f"alone {dc_ms:.4f} ms, equal to the front's y3 bit for bit [{card()}]; the banded route's NCO "
        f"stage alone {json.dumps(nco)} (ms, table rows and bound, at 128 lanes x rows)")
    del y3_p, f_p, y3_0, y2, y3_dc, nodc_args

    # ---- fir (B3) at the LPF1 shape: [lpf1_hist | block], 2^20 x 256 x 157 taps
    work = torch.cat([state.lpf1_hist, x_tm])
    t1 = taps.rev1.numel()
    fir_ops.conv1d_banded_tm(work, taps.rev1, 1, b)
    fir_ms, y1 = cuda_ms(torch, lambda: fir_ops.conv1d_banded_tm(work, taps.rev1, 1, b), 3)
    fir_ops.conv1d_banded_tm_plain(work, taps.rev1, 1, b)
    fir_plain_ms, y1_p = cuda_ms(torch, lambda: fir_ops.conv1d_banded_tm_plain(work, taps.rev1, 1, b), 2)
    fir_err = (y1 - y1_p).abs().max().item()
    need(fir_err <= FRONT_ATOL, f"fir at the LPF1 shape: {fir_err}")
    del y1, y1_p
    work_cn = work.T.contiguous().unsqueeze(1)
    w1 = taps.rev1.view(1, 1, -1)
    with torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False):
        F.conv1d(work_cn, w1)
        lib_ms, _ = cuda_ms(torch, lambda: F.conv1d(work_cn, w1), 3)
    del work_cn

    # ---- B3 and the float64 FIR at one client's shapes (paths (f), (g)): one
    # block of 262144, LPF1 on I and Q, LPF2 at d = 2, the DC FIR
    bs = SERVER_BLOCK
    t2s, t3s = taps.rev2.numel(), taps.rev_dc.numel()
    shapes = {"lpf1": (x_tm[: bs + t1 - 1, [0, c]].contiguous(), taps.rev1, 1, bs),
              "lpf2": (x_tm[: bs + t2s - 1, :1].contiguous(), taps.rev2, 2, bs // 2),
              "dc": (x_tm[: bs // 2 + t3s - 1, :1].contiguous(), taps.rev_dc, 1, bs // 2)}
    stream = {}
    for name, (xs, rev, stride, n_out) in shapes.items():
        nbytes, flops = fir_cost(xs.shape[0], xs.shape[1], n_out, rev.numel())
        x_cn = xs.T.contiguous().unsqueeze(1)
        for kind, fn, plain_fn, rate, dtype in (
                ("f32", fir_ops.conv1d_banded_tm, fir_ops.conv1d_banded_tm_plain, F32_FLOP_PER_S, torch.float32),
                ("f64", fir_ops.conv1d_exact_tm, fir_ops.conv1d_exact_tm_plain, F64_FLOP_PER_S, torch.float64)):
            call = functools.partial(fn, xs, rev, stride, n_out)
            call()
            ms, y = graph_ms(torch, call, 20)
            wrapper_ms, _ = cuda_ms(torch, call, 20)
            plain_ms, y_p = cuda_ms(torch, functools.partial(plain_fn, xs, rev, stride, n_out), 2)
            e = (y - y_p).abs().max().item()
            need(e <= FRONT_ATOL and (kind == "f32" or torch.equal(y, y_p)),
                 f"{name} {kind} at one client's shape differs from its plain version ({e})")
            lib_x, lib_w = x_cn.to(dtype), rev.view(1, 1, -1).to(dtype)
            with torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False):
                F.conv1d(lib_x, lib_w, stride=stride)
                lib = cuda_ms(torch, lambda: F.conv1d(lib_x, lib_w, stride=stride), 20)[0]
            b_ms, b_by = bound(nbytes, flops, rate)
            stream[f"{name} {kind}"] = dict(shape=f"{xs.shape[1]} x {xs.shape[0]}, T={rev.numel()}, "
                                                  f"stride {stride}", ms=ms, wrapper_ms=wrapper_ms,
                                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                                            max_abs_err=e)
    block64 = sum(v["ms"] for k, v in stream.items() if k.endswith("f64"))
    log(f"[kernels] B3 (f32) and the float64 FIR at one client's shapes (ms: device time of one call "
        f"alone from a CUDA graph, the wrapper's time a call back to back, plain, bound, conv1d): "
        f"{json.dumps(stream)}; the three float64 FIRs of one block {block64:.4f} ms [{card()}]")

    # ---- fir_tpu (B8) at path (c)'s shape
    x_fir, lpf2 = main["x_fir"], main["lpf2"]
    fir_ops.fir_tpu_plain(x_fir, lpf2, 2)
    fir_tpu_plain_ms, y_p = cuda_ms(torch, lambda: fir_ops.fir_tpu_plain(x_fir, lpf2, 2), 2)
    fir_tpu_err = (main["y_fir"] - y_p).abs().max().item()
    need(fir_tpu_err <= FRONT_ATOL, f"fir_tpu at full width: {fir_tpu_err}")
    t2 = len(lpf2)
    xp_cn = F.pad(x_fir.T.contiguous().unsqueeze(1), (t2 - 1, 0))
    w2 = torch.from_numpy(lpf2[::-1].copy()).to(dev).view(1, 1, -1)
    with torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False):
        F.conv1d(xp_cn, w2, stride=2)
        fir_tpu_lib_ms, _ = cuda_ms(torch, lambda: F.conv1d(xp_cn, w2, stride=2), 3)
    del xp_cn, y_p

    # ---- clock (B2) on the front's y3
    ck = state.clock
    clock_ms, (outs, counts, ck_fin) = cuda_ms(
        torch, lambda: clock_mm_batched_full(y3, ck, bank=pipe.bank, **p), 3
    )
    plan = chunk_plan(*y3.shape, ck.suffix.shape[0], **p)
    t0 = time.perf_counter()
    clock_plain_ms, (o_p, c_p, fin_p) = cuda_ms(
        torch,
        lambda: clock_ops.clock_mm_chunked_plain(
            y3, ck.suffix, ck.omega, ck.mu, ck.last_sample, ck.resid, pipe.bank, **plan
        ),
        1,
    )
    log(f"[kernels] plain clock at full width took {time.perf_counter() - t0:.3f} s wall")
    need(torch.equal(counts, c_p.T), "clock at full width: counts differ from plain")
    clock_err = (outs - o_p.permute(2, 0, 1)).abs().max().item()
    need(torch.equal(outs, o_p.permute(2, 0, 1)) and all(
        torch.equal(a, b) for a, b in zip((ck_fin.omega, ck_fin.mu, ck_fin.last_sample, ck_fin.resid), fin_p)),
        f"B2 at full width differs from its plain version (max |diff| {clock_err})")
    symbols = int(counts.sum().item())
    del o_p, c_p
    lanes = b2_lanes(torch, pipe, y3)
    lanes["server step"], server_step_ms = server_lanes(torch, dev)

    # ---- step (B7): the same front with Doppler and clock in one launch,
    # bit for bit against the pair just run (B1 with Doppler, then B2)
    s_args, s_kw = step_args(state, taps, pipe.bank, p, dop)
    step_ops.fused_step(x_tm, *s_args, **s_kw)  # warm-up
    step_ms, (s_outs, s_counts, _, s_front, s_clock) = cuda_ms(
        torch, lambda: step_ops.fused_step(x_tm, *s_args, **s_kw), 3)
    pair_state = (*f_k, ck_fin.omega, ck_fin.mu, ck_fin.last_sample, ck_fin.resid, ck_fin.suffix)
    step_state = (*s_front, *(s_clock[k] for k in ("omega", "mu", "last", "resid", "suffix")))
    need(same_stream(torch, (s_outs.permute(2, 0, 1), s_counts.T), (outs, counts))
         and all(torch.equal(a, b) for a, b in zip(step_state, pair_state)),
         "step at 128 x 2^20 with Doppler differs from the front (B1) and the clock (B2)")
    step_plain_ms, step_err = check_step_plain(torch, dev)
    s_bound, s_by = bound(*step_cost(c, b, taps, pipe.config.decimation, dop, ck.suffix.shape[0],
                                     s_outs.shape[0], s_outs.shape[1], int(s_counts.sum().item())))
    # the shared memory the launch asks for, from the kernel's own Layout
    s_shared = _build.load("step", step_ops._SIGNATURES).step_shared_bytes(
        t1, taps.rev2.numel(), taps.rev_dc.numel(), pipe.config.decimation, step_ops.DEFAULT_CHUNK,
        ck.suffix.shape[0])
    log(f"[kernels] step (B7) at {c} x {b} with Doppler ({s_rows} rows) {step_ms:.4f} ms, equal to "
        f"B1 + B2 bit for bit; the pair {front_ms:.4f} + {clock_ms:.4f} = {front_ms + clock_ms:.4f} ms, "
        f"the chain's floor (B2 alone on the same y3) {clock_ms:.4f} ms, B7 {step_ms / clock_ms:.3f}x it; "
        f"bound {s_bound:.4f} ms by {s_by}; {s_shared} bytes of shared memory a block; main-path steps "
        f"{json.dumps(main['step_ms'])} ms [{card()}]")
    del s_outs, s_counts, s_front, s_clock, step_state, pair_state

    f_bound, f_by = bound(*front_cost(c, b, taps, pipe.config.decimation, dop))
    fd_bound, fd_by = bound(*front_fir_cost(c, b, taps, pipe.config.decimation, dop))
    c_bound, c_by = bound(*clock_cost(y3.shape[0], c, ck.suffix.shape[0], counts.shape[1],
                                      plan["num_symbols"], symbols))
    r_bound, r_by = bound(*fir_cost(work.shape[0], 2 * c, b, t1))
    n_fir = main["y_fir"].shape[0]
    t_bound, t_by = bound(*fir_cost(x_fir.shape[0], c, n_fir, t2))
    log(f"[kernels] front {front_ms:.4f} ms (plain {front_plain_ms:.4f}, conv1d LPF1 {lib_ms:.4f}, "
        f"bound {f_bound:.4f} by {f_by}, {fd_bound:.4f} by {fd_by} with the DC as a FIR); clock {clock_ms:.4f} ms (plain {clock_plain_ms:.4f}, "
        f"bound {c_bound:.4f} by {c_by}); fir {fir_ms:.4f} ms (plain {fir_plain_ms:.4f}, conv1d "
        f"{lib_ms:.4f}, bound {r_bound:.4f} by {r_by}); fir_tpu {main['fir_tpu_ms']:.4f} ms (plain "
        f"{fir_tpu_plain_ms:.4f}, conv1d {fir_tpu_lib_ms:.4f}, bound {t_bound:.4f} by {t_by}); "
        f"{symbols} symbols")
    launches = main["totals"]
    # each row's error: the most over its comparisons at the paths' shapes
    front_err = max(front_err, main["front_err"])
    fir_err = max(fir_err, main["fir_err"])
    return [
        dict(name="front", route="cuda", source="sdrmodem_tpu_torch/csrc/front.cu",
             replaces="sdrmodem_tpu/ops/pallas_front.py:118", launches=launches["front_fused"],
             max_abs_err=front_err, ms=front_ms, plain_ms=front_plain_ms, bound_ms=f_bound,
             bound_by=f_by, library_ms=lib_ms, bound_dc_fir_ms=fd_bound, bound_dc_fir_by=fd_by,
             nodop_ms=nodop_ms, nodc_ms=nodc_ms, dc_ms=dc_ms, dc_bound_ms=dc_bound[0]),
        dict(name="clock", route="cuda", source="sdrmodem_tpu_torch/csrc/clock.cu",
             replaces="sdrmodem_tpu/ops/pallas_clock.py:326", launches=launches["clock"],
             max_abs_err=clock_err, ms=clock_ms, plain_ms=clock_plain_ms, bound_ms=c_bound,
             bound_by=c_by, library_ms=None, lanes_ms=lanes),
        dict(name="fir", route="cuda", source="sdrmodem_tpu_torch/csrc/fir.cu",
             replaces="sdrmodem_tpu/ops/pallas_fir.py:119", launches=launches["fir"],
             max_abs_err=fir_err, ms=fir_ms, plain_ms=fir_plain_ms, bound_ms=r_bound,
             bound_by=r_by, library_ms=lib_ms, dc_shape_ms=dc_wide_ms,
             stream_ms={k: v["ms"] for k, v in stream.items() if k.endswith("f32")}),
        dict(name="fir_exact", route="cuda", source="sdrmodem_tpu_torch/csrc/fir.cu",
             replaces="sdrmodem_tpu/dsp/fir.py:71", launches=launches["fir_exact"], max_abs_err=0.0,
             ms=stream["lpf1 f64"]["ms"], plain_ms=stream["lpf1 f64"]["plain_ms"],
             bound_ms=stream["lpf1 f64"]["bound_ms"], bound_by=stream["lpf1 f64"]["bound_by"],
             library_ms=stream["lpf1 f64"]["library_ms"], shape=stream["lpf1 f64"]["shape"],
             lpf2_ms=stream["lpf2 f64"]["ms"], dc_ms=stream["dc f64"]["ms"], block_ms=block64),
        dict(name="fir_tpu", route="cuda", source="sdrmodem_tpu_torch/csrc/fir.cu",
             replaces="sdrmodem_tpu/ops/pallas_fir.py:261", launches=launches["fir_tpu"],
             max_abs_err=fir_tpu_err, ms=main["fir_tpu_ms"], plain_ms=fir_tpu_plain_ms,
             bound_ms=t_bound, bound_by=t_by, library_ms=fir_tpu_lib_ms),
        dict(name="step", route="cuda", source="sdrmodem_tpu_torch/csrc/step.cu",
             replaces="sdrmodem_tpu/ops/pallas_step.py:89", launches=launches["step"],
             max_abs_err=step_err, ms=step_ms, plain_ms=step_plain_ms,
             plain_at=f"{LANES} x {CHECK_BLOCK}, the check size", bound_ms=s_bound, bound_by=s_by,
             library_ms=None, chain_ms=clock_ms, server_ms=server_step_ms),
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
        done = {}
        for name, fn in (("build", phase_build), ("check", lambda: phase_check(torch, dev)),
                         ("golden", lambda: phase_golden(torch, dev)),
                         ("main", lambda: phase_main(torch, dev)),
                         ("kernels", lambda: phase_kernels(torch, dev, done["main"])
                          + tx_kernels(torch, dev, done["main"], done["check"])
                          + ragged_kernels(done["main"], done["check"])
                          + pack_kernels(torch, dev, done["main"]))):
            t0 = time.perf_counter()
            done[name] = fn()
            log(f"[{name}] passed in {time.perf_counter() - t0:.3f} s")
        kernels = done["kernels"]
    except SmokeError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    log(f"[total] {time.perf_counter() - t_all:.3f} s")
    print(card())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
