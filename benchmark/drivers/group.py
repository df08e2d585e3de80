"""Driver ``group``: the fast group as the server serves it.

The entry is ``BatchedRxGroup.feed`` (``server/session.py``) with
``lanes`` fast-mode ``RxSession``s attached, each built from a wire
``RxRequest`` as the server builds it: the configuration's radio, the
pass's TLE and ground station as ``DopplerSettings``, and a start time
drawn from the seed (``FileSettings.start_time_seconds``).  Each session
writes to an in-memory writer (``write`` / ``drain``) in place of its
socket.  The group works as in the server: blocks queue to its worker, the
worker takes each lane's Doppler rows on the host (SGP4 once a second of
signal), steps the card, copies the symbols back and emits each lane's.

The traffic is a closed loop of one block: the next block is fed once
every client has its symbols of the one before.  A block's latency is the
time from its ``feed`` call to the last client's write of its symbols;
``served_msps`` is the lane-samples of every block over the whole window.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np

from benchmark import check, core, gen, tracing
from benchmark.reference.doppler import max_rows, tables
from benchmark.reference.fsk import Radio

WAIT_S = 60.0  # a block's symbols that take longer than this never came


class Clients:
    """Where the clients' symbols land: when each block's last client has
    written, and the bytes of the lanes and blocks the check reads."""

    def __init__(self, lanes: int, check_lanes):
        self.lanes = lanes
        self.check = {int(c) for c in check_lanes}
        self.block = -1
        self.count = 0
        self.done = asyncio.Event()
        self.t_done = 0.0
        self.bytes: dict[int, dict[int, bytes]] = {}  # block -> lane -> the bytes it got

    def start(self, block: int):
        self.block, self.count = block, 0
        self.t_done = 0.0
        self.done.clear()
        self.bytes[block] = {}

    def writer(self, lane: int) -> "Writer":
        return Writer(self, lane)

    def wrote(self, lane: int, data: bytes):
        if lane in self.check:
            self.bytes[self.block][lane] = bytes(data)
        self.count += 1
        if self.count == self.lanes:
            self.t_done = time.perf_counter()
            self.done.set()


class Writer:
    """A client's socket: ``write`` and ``drain`` as asyncio's
    ``StreamWriter`` has them."""

    def __init__(self, clients: Clients, lane: int):
        self.clients, self.lane = clients, lane

    def write(self, data: bytes):
        self.clients.wrote(self.lane, data)

    async def drain(self):
        pass


def run(cell, *, seed: int, seconds: float, trace: bool, device, t_start: float, trace_path=None,
        fault=None, control: bool = False, phases=None) -> dict:
    return asyncio.run(_run(cell, seed=seed, seconds=seconds, trace=trace, device=device,
                            t_start=t_start, trace_path=trace_path, fault=fault, control=control,
                            phases=phases))


async def _run(cell, *, seed, seconds, trace, device, t_start, trace_path, fault, control, phases) -> dict:
    import torch

    from sdrmodem_tpu_torch.server import wire
    from sdrmodem_tpu_torch.server.config import RxSdrType, ServerConfig
    from sdrmodem_tpu_torch.server.session import BatchedRxGroup, RxSession

    phases = core.Phases(t_start) if phases is None else phases
    cfg, mix = cell.config, cell.mix
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    lanes, block, ring = int(mix["lanes"]), int(mix["block"]), int(mix["ring"])
    r, p = cfg["radio"], cfg["pass"]
    if cuda:
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)  # the context, before its counters are reset
        torch.cuda.reset_peak_memory_stats(dev)
    phases.mark("modules")  # the port's modules this driver takes

    # ---- set-up: the stream, the clients, the group, one warm-up block
    blocks = gen.stream_blocks(cfg, mix, seed)
    starts = gen.client_starts(cfg, mix, seed)
    check_lanes = gen.sample_lanes(lanes, int(mix["check_lanes"]), seed)
    server = ServerConfig()
    server.demod_mode = "fast"
    server.buffer_size = block
    server.rx_sdr_type = RxSdrType.FILE  # a blocking queue: no block is dropped

    def request(start):
        return wire.RxRequest(
            rx_center_freq=int(p["center_freq"]), rx_sampling_freq=int(r["sampling_freq"]),
            demod_baud_rate=int(r["baud_rate"]), demod_decimation=int(r["decimation"]),
            demod_destination=wire.DemodDestination.SOCKET,
            doppler=wire.DopplerSettings(tle=list(p["tle"]), latitude=int(round(p["latitude"] * 1e7)),
                                         longitude=int(round(p["longitude"] * 1e7)),
                                         altitude=int(round(p["altitude_km"] * 1e4))),
            fsk_settings=wire.FskDemodulationSettings(
                demod_fsk_deviation=int(r["deviation"]), demod_fsk_transition_width=int(r["transition_width"]),
                demod_fsk_use_dc_block=bool(r["use_dc_block"])),
            file_settings=wire.FileSettings(filename="", start_time_seconds=int(start)))

    def serve(clients):
        """The clients' sessions, attached to a new group on the card."""
        sessions = [RxSession(i, request(starts[i]), server, clients.writer(i), dsp_device=dev)
                    for i in range(lanes)]
        group = BatchedRxGroup(sessions[0].fsk_config, block, blocking=True,
                               queue_capacity=server.queue_size, device=dev)
        if fault is not None:
            group._steps = [fault(s) for s in group._steps]
        for s in sessions:
            group.attach(s)
        return group, sessions

    phases.mark("traffic")
    warm_clients = Clients(lanes, [])
    group, sessions = serve(warm_clients)
    phases.mark("sessions")
    for k in range(int(mix["warmup_steps"])):
        warm_clients.start(k)
        await group.feed(blocks[k % ring])
        await asyncio.wait_for(warm_clients.done.wait(), WAIT_S)
    await group.close()
    for s in sessions:
        s.finish_fast()
    del group, sessions

    phases.mark("warmup")  # the kernels loaded (built on a checkout's first run), the warm-up blocks
    clients = Clients(lanes, check_lanes)
    group, sessions = serve(clients)
    step_lanes = group.LANES  # the step's width, which sets its clock chunks
    if cuda:
        torch.cuda.synchronize(dev)
    res = gen.Reservoir(int(mix["check_blocks"]), seed)
    kept_states: dict[int, object] = {}

    def wanted(j):
        return j < 2 or any(j in (i, i + 1) for i in res.items)

    phases.mark("sessions")  # the window's own sessions and group, on a fresh state
    setup_s = time.perf_counter() - t_start

    # ---- the window: one block at a time, fed once the last has landed
    lat = []
    k = failed = 0
    prev_state = None
    with tracing.traced(torch, trace, trace_path):
        with tracing.span(torch, tracing.WINDOW, trace):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                if k >= 2:  # block k-1 is done: it may start a sampled pair
                    _, old = res.offer(k - 1)
                    if k - 1 in res.items:
                        kept_states[k - 1] = prev_state
                    if old is not None:
                        kept_states.pop(old, None)
                    for j in (k - 1, *(() if old is None else (old, old + 1))):
                        if not wanted(j):
                            clients.bytes.pop(j, None)
                prev_state = group.state
                clients.start(k)  # its bytes kept until it is known whether the check needs them
                tf = time.perf_counter()
                with tracing.span(torch, "bench.feed", trace):
                    await group.feed(blocks[k % ring])
                try:
                    with tracing.span(torch, "bench.wait", trace):
                        await asyncio.wait_for(clients.done.wait(), WAIT_S)
                except asyncio.TimeoutError:
                    failed += 1
                    k += 1
                    break
                lat.append(clients.t_done - tf)
                k += 1
            window_s = time.perf_counter() - t0
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    await group.close()
    for s in sessions:
        s.finish_fast()
    kept = {j: check.ref_state(s, check_lanes) for j, s in kept_states.items()}
    kept_states.clear()
    del group, sessions, prev_state
    if cuda:
        torch.cuda.empty_cache()

    # ---- the check: each sampled client's Doppler rows and bytes
    radio = Radio.from_config(cfg)
    s_rows = max_rows(block, int(r["sampling_freq"]))
    seg_starts = [j for j in [0] + sorted(kept) if j + 1 < len(lat)]
    need = max(seg_starts, default=0) + 2
    rows = [[] for _ in range(need)]
    for lane in check_lanes:
        d = gen.client_doppler(cfg, int(starts[lane]))
        for j in range(need):
            rows[j].append(d.block(block))
    dop = [tables(rw, s_rows) for rw in rows]
    xs = np.stack([blocks.real, blocks.imag], axis=1).astype(np.float32)
    segs, prog = [], []
    for j in seg_starts:
        segs.append(check.Segment([xs[j % ring], xs[(j + 1) % ring]], [dop[j], dop[j + 1]],
                                  None if j == 0 else kept[j]))
        prog.append([[np.frombuffer(clients.bytes[b][int(l)], np.int8) for l in check_lanes]
                     for b in (j, j + 1)])
    numbers = check.compare(radio, step_lanes, block, segs, prog, len(check_lanes), dev,
                            int(mix["carry_chunks"]), control)
    blocks_done = len(lat)
    return {
        "metrics": {"served_msps": blocks_done * lanes * block / window_s / 1e6,
                    "block_p95_ms": float(np.percentile(np.asarray(lat) * 1e3, 95)) if lat else float("nan"),
                    "setup_s": setup_s},
        "setup_parts": phases.seconds,
        "attempted": k, "failed": failed, "numbers": numbers, "memory_peak_bytes": peak,
        "layer": {"blocks": blocks_done, "window_s": window_s, "lanes": lanes, "block": block},
    }
