"""RX/TX session management — the async analog of the reference's
tcp_worker / dsp_worker / sdr_worker triad (src/tcp_server.c,
src/dsp_worker.c, src/sdr_worker.c).

- An RxSession owns the per-client demod pipeline (queue → dump →
  doppler → fsk_demod → dump/socket), one task instead of one thread.
- An SdrStream owns one SDR device reader and fans buffers out to every
  attached session (connection sharing: a new client reuses a stream
  with equal center_freq, offset, and sampling_freq >= requested —
  sdr_worker_find_closest, src/sdr_worker.c:83-95).
- TX runs inline in the client connection handler, one TxData at a time
  with a synchronous ack (src/tcp_server.c:176-241).

The port of ``sdrmodem_tpu/server/session.py`` onto the port's DSP.  Every
session and group runs on the device the server hands it (``dsp_device``
/ ``device``; CUDA when None, raising without a card), a fast-mode group's
lanes sharded over ``devices`` where the server names several (or
SDRM_SERVER_MESH picks them):
exact clients on ``DemodPipeline(..., exact=True).streamer()`` (the
float64 FIR kernel and B4), fast-mode groups on
``make_batched_step_full("pallas", doppler=True, layout="fanout")`` (B1
and B2, or the banded front through B3 where B1 does not take the taps;
the symbols packed lane by lane by ``ops/pack.py:pack_lanes``),
standalone clients on the float32 streamer (B3 and B4), TX on
``StreamingGfskMod`` (B5).
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from sdrmodem_tpu_torch.devices.base import SdrDevice
from sdrmodem_tpu_torch.dsp.clock_recovery import ClockFullState
from sdrmodem_tpu_torch.dsp.doppler import Doppler
from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline, DemodStateFull
from sdrmodem_tpu_torch.dsp.streaming import StreamingGfskMod
from sdrmodem_tpu_torch.ops._build import resolve_device
from sdrmodem_tpu_torch.ops.pack import pack_lanes
from sdrmodem_tpu_torch.server import wire
from sdrmodem_tpu_torch.server.config import RxSdrType, ServerConfig
from sdrmodem_tpu_torch.utils.convert import doppler_tables_from_numpy, segment_tables
from sdrmodem_tpu_torch.utils.queue import BufferQueue
from sdrmodem_tpu_torch.utils import spans

log = logging.getLogger("sdrmodem.session")


def doppler_from_settings(
    settings: wire.DopplerSettings,
    sampling_freq: int,
    center_freq: int,
    constant_offset: int,
    start_time_seconds: int,
) -> Doppler:
    """Construct Doppler with the reference's exact unit quirks:
    lat/lon wire values divided by 10E6 (=1e7) and altitude by 10E3
    (src/dsp_worker.c:130, src/tcp_server.c:549)."""
    return Doppler(
        latitude=settings.latitude / 10e6,
        longitude=settings.longitude / 10e6,
        altitude_km=settings.altitude / 10e3,
        sampling_freq=sampling_freq,
        center_freq=center_freq,
        tle_lines=wire.tle_to_lines(settings.tle),
        constant_offset=constant_offset,
        start_time_seconds=start_time_seconds,
    )


@dataclass
class RxKey:
    """Connection-sharing key (struct sdr_rx analog)."""

    center_freq: int
    sampling_freq: int
    offset: int

    def matches(self, other: "RxKey") -> bool:
        """sdr_worker_find_closest: equal tuning, adequate rate."""
        return (
            self.center_freq == other.center_freq
            and self.sampling_freq >= other.sampling_freq
            and self.offset == other.offset
        )


class RxSession:
    """Per-client demodulation lane (dsp_worker analog).

    In ``demod_mode = exact`` (default) the session owns a deterministic
    f64-accumulated streaming pipeline and a consumer task, mirroring the
    reference's one-thread-per-client.  In ``demod_mode = fast`` the
    session is a LANE of its stream's BatchedRxGroup: the group steps all
    clients through one full-block step and calls ``emit`` with this
    lane's symbols.  ``dsp_device`` is where the DSP runs (CUDA when
    None)."""

    def __init__(
        self,
        client_id: int,
        req: wire.RxRequest,
        config: ServerConfig,
        writer: asyncio.StreamWriter | None,
        *,
        dsp_device=None,
    ):
        self.id = client_id
        self.dsp_device = resolve_device(dsp_device)
        self.req = req
        self.writer = writer
        self.config = config
        fsk = req.fsk_settings
        self.fsk_config = FskDemodConfig(
            sampling_freq=req.rx_sampling_freq,
            baud_rate=req.demod_baud_rate,
            deviation=fsk.demod_fsk_deviation,
            decimation=req.demod_decimation,
            transition_width=fsk.demod_fsk_transition_width,
            use_dc_block=fsk.demod_fsk_use_dc_block,
        )
        self.mode = config.demod_mode
        if self.mode == "exact":
            self.demod = DemodPipeline(
                self.fsk_config, block_size=config.buffer_size, exact=True,
                device=self.dsp_device,
            ).streamer()
        else:
            # constructing the pipeline validates the FSK parameters at
            # request time exactly like the exact path; the stream's
            # BatchedRxGroup owns the batched step
            self.demod = None
            DemodPipeline(self.fsk_config, block_size=config.buffer_size, exact=False,
                          device=self.dsp_device)
        self.group = None  # set by SdrStream.add_session in fast mode
        self.lane = -1
        self.doppler: Doppler | None = None
        if req.doppler is not None:
            start = req.file_settings.start_time_seconds if req.file_settings else 0
            self.doppler = doppler_from_settings(
                req.doppler, req.rx_sampling_freq, req.rx_center_freq, 0, start
            )
        # blocking queue iff rx source is a file (no drops; dsp_worker.c:176-179)
        self.queue = BufferQueue(
            config.queue_size, blocking=config.rx_sdr_type == RxSdrType.FILE
        )
        self.rx_dump = (
            open(f"{config.base_path}/rx.sdr2demod.{client_id}.cf32", "wb")
            if req.rx_dump_file
            else None
        )
        dest = req.demod_destination
        self.demod_dump = (
            open(f"{config.base_path}/rx.demod2client.{client_id}.s8", "wb")
            if dest in (wire.DemodDestination.FILE, wire.DemodDestination.BOTH)
            else None
        )
        self.to_socket = dest in (wire.DemodDestination.SOCKET, wire.DemodDestination.BOTH)
        self.task: asyncio.Task | None = None
        self.finished = asyncio.Event()
        # observability counters (the reference logs per-client byte totals;
        # SURVEY §5 adds running samples/s and queue drops)
        self.samples_in = 0
        self.symbols_out = 0
        self._rate_t0 = time.monotonic()
        self._rate_samples = 0
        self._rate_interval = 10.0  # seconds between samples/s log lines

    def note_progress(self, n_samples: int):
        """Update throughput counters; log a structured rate line every
        ``_rate_interval`` seconds (SURVEY §5 'samples/s counters')."""
        self.samples_in += n_samples
        self._rate_samples += n_samples
        now = time.monotonic()
        dt = now - self._rate_t0
        if dt >= self._rate_interval:
            log.info(
                "[%d] rx rate %.3f Msamples/s | totals: %d samples in, "
                "%d symbols out, %d queue drops",
                self.id, self._rate_samples / dt / 1e6,
                self.samples_in, self.symbols_out, self.queue_drops,
            )
            self._rate_t0 = now
            self._rate_samples = 0

    @property
    def queue_drops(self) -> int:
        """Buffers dropped on the way to this session: in fast mode its
        group's queue (the session's own queue is never fed there)."""
        return self.group.queue.dropped if self.group is not None else self.queue.dropped

    def start(self):
        if self.mode == "fast":
            log.info("[%d] dsp_worker is starting (batched fast lane)", self.id)
            return
        self.task = asyncio.create_task(self._run(), name=f"rx-session-{self.id}")

    def to_standalone(self):
        """Demote a fast-mode session to its own per-client ragged
        pipeline (float32, same numerics class as the batched step).

        Fast-mode lanes batch by EXACT demod-config equality; a client
        whose config matches no group when the per-stream group cap
        (SDRM_MAX_GROUPS) is reached would otherwise spawn yet another
        full batched step over mostly-empty lanes — quadratically
        wasteful as configs diversify.  The demoted session takes the
        queue/worker path instead (one reference dsp_worker thread)."""
        assert self.mode == "fast" and self.task is None
        self.mode = "standalone"
        self.demod = DemodPipeline(
            self.fsk_config, block_size=self.config.buffer_size, exact=False,
            device=self.dsp_device,
        ).streamer()
        log.info(
            "[%d] demod group cap reached; running as standalone lane", self.id
        )

    async def emit(self, symbols: np.ndarray):
        """Deliver one lane's demodulated symbols (fast mode).

        Guarded against teardown races: a batched step that snapshotted
        this lane before ``stop()`` closed the writers must become a no-op
        — an exception here would propagate through the group's feed()
        into SdrStream._run and kill the reader for EVERY client."""
        if self.finished.is_set():
            return
        with spans.span("sdrm.session.emit"):
            self.symbols_out += len(symbols)
            if self.demod_dump is not None:
                try:
                    self.demod_dump.write(symbols.tobytes())
                except ValueError:  # closed by stop() mid-step
                    return
            if not self.to_socket or self.writer is None:
                return
            try:
                self.writer.write(symbols.tobytes())
            except (ConnectionError, RuntimeError):
                return  # teardown arrives via the control loop
        try:
            await self.writer.drain()
        except (ConnectionError, RuntimeError):
            pass

    async def _run(self):
        log.info("[%d] dsp_worker is starting", self.id)
        # The ragged-block pipeline runs any chunk size, so buffers are
        # processed as they arrive (the reference's per-buffer dsp_worker
        # loop).  Every buffer already queued goes into the same streamer
        # call: each call pads to the whole block, and the symbols do not
        # depend on where the stream is cut.  Doppler still corrects a
        # buffer at a time, since its interpolation steps once a buffer.
        try:
            done = False
            while not done:
                buf = await self.queue.take()
                if buf is None:
                    break  # poison pill
                bufs = [buf]
                while not self.queue.empty():
                    buf = await self.queue.take()
                    if buf is None:
                        done = True
                        break
                    bufs.append(buf)
                if self.rx_dump is not None:
                    for buf in bufs:
                        self.rx_dump.write(np.asarray(buf, np.complex64).tobytes())
                if self.doppler is not None:
                    bufs = await asyncio.to_thread(self._correct, bufs)
                buf = np.concatenate(bufs) if len(bufs) > 1 else bufs[0]
                self.note_progress(len(buf))
                symbols = await asyncio.to_thread(self.demod.process, buf)
                self.symbols_out += len(symbols)
                if len(symbols) == 0:
                    continue
                if self.demod_dump is not None:
                    self.demod_dump.write(symbols.tobytes())
                if self.to_socket and self.writer is not None:
                    try:
                        self.writer.write(symbols.tobytes())
                        await self.writer.drain()
                    except (ConnectionError, RuntimeError):
                        break
        except asyncio.CancelledError:
            pass
        except Exception:
            log.exception("[%d] dsp_worker failed", self.id)
        finally:
            if self.rx_dump:
                self.rx_dump.close()
            if self.demod_dump:
                self.demod_dump.close()
            self.finished.set()
            log.info(
                "[%d] dsp_worker stopped (%d samples in, %d symbols out, "
                "%d queue drops)",
                self.id, self.samples_in, self.symbols_out, self.queue_drops,
            )

    def _correct(self, bufs: list[np.ndarray]) -> list[np.ndarray]:
        return [self.doppler.process_rx(buf) for buf in bufs]

    async def put(self, buf: np.ndarray):
        await self.queue.put(buf)

    def finish_fast(self):
        """Idempotently mark a fast-mode lane finished and close its
        writers.  ``finished`` is set FIRST so in-flight emits see it
        before the files close (both run on the event loop; emit has no
        await between the check and the write)."""
        if self.finished.is_set():
            return
        self.finished.set()
        if self.rx_dump and not self.rx_dump.closed:
            self.rx_dump.close()
        if self.demod_dump and not self.demod_dump.closed:
            self.demod_dump.close()
        log.info(
            "[%d] dsp_worker stopped (%d samples in, %d symbols out, "
            "%d queue drops)",
            self.id, self.samples_in, self.symbols_out, self.queue_drops,
        )

    async def stop(self):
        if self.mode == "fast":
            self.finish_fast()
            return
        await self.queue.interrupt()
        if self.task:
            await self.task


def mesh_shards(lanes: int, visible: int) -> int:
    """SDRM_SERVER_MESH's rule: the most of ``visible`` devices that divide
    ``lanes`` into multiples of 128 (each shard keeps whole 128-lane
    granules, as the JAX package's does), 1 where none do."""
    return next((n for n in range(visible, 1, -1) if lanes % n == 0 and (lanes // n) % 128 == 0), 1)


class BatchedRxGroup:
    """All fast-mode clients of one SDR stream that share a demod
    signature, batched as lanes of ONE full-block step.

    The reference's thread-per-client model as one batched step on the
    card: the stream buffer is broadcast to every lane (the reference's
    sdr_worker fan-out, src/sdr_worker.c:31-55), each lane's Doppler rows
    are built on the host and mixed on the device, and one step advances
    all lanes: B1 (the fused front) and B2 (the chunked clock), or the
    banded front through B3 where B1's layout does not hold the taps.

    ``LANES`` (SDRM_SERVER_LANES, default 128, rounded up to a multiple of
    128): the clients-per-step capacity.  The clock kernel runs one thread
    block a lane, so wider groups serve more clients a step.

    The lanes may be sharded over several devices (the JAX package's
    SDRM_SERVER_MESH, ``sdrmodem_tpu/server/session.py:367-417``): each
    shard a run of LANES / n lanes, a multiple of 128, with its own
    pipeline, step and state on its device.  ``devices`` names the shards'
    devices (a device may repeat); without it, SDRM_SERVER_MESH on a CUDA
    group takes the most visible cards that divide LANES into multiples of
    128, as JAX takes ``jax.devices()``, and otherwise the group runs on
    ``device`` alone.  Every shard steps the one shared stream and its own
    lanes' Doppler rows; no collective is needed."""

    LANES = max(128, -(-int(os.environ.get("SDRM_SERVER_LANES", "128")) // 128) * 128)

    def __init__(
        self,
        fsk_config: FskDemodConfig,
        block: int,
        *,
        blocking: bool = False,
        queue_capacity: int | None = None,
        device=None,
        devices=None,
    ):
        self.fsk_config = fsk_config
        self.block = block
        # ingest/compute overlap (the reference's whole reason for queue.c:
        # the SDR reader thread must never wait on the demodulator,
        # src/sdr_worker.c:31-55): filled blocks go through a bounded
        # BufferQueue to a worker task that runs the device step, so
        # ``feed`` returns as soon as the block is copied.  blocking=True
        # (file sources) back-pressures the reader instead of dropping.
        # Capacity follows the server config's queue_size (the reference's
        # queue_size knob, default 64, server_config.c:89-97) — deep
        # enough to ride out the first step's kernel build.
        self.blocking = blocking
        if queue_capacity is None:
            queue_capacity = int(os.environ.get("SDRM_GROUP_QUEUE", "64"))
        self.queue = BufferQueue(queue_capacity, blocking)
        self._worker_task: asyncio.Task | None = None
        self.blocks_processed = 0
        self.devices = self._shard_devices(resolve_device(device), devices)
        self.local = self.LANES // len(self.devices)  # lanes a shard
        # the reference's atan LUT, read by gather in the front kernel; one
        # pipeline a shard, its taps and tables on the shard's device
        self.pipes = [
            DemodPipeline(fsk_config, block, exact=False, use_atan_lut=True, device=d)
            for d in self.devices
        ]
        self.pipe = self.pipes[0]
        self.device = self.pipe.device
        # "fanout": the step takes the ONE shared (2, block) stream and
        # broadcasts it to the lanes on the device — no per-lane host copies
        # (the group exists precisely because every lane demodulates the
        # same SDR stream)
        self._steps = self._build_step()
        # device-side Doppler: S piecewise-linear phase rows per block
        # (host keeps the 1 Hz SGP4 bookkeeping; Doppler.device_segments)
        self.dop_rows = Doppler.max_rows(block, fsk_config.sampling_freq)
        # one DemodStateFull, or with several shards a tuple of them, shard
        # i holding lanes [i * local, (i + 1) * local)
        shard_states = tuple(p.init_full_state(self.local) for p in self.pipes)
        self.state = shard_states if self.sharded else shard_states[0]
        self._init_state_template = self.pipe.init_full_state(1)
        self.lanes: dict[int, RxSession] = {}
        # lanes whose state must be zeroed before the NEXT step: attach()
        # must not mutate self.state directly — a step awaiting in a worker
        # thread read the pre-reset state and would overwrite the reset on
        # return, silently handing the new client the previous occupant's
        # filter/clock history
        self._pending_resets: set[int] = set()
        self.acc = np.zeros(block, np.complex64)
        self.fill = 0

    @property
    def sharded(self) -> bool:
        return len(self.devices) > 1

    def _shard_devices(self, device, devices) -> list:
        """The shards' devices: ``devices`` as given (each shard a multiple
        of 128 lanes, else ``ValueError``), or SDRM_SERVER_MESH's choice,
        or ``device`` alone."""
        if devices is None:
            if os.environ.get("SDRM_SERVER_MESH", "0") in ("0", "", "off") or device.type != "cuda":
                return [device]
            n_use = mesh_shards(self.LANES, torch.cuda.device_count())
            devices = [torch.device("cuda", i) for i in range(n_use)]
        devices = [resolve_device(d) for d in devices]
        n = len(devices)
        if n < 1 or self.LANES % n or (self.LANES // n) % 128:
            raise ValueError(f"{self.LANES} lanes do not split over {n} devices in multiples of 128")
        if n > 1:
            log.info("rx group sharding %d lanes over %d devices: %s", self.LANES, n,
                     ", ".join(map(str, devices)))
        return devices

    def _build_step(self) -> list:
        """The batched fanout step of each shard, on its device."""
        return [p.make_batched_step_full("pallas", doppler=True, layout="fanout") for p in self.pipes]

    def has_space(self) -> bool:
        return len(self.lanes) < self.LANES

    def attach(self, session: RxSession) -> int:
        lane = next(i for i in range(self.LANES) if i not in self.lanes)
        self._pending_resets.add(lane)
        self.lanes[lane] = session
        session.group = self
        session.lane = lane
        return lane

    def detach(self, session: RxSession):
        if session.lane in self.lanes and self.lanes[session.lane] is session:
            del self.lanes[session.lane]
        session.group = None

    def _reset_lane(self, lane: int):
        """Fresh per-lane stream state (a new client starts from zero
        history, like a freshly created dsp_worker), in the one shard that
        holds the lane.  Every leaf is a new tensor: the template and a
        step's inputs are never written."""
        if not self.sharded:
            self.state = self._reset_in(self.state, lane)
            return
        shard, local = divmod(lane, self.local)
        states = list(self.state)
        states[shard] = self._reset_in(states[shard], local)
        self.state = tuple(states)

    def _reset_in(self, state: DemodStateFull, lane: int) -> DemodStateFull:
        cp = state.quad_prev.shape[1] // 2

        def reset(leaf, init):
            if leaf is None:
                return None
            leaf = leaf.clone()
            if leaf.dim() == 1:  # clock scalars, (C,)
                leaf[lane] = init[0]
            elif leaf.shape[-1] == 2 * cp:  # I/Q lane pairs
                leaf[..., lane] = init[..., 0]
                leaf[..., cp + lane] = init[..., 1]
            else:
                leaf[..., lane] = init[..., 0]
            return leaf

        init = self._init_state_template
        front = [reset(a, b) for a, b in zip(state[:4], init[:4])]
        clock = ClockFullState(*(reset(a, b) for a, b in zip(state.clock, init.clock)))
        return DemodStateFull(*front, clock)

    async def feed(self, buf: np.ndarray):
        """Accumulate a stream buffer; enqueue every filled block for the
        worker task.  Returns as soon as the data is copied (lossy mode) or
        queue space exists (blocking mode) — the reader never waits for the
        device step itself (reference src/queue.c:168-200).

        A block goes into the queue as (the time it was put, its samples).
        The span ``sdrm.group.feed`` covers the copies up to one filled
        block and closes before its put."""
        buf = np.asarray(buf, np.complex64)
        i = 0
        while i < len(buf):
            with spans.span("sdrm.group.feed"):
                take = min(self.block - self.fill, len(buf) - i)
                self.acc[self.fill : self.fill + take] = buf[i : i + take]
                self.fill += take
                i += take
                block = None
                if self.fill == self.block:
                    self.fill = 0
                    block = self.acc.copy()
            if block is not None:
                self._ensure_worker()
                await self.queue.put((time.perf_counter(), block))

    def _ensure_worker(self):
        if self._worker_task is None or self._worker_task.done():
            self._worker_task = asyncio.create_task(
                self._worker(), name=f"rx-group-worker-{id(self):x}"
            )

    async def _worker(self):
        """Drain filled blocks through the device step until the poison
        pill (the dsp_worker thread analog, src/dsp_worker.c:44-106)."""
        try:
            while True:
                item = await self.queue.take()
                if item is None:
                    break
                t_put, block = item
                spans.add("group.queue_wait_s", time.perf_counter() - t_put)
                await self._step_block(block)
                self.blocks_processed += 1
        except asyncio.CancelledError:
            pass
        except Exception:
            log.exception("rx group worker failed; finishing %d lanes", len(self.lanes))
            for s in list(self.lanes.values()):
                s.finish_fast()

    async def close(self):
        """Stop the worker (pending blocks are discarded, poison-pill
        semantics of queue.c:215-223)."""
        if self._worker_task is not None and not self._worker_task.done():
            await self.queue.interrupt()
            await self._worker_task

    async def _step_block(self, acc: np.ndarray):
        """Step a block for every live lane and emit each lane's symbols.

        Its spans: ``sdrm.group.rows`` (the lane resets, the stream's
        (2, B) pair and each lane's Doppler rows and tables),
        ``sdrm.group.step`` (``_step_host`` in a worker thread: the one
        span that crosses an await, so with several groups on one loop
        another group's spans can fall inside it), ``sdrm.group.split``
        (each live lane's slice of its shard's packed symbols, a lane
        with none left out), then each session's ``sdrm.session.emit``.
        The counter ``group.blocks`` counts the blocks stepped, the spans'
        totals read a block; ``group.packed`` counts the shards' packings
        (one a shard a block)."""
        with spans.span("sdrm.group.rows"):
            # apply lane resets queued by attach(); the single worker task
            # processes blocks serially, so no step can be mid-flight here
            for lane in self._pending_resets:
                self._reset_lane(lane)
            self._pending_resets.clear()
            sessions = {
                lane: s for lane, s in self.lanes.items() if not s.finished.is_set()
            }
            if not sessions:
                return
            # one shared (2, block) pair — the step broadcasts it to all lanes
            x = np.stack([acc.real, acc.imag]).astype(np.float32)
            # per-lane Doppler as device NCO tables: the host only runs the
            # 1 Hz SGP4 bookkeeping (cheap scalars), the mix itself happens
            # on the device inside the batched step — no serialized per-lane
            # host math (reference applies it in-stream, doppler.c:164-186)
            rows = {}
            for lane, s in sessions.items():
                s.note_progress(self.block)
                if s.doppler is not None:
                    rows[lane] = s.doppler.device_segments(self.block, +1)
            dop = segment_tables(rows, self.dop_rows, self.LANES)
        with spans.span("sdrm.group.step"):
            self.state, packed = await asyncio.to_thread(self._step_host, x, dop)
        spans.add("group.blocks", 1)
        # each shard's lanes packed back to back: a lane's symbols are one slice
        with spans.span("sdrm.group.split"):
            out = []
            for lane, s in sessions.items():
                shard, local = divmod(lane, self.local)
                flat, offsets = packed[shard]
                start, end = offsets[local], offsets[local + 1]
                if end > start:
                    out.append((s, flat[start:end]))
        for s, lane_symbols in out:
            await s.emit(lane_symbols)

    def _step_host(self, x: np.ndarray, dop):
        """One step on the devices: (state', one (flat, offsets) a shard),
        numpy out.  Each shard steps the shared block and its lanes'
        Doppler rows on its device and packs its symbols there
        (``ops/pack.py:pack_lanes``): local lane l's symbols are
        ``flat[offsets[l]:offsets[l + 1]]``.  Its offsets come back first,
        then only the valid prefix of its packed buffer."""
        states = self.state if self.sharded else (self.state,)
        xs = {}
        new, packed = [], []
        for i, (step, state, dev) in enumerate(zip(self._steps, states, self.devices)):
            if dev not in xs:
                xs[dev] = torch.from_numpy(x).to(dev)
            lanes = slice(i * self.local, (i + 1) * self.local)
            state, symbols, counts = step(state, xs[dev], doppler_tables_from_numpy(
                tuple(t[:, lanes] for t in dop), self.local, device=dev))
            new.append(state)
            packed.append(pack_lanes(symbols, counts))
            spans.add("group.packed", 1)
        out = []
        for flat, offsets in packed:
            offsets = offsets.cpu().numpy()
            out.append((flat[: int(offsets[-1])].cpu().numpy(), offsets))
        return (tuple(new) if self.sharded else new[0]), out


class SdrStream:
    """One reader per distinct SDR stream, fanning out to sessions
    (sdr_worker analog)."""

    def __init__(self, stream_id: int, key: RxKey, device: SdrDevice, *, group_devices=None):
        self.id = stream_id
        self.key = key
        self.device = device
        self.group_devices = group_devices  # the devices a fast group's lanes shard over
        self.sessions: list[RxSession] = []
        self.groups: list[BatchedRxGroup] = []  # fast-mode lane batches
        self.task: asyncio.Task | None = None

    def start(self):
        self.task = asyncio.create_task(self._run(), name=f"sdr-stream-{self.id}")

    def add_session(self, session: RxSession):
        self.sessions.append(session)
        if session.mode == "fast":
            for g in self.groups:
                if g.fsk_config == session.fsk_config and g.has_space():
                    g.attach(session)
                    return
            # bound the number of batched steps per stream:
            # a client whose config matches no group beyond the cap runs
            # standalone instead of spawning another mostly-empty step
            max_groups = int(os.environ.get("SDRM_MAX_GROUPS", "8"))
            if len(self.groups) >= max_groups:
                session.to_standalone()
                return
            group = BatchedRxGroup(
                session.fsk_config,
                session.config.buffer_size,
                blocking=self.device.lossless_rx,
                queue_capacity=session.config.queue_size,
                device=session.dsp_device,
                devices=self.group_devices,
            )
            group.attach(session)
            self.groups.append(group)

    async def _run(self):
        try:
            while True:
                buf = await self.device.read_stream()
                if buf is None:
                    break
                for session in list(self.sessions):
                    if session.mode == "fast":
                        if session.rx_dump is not None:
                            session.rx_dump.write(
                                np.asarray(buf, np.complex64).tobytes()
                            )
                    else:
                        await session.put(buf)
                for group in list(self.groups):
                    await group.feed(buf)
        except asyncio.CancelledError:
            pass
        except Exception:
            log.exception("[%d] sdr stream failed", self.id)
        finally:
            # stream ended: poison-pill every attached session (:49-53);
            # fast-mode lanes are notified too (finished + writers closed)
            # so nothing keeps emitting into a dead stream
            for group in list(self.groups):
                await group.close()
            for session in list(self.sessions):
                if session.mode == "fast":
                    session.finish_fast()
                else:
                    await session.queue.interrupt()

    async def remove_session(self, session: RxSession) -> bool:
        """Detach; returns True when the stream itself was torn down."""
        if session in self.sessions:
            self.sessions.remove(session)
        if session.group is not None:
            group = session.group
            group.detach(session)
            if not group.lanes and group in self.groups:
                self.groups.remove(group)
                await group.close()
        if not self.sessions:
            # stop the reader task before the graceful-shutdown drain so the
            # two never contend for the same stream reader
            if self.task:
                self.task.cancel()
                try:
                    await self.task
                except asyncio.CancelledError:
                    pass
            await self.device.stop_rx()
            await self.device.close()
            return True
        return False


class TxSession:
    """Per-client modulation state (tcp_worker TX-side analog).  ``device``
    is the SDR device the samples go to; ``dsp_device`` is where the
    modulator runs (CUDA when None)."""

    def __init__(
        self,
        client_id: int,
        req: wire.TxRequest,
        config: ServerConfig,
        device: SdrDevice | None,
        *,
        dsp_device=None,
    ):
        from sdrmodem_tpu_torch.dsp.gfsk_mod import GfskModConfig
        from sdrmodem_tpu_torch.dsp.nco_host import HostNco

        self.id = client_id
        self.req = req
        self.config = config
        self.device = device
        self.mod = StreamingGfskMod(
            GfskModConfig.from_radio(
                req.tx_sampling_freq, req.mod_baud_rate, req.fsk_settings.mod_fsk_deviation
            ),
            device=dsp_device,
        )
        self.doppler: Doppler | None = None
        self.nco: HostNco | None = None
        if req.doppler is not None:
            start = req.file_settings.start_time_seconds if req.file_settings else 0
            self.doppler = doppler_from_settings(
                req.doppler, req.tx_sampling_freq, req.tx_center_freq, req.tx_offset, start
            )
        elif req.tx_offset != 0:
            self.nco = HostNco(req.tx_sampling_freq)
        self.tx_dump = (
            open(f"{config.base_path}/tx.mod2sdr.{client_id}.cf32", "wb")
            if req.tx_dump_file
            else None
        )

    async def handle_tx_data(self, data: bytes) -> int:
        """Modulate + shift + dump + transmit one TxData payload in
        buffer_size batches.  Returns a ResponseDetails error or 0."""
        for start in range(0, len(data), self.config.buffer_size):
            batch = data[start : start + self.config.buffer_size]
            iq = await asyncio.to_thread(self.mod.process, batch)
            if self.doppler is not None:
                iq = await asyncio.to_thread(self.doppler.process_tx, iq)
            elif self.nco is not None:
                iq = self.nco.mix(self.req.tx_offset, iq)
            if self.tx_dump is not None:
                self.tx_dump.write(np.asarray(iq, np.complex64).tobytes())
                # full disk ignored: keep transmitting (tcp_server.c:214-221)
            if self.device is not None:
                try:
                    await self.device.write_stream(iq)
                except Exception:
                    log.exception("[%d] unable to transmit request fully", self.id)
                    return wire.ResponseDetails.INTERNAL_ERROR
        return 0

    async def close(self):
        if self.tx_dump:
            self.tx_dump.close()
        if self.device is not None:
            await self.device.close()
