"""Time-sharded demodulation of long streams across the shards of a mesh.

Counterpart of ``sdrmodem_tpu/parallel/time_shard.py``.  The reference
streams unbounded signals in O(buffer) memory by carrying per-block state
(FIR tails, the quad-demod sample, the clock's phase:
src/dsp/fir_filter.c:107-110, clock_recovery_mm.c:119-135).  Sharded over
a ``Mesh`` (``parallel/mesh.py``) this becomes:

- the front end (the Doppler NCO, LPF1, quad demod, LPF2, DC) is
  data-parallel over time blocks with overlap-save halos: each stage's
  history is the ring-left shard's tail of that stage (``ring_shift``),
  zeros where a shard holds a stream's first block, so every FIR window is
  whole and the sharded front equals the unsharded step's bit for bit (the
  port's FIR sums each output in tap order whatever its row);
- Mueller & Müller clock recovery is sequential, so its small carried
  state (``ClockFullState``) is handed block to block: in D systolic
  rounds every shard walks one ring group of streams through its block,
  then the state of those k lanes moves one shard right.

Streams s = j * k + g (ring group j in [0, D), slot g in [0, k)); stream
(j, g)'s time block dd lives on shard (j + dd) mod D, at lane s, so every
stream's previous block is on the ring-left shard and group j's first
block is on shard j: no fill or drain rounds.  The lanes are the k * D
streams, not padded to 128.

Each shard runs the port's kernels on its device: the NCO stage of B1
(``ops/front.py:nco_mix``) with ``dopplers``, B3 three times
(``ops/fir.py:conv1d_banded_tm``), the quad-demod kernel, and D rounds of
B2 (``clock_backend="pallas"``) or of B4 a chunk ("scan").  Each stream's
symbols equal that stream fed alone through
``DemodPipeline.make_batched_step_full`` at ``block = N / D``, bit for
bit.  Within one process nothing waits for a device until the symbols are
fetched, so on several cards the shards' launches overlap.
"""

from __future__ import annotations

import numpy as np
import torch

from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig, float_to_int8
from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
from sdrmodem_tpu_torch.ops.fir import conv1d_banded_tm
from sdrmodem_tpu_torch.ops.front import nco_mix, quad_demod
from sdrmodem_tpu_torch.parallel.mesh import Mesh

# the goldens' Doppler interpolation cadence (the reference's test_doppler.c
# streams 2000-sample buffers and interpolates once a buffer): pinning it
# makes the sharded correction independent of the block partitioning
DOPPLER_CADENCE = 2000


def demod_time_sharded(iq: np.ndarray, config: FskDemodConfig, mesh: Mesh, **kw):
    """Demodulate ONE stream with its time axis sharded over ``mesh``:
    ``demod_pipelined`` with S = 1.  Returns (int8 symbols, count), equal
    to the unsharded full-block step at block N / D."""
    outs = demod_pipelined(np.asarray(iq, np.complex64)[None, :], config, mesh, **kw)
    return outs[0], len(outs[0])


def _skewed_layout(iq, dopplers, config, n_dev):
    """Host-side staging shared by the pipelined and grid paths.

    Returns (x_skew (D, B, 2L) f32 with I in lanes [0, L) and Q in [L, 2L),
    dop_tabs (D, 4, rows, L) f32 or None, block, k), L = k * D lanes."""
    s_streams, n = iq.shape
    d = config.decimation
    k = -(-s_streams // n_dev)  # streams a ring group (zero-pad the rest)
    lanes = k * n_dev
    block = -(-n // n_dev)
    block = -(-block // d) * d
    padded = np.zeros((lanes, n_dev, block), np.complex64)
    padded.reshape(lanes, -1)[:s_streams, :n] = np.asarray(iq, np.complex64)

    x_skew = np.empty((n_dev, block, 2 * lanes), np.float32)
    s_idx = np.arange(lanes)
    for p in range(n_dev):
        # shard p holds lane s's block (p - j) mod D, j = s // k its ring group
        blocks = padded[s_idx, (p - s_idx // k) % n_dev]  # (lanes, block)
        x_skew[p, :, :lanes] = blocks.real.T
        x_skew[p, :, lanes:] = blocks.imag.T

    dop_tabs = None
    if dopplers is not None and any(dp is not None for dp in dopplers):
        from sdrmodem_tpu_torch.dsp.doppler import Doppler

        rows = Doppler.max_rows(block, config.sampling_freq, DOPPLER_CADENCE)
        # tabs rows: 0 = start, 1 = end, 2 = adj, 3 = ph0 (nco_mix_pair_tm's order)
        dop_tabs = np.zeros((n_dev, 4, rows, lanes), np.float32)
        for s, dp in enumerate(dopplers):
            if dp is None:
                continue
            j = s // k
            # walk the stream's blocks IN ORDER (device_segments advances the
            # 1 Hz SGP4 state as the streaming server does)
            for dd in range(n_dev):
                p = (j + dd) % n_dev
                segs = dp.device_segments(block, +1, max_batch=DOPPLER_CADENCE)
                for r, (st, ln, adj, ph0) in enumerate(segs):
                    dop_tabs[p, 0, r, s] = st
                    dop_tabs[p, 1, r, s] = st + ln
                    dop_tabs[p, 2, r, s] = adj
                    dop_tabs[p, 3, r, s] = ph0
    return x_skew, dop_tabs, block, k


class _Shard:
    """One shard's constants on its device: the pipeline (taps, arctangent
    table, MMSE bank) and the mask of lanes whose block here is their
    stream's first (ring group == shard index)."""

    def __init__(self, pipe: DemodPipeline, p: int, k: int, lanes: int):
        self.pipe = pipe
        first = (torch.arange(lanes) // k) == p
        self.first = first.to(pipe.device)
        self.first_iq = torch.cat([first, first]).to(pipe.device)


def _ring_halo(mesh: Mesh, shards: list[_Shard], arrs: list[torch.Tensor], h: int, iq: bool):
    """``_ring_halo``: each shard's ring-left neighbour's last ``h`` rows,
    zeros on the lanes whose block here is their stream's first."""
    halos = mesh.ring_shift([a[a.shape[0] - h :] for a in arrs])
    return [
        torch.where((sh.first_iq if iq else sh.first)[None, :], 0.0, halo)
        for sh, halo in zip(shards, halos)
    ]


def _front_halo(mesh: Mesh, shards: list[_Shard], xs: list[torch.Tensor], dops) -> list[torch.Tensor]:
    """``_front_full_halo``: the banded front (``ops/front.py:banded_front``)
    stage by stage on every shard, each stage's carried history replaced by
    the ring-left shard's tail of it; the quad stage takes the pipeline's
    arctangent (``FrontTaps.atan_lut``), as JAX's takes ``use_atan_lut``."""
    taps = [sh.pipe.front_taps for sh in shards]
    if dops is not None:
        xs = [nco_mix(x, dop) for x, dop in zip(xs, dops)]
    b = xs[0].shape[0]
    t1, t2 = taps[0].rev1.numel(), taps[0].rev2.numel()
    d = taps[0].d
    n2 = b // d
    hist = _ring_halo(mesh, shards, xs, t1 - 1, iq=True)
    y1 = [conv1d_banded_tm(torch.cat([h, x]), tp.rev1, 1, b) for h, x, tp in zip(hist, xs, taps)]
    # the quad demod's one-row carry: the ring-left shard's last LPF1 row
    prev = _ring_halo(mesh, shards, y1, 1, iq=True)
    yq = [quad_demod(y, q, tp) for y, q, tp in zip(y1, prev, taps)]
    hist = _ring_halo(mesh, shards, yq, t2 - 1, iq=False)
    y2 = [conv1d_banded_tm(torch.cat([h, y]), tp.rev2, d, n2) for h, y, tp in zip(hist, yq, taps)]
    if taps[0].rev_dc is None:
        return y2
    t3 = taps[0].rev_dc.numel()
    hist = _ring_halo(mesh, shards, y2, t3 - 1, iq=False)
    return [conv1d_banded_tm(torch.cat([h, y]), tp.rev_dc, 1, n2) for h, y, tp in zip(hist, y2, taps)]


def _clock_rotation(mesh: Mesh, shards: list[_Shard], soft: list[torch.Tensor], k: int, clock_backend: str):
    """D systolic rounds: in round r shard p walks the k streams of ring
    group (p - r) mod D through its block, then the ``ClockFullState`` of
    those k lanes moves one shard right.  Returns each shard's (symbols
    int8 (D, k, n_chunks, K), counts int32 (D, k, n_chunks)), rounds
    leading."""
    from sdrmodem_tpu_torch.dsp.clock_recovery import clock_mm_batched_full, initial_full_state

    n_dev = mesh.size
    p_clock = shards[0].pipe.config.clock_params()
    cstate = [initial_full_state(p_clock["omega"], k, p_clock["mu"], device=sh.pipe.device) for sh in shards]
    outs = [[] for _ in shards]
    counts = [[] for _ in shards]
    for r in range(n_dev):
        for i, (p, sh) in enumerate(zip(mesh.shards, shards)):
            g = (p - r) % n_dev
            o, cnt, cstate[i] = clock_mm_batched_full(
                soft[i][:, g * k : (g + 1) * k].contiguous(), cstate[i], bank=sh.pipe.bank,
                omega=p_clock["omega"], gain_omega=p_clock["gain_omega"], mu=p_clock["mu"],
                gain_mu=p_clock["gain_mu"], omega_relative_limit=p_clock["omega_relative_limit"],
                backend=clock_backend,
            )
            outs[i].append(float_to_int8(o))
            counts[i].append(cnt)
        if r + 1 < n_dev:
            cstate = mesh.ring_shift(cstate)
    return [torch.stack(o) for o in outs], [torch.stack(c) for c in counts]


def _check_block(taps, block: int) -> None:
    """The halos come from one neighbour, so each stage's history must fit
    in one shard's block (its rows at that stage)."""
    stages = [(taps.rev1.numel() - 1, block), (taps.rev2.numel() - 1, block)]
    if taps.rev_dc is not None:
        stages.append((taps.rev_dc.numel() - 1, block // taps.d))
    for hist, rows in stages:
        if hist > rows:
            raise ValueError(f"time sharding: a block of {block} samples gives a stage {rows} rows, "
                             f"fewer than its {hist}-row history; use fewer shards or longer streams")


def _launch(x_skew, dop_tabs, config, mesh: Mesh, k: int, *, clock_backend: str, use_atan_lut):
    """Put one time mesh's inputs on its shards and queue its whole
    program: (per-shard symbols, per-shard counts), on the devices."""
    block = x_skew.shape[1]
    lanes = x_skew.shape[2] // 2
    pipes = {}
    for dev in mesh.devices:
        if dev not in pipes:
            pipes[dev] = DemodPipeline(config, block, use_atan_lut=use_atan_lut, device=dev)
    shards = [_Shard(pipes[dev], p, k, lanes) for p, dev in zip(mesh.shards, mesh.devices)]
    _check_block(shards[0].pipe.front_taps, block)
    xs = mesh.put(x_skew)
    dops = None
    if dop_tabs is not None:
        dops = [tuple(t[q].contiguous() for q in range(4)) for t in mesh.put(dop_tabs)]
    soft = _front_halo(mesh, shards, xs, dops)
    return _clock_rotation(mesh, shards, soft, k, clock_backend)


def _reassemble(outs: np.ndarray, counts: np.ndarray, s_streams: int, k: int) -> list[np.ndarray]:
    """Stream (j, g)'s block r was walked on shard (j + r) mod D in round
    r, at slot g.  When N is not a multiple of D * decimation the zero
    padding clocks out trailing symbols, as the unsharded step would on the
    same padded stream."""
    n_dev = outs.shape[0]
    results = []
    for s in range(s_streams):
        j, g = s // k, s % k
        parts = []
        for r in range(n_dev):
            dev = (j + r) % n_dev
            for t in range(counts.shape[3]):
                parts.append(outs[dev, r, g, t, : counts[dev, r, g, t]])
        results.append(np.concatenate(parts))
    return results


def demod_pipelined(
    iq: np.ndarray,  # (S, N) complex64: S independent streams
    config: FskDemodConfig,
    mesh: Mesh,
    *,
    clock_backend: str = "pallas",
    use_atan_lut=True,
    dopplers=None,  # optional list of per-stream Doppler (or None) objects
) -> list[np.ndarray]:
    """The multi-device path: S streams, each stream's time axis sharded
    over ``mesh``, every shard busy in every round (the module docstring's
    layout and schedule).  On a mesh across processes every rank passes the
    same ``iq`` and gets every stream's symbols.

    With ``dopplers`` (one entry a stream, None = no correction), each
    stream's per-block Doppler tables, its rows every 2000 samples, are
    staged in the same skew as the data and mixed on the device before
    LPF1.

    Returns a list of S int8 symbol arrays, each equal to that stream fed
    alone through ``make_batched_step_full`` at block N / D."""
    x_skew, dop_tabs, _, k = _skewed_layout(iq, dopplers, config, mesh.size)
    outs, counts = _launch(x_skew, dop_tabs, config, mesh, k, clock_backend=clock_backend,
                           use_atan_lut=use_atan_lut)
    return _reassemble(mesh.fetch(outs), mesh.fetch(counts), iq.shape[0], k)


def pipeline_schedule_report(n_devices: int, n_samples: int, config: FskDemodConfig, n_streams: int = 0):
    """Steps-a-device accounting for ``demod_pipelined``, the same dict as
    the JAX package's for the same arguments (its 128-lane granule in
    ``lane_utilization`` and the halo bytes included).

    The schedule is systolic: S = k * D streams, D time blocks each, D
    clock rounds with every device walking one group of k streams a round,
    so every device is busy every round by construction."""
    d = config.decimation
    block = -(-(-(-n_samples // n_devices)) // d) * d
    t1 = len(config.lpf1_taps())
    t2 = len(config.lpf2_taps())
    dc = 4 * config.dc_length - 4 if config.use_dc_block else 0
    lanes = 128
    k = max(1, -(-n_streams // n_devices)) if n_streams else 1
    halo_bytes = 4 * lanes * (2 * (t1 - 1) + 2 * 1 + t2 - 1 + dc)
    state_bytes = 4 * (64 + 4) * k * n_devices  # suffix + scalars, a round
    clock_tasks = k * n_devices * n_devices  # S streams x D blocks
    busy = n_devices * n_devices  # 1 group-task a device a round x D rounds
    return dict(
        devices=n_devices,
        rounds=n_devices,
        block_samples=block,
        streams=k * n_devices,
        streams_per_group=k,
        lane_utilization=min(1.0, k * n_devices / lanes),
        clock_block_tasks=clock_tasks,
        busy_device_rounds=busy,
        idle_device_rounds=0,
        schedule_efficiency=1.0,
        halo_bytes_per_device=halo_bytes,
        clock_state_bytes_per_round=state_bytes,
    )


def demod_grid_sharded(
    iq: np.ndarray,  # (C, N) complex64
    config: FskDemodConfig,
    meshes: list[Mesh],
    *,
    clock_backend: str = "pallas",
    use_atan_lut=True,
    dopplers=None,  # optional list of per-channel Doppler (or None)
) -> list[np.ndarray]:
    """2-D sharding: channels over the list ``meshes``, one time mesh a
    channel shard, and each stream's time over its mesh.  Channels go
    round-robin (shard ci takes channels ci, ci + n_c, ...); each channel
    shard runs the pipelined program of ``demod_pipelined``, every shard's
    program queued before any is fetched.

    Returns the per-channel int8 symbol arrays, each equal to that channel's
    ``demod_pipelined``, so to the unsharded full-block step."""
    c, n = iq.shape
    n_c = len(meshes)
    if len({m.size for m in meshes}) != 1:
        raise ValueError("every channel shard's time mesh must have the same size")
    c_per = -(-c // n_c)
    runs = []
    for ci, mesh in enumerate(meshes):
        chans = list(range(ci, c, n_c))
        local = np.zeros((c_per, n), np.complex64)
        local[: len(chans)] = iq[chans]
        dops = None
        if dopplers is not None:
            dops = [dopplers[ch] for ch in chans] + [None] * (c_per - len(chans))
        x_skew, dop_tabs, _, k = _skewed_layout(local, dops, config, mesh.size)
        runs.append((chans, k, _launch(x_skew, dop_tabs, config, mesh, k, clock_backend=clock_backend,
                                       use_atan_lut=use_atan_lut)))
    results = [None] * c
    for mesh, (chans, k, (outs, counts)) in zip(meshes, runs):
        for ch, sym in zip(chans, _reassemble(mesh.fetch(outs), mesh.fetch(counts), len(chans), k)):
            results[ch] = sym
    return results
