"""The port's entry points for a compile check and a dry run of the
sharded pipeline over n devices.

The twin of the JAX package's ``__graft_entry__.py``:

- ``entry(device=None)`` returns ``(fn, (iq,))``: ``fn`` is the float32
  ``FskDemodulator.process`` of the lucky7 configuration returning
  ``(symbols, count)``, ``iq`` a (4, 4096) complex64 tensor from
  ``default_rng(0)``;
- ``dryrun_multichip(n, devices=None)`` runs JAX's sequence on the port's
  ``Mesh`` of n shards, JAX's asserts held and one equality a case added,
  each case against the port's unsharded step on the same data:
  (a) ``ShardedChannelDemod``, 2n channels x 2048, two steps;
  (b) ``demod_time_sharded`` of one stream of n x 2048;
  (c) ``ShardedChannelDemodFull`` with the scan clock, two steps, then with
      the production kernels at block 1024, lane 0 equal bit for bit to the
      unsharded ``make_batched_step_full("pallas", front="step", chunk=256)``
      (the port passes the chunk where JAX sets SDRM_STEP_CHUNK);
  (d) ``demod_pipelined`` of 2n streams, stream 0 with the LUCKY-7 pass's
      Doppler, and ``pipeline_schedule_report``: 0 idle rounds, 2 streams a
      group;
  (e) ``demod_grid_sharded`` over 2 x (n / 2) shards when n >= 4.

(d)'s streams are n x 2048 samples, where JAX takes n x 1024: a shard's
block of 1024 gives the DC stage 512 rows, fewer than its 636-row history
(lucky7: 157 / 57 / 637 taps), and the halo comes from one neighbour only.
The port raises ``ValueError`` there (``parallel/time_shard.py:_check_block``)
where JAX runs and gets it wrong (ROADMAP §C, JAX-side findings: 8 shards x
1024 samples give 819 symbols against 818 on one shard).

Usage: python -m sdrmodem_tpu_torch.tools.graft_entry [--devices 4]
       [--device cpu]

``--device cpu`` builds a mesh of n repeated CPU devices; on the card a
mesh of the visible cards, each repeated in turn where fewer than n are
visible.  Prints the entry's symbol count and one JSON report.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodulator
from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
from sdrmodem_tpu_torch.ops._build import resolve_device
from sdrmodem_tpu_torch.parallel import time_shard
from sdrmodem_tpu_torch.parallel.channels import ShardedChannelDemod, ShardedChannelDemodFull
from sdrmodem_tpu_torch.parallel.mesh import Mesh
from sdrmodem_tpu_torch.tools._common import LUCKY7, add_device, start

# the pass the Doppler goldens were recorded with (tests/test_doppler.py)
LUCKY7_TLE = [
    "LUCKY-7",
    "1 44406U 19038W   20069.88080907  .00000505  00000-0  32890-4 0  9992",
    "2 44406  97.5270  32.5584 0026284 107.4758 252.9348 15.12089395 37524",
]
DOPPLER = dict(latitude=53.72, longitude=47.57, altitude_km=0.0, sampling_freq=48000,
               center_freq=437525000, tle_lines=LUCKY7_TLE, start_time_seconds=1583840449)
STREAM_BLOCK = 2048  # a shard's block in (b) and (d)


def entry(device=None):
    """(fn, example_args): the batched float32 demodulation chain on
    (4, 4096) complex64 noise."""
    dev = resolve_device(device)
    dem = FskDemodulator(LUCKY7, exact=False, device=dev)

    def fn(iq):
        symbols, count, _ = dem.process(iq)
        return symbols, count

    rng = np.random.default_rng(0)
    iq = (rng.standard_normal((4, 4096)) + 1j * rng.standard_normal((4, 4096))).astype(np.complex64)
    return fn, (torch.from_numpy(iq).to(dev),)


def mesh_devices(n: int, devices=None) -> list:
    """``devices``, or n cards: the visible ones in turn, repeated where
    fewer than n are visible (raising without a card)."""
    if devices is not None:
        return list(devices)
    resolve_device(None)
    return [f"cuda:{i % torch.cuda.device_count()}" for i in range(n)]


def _lane(symbols, counts, lane: int) -> np.ndarray:
    symbols, counts = np.asarray(symbols), np.asarray(counts)
    return np.concatenate([symbols[lane, t, : counts[lane, t]] for t in range(counts.shape[1])])


def _unsharded_streams(streams: np.ndarray, block: int, device, dopplers=None) -> list[np.ndarray]:
    """Each stream alone, a lane of one batch, through the unsharded
    full-block step at ``block`` (the scan clock), with each Doppler
    stream's rows every 2000 samples as the time shard stages them."""
    from sdrmodem_tpu_torch.dsp.doppler import Doppler
    from sdrmodem_tpu_torch.utils.convert import doppler_tables_from_numpy, segment_tables

    s, n = streams.shape
    pipe = DemodPipeline(LUCKY7, block, device=device)
    step = pipe.make_batched_step_full("scan", doppler=True)
    state = pipe.init_full_state(s)
    dops = {k: d for k, d in enumerate(dopplers or []) if d is not None}
    rows = Doppler.max_rows(block, LUCKY7.sampling_freq, time_shard.DOPPLER_CADENCE)
    out = [[] for _ in range(s)]
    for t in range(-(-n // block)):
        blk = np.zeros((s, block), np.complex64)
        part = streams[:, t * block : (t + 1) * block]
        blk[:, : part.shape[1]] = part
        x = torch.from_numpy(np.stack([blk.real, blk.imag], axis=1).astype(np.float32)).to(pipe.device)
        tables = None
        if dops:
            segs = {k: d.device_segments(block, +1, max_batch=time_shard.DOPPLER_CADENCE) for k, d in dops.items()}
            tables = doppler_tables_from_numpy(segment_tables(segs, rows, s), s, device=pipe.device)
        state, sym, cnt = step(state, x, tables)
        for k in range(s):
            out[k].append(_lane(sym.cpu(), cnt.cpu(), k))
    return [np.concatenate(o) for o in out]


def _equal(what: str, *pairs) -> None:
    """Raise unless each (sharded, unsharded) pair of arrays is equal."""
    for got, want in pairs:
        if not np.array_equal(np.asarray(got), np.asarray(want)):
            raise AssertionError(f"{what}: the sharded symbols differ from the unsharded step's")


def _lucky7_dopplers(count: int):
    from sdrmodem_tpu_torch.dsp.doppler import Doppler

    return [Doppler(**DOPPLER) if s == 0 else None for s in range(count)]


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run one pass of the sharded pipeline on an ``n_devices`` mesh:
    channel-parallel steps and time-sharded demodulation with halo and
    clock-state hand-off.  Returns what each case ran and compared."""
    devs = mesh_devices(n_devices, devices)
    if len(devs) != n_devices:
        raise ValueError(f"{len(devs)} devices for a mesh of {n_devices}")
    cfg = LUCKY7
    rng = np.random.default_rng(0)
    report = {"devices": [str(resolve_device(d)) for d in devs]}

    # (a) channel-parallel: C channels sharded over the mesh, carried state
    mesh = Mesh(devs, "channel")
    channels, block = 2 * n_devices, 2048
    sharded = ShardedChannelDemod(cfg, block, channels, mesh)
    state = sharded.init_state()
    iq = (rng.standard_normal((channels, block)) + 1j * rng.standard_normal((channels, block))).astype(np.complex64)
    upipe = DemodPipeline(cfg, block, device=devs[0])
    ustep = upipe.make_batched_step("pallas")
    ustate = upipe.init_state(channels)
    ux = torch.from_numpy(np.stack([iq.real, iq.imag], axis=1).astype(np.float32)).to(upipe.device)
    nv = torch.full((channels,), block, dtype=torch.int32, device=upipe.device)
    for _ in range(2):
        state, symbols, count = sharded.step(state, sharded.place_input(iq))
        ustate, usym, ucnt = ustep(ustate, ux, nv)
        _equal("(a) ShardedChannelDemod", (symbols, usym.cpu()), (count, ucnt.cpu()))
    assert symbols.shape[0] == channels
    report["a_channel_sharded"] = {"channels": channels, "block": block, "symbols": int(count.sum())}

    # (b) time-parallel: one long stream sharded into blocks with halo exchange
    tmesh = Mesh(devs, "time")
    stream = (rng.standard_normal(n_devices * STREAM_BLOCK)
              + 1j * rng.standard_normal(n_devices * STREAM_BLOCK)).astype(np.complex64)
    out, n = time_shard.demod_time_sharded(stream, cfg, tmesh, clock_backend="scan")
    assert n > 0
    _equal("(b) demod_time_sharded", (out, _unsharded_streams(stream[None], STREAM_BLOCK, devs[0])[0]))
    report["b_time_sharded"] = {"samples": len(stream), "symbols": n}

    # (c) the full-block fast path a shard: the scan clock, then the
    # production kernels, lane 0 equal to the unsharded fused step
    full = ShardedChannelDemodFull(cfg, block, channels, mesh, clock_backend="scan")
    fstate = full.init_state()
    fpipe = DemodPipeline(cfg, block, device=devs[0])
    fstep = fpipe.make_batched_step_full("scan")
    ufstate = fpipe.init_full_state(channels)
    for _ in range(2):
        fstate, fsym, fcnt = full.step(fstate, full.place_input(iq))
        ufstate, ufsym, ufcnt = fstep(ufstate, ux)
        _equal("(c) ShardedChannelDemodFull scan", (fsym, ufsym.cpu()), (fcnt, ufcnt.cpu()))
    assert int(np.asarray(fcnt).sum()) > 0

    prod = ShardedChannelDemodFull(cfg, 1024, channels, mesh, clock_backend="pallas")
    piq = iq[:, :1024]
    pst = prod.init_state()
    ppipe = DemodPipeline(cfg, 1024, device=devs[0])
    assert ppipe.fused_step_available(128, 256)
    pstep = ppipe.make_batched_step_full("pallas", front="step", chunk=256)
    ust = ppipe.init_full_state(1)
    x0 = torch.from_numpy(np.stack([piq[0].real, piq[0].imag])[None].astype(np.float32)).to(ppipe.device)
    for _ in range(2):
        pst, psym, pcnt = prod.step(pst, prod.place_input(piq))
        ust, usym, ucnt = pstep(ust, x0)
        assert int(pcnt.sum()) > 0
        _equal("(c) sharded production kernels", (_lane(psym, pcnt, 0), _lane(usym.cpu(), ucnt.cpu(), 0)))
    report["c_full_sharded"] = {"scan_symbols": int(fcnt.sum()), "pallas_lane0_symbols": int(pcnt[0].sum())}

    # (d) the pipelined path: 2n streams in the skewed systolic layout,
    # stream 0 with the pass's Doppler tables staged in the same skew
    s_streams = 2 * n_devices
    samples = n_devices * STREAM_BLOCK
    streams = (rng.standard_normal((s_streams, samples))
               + 1j * rng.standard_normal((s_streams, samples))).astype(np.complex64)
    pouts = time_shard.demod_pipelined(streams, cfg, tmesh, clock_backend="scan",
                                       dopplers=_lucky7_dopplers(s_streams))
    assert len(pouts) == s_streams
    alone = _unsharded_streams(streams, STREAM_BLOCK, devs[0], _lucky7_dopplers(s_streams))
    for s in range(s_streams):
        _equal(f"(d) demod_pipelined stream {s}", (pouts[s], alone[s]))
    rep = time_shard.pipeline_schedule_report(n_devices, samples, cfg, s_streams)
    assert rep["idle_device_rounds"] == 0 and rep["streams_per_group"] == 2
    report["d_pipelined"] = {"streams": s_streams, "samples": samples,
                             "symbols": int(sum(len(o) for o in pouts)), "schedule": rep}

    # (e) the 2-D (channel x time) grid: channel shards, each a time mesh
    if n_devices >= 4 and n_devices % 2 == 0:
        half = n_devices // 2
        meshes = [Mesh(devs[:half], "time"), Mesh(devs[half:], "time")]
        giq = (rng.standard_normal((2, 8192)) + 1j * rng.standard_normal((2, 8192))).astype(np.complex64)
        gout = time_shard.demod_grid_sharded(giq, cfg, meshes, clock_backend="scan")
        assert len(gout) == 2
        galone = _unsharded_streams(giq, 8192 // half, devs[0])
        for ch in range(2):
            _equal(f"(e) demod_grid_sharded channel {ch}", (gout[ch], galone[ch]))
        report["e_grid"] = {"grid": [2, half], "symbols": int(sum(len(o) for o in gout))}
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--devices", type=int, default=4, help="shards of the dry run's mesh")
    add_device(parser)
    args = parser.parse_args(argv)
    dev = start(args.device)
    fn, (iq,) = entry(dev)
    symbols, count = fn(iq)
    print(f"entry: FskDemodulator.process on {tuple(iq.shape)} complex64 -> symbols "
          f"{tuple(symbols.shape)}, counts {count.cpu().tolist()}", flush=True)
    devices = [dev] * args.devices if dev.type == "cpu" else None
    report = dryrun_multichip(args.devices, devices)
    print(json.dumps({"ok": True, **report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
