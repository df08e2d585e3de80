"""Several processes on one time mesh: run ``demod_pipelined`` across
worker processes joined with ``torch.distributed``, and hold their symbols
to the same call in one process.

The port's twin of the JAX package's ``tools/multihost.py``.  N worker
processes join one process group (``init_process_group`` on a free local
port); each owns D / N shards, a contiguous run of one time mesh of D
shards, and runs ``parallel/time_shard.py:demod_pipelined`` with the halo
and clock-state hops (``Mesh.ring_shift``) and the final gather
(``Mesh.fetch``) crossing the process boundary.  The orchestrating process
then runs the same call on a one-process mesh of D shards and prints one
JSON record with the JAX tool's keys (``ok``, ``mechanism``,
``cross_process``, ``single_process``, ``symbols_compared``,
``max_lsb_diff_vs_single_process``, ``mismatched_symbols``), plus the
backend and, on the card, the card's name and power limit.  It writes the
record only with ``--out``, and exits 1 unless no symbol differs.

``--backend``: ``nccl`` (the default on the card) sends device tensors and
needs a card a rank; ``gloo`` (the default with ``--device cpu``) sends CPU
tensors, so on the card every hop is staged through host memory and the
record says so.  On a machine with one card, pass ``--backend gloo``: every
rank's shards then sit on that card.

Usage: python -m sdrmodem_tpu_torch.tools.multihost [--procs 2]
       [--shards 2] [--streams 16] [--samples 32768] [--backend gloo|nccl]
       [--device cpu] [--out MULTIHOST_GPU.json] [--timeout 600]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
LUCKY7 = (48000, 4800, 5000, 2, 2000, True)


def make_streams(n_streams: int, n: int) -> np.ndarray:
    """The JAX tool's streams: the corrected lucky7 capture at offsets 777
    samples apart, each with its own noise from seed 42."""
    iq = np.fromfile(ROOT / "tests" / "fixtures" / "lucky7.expected.cf32", dtype=np.complex64)
    iq = np.resize(iq, (n_streams - 1) * 777 + n)
    rng = np.random.default_rng(42)
    return np.stack([
        iq[s * 777 : s * 777 + n] + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        for s in range(n_streams)
    ]).astype(np.complex64)


def run_pipeline(mesh, n_streams: int, n: int, tag: str):
    """``demod_pipelined`` of the tool's streams on ``mesh``: (symbols a
    stream, the record's numbers)."""
    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
    from sdrmodem_tpu_torch.parallel.time_shard import demod_pipelined

    streams = make_streams(n_streams, n)
    t0 = time.perf_counter()
    outs = demod_pipelined(streams, FskDemodConfig(*LUCKY7), mesh)
    dt = time.perf_counter() - t0
    print(f"[{tag}] procs={mesh.world} shards={mesh.size} streams={n_streams} "
          f"block={-(-n // mesh.size)} seconds={dt:.3f}", file=sys.stderr, flush=True)
    return outs, dict(processes=mesh.world, devices=mesh.size, streams=n_streams,
                      samples_per_stream=n, seconds=round(dt, 3))


def rank_device(device: str, backend: str, rank: int) -> str:
    """This rank's device: the CPU, or with NCCL card ``rank`` (one a
    rank), with gloo the card ``rank`` modulo the cards there are."""
    if device == "cpu":
        return "cpu"
    import torch

    count = torch.cuda.device_count()
    if backend == "nccl" and count <= rank:
        raise RuntimeError(f"nccl puts one rank on a card: rank {rank} of {count} cards; "
                           "pass --backend gloo to share a card")
    return f"cuda:{rank % max(count, 1)}"


def worker(args) -> None:
    """One rank: join the group, run its shards of the mesh, and (rank 0)
    save every stream's symbols."""
    import torch
    import torch.distributed as dist

    from sdrmodem_tpu_torch.parallel.mesh import Mesh

    dev = rank_device(args.device, args.backend, args.rank)
    if dev != "cpu":
        torch.cuda.set_device(dev)
    dist.init_process_group(args.backend, init_method=f"tcp://127.0.0.1:{args.port}",
                            world_size=args.procs, rank=args.rank)
    try:
        mesh = Mesh([dev] * args.shards, "time", group=dist.group.WORLD)
        outs, meta = run_pipeline(mesh, args.streams, args.samples, f"rank{args.rank}")
        meta["staged_through_host"] = mesh.staged
        if args.rank == 0:
            np.savez(pathlib.Path(args.outdir) / "multihost_out.npz",
                     **{f"s{i}": o for i, o in enumerate(outs)}, meta=json.dumps(meta))
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def orchestrate(args) -> dict:
    """Start the workers, wait for them (stopping every one on a failure or
    the timeout), run the one-process reference, and compare."""
    from sdrmodem_tpu_torch.ops._build import resolve_device
    from sdrmodem_tpu_torch.parallel.mesh import Mesh

    device = resolve_device(args.device)  # the card unless --device cpu; raises without one
    with tempfile.TemporaryDirectory(prefix="sdrm_multihost_") as outdir:
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")]))}
        port = free_port()
        cmd = [sys.executable, "-m", "sdrmodem_tpu_torch.tools.multihost", "--port", str(port),
               "--procs", str(args.procs), "--shards", str(args.shards), "--streams", str(args.streams),
               "--samples", str(args.samples), "--backend", args.backend, "--outdir", outdir,
               "--device", args.device]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env) for r in range(args.procs)]
        try:
            deadline = time.monotonic() + args.timeout
            codes = [p.wait(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if codes != [0] * args.procs:
            raise RuntimeError(f"worker exit codes {codes}")
        with np.load(pathlib.Path(outdir) / "multihost_out.npz") as cross_file:
            cross = {k: cross_file[k] for k in cross_file.files}
    meta = json.loads(str(cross.pop("meta")))

    single = [str(device)] * (args.procs * args.shards)
    ref_outs, ref_meta = run_pipeline(Mesh(single, "time"), args.streams, args.samples, "single")
    max_lsb, mismatched, total = 0, 0, 0
    for i in range(args.streams):
        a, b = cross[f"s{i}"], np.asarray(ref_outs[i])
        if len(a) != len(b):
            raise RuntimeError(f"stream {i}: {len(a)} symbols across processes, {len(b)} in one")
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        max_lsb = max(max_lsb, int(d.max()) if len(d) else 0)
        mismatched += int((d != 0).sum())
        total += len(a)
    where = "cpu devices" if device.type == "cpu" else f"shards on {device.type}"
    hop = ("staged through host memory" if meta.get("staged_through_host")
           else "device to device" if args.backend == "nccl" else "host to host")
    report = {
        "ok": mismatched == 0,
        "mechanism": f"torch.distributed ({args.backend}), {args.procs} processes x {args.shards} "
                     f"{where}, one {args.procs * args.shards}-shard time mesh; ring_shift halo and "
                     f"clock-state hops cross the process boundary ({hop})",
        "backend": args.backend,
        "cross_process": meta,
        "single_process": ref_meta,
        "symbols_compared": total,
        "max_lsb_diff_vs_single_process": max_lsb,
        "mismatched_symbols": mismatched,
    }
    if device.type == "cuda":
        from sdrmodem_tpu_torch.tools._common import card

        report["card"] = card()
    return report


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--shards", type=int, default=2, help="shards a process")
    ap.add_argument("--streams", type=int, default=16)
    ap.add_argument("--samples", type=int, default=32768, help="samples a stream")
    ap.add_argument("--device", default="cuda", help="cpu for CPU shards (default: the card)")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="default nccl on the card, gloo with --device cpu")
    ap.add_argument("--out", default=None, help="write the record here")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds the workers may take")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--outdir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.backend is None:
        args.backend = "gloo" if args.device == "cpu" else "nccl"
    return args


def main(argv=None) -> int:
    args = parse(argv)
    if args.rank is not None:
        worker(args)
        return 0
    report = orchestrate(args)
    text = json.dumps(report, indent=2)
    print(text)
    if args.out:
        pathlib.Path(args.out).write_text(text + "\n")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
