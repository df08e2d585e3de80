"""Split the TX kernels' (B5, B6: ``csrc/tx.cu``) time on the card.

Builds copies of ``sdrmodem_tpu_torch/csrc/tx.cu`` under
``build/tx_split/``, each with one part of the work taken out or changed, loads each
in place of the TX library and times the wrappers at the shapes of
``chip_smoke.py``'s kernel phase (B5 on packed bytes at 2048 B and 32 KiB,
I = 2, and 32 KiB, I = 60; B6 at 128 x 2048 B, I = 2), 20 calls replayed
in one CUDA graph as ``chip_smoke.py`` times them.  Variants:

- ``as built``: the source unchanged;
- ``fast sincos``: ``__sincosf`` in place of the precise ``sincosf``;
- ``no sincos``: the sample is (phase, 0), no cos/sin at all;
- ``thread rows``: B5 at I = 60 without the warp's row-at-a-time stores,
  each thread writing its own row of 480 bytes, two samples a store;
- ``launch 1 only``: the writer returns at once, so what is left is the
  tile totals (where the call has them) and an empty launch;
- ``writer only``: launch 1 is skipped (the writer reads stale totals);
- ``B5 runs of S samples``, ``B6 runs of S samples``: the run's samples
  (csrc/tx.cu kFoldRunSamples, kBatchRunSamples; ops/tx.py RUN_SAMPLES)
  set to S.

Then a probed copy (``clock64()`` read by each writer block's thread 0)
splits the writer launch at each shape, as means over its blocks: cycles
in the prologue (the earlier tiles), reading and summing the thread's own
rows with the block's scan, and writing; and
``block_us`` (a block's ``%globaltimer`` span) beside ``span_us`` (first
block's start to last block's end).

The outputs of all but ``as built`` are wrong by design; only the times
mean anything.  Run from the root of a checkout on a machine with one
CUDA card: ``python3 tx_split.py``.  Prints the card and one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "build" / "tx_split"

VARIANTS = {
    "as built": (),
    "fast sincos": (("  sincosf(static_cast<float>(phase), &s, &c);",
                     "  __sincosf(static_cast<float>(phase), &s, &c);"),),
    "no sincos": (("  sincosf(static_cast<float>(phase), &s, &c);",
                   "  s = 0.f;\n  c = static_cast<float>(phase);"),),
    "thread rows": (("constexpr int kRowInterp = 32;", "constexpr int kRowInterp = 1 << 30;"),),
    "launch 1 only": (("  const int tile = blockIdx.x;\n  double pre = 0.0;\n",
                       "  return;\n  const int tile = blockIdx.x;\n  double pre = 0.0;\n"),
                      ("  __shared__ double s_pre[kBatchRuns][kBatchLanes];\n",
                       "  return;\n  __shared__ double s_pre[kBatchRuns][kBatchLanes];\n")),
    "writer only": (("    tx_fold_totals_kernel<<<", "    if (false) tx_fold_totals_kernel<<<"),
                    ("    tx_lanes_totals_kernel<<<", "    if (false) tx_lanes_totals_kernel<<<")),
}
RUNS = {"B5 runs of 2 samples": ("folded", 2), "B5 runs of 8 samples": ("folded", 8),
        "B6 runs of 16 samples": ("batched", 16)}
CONSTANTS = {"folded": "kFoldRunSamples", "batched": "kBatchRunSamples"}
for _name, (_kind, _samples) in RUNS.items():
    _line = [ln for ln in (pathlib.Path(__file__).resolve().parent / "sdrmodem_tpu_torch" / "csrc" / "tx.cu")
             .read_text().splitlines() if ln.startswith(f"constexpr int {CONSTANTS[_kind]} = ")]
    VARIANTS[_name] = ((_line[0], f"constexpr int {CONSTANTS[_kind]} = {_samples};"),) if _line else ()
ONLY = {"thread rows": "I = 60"}  # variants that change only some shapes


RECORD = (
    "    unsigned long long g1;\n    unsigned sm;\n"
    "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g1));\n"
    "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
    "    unsigned long long* r = g_split + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 8;\n"
    "    r[0] = c2 - c0; r[1] = c3 - c2; r[2] = clock64() - c3; r[4] = g0; r[5] = g1; r[6] = sm;\n")
START = ("  const long long c0 = clock64();\n  unsigned long long g0;\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g0));\n")
PHASE_PROBES = (
    ("#include <stdint.h>\n", "#include <stdint.h>\n__device__ unsigned long long g_split[65536 * 8];\n"),
    ("  __shared__ double s_warp[kWarps];\n  const int tile = blockIdx.x;\n",
     "  __shared__ double s_warp[kWarps];\n" + START + "  const int tile = blockIdx.x;\n"),
    ("  pre = block_sum(pre, s_warp);\n", "  pre = block_sum(pre, s_warp);\n  const long long c2 = clock64();\n"),
    ("  const double start = wrap_2pi(phase0 + pre + block_exclusive_scan(own, s_warp));\n",
     "  const double start = wrap_2pi(phase0 + pre + block_exclusive_scan(own, s_warp));\n"
     "  const long long c3 = clock64();\n"),
    ("  if (n0 < n && n1 == n) *phase_out = end;\n}",
     "  if (threadIdx.x == 0) {\n" + RECORD + "  }\n  if (n0 < n && n1 == n) *phase_out = end;\n}"),
    ("  __shared__ double s_run[kBatchRuns][kBatchLanes];\n  const int tile = blockIdx.x;\n",
     "  __shared__ double s_run[kBatchRuns][kBatchLanes];\n" + START + "  const int tile = blockIdx.x;\n"),
    ("  const RunBits b = live && n0 < n ? load_run(f, x, n0, n1) : RunBits{};\n",
     "  const long long c2 = clock64();\n  const RunBits b = live && n0 < n ? load_run(f, x, n0, n1) : RunBits{};\n"),
    ("  LaneOut o{out, lanes, lane};\n", "  const long long c3 = clock64();\n  LaneOut o{out, lanes, lane};\n"),
    ("  if (n1 == n) phase_out[lane] = ph;\n}",
     "  if (threadIdx.x == 0 && threadIdx.y == 0) {\n" + RECORD + "  }\n  if (n1 == n) phase_out[lane] = ph;\n}"),
    ('extern "C" const char* cuda_error_string(int err) {\n',
     'extern "C" int tx_split_read(void* dst, int n) {\n'
     "  return (int)cudaMemcpyFromSymbol(dst, g_split, (size_t)n * 8);\n}\n\n"
     'extern "C" const char* cuda_error_string(int err) {\n'),
)


def build_variants():
    """One library a variant; returns {variant: path}."""
    from sdrmodem_tpu_torch.ops import _build

    src = (_build.CSRC / "tx.cu").read_text()
    procs = {}
    for i, (name, subs) in enumerate({**VARIANTS, "phases": PHASE_PROBES}.items()):
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"tx_split: {name}: the probe does not match tx.cu once: {old!r}")
            text = text.replace(old, new)
        d = OUT / str(i)
        d.mkdir(parents=True, exist_ok=True)
        (d / "tx.cu").write_text(text)
        lib = d / "libtx.so"
        cmd = [_build._nvcc(), *_build._flags("tx"), "-o", str(lib), str(d / "tx.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"tx_split: nvcc failed for {name}:\n{log}")
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tx_split: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from sdrmodem_tpu_torch.ops import _build
    from sdrmodem_tpu_torch.ops import tx as tx_ops

    dev = torch.device("cuda")
    print(cs.card(), flush=True)
    rng = np.random.default_rng(15)
    calls = {}
    for fs, nb in ((cs.TX_FS[0], 2048), (cs.TX_FS[0], cs.TXDATA_MAX), (cs.TX_FS[1], cs.TXDATA_MAX)):
        mod = cs.tx_mod(fs, dev)
        data = torch.from_numpy(rng.integers(0, 256, nb).astype(np.uint8)).to(dev)
        hist = torch.from_numpy(rng.choice([-1.0, 1.0], mod.k - 1).astype(np.float32)).to(dev)
        args = (data, mod.taps, mod.interpolation, mod.config.sensitivity, 1.0, hist)
        calls[f"B5 {nb} B at I = {mod.interpolation}"] = lambda a=args: tx_ops.gfsk_tx_folded_iq(*a)
    mod = cs.tx_mod(cs.TX_FS[0], dev)
    nrz = torch.from_numpy(rng.choice([-1.0, 1.0], (2048 * 8, cs.LANES)).astype(np.float32)).to(dev)
    hist = torch.zeros((mod.k - 1, cs.LANES), dtype=torch.float32, device=dev)
    ph0 = torch.zeros(cs.LANES, dtype=torch.float64, device=dev)
    args = (nrz, mod.taps, mod.interpolation, mod.config.sensitivity, ph0, hist)
    calls[f"B6 {cs.LANES} x 2048 B at I = {mod.interpolation}"] = lambda: tx_ops.gfsk_tx_call(*args)
    blocks = {}
    for fs, nb in ((cs.TX_FS[0], 2048), (cs.TX_FS[0], cs.TXDATA_MAX), (cs.TX_FS[1], cs.TXDATA_MAX)):
        m = cs.tx_mod(fs, dev)
        blocks[f"B5 {nb} B at I = {m.interpolation}"] = tx_ops.tx_plan(nb * 8, m.interpolation, m.k).tiles
    blocks[f"B6 {cs.LANES} x 2048 B at I = {mod.interpolation}"] = (
        tx_ops.tx_plan(2048 * 8, mod.interpolation, mod.k, cs.LANES).tiles * (cs.LANES // 32))

    res = {}
    libs = build_variants()
    phase_lib = libs.pop("phases")
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in tx_ops._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _build._libs["tx"] = lib
        kind, samples = RUNS.get(name, ("folded", tx_ops.RUN_SAMPLES["folded"]))
        built = dict(tx_ops.RUN_SAMPLES)
        tx_ops.RUN_SAMPLES[kind] = samples  # the wrapper's plan follows the variant's constants
        times = {}
        for shape, fn in calls.items():
            if ONLY.get(name, shape) not in shape:
                continue
            fn()
            torch.cuda.synchronize()
            times[shape] = cs.graph_ms(torch, fn, 20)[0]
        tx_ops.RUN_SAMPLES.update(built)
        res[name] = times
    print(json.dumps(res), flush=True)
    print(json.dumps(phases(torch, phase_lib, calls, blocks)), flush=True)
    return 0


def load(path, tx_ops, _build):
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in tx_ops._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    _build._libs["tx"] = lib
    return lib


def phases(torch, path, calls, blocks):
    """The probed writer's split at each shape (see the module's note)."""
    from sdrmodem_tpu_torch.ops import _build
    from sdrmodem_tpu_torch.ops import tx as tx_ops

    lib = load(path, tx_ops, _build)
    lib.tx_split_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    out = {}
    for shape, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        nb = blocks[shape]
        buf = np.zeros(nb * 8, np.uint64)
        if lib.tx_split_read(buf.ctypes.data, nb * 8) != 0:
            raise SystemExit("tx_split: reading the probes failed")
        rec = buf.reshape(nb, 8).astype(np.float64)
        out[shape] = dict(
            blocks=nb, sms=int(len(np.unique(rec[:, 6]))),
            prologue_cycles=float(rec[:, 0].mean()), own_and_scan_cycles=float(rec[:, 1].mean()),
            write_cycles=float(rec[:, 2].mean()),
            block_us=float((rec[:, 5] - rec[:, 4]).mean() / 1e3),
            span_us=float((rec[:, 5].max() - rec[:, 4].min()) / 1e3))
    return out


if __name__ == "__main__":
    sys.exit(main())
