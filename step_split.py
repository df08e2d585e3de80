"""Split the fused step's (B7, ``csrc/step.cu``) time on the card.

Builds a copy of ``sdrmodem_tpu_torch/csrc/`` under ``build/step_split/``
with probes added to ``fused_step_kernel`` (``clock64()`` around each
producer's ``front_tile`` and the walker's ``clock_chunk``, the block's
``%smid``, the walker's ``%warpid``, ``%globaltimer`` at its start and
end), loads it in place of the step's library, and runs ``fused_step`` at
the lucky7 shapes of ``chip_smoke.py`` with every lane's Doppler rows.
Prints one JSON line a shape:

- ``ms``: the probed kernel's time by CUDA events (the probes add ~2%);
- ``block_ms``, ``walker_ms``: a block's time and its walker's time in its
  chunk walks, ``walker_us_a_step`` the latter over the lane's symbols;
- ``producer_ms_by_warp``: each producer warp's time in its tiles (warps
  0-2, 4-6, 8, 9), barrier waits included;
- ``walker_subpartition``: the walker's ``%warpid % 4`` over the blocks,
  and ``pairs``, for SMs running two blocks at once, whether their walkers
  share a sub-partition.

The side that takes longer a block (the walker, or the slowest producer
warp) sets the kernel's pace.  Run from the root of a checkout on a
machine with one CUDA card: ``python3 step_split.py``.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
SHAPES = ((128, 262144), (264, 262144), (128, 1 << 20))  # lanes x rows; 264 = two blocks on each SM
SLOTS = 6 + 256  # a block's record: SM, walker warp id, cycles, walker cycles, start, end; producers

PROBES = (
    ('#include "stage.cuh"\n',
     '#include "stage.cuh"\n\n'
     "__device__ unsigned long long g_split[1024 * %d];\n" % SLOTS),
    ("  const int n_tiles = p.block / r;\n",
     "  const int n_tiles = p.block / r;\n"
     "  const long long t_start = clock64();\n"
     "  unsigned long long g_start;\n"
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_start));\n'
     "  long long busy = 0;\n"),
    ("        front_tile<D>(p, L, sm, g, n_tiles, pt);\n",
     "        const long long a0 = clock64();\n"
     "        front_tile<D>(p, L, sm, g, n_tiles, pt);\n"
     "        busy += clock64() - a0;\n"),
    ("      clock_chunk(p, sm + L.bank, sm + L.slots + ((g - 1) & 1) * L.slot_rows, g - 1, s);\n",
     "      const long long a0 = clock64();\n"
     "      clock_chunk(p, sm + L.bank, sm + L.slots + ((g - 1) & 1) * L.slot_rows, g - 1, s);\n"
     "      busy += clock64() - a0;\n"),
    ("  // the clock state and the front's histories out\n",
     "  if (c < 1024) {\n"
     "    unsigned long long* rec = g_split + (long long)c * %d;\n"
     "    if (walker) {\n"
     "      unsigned v, w;\n"
     "      unsigned long long g_end;\n"
     '      asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(v));\n'
     '      asm volatile("mov.u32 %%0, %%%%warpid;" : "=r"(w));\n'
     '      asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(g_end));\n'
     "      rec[0] = v;\n"
     "      rec[1] = w;\n"
     "      rec[2] = (unsigned long long)(clock64() - t_start);\n"
     "      rec[3] = (unsigned long long)busy;\n"
     "      rec[4] = g_start;\n"
     "      rec[5] = g_end;\n"
     "    }\n"
     "    if (pt >= 0) rec[6 + pt] = (unsigned long long)busy;\n"
     "  }\n"
     "  // the clock state and the front's histories out\n" % SLOTS),
    ('extern "C" const char* cuda_error_string(int err) {\n',
     'extern "C" int step_split_read(void* dst, int n) {\n'
     "  return (int)cudaMemcpyFromSymbol(dst, g_split, (size_t)n * 8);\n"
     "}\n\n"
     'extern "C" const char* cuda_error_string(int err) {\n'),
)


def probed_library():
    """Build the probed copy of step.cu and return it loaded, with the
    step's own C signatures."""
    from sdrmodem_tpu_torch.ops import _build
    from sdrmodem_tpu_torch.ops import step as step_ops

    out = ROOT / "build" / "step_split"
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(_build.CSRC, out / "csrc")
    src = out / "csrc" / "step.cu"
    text = src.read_text()
    for anchor, probed in PROBES:
        if text.count(anchor) != 1:
            raise SystemExit(f"step_split: csrc/step.cu no longer has {anchor.strip()!r} once")
        text = text.replace(anchor, probed)
    src.write_text(text)
    lib_path = out / "libstep_split.so"
    run = subprocess.run([_build._nvcc(), *_build._flags("step"), "-o", str(lib_path), str(src)],
                         capture_output=True, text=True)
    if run.returncode:
        raise SystemExit(f"step_split: nvcc failed\n{run.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in step_ops._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    lib.step_split_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def split(torch, lanes, block, lib):
    """One shape: the probed kernel once warm, timed over 3 calls, then its
    last call's records."""
    import chip_smoke as cs
    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
    from sdrmodem_tpu_torch.ops import step as step_ops

    dev = torch.device("cuda")
    pipe = DemodPipeline(FskDemodConfig(*cs.LUCKY7), block, device=dev)
    p = pipe.config.clock_params()
    x = cs.capture_lanes(torch, dev, block, lanes, "lucky7.cf32")
    dop = cs.doppler_tables(cs.lane_dopplers(range(lanes)), block, lanes, dev)
    args, kw = cs.step_args(pipe.init_full_state(lanes), pipe.front_taps, pipe.bank, p, dop)
    step_ops.fused_step(x, *args, **kw)
    ms, res = cs.cuda_ms(torch, lambda: step_ops.fused_step(x, *args, **kw), 3)
    steps = res[1].sum(0).cpu().numpy().astype(np.int64)
    buf = np.zeros(lanes * SLOTS, np.uint64)
    if lib.step_split_read(buf.ctypes.data, lanes * SLOTS):
        raise SystemExit("step_split: reading the records failed")
    rec = buf.reshape(lanes, SLOTS).astype(np.int64)
    smid, warp, cycles, walker, g0, g1 = rec[:, :6].T
    prod = rec[:, 6:]
    per_ns = float(np.median(cycles / (g1 - g0)))  # the SM clock, cycles a ns
    ms_of = lambda cyc: cyc / per_ns / 1e6  # noqa: E731
    pairs = {"same": 0, "differ": 0}
    for m in np.unique(smid):
        i = np.flatnonzero(smid == m)
        for a in i:
            for b in i[i > a]:
                if g0[a] < g1[b] and g0[b] < g1[a]:
                    pairs["same" if warp[a] % 4 == warp[b] % 4 else "differ"] += 1
    return dict(
        lanes=lanes, rows=block, ms=ms, sm_ghz=per_ns,
        block_ms=float(ms_of(cycles).mean()), walker_ms=float(ms_of(walker).mean()),
        walker_us_a_step=[float(v) for v in np.percentile(ms_of(walker) * 1e3 / np.maximum(steps, 1), (0, 50, 100))],
        producer_ms_by_warp={w: float(ms_of(prod[:, k * 32:(k + 1) * 32]).mean())
                             for k, w in enumerate((0, 1, 2, 4, 5, 6, 8, 9))},
        walker_subpartition={k: int((warp % 4 == k).sum()) for k in range(4)},
        walker_warp_ids=sorted({int(v) for v in warp}), pairs=pairs,
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("step_split: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from sdrmodem_tpu_torch.ops import _build

    _build._libs["step"] = probed_library()  # fused_step now launches the probed kernel
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for lanes, block in SHAPES:
        print(json.dumps(split(torch, lanes, block, _build._libs["step"])), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
