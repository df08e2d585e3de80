"""Build the CUDA sources under ``csrc/`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>-<hash>.so`` at the
root of the checkout, on first use.  ``<hash>`` covers the source's
compiler flags, its text and the text of every shared header
``csrc/*.cuh``, so a change of any of them (the clock's ``-fmad=false``,
the FIR kernel in ``fir.cuh``) names a new library and a stale one is
never loaded.  No PyTorch headers are included, so a build takes seconds.
Builds and loads take one lock: the server's sessions call the kernels
from worker threads, and two first calls of one source build it once.  Every C entry
point returns the ``cudaGetLastError()`` value after its launches, and
``check`` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]
# per-source flags: nothing of the clocks' f32 arithmetic may be contracted
# into FMAs.  mm_step.cuh writes the M&M step with explicit round-to-nearest
# intrinsics, so the fused step (step.cu) builds with the front end's
# default flags and gives front.cu's bits, cosf and sinf included.
EXTRA_FLAGS = {"clock": ["-fmad=false"]}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.RLock()  # one build or load at a time in this process


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return path


def _flags(name: str) -> list[str]:
    return [*NVCC_FLAGS, *EXTRA_FLAGS.get(name, [])]


def library_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(_flags(name)).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: list[str] | None = None) -> dict[str, str]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together.  Returns each compiled source's compiler output (register
    and shared-memory use from ``-Xptxas -v``); raises if any build fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock:
        return _build(names)


def _build(names: list[str]) -> dict[str, str]:
    todo = {n: library_path(n) for n in names}
    todo = {n: lib for n, lib in todo.items() if not lib.exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, lib in todo.items():
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.so.tmp"
        cmd = [nvcc, *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            lib,
        )
    logs, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError(
            "nvcc failed for "
            + ", ".join(failed)
            + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if missing.

    ``signatures`` maps each C function to its ``argtypes``: pointers and
    the stream are ``c_void_p``, so ctypes never cuts them to 32 bits."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, or the current CUDA device when it
    is None.  Raises when a CUDA device is asked for and there is none:
    nothing falls back to the CPU unless the caller passes ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for {dev}; pass device='cpu' for the plain versions")
        if dev.index is None:
            # tensors report "cuda:N", so name the card the way they do
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_kind(x, what: str) -> str:
    """"cpu" (run the plain version) or "cuda" (launch the kernel) for the
    tensor ``x``; raise for any other device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x.device.type


def check_arg(kernel: str, name: str, t, shape, dtype, device) -> None:
    """Raise unless tensor ``t`` is what the kernel reads through its
    pointer: ``dtype``, ``shape``, contiguous, on ``device``."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{kernel} kernel: {name} must be {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{kernel} kernel: {name} must be contiguous")


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (refused launch, bad config)."""
    if rc != 0:
        msg = lib.cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
