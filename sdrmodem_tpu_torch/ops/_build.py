"""Build the CUDA sources under ``csrc/`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>-<flags>.so`` at the
root of the checkout, on first use or when the source is newer than the
library.  ``<flags>`` is a hash of the source's compiler flags, so a
change of flags (the clock's ``-fmad=false``, say) builds a new library.
No PyTorch headers are included, so a build takes seconds.  Every C entry
point returns the ``cudaGetLastError()`` value after its launches, and
``check`` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

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
# per-source flags: the clock's f32 step must never be contracted into FMAs
EXTRA_FLAGS = {"clock": ["-fmad=false"]}

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return path


def _flags(name: str) -> list[str]:
    return [*NVCC_FLAGS, *EXTRA_FLAGS.get(name, [])]


def library_path(name: str) -> Path:
    digest = hashlib.sha1(" ".join(_flags(name)).encode()).hexdigest()[:10]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    src = CSRC / f"{name}.cu"
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def build(names: list[str] | None = None) -> dict[str, str]:
    """Compile every stale source, one ``nvcc`` per source, all started
    together.  Returns each compiled source's compiler output (register
    and shared-memory use from ``-Xptxas -v``); raises if any build fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.so.tmp"
        cmd = [nvcc, *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
        )
    logs, failed = {}, []
    for name, (proc, tmp) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError(
            "nvcc failed for "
            + ", ".join(failed)
            + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if stale.

    ``signatures`` maps each C function to its ``argtypes``: pointers and
    the stream are ``c_void_p``, so ctypes never cuts them to 32 bits."""
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
