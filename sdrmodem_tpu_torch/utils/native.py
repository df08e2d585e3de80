"""ctypes bindings for the native host runtime (native/sdrm_host.cpp).

Sample-format conversions and the SPSC block queue run natively when the
library is built (``cmake -B build && ninja -C build`` under native/);
every entry point has a numpy fallback so the framework works without the
build step.

A copy of ``sdrmodem_tpu/utils/native.py`` with its imports pointing at the port.
"""

from __future__ import annotations

import ctypes
import pathlib

import numpy as np

_LIB = None
_SEARCH = [
    pathlib.Path(__file__).resolve().parents[2] / "native" / "build" / "libsdrm_host.so",
    pathlib.Path("/usr/local/lib/libsdrm_host.so"),
]


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    for path in _SEARCH:
        if path.exists():
            lib = ctypes.CDLL(str(path))
            lib.sdrm_int16_to_float.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_float]
            lib.sdrm_float_to_int16.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_float]
            lib.sdrm_float_to_int8.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_float]
            lib.sdrm_bytes_to_nrz.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
            lib.sdrm_iq_int16_to_planar_float.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_size_t, ctypes.c_float]
            lib.sdrm_queue_create.restype = ctypes.c_void_p
            lib.sdrm_queue_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int]
            lib.sdrm_queue_destroy.argtypes = [ctypes.c_void_p]
            lib.sdrm_queue_put.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
            lib.sdrm_queue_take.restype = ctypes.c_int64
            lib.sdrm_queue_take.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
            lib.sdrm_queue_interrupt.argtypes = [ctypes.c_void_p]
            lib.sdrm_queue_dropped.restype = ctypes.c_uint64
            lib.sdrm_queue_dropped.argtypes = [ctypes.c_void_p]
            _LIB = lib
            return lib
    return None


def available() -> bool:
    return _load() is not None


def int16_to_float(x: np.ndarray, scale: float) -> np.ndarray:
    lib = _load()
    x = np.ascontiguousarray(x, np.int16)
    if lib is None:
        return (x.astype(np.float32) / np.float32(scale)).astype(np.float32)
    out = np.empty(x.size, np.float32)
    lib.sdrm_int16_to_float(x.ctypes.data, out.ctypes.data, x.size, scale)
    return out


def float_to_int16(x: np.ndarray, scale: float) -> np.ndarray:
    lib = _load()
    x = np.ascontiguousarray(x, np.float32)
    if lib is None:
        return np.clip(x * np.float32(scale), -32768, 32767).astype(np.int16)
    out = np.empty(x.size, np.int16)
    lib.sdrm_float_to_int16(x.ctypes.data, out.ctypes.data, x.size, scale)
    return out


def float_to_int8(x: np.ndarray, scale: float = 127.0) -> np.ndarray:
    lib = _load()
    x = np.ascontiguousarray(x, np.float32)
    if lib is None:
        return np.round(np.clip(x * np.float32(scale), -128, 127)).astype(np.int8)
    out = np.empty(x.size, np.int8)
    lib.sdrm_float_to_int8(x.ctypes.data, out.ctypes.data, x.size, scale)
    return out


def bytes_to_nrz(data: bytes | np.ndarray) -> np.ndarray:
    lib = _load()
    arr = np.frombuffer(bytes(data), np.uint8) if isinstance(data, (bytes, bytearray)) else np.ascontiguousarray(data, np.uint8)
    if lib is None:
        bits = np.unpackbits(arr)
        return (bits.astype(np.float32) * 2.0 - 1.0).astype(np.float32)
    out = np.empty(arr.size * 8, np.float32)
    lib.sdrm_bytes_to_nrz(arr.ctypes.data, out.ctypes.data, arr.size)
    return out


class NativeQueue:
    """SPSC block queue backed by the native ring buffer.

    Mirrors utils.queue.BufferQueue semantics (blocking/lossy, poison
    pill) for threaded (non-asyncio) producers such as device read loops.
    """

    def __init__(self, capacity: int, block_bytes: int, blocking: bool):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library not built (see native/README)")
        self._lib = lib
        self._q = lib.sdrm_queue_create(capacity, block_bytes, int(blocking))
        self.block_bytes = block_bytes

    def put(self, data: np.ndarray) -> bool:
        buf = np.ascontiguousarray(data)
        code = self._lib.sdrm_queue_put(self._q, buf.ctypes.data, buf.nbytes)
        return code == 0

    def take(self) -> bytes | None:
        out = np.empty(self.block_bytes, np.uint8)
        n = self._lib.sdrm_queue_take(self._q, out.ctypes.data, out.size)
        if n == 0:
            return None
        if n < 0:
            raise RuntimeError(f"queue take failed: {n}")
        return out[:n].tobytes()

    def interrupt(self):
        self._lib.sdrm_queue_interrupt(self._q)

    @property
    def dropped(self) -> int:
        return self._lib.sdrm_queue_dropped(self._q)

    def __del__(self):
        if getattr(self, "_q", None):
            self._lib.sdrm_queue_destroy(self._q)
            self._q = None
