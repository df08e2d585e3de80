"""libiio access seam.

The reference dlopens ``libiio.so`` and resolves a table of function
pointers (src/sdr/iio_lib.c:14-160) so the dependency is runtime-optional
AND mockable in tests.  Here the same seam is an abstract interface with
(a) a ctypes-backed implementation binding the subset of libiio the
PlutoSDR device needs, and (b) test mocks that implement it in memory
(the analog of test/iio_lib_mock.c).

A copy of ``sdrmodem_tpu/devices/iio_lib.py`` with its imports pointing at the port.
"""

from __future__ import annotations

import abc
import ctypes
import ctypes.util


class IioError(RuntimeError):
    pass


class IioLib(abc.ABC):
    """Operations the PlutoSDR device needs, device/channel handles opaque."""

    @abc.abstractmethod
    def create_context(self) -> object: ...

    @abc.abstractmethod
    def destroy_context(self, ctx) -> None: ...

    @abc.abstractmethod
    def find_device(self, ctx, name: str) -> object: ...

    @abc.abstractmethod
    def find_channel(self, device, name: str, output: bool) -> object: ...

    @abc.abstractmethod
    def channel_attr_write(self, channel, attr: str, value: str) -> int: ...

    @abc.abstractmethod
    def channel_attr_write_longlong(self, channel, attr: str, value: int) -> int: ...

    @abc.abstractmethod
    def channel_attr_write_double(self, channel, attr: str, value: float) -> int: ...

    @abc.abstractmethod
    def channel_attr_write_bool(self, channel, attr: str, value: bool) -> int: ...

    @abc.abstractmethod
    def device_attr_write_bool(self, device, attr: str, value: bool) -> int: ...

    @abc.abstractmethod
    def device_attr_write_raw(self, device, attr: str, data: bytes) -> int: ...

    @abc.abstractmethod
    def channel_enable(self, channel) -> None: ...

    @abc.abstractmethod
    def create_buffer(self, device, samples_count: int, cyclic: bool) -> object: ...

    @abc.abstractmethod
    def destroy_buffer(self, buffer) -> None: ...

    @abc.abstractmethod
    def buffer_refill(self, buffer) -> bytes: ...
    """Blocking read; returns raw interleaved int16 I/Q bytes."""

    @abc.abstractmethod
    def buffer_push(self, buffer, data: bytes) -> int: ...

    @abc.abstractmethod
    def set_timeout(self, ctx, timeout_millis: int) -> int: ...


class CtypesIioLib(IioLib):
    """Bind libiio via ctypes (dlopen analog). Raises IioError when the
    library is unavailable — the server only loads this when a PlutoSDR
    is configured, mirroring iio_lib_create()."""

    def __init__(self, path: str | None = None):
        path = path or ctypes.util.find_library("iio") or "libiio.so"
        try:
            self._lib = ctypes.CDLL(path)
        except OSError as e:
            raise IioError(f"unable to load libiio: {e}") from None
        lib = self._lib
        lib.iio_create_default_context.restype = ctypes.c_void_p
        lib.iio_context_find_device.restype = ctypes.c_void_p
        lib.iio_context_find_device.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.iio_device_find_channel.restype = ctypes.c_void_p
        lib.iio_device_find_channel.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_bool]
        lib.iio_channel_attr_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p]
        lib.iio_channel_attr_write.restype = ctypes.c_ssize_t
        lib.iio_channel_attr_write_longlong.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong]
        lib.iio_channel_attr_write_double.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_double]
        lib.iio_channel_attr_write_bool.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_bool]
        lib.iio_device_attr_write_bool.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_bool]
        lib.iio_device_attr_write_raw.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t]
        lib.iio_device_attr_write_raw.restype = ctypes.c_ssize_t
        lib.iio_channel_enable.argtypes = [ctypes.c_void_p]
        lib.iio_device_create_buffer.restype = ctypes.c_void_p
        lib.iio_device_create_buffer.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_bool]
        lib.iio_buffer_refill.argtypes = [ctypes.c_void_p]
        lib.iio_buffer_refill.restype = ctypes.c_ssize_t
        lib.iio_buffer_start.argtypes = [ctypes.c_void_p]
        lib.iio_buffer_start.restype = ctypes.c_void_p
        lib.iio_buffer_end.argtypes = [ctypes.c_void_p]
        lib.iio_buffer_end.restype = ctypes.c_void_p
        lib.iio_buffer_push_partial.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        lib.iio_buffer_push_partial.restype = ctypes.c_ssize_t
        lib.iio_buffer_destroy.argtypes = [ctypes.c_void_p]
        lib.iio_context_destroy.argtypes = [ctypes.c_void_p]
        lib.iio_context_set_timeout.argtypes = [ctypes.c_void_p, ctypes.c_uint]

    def create_context(self):
        ctx = self._lib.iio_create_default_context()
        if not ctx:
            raise IioError("no iio context found")
        return ctx

    def destroy_context(self, ctx):
        self._lib.iio_context_destroy(ctx)

    def find_device(self, ctx, name):
        dev = self._lib.iio_context_find_device(ctx, name.encode())
        if not dev:
            raise IioError(f"device not found: {name}")
        return dev

    def find_channel(self, device, name, output):
        chn = self._lib.iio_device_find_channel(device, name.encode(), output)
        if not chn:
            raise IioError(f"channel not found: {name}")
        return chn

    def channel_attr_write(self, channel, attr, value):
        return self._lib.iio_channel_attr_write(channel, attr.encode(), value.encode())

    def channel_attr_write_longlong(self, channel, attr, value):
        return self._lib.iio_channel_attr_write_longlong(channel, attr.encode(), value)

    def channel_attr_write_double(self, channel, attr, value):
        return self._lib.iio_channel_attr_write_double(channel, attr.encode(), value)

    def channel_attr_write_bool(self, channel, attr, value):
        return self._lib.iio_channel_attr_write_bool(channel, attr.encode(), value)

    def device_attr_write_bool(self, device, attr, value):
        return self._lib.iio_device_attr_write_bool(device, attr.encode(), value)

    def device_attr_write_raw(self, device, attr, data):
        return self._lib.iio_device_attr_write_raw(device, attr.encode(), data, len(data))

    def channel_enable(self, channel):
        self._lib.iio_channel_enable(channel)

    def create_buffer(self, device, samples_count, cyclic):
        buf = self._lib.iio_device_create_buffer(device, samples_count, cyclic)
        if not buf:
            raise IioError("unable to create iio buffer")
        return buf

    def destroy_buffer(self, buffer):
        self._lib.iio_buffer_destroy(buffer)

    def buffer_refill(self, buffer):
        n = self._lib.iio_buffer_refill(buffer)
        if n < 0:
            raise IioError(f"refill failed: {n}")
        start = self._lib.iio_buffer_start(buffer)
        return ctypes.string_at(start, n)

    def buffer_push(self, buffer, data):
        start = self._lib.iio_buffer_start(buffer)
        ctypes.memmove(start, data, len(data))
        return self._lib.iio_buffer_push_partial(buffer, len(data) // 4)

    def set_timeout(self, ctx, timeout_millis):
        return self._lib.iio_context_set_timeout(ctx, timeout_millis)
