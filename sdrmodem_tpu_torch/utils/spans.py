"""Spans and counters inside the port, recorded only while the torch
profiler records.

``span(name)`` marks a stretch of host work: while the profiler records,
it enters a profiler record function, so the span lands in the exported
trace beside the kernels and copies (on the profiled thread), and it adds
its ``perf_counter_ns`` duration and a count to a table keyed by name.
``add(name, value)`` adds to a counter in the same table.  Otherwise both
cost one flag read and allocate nothing: ``span`` returns one shared null
context and nothing is recorded.

"Records" is torch's process-wide flag, set while any profiler is on, so
a span opened in a worker thread is counted in the table too, though the
profiler keeps only the profiled thread's spans in its trace.  The table
holds totals, not a list of spans: its size does not grow with the time
profiled.  A lock guards it, so any thread may write to it.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch
from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()
_LOCK = threading.Lock()
_TABLE: dict[str, list] = {}  # name -> [count, total]; a span's total in seconds


class _Span:
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str):
        self.name = name
        self.rf = torch._C._profiler._RecordFunctionFast(name)

    def __enter__(self):
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        self.rf.__exit__(*exc)
        add(self.name, dt / 1e9)
        return False


def span(name: str):
    """A named span of host work."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def add(name: str, value: float) -> None:
    """Add ``value`` and a count to the counter ``name``, while recording."""
    if not _profiler._is_profiler_enabled:
        return
    with _LOCK:
        entry = _TABLE.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += value


def snapshot() -> dict[str, tuple[int, float]]:
    """A copy of the table: name -> (count, total)."""
    with _LOCK:
        return {k: (v[0], v[1]) for k, v in _TABLE.items()}


def clear() -> None:
    with _LOCK:
        _TABLE.clear()
