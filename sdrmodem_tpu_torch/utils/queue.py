"""Bounded buffer queue between the SDR reader and the DSP worker.

Async analog of reference src/queue.c: fixed capacity, two modes —

- blocking (file sources: no sample may be dropped, src/dsp_worker.c:176-179)
- lossy (live SDRs: when full, the newest buffer overwrites the last
  queued one and a "queue is full" message is logged, src/queue.c:124-128)

``None`` is the poison pill (interrupt_waiting_the_data, :215-223).

A copy of ``sdrmodem_tpu/utils/queue.py`` with its imports pointing at the port.
"""

from __future__ import annotations

import asyncio
import logging

import numpy as np

log = logging.getLogger(__name__)


class BufferQueue:
    def __init__(self, capacity: int, blocking: bool):
        self.capacity = int(capacity)
        self.blocking = blocking
        self._q: asyncio.Queue = asyncio.Queue(maxsize=self.capacity)
        self._interrupted = False
        self.dropped = 0  # lossy-mode overwrites (queue.c logs "queue is full")

    async def put(self, buffer: np.ndarray) -> None:
        if self._interrupted:
            return
        if self.blocking:
            await self._q.put(buffer)
            return
        # lossy: overwrite the most recently queued buffer when full
        if self._q.full():
            self.dropped += 1
            log.warning("queue is full (%d buffers dropped)", self.dropped)
            try:
                # drop the newest element (the last one put), keep order of
                # the older ones — mirror of queue.c:124-128
                items = []
                while not self._q.empty():
                    items.append(self._q.get_nowait())
                items[-1] = buffer
                for it in items:
                    self._q.put_nowait(it)
            except asyncio.QueueEmpty:
                self._q.put_nowait(buffer)
            return
        self._q.put_nowait(buffer)

    async def take(self) -> np.ndarray | None:
        """Blocks until a buffer or the poison pill arrives."""
        return await self._q.get()

    def empty(self) -> bool:
        return self._q.empty()

    async def interrupt(self) -> None:
        """Poison pill: wake the consumer and end the stream."""
        self._interrupted = True
        await self._q.put(None)
