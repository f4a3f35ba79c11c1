"""Pipeline plumbing: bounded blocking queues + the frame reorder buffer.

Mirrors the reference's BlockingQueue (util/blocking_queue.hpp) and the
``buffer_and_order`` thread (rtpose.cpp:1214-1273): a min-heap on frame index
with a parallel heap of dropped indices, flushing in order whenever the next
expected index is available (or when the buffer exceeds BUFFER_SIZE).

A copy of ``caffe_rtpose_tpu/pipeline/queues.py`` (that package cannot be
imported without jax).
"""

from __future__ import annotations

import heapq
import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

BUFFER_SIZE = 4  # rtpose.cpp:97 (affects latency)


class BlockingQueue(queue.Queue):
    """Bounded FIFO; thin wrapper to match reference naming."""

    def try_pop(self):
        try:
            return self.get_nowait()
        except queue.Empty:
            return None

    def has_real_item(self) -> bool:
        """True if a non-``None`` item is queued.  The ``None`` end-of-stream
        sentinel must not count as a "fresher frame waiting" for shed
        policies (a final frame with only the terminator behind it has
        nothing fresher to supersede it)."""
        with self.mutex:
            return any(x is not None for x in self.queue)


@dataclass(order=True)
class _Entry:
    index: int
    item: Any = field(compare=False)


class OrderedBuffer:
    """Reorders frames by index, skipping dropped ones.

    ``push(index, item)`` buffers; ``push_dropped(index)`` registers a hole.
    ``pop_ready(force=False)`` yields the next in-order items; with
    ``force=True`` (buffer overflow) it emits the smallest regardless.
    """

    def __init__(self, buffer_size: int = BUFFER_SIZE):
        self.buffer_size = buffer_size
        self._heap: List[_Entry] = []
        self._dropped: List[int] = []
        self._next = 1  # frame indices start at 1 (rtpose.cpp global_counter)
        self._lock = threading.Lock()

    def push_dropped(self, index: int) -> None:
        with self._lock:
            heapq.heappush(self._dropped, index)

    def push(self, index: int, item: Any) -> List[Any]:
        with self._lock:
            heapq.heappush(self._heap, _Entry(index, item))
            return self._drain_locked()

    def _drain_locked(self) -> List[Any]:
        out = []
        while self._heap:
            # consume dropped/stale indices at or below the next expected
            # (stale ones arise when an overflow advanced past them)
            while self._dropped and self._dropped[0] <= self._next:
                if heapq.heappop(self._dropped) == self._next:
                    self._next += 1
            head = self._heap[0]
            if head.index == self._next:
                heapq.heappop(self._heap)
                self._next += 1
                out.append(head.item)
            elif head.index < self._next:
                # late frame that overflow already skipped past: emit it
                # immediately, do NOT move _next backwards
                heapq.heappop(self._heap)
                out.append(head.item)
            elif len(self._heap) > self.buffer_size:
                # overflow: emit smallest anyway (buffer_and_order flush)
                heapq.heappop(self._heap)
                self._next = max(self._next, head.index + 1)
                out.append(head.item)
            else:
                break
        return out

    def flush(self) -> List[Any]:
        with self._lock:
            out = [heapq.heappop(self._heap).item for _ in range(len(self._heap))]
            return out
