"""Timer / CPUTimer (reference util/benchmark.hpp:10-47).

The port of ``caffe_rtpose_tpu/utils/timer.py``.  :class:`Timer` on a CUDA
device records a CUDA event at ``start`` and ``stop`` (Caffe's GPU timer):
the time is the device's, queued work included.  On the CPU it is
:class:`CPUTimer`, the host clock."""

from __future__ import annotations

import time
from typing import Optional, Union

import torch


class CPUTimer:
    def __init__(self):
        self._start: Optional[float] = None
        self._elapsed = 0.0
        self.has_run_at_least_once = False
        self.running = False

    def start(self):
        self._start = time.perf_counter()
        self.running = True
        return self

    def stop(self):
        if self.running and self._start is not None:
            self._elapsed = time.perf_counter() - self._start
            self.running = False
            self.has_run_at_least_once = True
        return self

    def milli_seconds(self) -> float:
        return self._elapsed * 1e3

    def micro_seconds(self) -> float:
        return self._elapsed * 1e6

    def seconds(self) -> float:
        return self._elapsed


class Timer(CPUTimer):
    """Device time between ``start`` and ``stop`` from CUDA events on a
    CUDA ``device``; the host clock on the CPU.  ``stop`` waits for the
    device (cudaEventSynchronize)."""

    def __init__(self, device: Union[str, torch.device] = "cpu"):
        super().__init__()
        self.cuda = torch.device(device).type == "cuda"
        self._events = None

    def start(self):
        if not self.cuda:
            return super().start()
        self._events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        self._events[0].record()
        self.running = True
        return self

    def stop(self):
        if not self.cuda:
            return super().stop()
        if self.running and self._events is not None:
            self._events[1].record()
            self._events[1].synchronize()
            self._elapsed = self._events[0].elapsed_time(self._events[1]) / 1e3
            self.running = False
            self.has_run_at_least_once = True
        return self
