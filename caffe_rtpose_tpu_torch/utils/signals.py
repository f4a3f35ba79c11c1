"""Signal -> solver action mapping (reference util/signal_handler.cpp +
tools/caffe.cpp:51-56): SIGINT/SIGHUP each map to 'stop', 'snapshot' or
'none'; the training loop polls ``check_for_action()`` between iterations
(Solver::Step signal checks, solver.cpp:260-276).

A copy of ``caffe_rtpose_tpu/utils/signals.py``, which cannot be imported
without jax."""

from __future__ import annotations

import signal
import threading
from enum import Enum
from typing import Optional


class SolverAction(Enum):
    NONE = 0
    STOP = 1
    SNAPSHOT = 2


class SignalHandler:
    def __init__(self, sigint_action: SolverAction = SolverAction.STOP,
                 sighup_action: SolverAction = SolverAction.SNAPSHOT):
        self._actions = {}
        self._pending = []
        self._lock = threading.Lock()
        self._prev = {}
        for sig, act in ((signal.SIGINT, sigint_action), (signal.SIGHUP, sighup_action)):
            if act != SolverAction.NONE:
                self._actions[sig] = act
                try:
                    self._prev[sig] = signal.signal(sig, self._handle)
                except ValueError:
                    pass  # not on main thread

    def _handle(self, signum, frame):
        with self._lock:
            self._pending.append(self._actions.get(signum, SolverAction.NONE))

    def check_for_action(self) -> SolverAction:
        with self._lock:
            if self._pending:
                return self._pending.pop(0)
        return SolverAction.NONE

    def restore(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass


def parse_action(name: str) -> SolverAction:
    return {"stop": SolverAction.STOP, "snapshot": SolverAction.SNAPSHOT,
            "none": SolverAction.NONE}[name]
