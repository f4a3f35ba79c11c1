"""Frame-parallel multi-device inference.

Counterpart of ``caffe_rtpose_tpu/parallel/inference.py``.  The reference
runs one full net replica per GPU, each worker thread pulling frames from a
shared queue (rtpose.cpp:1463-1472 + NetCopy).  Here one replica of the
estimator's device program and weight operands lives on each card
(``PoseEstimator.replicate``, which an ``ExportedPose`` bundle provides
too), each with its own CUDA graphs, and frames are dispatched round-robin:
a dispatch is an asynchronous graph replay on its card, so one host thread
keeps N cards busy and the fetcher pool drains the results.
"""

from __future__ import annotations

import itertools
import threading
from typing import List, Optional

import numpy as np
import torch


class DevicePool:
    """Round-robin frame dispatcher over ``num_devices`` cards
    (``cuda:start_device`` on; default every card from ``start_device``).

    The estimator serves its own card; every other card gets a replica.
    For an estimator on the CPU the replicas are on the CPU too
    (``num_devices`` of them, default 1), which runs the same dispatch with
    the plain versions.  Raises ``ValueError`` when the cards asked for are
    not there."""

    def __init__(self, estimator, num_devices: Optional[int] = None, start_device: int = 0):
        self.est = estimator
        if estimator.device.type == "cpu":
            devs = [torch.device("cpu")] * (num_devices or 1)
        else:
            have = torch.cuda.device_count()
            n = num_devices or have - start_device
            if n < 1 or start_device < 0 or start_device + n > have:
                raise ValueError(f"need devices [{start_device}, {start_device + n}), "
                                 f"have {have}")
            devs = [torch.device("cuda", start_device + i) for i in range(n)]
        self.devices: List[torch.device] = devs
        own = estimator.device
        if own.type == "cuda" and own.index is None:
            own = torch.device("cuda", torch.cuda.current_device())
        self.replicas = []
        for d in devs:
            mine = d == own and estimator not in self.replicas
            self.replicas.append(estimator if mine else estimator.replicate(d))
        self._rr = itertools.cycle(range(len(devs)))
        self._rr_lock = threading.Lock()

    def run_device(self, net_input: np.ndarray, nms_threshold=None, inter_threshold=None,
                   device_index: Optional[int] = None):
        """One pass on the next card in turn (or on ``device_index``):
        the estimator's ``run_device`` there, not synchronized."""
        if device_index is None:
            with self._rr_lock:
                device_index = next(self._rr)
        return self.replicas[device_index].run_device(net_input, nms_threshold=nms_threshold,
                                                      inter_threshold=inter_threshold)

    def fetch(self, out):
        return self.est.fetch(out)

    def fetch_batch(self, out):
        return self.est.fetch_batch(out)
