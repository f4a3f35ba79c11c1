#!/usr/bin/env python3
"""The port's pose and training paths in two checkouts of the PyTorch port,
timed on one CUDA card: what a change to the net's layer dispatch costs.

    python3 scripts/torch_dispatch_ab.py OLD_CHECKOUT NEW_CHECKOUT

Runs each checkout in a process of its own, in the order old, new, new, old.
Each run builds that checkout's kernels with its own chip_smoke.py and then
measures two paths:

* The device programs, graph and eager. This is chip_smoke's graph phase:
  f32 1-scale, bf16 batch 8 and f32 heatmap. It reports device ms/frame
  (CUDA events, median of 10) and checks that graph and eager agree.
* A CPM training step at scripts/bench_train.py's shape (6 stages, batch
  10, crop 368, f32, TF32 off). It runs on one fixed batch that is already
  on the card, so no host augmentation takes part. It reports the step
  between CUDA events (median of 10 after 3 warm steps) and the host's wall
  time a step.

Prints every run, then the median of each side.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

CHILD = r"""
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.phase_build()
weights, frames = cs.calibrated_weights(1, 8)
graph, ests = cs.phase_graph(weights, frames)
del ests
out = {f"{k} {m}": v[f"{m}_device_ms"] for k, v in graph.items() for m in ("graph", "eager")}
from caffe_rtpose_tpu_torch.core.net import Net
from caffe_rtpose_tpu_torch.models.cpm import make_pose_train_net
from caffe_rtpose_tpu_torch.training.solver import Solver
net = Net(make_pose_train_net(batch=cs.TRAIN_BATCH, crop=cs.TRAIN_CROP), phase="TRAIN",
          device="cuda", seed=0)
g = torch.Generator().manual_seed(1)
batch = {k: torch.rand(net.blob_shapes[k], generator=g).cuda() for k in net.input_names}
solver = Solver(cs.TRAIN_SOLVER, net, lambda _: batch)
solver.step(3)
torch.cuda.synchronize()
dev, wall = [], []
for _ in range(10):
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    solver.step(1)
    b.record()
    b.synchronize()
    wall.append((time.perf_counter() - t0) * 1e3)
    dev.append(a.elapsed_time(b))
out["train step"] = statistics.median(dev)
out["train step host wall"] = statistics.median(wall)
print("AB " + json.dumps(out))
"""


def run(checkout: str) -> dict:
    res = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(checkout)],
                         capture_output=True, text=True, cwd=os.path.abspath(checkout),
                         timeout=900)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("AB ")]
    if res.returncode != 0 or not lines:
        raise RuntimeError(f"{checkout} failed (exit {res.returncode}):\n{res.stdout[-4000:]}"
                           f"\n{res.stderr[-4000:]}")
    return json.loads(lines[-1][3:])


def main() -> int:
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    old, new = sys.argv[1:]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    runs = {old: [], new: []}
    for checkout in (old, new, new, old):
        r = run(checkout)
        runs[checkout].append(r)
        print(f"{checkout}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in r.items()))
    for label, checkout in (("old", old), ("new", new)):
        med = {k: statistics.median(r[k] for r in runs[checkout]) for k in runs[checkout][0]}
        print(f"{label} median: " + ", ".join(f"{k} {v:.3f} ms" for k, v in med.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
