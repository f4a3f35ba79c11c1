#!/usr/bin/env python3
"""Where f32 training trajectories of the CPM train net part, on one CUDA
card and its host's CPU: chip_smoke.py's train small comparison (a 2-stage
net at crop 184, batch 2, SGD from fan-in weights) over several synthetic
batches, in its three arithmetics: f32 on the card, f32 on the CPU, and
f64 on the CPU taking the card's ReLU decisions step by step (the run the
card is held to; ROADMAP C6).

    python3 scripts/torch_train_trajectory_witness.py [--batches 6]

Batch 0 is the one chip_smoke.py checks.  Prints one JSON line a batch:
for every pair of arithmetics the gaps after 3 steps (the largest relative
loss gap; the weights', biases' and momentum's gaps relative to each blob's
largest magnitude) and after the first step, which all three take from
the same state.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    import chip_smoke as cs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pairs = list(itertools.combinations(cs.SMALL_ARITHMETICS, 2))
    for seed in range(args.batches):
        row = dict(batch=seed)
        for steps in (3, 1):
            solvers, losses, _ = cs.small_trajectories("cuda", seed, steps)
            if steps == 3:
                row["losses"] = losses
            row[f"after_{steps}"] = {f"{a}-{b}": cs.trajectory_gaps(solvers, losses, a, b)
                                     for a, b in pairs}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
