#!/usr/bin/env python3
"""The data x spatial train step of two checkouts of the PyTorch port, timed
on one CUDA card.

    python3 scripts/torch_parallel_ab.py OLD_CHECKOUT NEW_CHECKOUT

Runs each checkout's own ``parallel.dryrun.dryrun_dp_sp_train`` (four ranks
sharing ``cuda:0`` over gloo, a 2x2 data x spatial mesh, the 6-stage COCO
train net at global batch 10, crop 368, f32) in a process of its own, in
the order old, new, new, old.  Each dry run holds its step to the one-rank
step and times a second call of both (CUDA-synchronized host clock).
Prints every run's loss and step ms, then the medians of each side.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from caffe_rtpose_tpu_torch.parallel import dp, dryrun

if __name__ == "__main__":
    res = dp.spawn(dryrun.rank_cases, 4, ["cuda:0"] * 4, args=([("dryrun_dp_sp_train", dict(
        n_devices=4, crop=368, batch=10, spatial=2, stages=6))],), timeout=600)
    r = res[0]["dryrun_dp_sp_train"]
    print("AB " + json.dumps({k: r[k] for k in ("loss", "step_ms", "ref_step_ms")}))
"""


def run(checkout: str) -> dict:
    path = os.path.join(os.path.abspath(checkout), "_parallel_ab_child.py")
    with open(path, "w") as f:
        f.write(CHILD)
    try:
        res = subprocess.run([sys.executable, path, os.path.abspath(checkout)],
                             capture_output=True, text=True, cwd=os.path.abspath(checkout),
                             timeout=900)
    finally:
        os.remove(path)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("AB ")]
    if res.returncode != 0 or not lines:
        raise RuntimeError(f"{checkout} failed (exit {res.returncode}):\n{res.stdout[-4000:]}"
                           f"\n{res.stderr[-4000:]}")
    return json.loads(lines[-1][3:])


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__)
        return 2
    old, new = argv
    runs = []
    for name, checkout in (("old", old), ("new", new), ("new", new), ("old", old)):
        r = run(checkout)
        runs.append((name, r))
        print(name, json.dumps(r), flush=True)
    for side in ("old", "new"):
        ms = [r["step_ms"] for n, r in runs if n == side]
        print(f"{side}: median step {statistics.median(ms):.1f} ms over {ms}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
