#!/usr/bin/env python3
"""The bf16 batch-8 realtime pass of two checkouts of the PyTorch port,
compared on one CUDA card.

    python3 scripts/torch_bf16_ab.py OLD_CHECKOUT NEW_CHECKOUT

Runs each checkout's own chip_smoke.py phases in a process of its own, in the
order old, new, new, old: the kernel build, the 1-scale f32 slice (whose
calibrated weights the bf16 phase takes) and the bf16 batch-8 phase
(bench.py's configuration: COCO 656x368, u8, pair_cap=32, 16 frames).
Prints each run's device ms/frame, CNN ms/frame, end-to-end ms/frame and
the kernels a replayed batch pass runs (torch.profiler), then the medians
of each side.  The phases raise on failure as in
chip_smoke.py.
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
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.phase_build()
one = cs.phase_slice(1, 8)
r = cs.phase_bf16(one["weights"])
print("AB " + json.dumps({k: r[k] for k in ("device_ms", "cnn_ms", "e2e_ms", "kernels_per_pass")}))
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
        print(f"{checkout}: device {r['device_ms']:.3f} ms/frame, CNN {r['cnn_ms']:.3f} ms/frame, "
              f"end-to-end {r['e2e_ms']:.3f} ms/frame, {r['kernels_per_pass']:.0f} kernels a "
              f"replayed pass")
    for label, checkout in (("old", old), ("new", new)):
        med = {k: statistics.median(r[k] for r in runs[checkout]) for k in runs[checkout][0]}
        print(f"{label} median of 2: " + json.dumps(med))
    return 0


if __name__ == "__main__":
    sys.exit(main())
