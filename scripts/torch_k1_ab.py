#!/usr/bin/env python3
"""The peak-mask kernel (K1) or the upsample-keys kernel (K3) of two
checkouts of the PyTorch port, timed on one CUDA card.

    python3 scripts/torch_k1_ab.py [--kernel K1|K3] OLD_CHECKOUT NEW_CHECKOUT

Runs each checkout's own chip_smoke.py kernel build and that kernel's phase
(K1: phase_kernels, K3: phase_upsample_keys) in a process of its own, in
the order old, new, new, old: the kernel against its plain version at every
case of that phase, then the kernel's own device time (torch.profiler over
20 launches) and the wrapper call's time (CUDA events, median of 20) at each
shape that checkout times.  For K3, a shape of K3_SHAPES that the
checkout's phase does not time is timed the same way through that
checkout's wrapper, on random input.  Prints every run's times by shape,
then the medians of each side at the shapes both time, and the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

# K3 at COCO 1 and 3 scales and MPI 3 scales (S, start, gap, C, key channels):
# 46x82 -> 368x656, labelled as chip_smoke.phase_upsample_keys labels them
K3_SHAPES = ((1, 1.0, 0.3, 57, 18), (3, 1.0, 0.3, 57, 18), (3, 0.9, 0.1, 44, 15))

CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import chip_smoke as cs
from caffe_rtpose_tpu_torch.ops import nms_cuda
cs.phase_build()
rows = cs.phase_kernels() if sys.argv[2] == "K1" else cs.phase_upsample_keys()
cs.profile_pending()
out = {r["shape"]: [r["kernel_ms"], r["call_ms"]] for r in rows}
if sys.argv[2] == "K3":
    for s, start, gap, c, kc in json.loads(sys.argv[3]):
        label = f"S={s} 46x82x{c} -> 368x656, keys for {kc}"
        if label in out:
            continue
        low = torch.from_numpy(np.random.RandomState(s * c).rand(s, 46, 82, c).astype(np.float32)
                               * 2 - 1).cuda()
        fn = lambda: nms_cuda.upsample_peak_keys(low, (368, 656), start, gap, 0.05, key_channels=kc)
        out[label] = [cs.kernel_ms(fn, "upsample_peak_keys_kernel"), cs.cuda_ms(fn)]
print("AB " + json.dumps(out))
"""


def run(checkout: str, kernel: str) -> dict:
    res = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(checkout), kernel,
                          json.dumps(K3_SHAPES)],
                         capture_output=True, text=True, cwd=os.path.abspath(checkout),
                         timeout=600)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("AB ")]
    if res.returncode != 0 or not lines:
        raise RuntimeError(f"{checkout} failed (exit {res.returncode}):\n{res.stdout[-4000:]}"
                           f"\n{res.stderr[-4000:]}")
    return json.loads(lines[-1][3:])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("K1", "K3"), default="K1")
    ap.add_argument("old")
    ap.add_argument("new")
    args = ap.parse_args()
    old, new = args.old, args.new
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    runs = {old: [], new: []}
    for checkout in (old, new, new, old):
        r = run(checkout, args.kernel)
        runs[checkout].append(r)
        for shape, (k_ms, c_ms) in r.items():
            print(f"{checkout}: {args.kernel} {shape}: kernel {k_ms:.5f} ms, call {c_ms:.4f} ms")
    shared = [s for s in runs[old][0] if s in runs[new][0]]
    for label, checkout in (("old", old), ("new", new)):
        med = {s: [statistics.median(r[s][i] for r in runs[checkout]) for i in (0, 1)]
               for s in shared}
        print(f"{label} {args.kernel} median of 2 (kernel_ms, call_ms): " + json.dumps(med))
    return 0


if __name__ == "__main__":
    sys.exit(main())
