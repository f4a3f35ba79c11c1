#!/usr/bin/env python3
"""The peak-mask kernel (K1) of two checkouts of the PyTorch port, timed on
one CUDA card.

    python3 scripts/torch_k1_ab.py OLD_CHECKOUT NEW_CHECKOUT

Runs each checkout's own chip_smoke.py kernel build and kernel phase in a
process of its own, in the order old, new, new, old: the peak mask against
its plain version at every case of that phase, then the kernel's own device
time (torch.profiler over 20 launches) and the wrapper call's time (CUDA
events, median of 20) at each shape that checkout times.  Prints every run's
times by shape, then the medians of each side at the shapes both time.
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
import chip_smoke as cs
cs.phase_build()
rows = cs.phase_kernels()
cs.profile_pending()
print("AB " + json.dumps({r["shape"]: [r["kernel_ms"], r["call_ms"]] for r in rows}))
"""


def run(checkout: str) -> dict:
    res = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(checkout)],
                         capture_output=True, text=True, cwd=os.path.abspath(checkout),
                         timeout=600)
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
        for shape, (k_ms, c_ms) in r.items():
            print(f"{checkout}: {shape}: kernel {k_ms:.5f} ms, call {c_ms:.4f} ms")
    shared = [s for s in runs[old][0] if s in runs[new][0]]
    for label, checkout in (("old", old), ("new", new)):
        med = {s: [statistics.median(r[s][i] for r in runs[checkout]) for i in (0, 1)]
               for s in shared}
        print(f"{label} median of 2 (kernel_ms, call_ms): " + json.dumps(med))
    return 0


if __name__ == "__main__":
    sys.exit(main())
