#!/usr/bin/env python3
"""Where the fused conv1-block kernel (K4, caffe_rtpose_tpu_torch/csrc/
conv1_block.cu) spends its time, on one CUDA card.

    python3 scripts/torch_conv1_ablation.py [--batch 8]

Builds the kernel as it is and in variants with one phase taken out (text
substitutions on a copy of the source, so the variants follow the kernel),
all with one nvcc each, started together; then times each on the same
COCO 656x368 bf16 input: 20 launches back to back between CUDA events, in
the order as-is, variants, variants reversed, as-is.  A variant's output is
wrong by design; only its time is read.

    no_recompute  conv1_1's near-midpoint f32 recompute off
    no_conv1_1    no halo load and no conv1_1 (conv1_2 and the pool on
                  whatever h1 holds)
    no_conv1_2    no conv1_2 (halo, conv1_1 and the pool of zeros)
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SRC = os.path.join(ROOT, "caffe_rtpose_tpu_torch", "csrc", "conv1_block.cu")
VARIANTS = {  # name -> [(text, replacement)], each text must occur in the source
    "as_is": [],
    "no_recompute": [("return ((__float_as_uint(v) + (kTieUlps - 1)) & 0xFF00u) == 0x8000u;",
                      "return false;")],
    "no_conv1_1": [("for (int p = t; p < kIn * kIn; p += 128)", "for (int p = t; p < 0; p += 128)"),
                   ("for (int rnd = 0; rnd < 3; ++rnd)", "for (int rnd = 0; rnd < 0; ++rnd)")],
    "no_conv1_2": [("for (int mb = 0; mb < 2; ++mb)\n#pragma unroll\n        for (int s = 0; s < 4; ++s)\n"
                    "          ldmatrix_x4(a[0]",
                    "for (int mb = 0; mb < 0; ++mb)\n#pragma unroll\n        for (int s = 0; s < 4; ++s)\n"
                    "          ldmatrix_x4(a[0]"),
                   ("for (int tap = 0; tap < kTaps; ++tap)", "for (int tap = 0; tap < 0; ++tap)"),
                   ("      wgmma_wait<0>();\n      fence_acc(acc[0]);\n      fence_acc(acc[1]);\n\n",
                    "#pragma unroll\n      for (int i = 0; i < 32; ++i) acc[0][i] = acc[1][i] = 0.f;\n\n")],
}


def build_all(out_dir: str):
    from caffe_rtpose_tpu_torch._build import NVCC_FLAGS
    from caffe_rtpose_tpu_torch.utils.device import nvcc_path

    src = open(SRC).read()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: the kernel source no longer holds {old!r}")
            text = text.replace(old, new)
        cu, so = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", so, cu],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (p, so) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"build of {name} failed:\n{log}")
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines() if "registers" in ln]
        print(f"[build] {name}: {regs}")
        lib = ctypes.CDLL(so)
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.crt_conv1_prepare.restype = i
        lib.crt_conv1_block.restype = i
        lib.crt_conv1_block.argtypes = [vp, ll, ll, ll, ll, i, i, i, vp, vp, vp, vp, vp, i, vp]
        if lib.crt_conv1_prepare() != 0:
            raise RuntimeError(f"{name}: shared-memory attribute refused")
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    from caffe_rtpose_tpu_torch.ops.conv1_cuda import Conv1Weights

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    b, h, w = args.batch, 368, 656
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(tmp)
        rs = np.random.RandomState(0)
        x = torch.from_numpy(rs.rand(b, 3, h, w).astype(np.float32) - 0.5).cuda()
        x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        t = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()  # noqa: E731
        cw = Conv1Weights.pack(t(rs.randn(64, 3, 3, 3) * 0.1), t(rs.randn(64) * 0.1),
                               t(rs.randn(64, 64, 3, 3) * 0.05), t(rs.randn(64) * 0.1))
        out = torch.empty((b, 64, h // 2, w // 2), dtype=torch.bfloat16, device="cuda",
                          memory_format=torch.channels_last)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        ptr = lambda a: ctypes.c_void_p(a.data_ptr())  # noqa: E731
        st = x.stride()

        def launch(lib):
            err = lib.crt_conv1_block(ptr(x), st[0], st[1], st[2], st[3], b, h, w, ptr(cw.w1_p),
                                      ptr(cw.b1), ptr(cw.w2_p), ptr(cw.b2), ptr(out), sms,
                                      ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if err != 0:
                raise RuntimeError(f"launch failed ({err})")

        names = list(libs)
        times = {n: [] for n in names}
        for name in names + names[::-1]:
            for _ in range(3):
                launch(libs[name])
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(20):
                launch(libs[name])
            e1.record()
            e1.synchronize()
            times[name].append(e0.elapsed_time(e1) / 20)
        flops = 2 * b * h * w * 64 * (27 + 576)
        for name in names:
            ms = min(times[name])
            print(f"{name}: {' / '.join(f'{v:.4f}' for v in times[name])} ms at B={b} "
                  f"(min {ms:.4f}; {flops / ms / 1e9:.1f} TFLOP/s of the full block's work)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
