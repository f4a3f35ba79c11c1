#!/usr/bin/env python3
"""Where the upsample-keys kernel (K3, caffe_rtpose_tpu_torch/csrc/
upsample_peak_keys.cu) spends its time, on one CUDA card.

    python3 scripts/torch_k3_ablation.py

Builds the kernel as it is and in variants with one phase taken out (text
substitutions on a copy of the source, so the variants follow the kernel),
one nvcc each, started together; then times each at COCO 656x368 (46x82
low-res, 57 channels, keys for 18) at 1 and 3 scales: 50 launches back to
back between CUDA events, in the order as-is, variants, variants reversed,
as-is.  A variant's output is wrong by design; only its time is read.

    no_heat_store  the heat box's TMA store taken out
    no_key_pass    no key pass and no key store
    no_stores      neither TMA store (the key pass kept)
    upsample_only  no key pass and no store: windows, upsample, halo

Beside them, on the as-is build: the direct store path (each lane's column
with bounds-checked streaming stores instead of TMA), tiles of 30 rows
instead of keys_tile_rows' choice (46), and the write alone (heat.fill_ and
keys.fill_, PyTorch's fill kernels over the same 64.6 MB: the write rate a
plain kernel reaches on this card).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CSRC = os.path.join(ROOT, "caffe_rtpose_tpu_torch", "csrc")
HEAT_STORE = "if (lane == 0) tma_store_3d(&heat_map, box + kKeysTileX, x0, y0, c);"
KEY_STORE = "if (lane == 0) tma_store_3d(&keys_map, kbox, x0 / 2, y0, c);"
KEY_PASS = "if (c < a.key_channels) {"
VARIANTS = {  # name -> [(text, replacement)], each text must occur in the source
    "as_is": [],
    "no_heat_store": [(HEAT_STORE, "")],
    "no_key_pass": [(KEY_PASS, "if (c < 0) {")],
    "no_stores": [(HEAT_STORE, ""), (KEY_STORE, "")],
    "upsample_only": [(HEAT_STORE, ""), (KEY_PASS, "if (c < 0) {")],
}


def build_all(out_dir: str):
    from caffe_rtpose_tpu_torch._build import NVCC_FLAGS
    from caffe_rtpose_tpu_torch.utils.device import nvcc_path

    src = open(os.path.join(CSRC, "upsample_peak_keys.cu")).read()
    header = open(os.path.join(CSRC, "bicubic_tile.cuh")).read()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: the kernel source no longer holds {old!r}")
            text = text.replace(old, new)
        d = os.path.join(out_dir, name)
        os.makedirs(d)
        with open(os.path.join(d, "bicubic_tile.cuh"), "w") as f:
            f.write(header)
        cu, so = os.path.join(d, "k3.cu"), os.path.join(d, "k3.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", so, cu],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    vp, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    for name, (p, so) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"build of {name} failed:\n{log}")
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines() if "registers" in ln]
        print(f"[build] {name}: {regs}")
        lib = ctypes.CDLL(so)
        lib.crt_upsample_peak_keys.restype = i
        lib.crt_upsample_peak_keys.argtypes = [vp, ll, ll, ll, ll, i, i, i, i, i, i, vp, vp, vp,
                                               vp, vp, vp, i, i, f, i, vp, vp, vp, vp]
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    from caffe_rtpose_tpu_torch.ops import nms_cuda

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    h, w, th, tw, c, kc = 46, 82, 368, 656, 57, 18
    n_bytes = c * th * tw * 4 + kc * th * (tw // 2) * 4
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(tmp)
        for s, start, gap in ((1, 1.0, 0.3), (3, 1.0, 0.3)):
            low = torch.from_numpy(np.random.RandomState(s).rand(s, h, w, c).astype(np.float32)
                                   * 2 - 1).cuda()
            thr = torch.tensor(0.05, device="cuda")
            heat = torch.empty((c, th, tw), device="cuda")
            keys = torch.empty((kc, th * (tw // 2)), dtype=torch.int32, device="cuda")
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

            def launcher(lib, rows=None, tma=1):
                geo = nms_cuda.keys_geometry(h, w, th, tw, s, start, gap, rows)
                tables = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (
                    geo.ytap_w, geo.ytap_off, geo.xtap_w, geo.xtap_off, geo.ywin, geo.xwin)]

                def launch():
                    err = lib.crt_upsample_peak_keys(
                        ptr(low), *low.stride(), s, c, th, tw, kc, geo.rows,
                        *[ptr(t) for t in tables], geo.wh, geo.wp, 1.0 / s, tma, ptr(thr),
                        ptr(heat), ptr(keys), stream)
                    if err != 0:
                        raise RuntimeError(f"launch failed ({err})")
                return launch

            fns = {name: launcher(lib) for name, lib in libs.items()}
            fns["direct_stores"] = launcher(libs["as_is"], tma=0)
            fns["rows_30"] = launcher(libs["as_is"], rows=30)
            fns["write_alone"] = lambda: (heat.fill_(1.0), keys.fill_(0))
            names = list(fns)
            times = {n: [] for n in names}
            for name in names + names[::-1]:
                for _ in range(3):
                    fns[name]()
                torch.cuda.synchronize()
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(50):
                    fns[name]()
                e1.record()
                e1.synchronize()
                times[name].append(e0.elapsed_time(e1) / 50)
            rows = nms_cuda.keys_tile_rows(th)
            for name in names:
                ms = min(times[name])
                print(f"S={s} (tile rows {rows} unless named): {name}: "
                      f"{' / '.join(f'{v:.5f}' for v in times[name])} ms (min {ms:.5f}; "
                      f"{n_bytes / ms / 1e9:.3f} TB/s of the 64.6 MB heat and keys)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
