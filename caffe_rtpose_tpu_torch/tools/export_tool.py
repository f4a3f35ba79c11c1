"""Export tool: build / check serving bundles.

The port of ``caffe_rtpose_tpu/tools/export_tool.py``, with ``--device``
in place of ``--platforms``: the realtime device program exported with
``torch.export``, its weights and its metadata (``serving.py``).

  build   build a bundle from (prototxt, caffemodel?) at a fixed config
  check   load a bundle, print its metadata, run synthetic frames

Run:  python -m caffe_rtpose_tpu_torch export build --caffeproto P --out bundle/
      python -m caffe_rtpose_tpu_torch export check bundle/
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _parse_resolution(s: str):
    w, h = s.split("x")
    return int(w), int(h)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="export", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("build", help="build a serving bundle")
    e.add_argument("--caffeproto", required=True, help="deploy prototxt")
    e.add_argument("--caffemodel", default="", help=".caffemodel weights "
                   "(omitted: seeded random init, for parity and testing bundles)")
    e.add_argument("--out", required=True, help="bundle output directory")
    e.add_argument("--net_resolution", type=_parse_resolution, default=(656, 368))
    e.add_argument("--num_scales", type=int, default=1)
    e.add_argument("--start_scale", type=float, default=1.0)
    e.add_argument("--scale_gap", type=float, default=0.3)
    e.add_argument("--batch", type=int, default=1)
    e.add_argument("--pair_cap", type=int, default=32,
                   help="0 = uncapped (no overflow program needed)")
    e.add_argument("--dtype", default="float32", choices=["bfloat16", "float32"])
    e.add_argument("--input_u8", action="store_true",
                   help="u8 transfer-format input (the production pipeline's path)")
    e.add_argument("--device_rescale", action="store_true")
    e.add_argument("--seed", type=int, default=0)
    e.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the programs are exported (a bundle loads on either: "
                        "its kernels are operators that dispatch on the device)")

    c = sub.add_parser("check", help="load a bundle and smoke-run it")
    c.add_argument("bundle", help="bundle directory")
    c.add_argument("--frames", type=int, default=1,
                   help="synthetic frames to run (timing: >1 amortizes the first call's "
                        "graph capture)")
    c.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def cmd_export(args) -> int:
    import torch

    from ..pose.estimator import PoseEstimator
    from ..serving import export_estimator

    t0 = time.perf_counter()
    est = PoseEstimator(
        args.caffeproto,
        weights=args.caffemodel or None,
        net_resolution=tuple(args.net_resolution),
        num_scales=args.num_scales,
        start_scale=args.start_scale,
        scale_gap=args.scale_gap,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        seed=args.seed,
        input_u8=args.input_u8 or args.device_rescale,
        pair_cap=args.pair_cap or None,
        batch=args.batch,
        device_rescale=args.device_rescale,
        device=args.device,
        # a bundle records the hand kernels as operators (the plain
        # versions run where it is loaded on the CPU)
        peak_kernel=True,
        conv1_kernel=True,
    )
    t1 = time.perf_counter()
    export_estimator(est, args.out)
    t2 = time.perf_counter()
    print(f"exported bundle -> {args.out} (estimator built in {t1 - t0:.2f} s, "
          f"exported in {t2 - t1:.2f} s)")
    for f in sorted(os.listdir(args.out)):
        print(f"  {f:<24} {os.path.getsize(os.path.join(args.out, f)) / 1e6:.2f} MB")
    return 0


def cmd_check(args) -> int:
    import numpy as np

    from ..serving import ExportedPose

    with open(os.path.join(args.bundle, "meta.json")) as f:
        print(json.dumps(json.load(f), indent=1, sort_keys=True))
    t0 = time.perf_counter()
    pose = ExportedPose(args.bundle, device=args.device)
    print(f"platforms: {pose.platforms}; loaded on {pose.device} in "
          f"{time.perf_counter() - t0:.2f} s")
    rs = np.random.RandomState(0)
    frame = (rs.rand(720, 1280, 3) * 255).astype(np.uint8)
    t0 = time.perf_counter()
    for _ in range(args.frames):
        result, _ = pose.estimate(frame)
    dt = time.perf_counter() - t0
    print(f"smoke ok: {args.frames} frame(s) in {dt * 1e3:.1f} ms, "
          f"num_people={result.num_people}, peaks_sum="
          f"{float(result.peaks[:, 0, 0].sum()):.0f}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return {"build": cmd_export, "check": cmd_check}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
