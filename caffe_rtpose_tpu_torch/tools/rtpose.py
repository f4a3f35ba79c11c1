"""rtpose CLI — the realtime pose demo on a CUDA card (or the CPU).

The port of ``caffe_rtpose_tpu/tools/rtpose.py``: the same flags and
defaults (which mirror the reference gflags, examples/rtpose/rtpose.cpp:
50-72), plus ``--device``; ``--caffeproto`` defaults to the reference
checkout's relative path, as ``--caffemodel`` does.  Run:

    python -m caffe_rtpose_tpu_torch rtpose --image_dir DIR --write_json OUT --no_display

An existing ``--caffeproto`` prototxt and ``--caffemodel`` file are read
as the JAX tool reads them; a missing prototxt falls back to the built-in
COCO graph and a missing caffemodel to random weights, with the JAX tool's
warnings.  ``--bundle DIR`` serves an exported bundle (``serving.py``;
the bundle fixes the net geometry, dtype and batch), and ``--num_gpu N``
spreads the passes round-robin over N cards from ``--start_device``
(``parallel/inference.py``).
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_resolution(s: str):
    try:
        w, h = s.split("x")
        return int(w), int(h)
    except Exception:
        raise argparse.ArgumentTypeError(
            f"Error, resolution format ({s}) invalid, should be e.g., 656x368"
        )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rtpose", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--video", default="", help="Use a video file instead of the camera.")
    p.add_argument("--camera", type=int, default=0, help="The camera index for VideoCapture.")
    p.add_argument("--image_dir", default="", help="Process a directory of images.")
    p.add_argument("--start_frame", type=int, default=0, help="Skip to frame # of video")
    p.add_argument("--caffemodel", default="model/coco/pose_iter_440000.caffemodel",
                   help="Caffe model.")
    p.add_argument("--caffeproto", default="model/coco/pose_deploy_linevec.prototxt",
                   help="Caffe deploy prototxt.")
    p.add_argument("--resolution", type=parse_resolution, default=(1280, 720),
                   help="The image resolution (display).")
    p.add_argument("--net_resolution", type=parse_resolution, default=(656, 368),
                   help="Multiples of 16.")
    p.add_argument("--camera_resolution", type=parse_resolution, default=(1280, 720),
                   help="Size of the camera frames to ask for.")
    p.add_argument("--start_device", type=int, default=0,
                   help="CUDA device number (--device cuda runs on cuda:N).")
    p.add_argument("--num_gpu", type=int, default=1,
                   help="The number of GPUs to use (frame-parallel, round-robin).")
    p.add_argument("--start_scale", type=float, default=1.0, help="Initial scale.")
    p.add_argument("--scale_gap", type=float, default=0.3,
                   help="Scale gap between scales. No effect unless num_scales>1")
    p.add_argument("--num_scales", type=int, default=1, help="Number of scales to average")
    p.add_argument("--no_frame_drops", action="store_true", help="Dont drop frames.")
    p.add_argument("--write_frames", default="", help="Write frames with format prefix%%06d.jpg")
    p.add_argument("--write_json", default="", help="Write joint data with json format as prefix%%06d.json")
    p.add_argument("--no_display", action="store_true", help="Do not open a display window.")
    p.add_argument("--no_text", action="store_true", help="Do not write text on output images.")
    p.add_argument("--fullscreen", action="store_true", help="Run in fullscreen mode")
    p.add_argument("--part_to_show", type=int, default=0, help="Part to show from the start.")
    p.add_argument("--frame_limit", type=int, default=None,
                   help="(extension) stop after N frames")
    p.add_argument("--pair_cap", type=int, default=32,
                   help="transfer PAF pair scores for the first K peaks/part; "
                        "frames where any part exceeds K are detected from "
                        "the raw counts and automatically refetched uncapped "
                        "(logged), so results are always exact (0 = uncapped)")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                   help="(extension) CNN compute dtype")
    p.add_argument("--nms_threshold", type=float, default=None,
                   help="(extension) starting NMS threshold — the value the "
                        "reference only reaches via the -/= keyboard tuning "
                        "(rtpose.cpp:1617); default = the model descriptor's")
    p.add_argument("--device_rescale", action="store_true",
                   help="(extension, documented divergence) multi-scale: "
                        "upload only the largest scale and derive smaller "
                        "scales on device with INTER_AREA matmuls — "
                        "multi-scale at single-scale upload bytes; pixels "
                        "differ by resize-of-a-resize rounding")
    p.add_argument("--no_weights", action="store_true",
                   help="(extension) run with random-initialized weights")
    p.add_argument("--bundle", default="",
                   help="(extension) run from an exported serving bundle directory "
                        "(python -m caffe_rtpose_tpu_torch export build)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the network runs: cuda (cuda:<start_device>) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from ..pose.estimator import PoseEstimator

    device = f"cuda:{args.start_device}" if args.device == "cuda" else "cpu"
    if args.bundle:
        if args.part_to_show > 0:
            print("error: --bundle runs the packed fast path; heatmap views "
                  "(--part_to_show > 0) need a live estimator with "
                  "keep_heatmap", file=sys.stderr)
            return 2
        from ..serving import ExportedPose

        est = ExportedPose(args.bundle, warm_overflow=True, device=device)
        # the exported program fixes the input geometry: the pipeline's
        # preprocess must match it
        args.net_resolution = (est.net_w, est.net_h)
        args.num_scales = est.num_scales
        args.start_scale = est.start_scale
        args.scale_gap = est.scale_gap
        return _run_pipeline(est, args)
    weights = None if args.no_weights else (
        args.caffemodel if os.path.exists(args.caffemodel) else None)
    if weights is None and not args.no_weights:
        print(f"warning: caffemodel {args.caffemodel!r} not found; "
              "running with random weights", file=sys.stderr)
    if args.device_rescale and args.part_to_show > 0:
        print("error: --device_rescale needs the u8 fast path "
              "(incompatible with --part_to_show heatmap views)", file=sys.stderr)
        return 2
    if args.pair_cap < 0:
        print("error: --pair_cap must be >= 0", file=sys.stderr)
        return 2

    nw, nh = args.net_resolution
    if nw % 16 or nh % 16:
        # reference CHECK (rtpose.cpp:360): net dims must be multiples of 16
        print(f"error: --net_resolution {nw}x{nh} invalid — both dimensions "
              "must be multiples of 16", file=sys.stderr)
        return 2

    proto = args.caffeproto
    if not os.path.exists(proto):
        # self-contained fallback: the generator emits the identical COCO
        # deploy topology (models/cpm.py), so the demo runs without the
        # reference checkout
        from ..models.cpm import make_pose_deploy_net

        print(f"warning: prototxt {proto!r} not found; using the built-in "
              "COCO 18-kpt deploy graph", file=sys.stderr)
        proto = make_pose_deploy_net()

    est = PoseEstimator(
        proto,
        weights=weights,
        net_resolution=args.net_resolution,
        num_scales=args.num_scales,
        start_scale=args.start_scale,
        scale_gap=args.scale_gap,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        # part/PAF heatmap views (--part_to_show > 0 or the 0-9qwe..s keys)
        # need the full-res maps on host; that disables the packed fast path,
        # so only request them when the run starts in a heatmap view
        keep_heatmap=args.part_to_show > 0,
        input_u8=args.part_to_show == 0,
        pair_cap=args.pair_cap or None,
        device_rescale=args.device_rescale,
        # realtime: capture the pair_cap overflow program in the background
        # so the first crowded frame doesn't stall the stream
        warm_overflow=True,
        device=device,
    )
    return _run_pipeline(est, args)


def _run_pipeline(est, args) -> int:
    from ..pipeline.runner import PipelineConfig, RtPosePipeline

    cfg = PipelineConfig(
        video=args.video, camera=args.camera, image_dir=args.image_dir,
        resolution=args.resolution, net_resolution=args.net_resolution,
        camera_resolution=args.camera_resolution, start_frame=args.start_frame,
        num_devices=args.num_gpu, start_device=args.start_device,
        start_scale=args.start_scale,
        scale_gap=args.scale_gap, num_scales=args.num_scales,
        no_frame_drops=args.no_frame_drops, write_frames=args.write_frames,
        write_json=args.write_json,
        no_display=args.no_display or os.environ.get("DISPLAY") is None,
        part_to_show=args.part_to_show, fullscreen=args.fullscreen,
        no_text=args.no_text, frame_limit=args.frame_limit,
        nms_threshold=args.nms_threshold,
    )
    pipe = RtPosePipeline(est, cfg)
    n = pipe.run()
    refetches = getattr(est, "_overflow_refetches", 0)
    print(f"rtpose: {n} frames, {refetches} overflow refetches (pair_cap={args.pair_cap})")
    return 0 if n >= 0 else 1


if __name__ == "__main__":
    sys.exit(main())
