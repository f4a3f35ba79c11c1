"""Windowed detection CLI (reference python/detect.py), the port of
``caffe_rtpose_tpu/tools/detect.py``: runs a classifier (``api.Detector``)
over proposal windows listed in a CSV ('filename, xmin, ymin, xmax, ymax'
header) or over whole images from a .txt list, and writes a CSV or HDF5 of
per-window predictions.

    python -m caffe_rtpose_tpu_torch.tools.detect windows.csv out.csv \
        --model_def deploy.prototxt --pretrained_model weights.caffemodel \
        --crop_mode=list [--device cpu]

Runs on the card (``--device cuda``, the default; ``--gpu`` is accepted and
means the same) or with ``--device cpu``.  PNG, BMP and JPEG images need no
OpenCV; an ``.h5`` output is written by the port's HDF5 codec
(``utils/hdf5.py``).
"""

import argparse
import csv
import os
import sys
import time

import numpy as np

CROP_MODES = ["list", "selective_search"]


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("input_file",
                        help=".txt list of images or .csv of windows "
                             "(header: filename, xmin, ymin, xmax, ymax)")
    parser.add_argument("output_file",
                        help="Output h5/csv filename (by extension).")
    parser.add_argument("--model_def", required=True)
    parser.add_argument("--pretrained_model", default=None)
    parser.add_argument("--crop_mode", default="selective_search",
                        choices=CROP_MODES,
                        help="How to generate windows for detection.")
    parser.add_argument("--gpu", action="store_true", help="run on the card (the default)")
    parser.add_argument("--device", default="cuda", help="cuda (a card) or cpu")
    parser.add_argument("--mean_file", default="")
    parser.add_argument("--input_scale", type=float)
    parser.add_argument("--raw_scale", type=float, default=255.0)
    parser.add_argument("--channel_swap", default="2,1,0")
    parser.add_argument("--context_pad", type=int, default=16,
                        help="Surrounding context to include per window.")
    return parser


def _read_windows_csv(path):
    images_windows = {}
    with open(path) as f:
        for row in csv.DictReader(f, skipinitialspace=True):
            w = [float(row["ymin"]), float(row["xmin"]),
                 float(row["ymax"]), float(row["xmax"])]
            images_windows.setdefault(row["filename"], []).append(w)
    return list(images_windows.items())


def main(argv=None):
    args = build_parser().parse_args(argv)
    from .. import api as caffe

    mean = np.load(args.mean_file) if args.mean_file else None
    channel_swap = ([int(s) for s in args.channel_swap.split(",")]
                    if args.channel_swap else None)
    if args.device == "cpu" and not args.gpu:
        caffe.set_mode_cpu()
    else:
        caffe.set_mode_gpu()
        if ":" in args.device:
            caffe.set_device(int(args.device.split(":", 1)[1]))

    detector = caffe.Detector(
        args.model_def, args.pretrained_model, mean=mean,
        input_scale=args.input_scale, raw_scale=args.raw_scale,
        channel_swap=channel_swap, context_pad=args.context_pad)

    if args.input_file.lower().endswith(".csv"):
        images_windows = _read_windows_csv(args.input_file)
    elif args.input_file.lower().endswith(".txt"):
        if args.crop_mode == "selective_search":
            raise SystemExit(
                "selective_search proposals need the external "
                "selective_search_ijcv_with_python package (not in this "
                "image); provide a windows .csv and --crop_mode=list")
        paths = [l.strip() for l in open(args.input_file) if l.strip()]
        images_windows = []
        for p in paths:
            im = caffe.load_image(p)
            images_windows.append((p, [[0, 0, im.shape[0], im.shape[1]]]))
    else:
        raise SystemExit("input must be .txt or .csv")

    t = time.time()
    detections = (detector.detect_windows(images_windows)
                  if images_windows else [])
    print(f"Processed {len(detections)} windows in "
          f"{time.time() - t:.3f} s.")

    if args.output_file.lower().endswith((".h5", ".hdf5")):
        from ..utils import hdf5

        with hdf5.File(args.output_file, "w") as f:
            f["prediction"] = np.stack([d["prediction"] for d in detections])
            f["ymin"] = [d["window"][0] for d in detections]
            f["xmin"] = [d["window"][1] for d in detections]
            f["ymax"] = [d["window"][2] for d in detections]
            f["xmax"] = [d["window"][3] for d in detections]
            f["filename"] = [d["filename"].encode() for d in detections]
    else:
        with open(args.output_file, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["filename", "ymin", "xmin", "ymax", "xmax",
                        "prediction"])
            for d in detections:
                w.writerow([d["filename"], *d["window"],
                            " ".join("%g" % v
                                     for v in np.ravel(d["prediction"]))])
    print(f"Saved to {args.output_file}.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
