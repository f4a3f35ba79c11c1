"""Image classifier CLI (reference python/classify.py), the port of
``caffe_rtpose_tpu/tools/classify.py``: a deploy net and its weights, the
images resized, cropped (the centre, or 10 crops averaged), mean-subtracted
and channel-swapped, the class probabilities written as an ``.npy``.

    python -m caffe_rtpose_tpu_torch classify input.png out.npy \\
        --model_def deploy.prototxt --pretrained_model weights.caffemodel [--device cpu]

Runs on the card (``--device cuda``, the default; ``--gpu`` is accepted and
means the card, as the reference's switch) or with ``--device cpu``.
``input_file`` is an image, a directory of ``--ext`` images or an ``.npy``
of images (H, W, K) in [0, 1]; PNG and BMP need no OpenCV.
"""

import argparse
import glob
import os
import sys
import time

import numpy as np


def build_parser():
    parser = argparse.ArgumentParser(prog="classify", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("input_file", help="Input image, directory, or npy.")
    parser.add_argument("output_file", help="Output npy filename.")
    parser.add_argument("--model_def", required=True, help="Model definition file.")
    parser.add_argument("--pretrained_model", default=None, help="Trained model weights file.")
    parser.add_argument("--device", default="cuda", help="cuda (a card) or cpu")
    parser.add_argument("--gpu", action="store_true", help="run on the card (the default)")
    parser.add_argument("--center_only", action="store_true",
                        help="Predict from the centre crop alone instead of averaging "
                             "predictions across 10 crops.")
    parser.add_argument("--images_dim", default="256,256",
                        help="Canonical 'height,width' of input images.")
    parser.add_argument("--mean_file", default="", help="Image mean .npy (C x H x W); '' = none.")
    parser.add_argument("--input_scale", type=float, help="Multiply input features by this scale.")
    parser.add_argument("--raw_scale", type=float, default=255.0,
                        help="Multiply raw input by this scale.")
    parser.add_argument("--channel_swap", default="2,1,0",
                        help="Channel permutation (RGB -> BGR default).")
    parser.add_argument("--ext", default="png", help="Image extension for directory inputs.")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .. import api as caffe

    if args.device == "cpu" and not args.gpu:
        caffe.set_mode_cpu()
    else:
        caffe.set_mode_gpu()
        if ":" in args.device:
            caffe.set_device(int(args.device.split(":", 1)[1]))
    image_dims = [int(s) for s in args.images_dim.split(",")]
    mean = np.load(args.mean_file) if args.mean_file else None
    channel_swap = [int(s) for s in args.channel_swap.split(",")] if args.channel_swap else None
    classifier = caffe.Classifier(args.model_def, args.pretrained_model, image_dims=image_dims,
                                  mean=mean, input_scale=args.input_scale,
                                  raw_scale=args.raw_scale, channel_swap=channel_swap)
    if args.input_file.endswith("npy"):
        inputs = np.load(args.input_file)
        inputs = list(inputs) if inputs.ndim == 4 else [inputs]
    elif os.path.isdir(args.input_file):
        inputs = [caffe.load_image(f) for f in
                  sorted(glob.glob(os.path.join(args.input_file, "*." + args.ext)))]
    else:
        inputs = [caffe.load_image(args.input_file)]
    print(f"Classifying {len(inputs)} inputs.")
    start = time.time()
    predictions = classifier.predict(inputs, not args.center_only)
    print(f"Done in {time.time() - start:.2f} s.")
    np.save(args.output_file, predictions)
    return 0


if __name__ == "__main__":
    sys.exit(main())
