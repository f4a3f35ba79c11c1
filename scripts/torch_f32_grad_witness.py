#!/usr/bin/env python3
"""One CPM train step's gradients on one CUDA card in several arithmetics,
each held against an f64 run of the same step: which of them computes the
gradients right at bench_train.py's shape.

    python3 scripts/torch_f32_grad_witness.py [--batch 10] [--crop 368]

The full 6-stage train net (seed 0 init) on one augmented synthetic batch
with its labels rasterized on the card, as chip_smoke.py's train bf16 phase
builds it.  Runs, each a fresh net: f64 on the card (the witness: the f32
parameters and inputs converted to f64; the losses keep f32 residuals), f32
with cuDNN (the port's f32 training, TF32 off), f32 without cuDNN (ATen's
own convolutions), bf16 mixed precision (cuDNN), and f32 on the host CPU.
The port's f32 TRAIN path is the one without cuDNN (``ops/nn.py::
_OutsideCudnn``); the cuDNN run takes that class out for its duration.
Prints, for each, the relative L2 distance of every parameter blob's
gradient from the witness's: the median and the largest, and the blobs
conv2_2, conv4_1 (weight and bias); on the card also a second forward and
backward of each run between CUDA events.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def step_grads(batch, crop, inputs, device, dtype=torch.float32, f64=False):
    from caffe_rtpose_tpu_torch.core.net import Net
    from caffe_rtpose_tpu_torch.models.cpm import make_pose_train_net

    net = Net(make_pose_train_net(batch=batch, crop=crop), phase="TRAIN", device=device,
              seed=0, dtype=dtype)
    if f64:
        net.double()
        net.dtype = torch.float64
        net.params_changed()
    feed = {k: v.to(device) for k, v in inputs.items()}
    loss, _ = net.loss(feed)
    loss.backward()
    grads = {name: [p.grad.detach().double().cpu() for p in ps]
             for name, ps in net.layer_blobs().items()}
    ms = None
    if device == "cuda":  # forward and backward again, between CUDA events
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        net.loss(feed)[0].backward()
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b)
    return grads, ms


class _ThroughCudnn:
    """Stands in for ``_OutsideCudnn``: the plain ops, through cuDNN."""

    @staticmethod
    def apply(x, w, b, stride, pad, dilation, groups, transposed):
        import torch.nn.functional as F

        op = F.conv_transpose2d if transposed else F.conv2d
        return op(x, w, b, stride=stride, padding=pad, dilation=dilation, groups=groups)


def distances(run, ref):
    got, ms = run
    rel = {}
    for name, refs in ref.items():
        for i, (g, r) in enumerate(zip(got[name], refs)):
            rel[f"{name}[{i}]"] = float((g - r).norm() / max(float(r.norm()), 1e-300))
    worst = max(rel, key=rel.get)
    keep = ("conv2_2[1]", "conv4_1[0]", "conv4_1[1]")
    return dict(median=float(np.median(list(rel.values()))), largest=rel[worst],
                largest_blob=worst, fwd_bwd_ms=ms, **{k: rel[k] for k in keep if k in rel})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=10)
    ap.add_argument("--crop", type=int, default=368)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_f32_grad_witness: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from caffe_rtpose_tpu_torch.training.datasets import SyntheticPoseSource
    from caffe_rtpose_tpu_torch.training.labels_device import (make_input_transform,
                                                               pose_batches_jointfeed)
    from caffe_rtpose_tpu_torch.training.transformer import AugParams

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    B, crop = args.batch, args.crop
    prm = AugParams(crop_size_x=crop, crop_size_y=crop)
    host = next(pose_batches_jointfeed(SyntheticPoseSource(n=16, size=crop, seed=3), prm, B,
                                       seed=4, data_u8=True))
    transform = make_input_transform(prm, data_u8=True)
    inputs = {k: v.cpu() for k, v in transform(
        {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in host.items()}).items()}
    witness = step_grads(B, crop, inputs, "cuda", f64=True)[0]
    from caffe_rtpose_tpu_torch.ops import nn as nn_ops

    out = {}
    out["f32 without cuDNN"] = distances(step_grads(B, crop, inputs, "cuda"), witness)
    outside = nn_ops._OutsideCudnn
    nn_ops._OutsideCudnn = _ThroughCudnn
    try:
        out["f32 cuDNN"] = distances(step_grads(B, crop, inputs, "cuda"), witness)
    finally:
        nn_ops._OutsideCudnn = outside
    out["bf16 cuDNN"] = distances(step_grads(B, crop, inputs, "cuda", torch.bfloat16), witness)
    torch.set_num_threads(os.cpu_count() or 1)
    out["f32 host CPU"] = distances(step_grads(B, crop, inputs, "cpu"), witness)
    print(f"card {card}; batch {B}, crop {crop}: relative L2 of each blob's gradient from an "
          "f64 run of the same step")
    for k, v in out.items():
        print(f"  {k:<18} median {v['median']:.2e}, largest {v['largest']:.2e} "
              f"({v['largest_blob']}); conv2_2[1] {v.get('conv2_2[1]', float('nan')):.2e}, "
              f"conv4_1[0] {v.get('conv4_1[0]', float('nan')):.2e}, conv4_1[1] "
              f"{v.get('conv4_1[1]', float('nan')):.2e}; forward+backward {v['fwd_bwd_ms']} ms")
    print(json.dumps(dict(card=card, batch=B, crop=crop, against_f64=out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
