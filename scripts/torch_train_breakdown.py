#!/usr/bin/env python3
"""Breakdown of the port's CPM training step on one CUDA card, the
counterpart of scripts/train_breakdown.py (same flags).

    python3 scripts/torch_train_breakdown.py [--batch 10] [--crop 368] [--n 10]
        [--dtype f32|bf16] [--remat none|convs]

Builds ``make_pose_train_net(batch, crop)`` (6 stages, seed 0 init) in the
TRAIN phase with ``dtype`` (bf16: mixed precision, f32 parameters and
update) and ``remat``, and feeds it one fixed batch already on the card
(data uniform in [-0.5, 0.5), labels 0/1), as the JAX script does, so no
host augmentation takes part.  Reports, from CUDA events (median of
``--n`` after 3 warm runs): the forward loss alone (no gradient), forward
and backward, and the whole ``Solver.step`` (SGD 2e-5, momentum 0.9, weight
decay 5e-4); from ``torch.profiler`` over 2 steps: the kernels a step,
their busy ms and the top kernels by device ms; the peak of
``torch.cuda.max_memory_allocated`` over the timed steps; the
convolutions' operations (3x the forward's, as the JAX script counts) and
their bound at the card's peak for the dtype (989 TFLOP/s bf16, 67 TFLOP/s
f32: the H100 SXM data sheet).  Prints the card's name and power limit.
Needs a CUDA card; it does not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PEAK = {"bf16": 989e12, "f32": 67e12}
SOLVER = "base_lr: 2e-5 lr_policy: 'fixed' momentum: 0.9 weight_decay: 5e-4"


def events_ms(fn, n: int, warm: int = 3) -> list:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def profile_steps(fn, steps: int = 2, top: int = 10):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    rows, kernels, busy_us = {}, 0, 0.0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or "Memcpy" in evt.key or "Memset" in evt.key:
            continue
        us = getattr(evt, "device_time_total", None)
        us = evt.cuda_time_total if us is None else us
        kernels += evt.count
        busy_us += us
        rows[evt.key] = (evt.count / steps, us / 1000.0 / steps)
    best = sorted(rows.items(), key=lambda kv: -kv[1][1])[:top]
    return kernels / steps, busy_us / 1000.0 / steps, best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=10)
    ap.add_argument("--crop", type=int, default=368)
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--remat", default="none", choices=["none", "convs"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_train_breakdown: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1

    from caffe_rtpose_tpu_torch.core.net import Net
    from caffe_rtpose_tpu_torch.models.cpm import make_pose_train_net
    from caffe_rtpose_tpu_torch.training.solver import Solver

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    B, crop = args.batch, args.crop
    net = Net(make_pose_train_net(batch=B, crop=crop), phase="TRAIN", device="cuda", seed=0,
              dtype=dtype, remat=args.remat)
    rs = np.random.RandomState(0)
    batch = {"data": torch.from_numpy(rs.rand(B, 3, crop, crop).astype(np.float32) - 0.5),
             "label": torch.from_numpy((rs.rand(B, 114, crop // 8, crop // 8) > 0.7)
                                       .astype(np.float32))}
    batch = {k: v.cuda() for k, v in batch.items()}
    solver = Solver(SOLVER, net, lambda _: batch)
    fwd_flops = 0
    for layer in net.layers:
        if layer.type == "Convolution":
            n, co, h, w = net.blob_shapes[layer.tops[0]]
            conv = net.convs[layer.name]
            fwd_flops += 2 * n * co * h * w * conv.weight.shape[1] * conv.kernel[0] * conv.kernel[1]
    flops = 3 * fwd_flops

    def forward():
        with torch.no_grad():
            net.loss(batch)

    def forward_backward():
        for p in net.parameters():
            p.grad = None
        net.loss(batch)[0].backward()

    t_fwd = events_ms(forward, args.n)
    t_fb = events_ms(forward_backward, args.n)
    torch.cuda.reset_peak_memory_stats()
    t_step = events_ms(lambda: solver.step(1), args.n)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    kernels, busy, top = profile_steps(lambda: solver.step(1))
    med = {k: statistics.median(v) for k, v in
           (("forward", t_fwd), ("forward_backward", t_fb), ("step", t_step))}
    bound = flops / PEAK[args.dtype] * 1e3
    print(f"card {card}; batch={B} crop={crop} dtype={args.dtype} remat={args.remat}")
    print(f"forward loss        {med['forward']:8.2f} ms")
    print(f"forward+backward    {med['forward_backward']:8.2f} ms")
    print(f"Solver.step         {med['step']:8.2f} ms  ({1e3 / med['step']:.2f} iters/s, "
          f"{B * 1e3 / med['step']:.1f} imgs/s, compute only)")
    print(f"backward only       {med['forward_backward'] - med['forward']:8.2f} ms; "
          f"update {med['step'] - med['forward_backward']:.2f} ms")
    print(f"profiler: {kernels:.0f} kernels a step, busy {busy:.2f} ms a step "
          f"({busy / med['step']:.3f} of the step)")
    for name, (n, ms) in top:
        print(f"  {ms:8.2f} ms  x{n:<5.0f} {name[:100]}")
    print(f"convolutions {flops / 1e12:.3f} TFLOP a step (3x the forward), bound "
          f"{bound:.1f} ms at the {args.dtype} peak ({bound / med['step']:.3f} of the step); "
          f"peak memory {peak:.3f} GiB")
    print(json.dumps(dict(card=card, batch=B, crop=crop, dtype=args.dtype, remat=args.remat,
                          ms=med, step_ms=t_step, kernels_a_step=kernels, busy_ms=busy,
                          peak_gib=peak, tflop_a_step=flops / 1e12, bound_ms=bound,
                          top=[dict(name=k, launches=n, ms=ms) for k, (n, ms) in top])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
