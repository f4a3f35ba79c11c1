"""Per-layer timing: ``caffe time`` (reference tools/caffe.cpp:334-421, the
per-layer Forward/Backward millisecond breakdown).

The port of ``caffe_rtpose_tpu/utils/profiler.py``.  The blobs are realized
by one forward; then each layer's forward is timed on them, and its backward
(the gradient of the sum of its tops with respect to its parameters and its
floating-point bottoms, by autograd) after an untimed forward.  Times come
from CUDA events on the card (``utils/timer.Timer``) and from the host clock
on the CPU.  The whole net's forward is timed too.  ``label_layers`` names
each layer's timed passes for ``torch.profiler`` (``record_function``), so
a trace of them (``caffe time --trace_dir``) reads by layer.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping

import numpy as np
import torch

from .timer import Timer


def _differentiable(layer_params, bots):
    leaves = [p for p in layer_params if p.requires_grad]
    for b in bots:
        if b.is_floating_point():
            leaves.append(b)
    return leaves


def time_net(net, inputs: Mapping[str, torch.Tensor], iterations: int = 10,
             backward: bool = True, label_layers: bool = False) -> Dict[str, Dict[str, float]]:
    """``{layer: {"forward_ms", "backward_ms"}}`` (NaN where a layer has no
    backward) plus ``"__fused_forward__"``, the whole net's forward."""

    def label(name):
        return torch.profiler.record_function(name) if label_layers else contextlib.nullcontext()

    timer = Timer(net.device)
    ops = net.operands()
    feed = {k: v.to(net.device) for k, v in inputs.items()}
    with torch.no_grad():
        blobs = {k: v.to(net.dtype).contiguous(memory_format=net.memory_format)
                 if v.dim() == 4 else v for k, v in feed.items()}
        blobs.update(net.forward(feed, outputs=[t for layer in net.layers for t in layer.tops]))
    results: Dict[str, Dict[str, float]] = {}
    for layer in net.layers:
        bots = [blobs[b] for b in layer.bottoms]
        with torch.no_grad(), label(f"{layer.name} forward"):
            net._run_layer(layer, bots, ops)  # warm-up
            timer.start()
            for _ in range(iterations):
                net._run_layer(layer, bots, ops)
            timer.stop()
        fwd_ms = timer.milli_seconds() / iterations
        bwd_ms = float("nan")
        params = net.mods[layer.name].blobs()
        if backward:
            gbots = [b.detach().requires_grad_(b.is_floating_point()) for b in bots]
            leaves = _differentiable(params, gbots)
            if leaves and layer.tops:
                total = 0.0
                for i in range(iterations + 1):
                    tops = net._run_layer(layer, gbots, ops)
                    out = sum(t.float().sum() for t in tops)
                    timer.start()
                    with label(f"{layer.name} backward"):
                        torch.autograd.grad(out, leaves, allow_unused=True)
                    timer.stop()
                    total += timer.milli_seconds() if i else 0.0  # the first is a warm-up
                bwd_ms = total / iterations
        results[layer.name] = {"forward_ms": fwd_ms, "backward_ms": bwd_ms}
    with torch.no_grad():
        net.forward(feed)
        timer.start()
        for _ in range(iterations):
            net.forward(feed)
        timer.stop()
    results["__fused_forward__"] = {"forward_ms": timer.milli_seconds() / iterations,
                                    "backward_ms": float("nan")}
    return results


def print_timing(results: Dict[str, Dict[str, float]]) -> None:
    total_f = sum(v["forward_ms"] for k, v in results.items() if not k.startswith("__"))
    total_b = sum(v["backward_ms"] for k, v in results.items()
                  if not k.startswith("__") and np.isfinite(v["backward_ms"]))
    for name, v in results.items():
        if name.startswith("__"):
            continue
        b = f"{v['backward_ms']:10.3f}" if np.isfinite(v["backward_ms"]) else "       n/a"
        print(f"{name:>28}  forward: {v['forward_ms']:10.3f} ms  backward: {b} ms")
    print(f"{'TOTAL (per-layer sum)':>28}  forward: {total_f:10.3f} ms  backward: {total_b:10.3f} ms")
    fused = results.get("__fused_forward__")
    if fused:
        print(f"{'whole-net forward':>28}  {fused['forward_ms']:10.3f} ms")
