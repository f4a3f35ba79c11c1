#!/usr/bin/env python3
"""Smoke test of the PyTorch port (caffe_rtpose_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:

1. device   - the card's name and power limit (nvidia-smi), torch/CUDA
              versions and the nvcc path; refuses to run without CUDA.
2. build    - builds the CUDA kernels from csrc/ with nvcc.
3. kernels  - the hand-written peak-mask kernel against its plain PyTorch
              version on the card, at the estimator's shapes (COCO 1 and 3
              scales, MPI, small and ragged); masks must be equal except at
              near-ties (|U-thr| or |U-max8| <= 1e-5*max(1,|U|)); times both
              at the COCO 1-scale and 3-scale (gap 0.3) shapes.
4. slice    - the full-width COCO estimator (656x368, 1 scale, u8 input,
              pair_cap=32, f32) over 8 synthetic frames through
              estimate_from_net_input, with the kernel's launch count read
              around that run; its packed outputs against the same estimator
              with the plain peak mask; device and end-to-end ms/frame.
              Then once more at 3 scales.

Weights are seeded numpy at fan-in scale.  In each slice run the
part-heatmap head's bias is set from that run's frames so that 0.05% of the
scale-averaged full-res part-map pixels clear the NMS threshold, as a
trained model's maps give a few peaks per person (random maps would put
hundreds of peaks in every part).

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np

TOL_NEAR_TIE = 1e-5
TOL_FLOAT = 1e-4
HEAT_FRAC = 5e-4  # share of full-res part-map pixels above the NMS threshold


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps: int = 20):
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch

    fn()  # warm-up
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def near_tie_violations(got, ref, heat, thr):
    """(number of differing pixels, number of those that are no near-tie)."""
    import torch
    import torch.nn.functional as F

    diff = got != ref
    n_diff = int(diff.sum())
    if n_diff == 0:
        return 0, 0
    pad = F.pad(heat, (1, 1, 1, 1), value=-float("inf"))
    shifts = [pad[:, 1 + dy : 1 + dy + heat.shape[1], 1 + dx : 1 + dx + heat.shape[2]]
              for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx]
    max8 = torch.stack(shifts).amax(0)
    tol = TOL_NEAR_TIE * torch.clamp_min(heat.abs(), 1.0)
    tie = ((heat - thr).abs() <= tol) | ((heat - max8).abs() <= tol)
    return n_diff, int((diff & ~tie).sum())


def phase_device():
    import torch

    from caffe_rtpose_tpu_torch.utils.device import device_query

    info = device_query()
    for k, v in info.items():
        print(f"[device] {k}: {v}")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke needs a CUDA card")
    return info


def phase_build():
    from caffe_rtpose_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load_kernels()
    secs = time.perf_counter() - t0
    print(f"[build] kernels ready in {secs:.2f} s")
    for line in _build.build_log.get("crt_kernels", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build] {line.strip()}")
    return secs


def phase_kernels(device="cuda"):
    import torch

    from caffe_rtpose_tpu_torch.ops import nms_cuda
    from caffe_rtpose_tpu_torch.ops.imresize import imresize_average

    dev = torch.device(device)
    cases = [  # name, S, start, gap, h, w, factor, C
        ("coco_1scale", 1, 1.0, 0.3, 46, 82, 8, 18),
        ("coco_3scale_gap0.15", 3, 1.0, 0.15, 46, 82, 8, 18),
        ("coco_3scale_gap0.3", 3, 1.0, 0.3, 46, 82, 8, 18),
        ("mpi_3scale", 3, 0.9, 0.1, 46, 82, 8, 15),
        ("small", 1, 1.0, 0.3, 12, 16, 8, 6),
        ("small_3scale", 3, 0.9, 0.1, 12, 16, 8, 6),
        ("ragged", 1, 1.0, 0.3, 13, 17, 8, 5),
        ("ragged_3scale", 3, 0.9, 0.1, 13, 17, 8, 5),
    ]
    thr = 0.05
    timing = None
    for i, (name, s, start, gap, h, w, f, c) in enumerate(cases):
        rs = np.random.RandomState(100 + i)
        low = torch.from_numpy(rs.rand(s, h, w, c).astype(np.float32) * 2 - 1).to(dev)
        th, tw = h * f, w * f
        got = nms_cuda.peak_mask_fused(low, (th, tw), start, gap, thr)
        torch.cuda.synchronize()
        ref = nms_cuda.peak_mask_fused_reference(low, (th, tw), start, gap, thr)
        heat = imresize_average(low, th, tw, start, gap)[0].permute(2, 0, 1)
        n_diff, n_bad = near_tie_violations(got, ref, heat, thr)
        print(f"[kernels] {name}: S={s} {h}x{w}->{th}x{tw} C={c}: {int(ref.sum())} peaks, "
              f"{n_diff} pixels differ, {n_bad} of them no near-tie")
        check(n_bad == 0, f"peak mask kernel disagrees with the plain version at {name}")
        check(int(ref.sum()) > 0, f"{name}: no peaks, the comparison is vacuous")
        if name in ("coco_1scale", "coco_3scale_gap0.3"):
            args = (low, (th, tw), start, gap, thr)
            ms_p = cuda_ms(lambda: nms_cuda.peak_mask_fused_reference(*args))
            ms_k = cuda_ms(lambda: nms_cuda.peak_mask_fused(*args))
            ms_k2 = cuda_ms(lambda: nms_cuda.peak_mask_fused(*args))
            ms_p2 = cuda_ms(lambda: nms_cuda.peak_mask_fused_reference(*args))
            print(f"[kernels] {name} median of 20 (plain, kernel, kernel, plain): "
                  f"{ms_p:.4f} {ms_k:.4f} {ms_k2:.4f} {ms_p2:.4f} ms")
        if name == "coco_1scale":
            max_err = float((got.to(torch.int8) - ref.to(torch.int8)).abs().max())
            timing = dict(ms=min(ms_k, ms_k2), plain_ms=min(ms_p, ms_p2), max_abs_err=max_err)
    return timing


def fan_in_weights(net, seed: int):
    rs = np.random.RandomState(seed)
    weights = {}
    for name in sorted(net.convs.keys()):
        cout, cin, kh, kw = net.convs[name].weight.shape
        w = rs.randn(cout, cin, kh, kw).astype(np.float32) * np.sqrt(2.0 / (cin * kh * kw))
        weights[name] = [w, np.zeros(cout, np.float32)]
    return weights


def calibrate_heat_head(est, weights, frames, frac: float):
    """Shift the part-heatmap head's bias so that ``frac`` of each part's
    pixels of the scale-averaged full-res map, over all ``frames``, clear the
    NMS threshold.  Every bicubic row sums to 1, so a bias shift b moves that
    map by exactly b."""
    import torch

    from caffe_rtpose_tpu_torch.ops.imresize import imresize_average

    head = est.net.post_layers["resize"].bottoms[0]
    concat = next(l for l in est.net.layers if l.tops == [head])
    heat_layer = concat.bottoms[0]  # heatmaps first (deploy file order)
    P = est.num_parts
    th, tw = est.target_hw
    maps = []
    for canvas in frames:
        x = torch.from_numpy(canvas).to(est.device).float() / 256.0 - 0.5
        x = (x * est._mask).permute(0, 3, 1, 2)  # as the estimator normalizes u8 input
        with torch.inference_mode():
            low = est.net({"image": x}, outputs=[heat_layer])[heat_layer][:, :P]
            u = imresize_average(low.permute(0, 2, 3, 1), th, tw, est.start_scale, est.scale_gap)
        maps.append(u.reshape(-1, P))
    u = torch.cat(maps)
    q = u.kthvalue(int(u.shape[0] * (1.0 - frac)), dim=0).values
    bias = weights[heat_layer][1].copy()
    bias[:P] += est.params_connect.nms_threshold - q.cpu().numpy()
    weights[heat_layer][1] = bias
    return weights


def canvases(rs, n, shape):
    """Synthetic u8 frames: smooth colour gradients plus noise."""
    s, h, w, _ = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for _ in range(n):
        base = np.stack([(np.sin(xx / rs.uniform(20, 80) + rs.uniform(0, 6)) * 0.5 + 0.5)
                         * (np.cos(yy / rs.uniform(20, 80)) * 0.5 + 0.5) for _ in range(3)], -1)
        img = np.clip(base * 200 + rs.rand(h, w, 3) * 55, 0, 255).astype(np.uint8)
        out.append(np.broadcast_to(img, (s, h, w, 3)).copy())
    return out


def phase_slice(num_scales: int, n_frames: int, device="cuda", net_resolution=(656, 368),
                stages=6):
    import torch

    from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
    from caffe_rtpose_tpu_torch.ops import nms_cuda
    from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator

    cfg = dict(net_resolution=net_resolution, num_scales=num_scales, input_u8=True,
               pair_cap=32, pack_u8=False, dtype=torch.float32, device=device)
    proto = make_pose_deploy_net("COCO", stages=stages)
    est = PoseEstimator(proto, peak_kernel=True, **cfg)
    rs = np.random.RandomState(0)
    frames = canvases(rs, n_frames, est.input_shape())
    weights = fan_in_weights(est.net, 0)
    est.net.load_weights(weights)
    weights = calibrate_heat_head(est, weights, frames, HEAT_FRAC)
    est.net.load_weights(weights)
    twin = PoseEstimator(proto, weights=weights, peak_kernel=False, **cfg)
    tag = f"[slice {num_scales}-scale]"

    est.estimate_from_net_input(frames[0])  # warm-up (cuDNN autotune, allocator)
    torch.cuda.synchronize()
    nms_cuda.launches = 0
    refetch0 = est._overflow_refetches
    t0 = time.perf_counter()
    results = [est.estimate_from_net_input(f) for f in frames]
    e2e_ms = (time.perf_counter() - t0) * 1000.0 / n_frames
    launches = nms_cuda.launches
    passes = n_frames + est._overflow_refetches - refetch0
    check(launches == passes, f"{tag} kernel launched {launches} times for {passes} device passes")

    dev_ms = cuda_ms(lambda: est.run_device(frames[1 % n_frames]), reps=n_frames)
    total_peaks = 0
    max_err = 0.0
    for f, res in zip(frames, results):
        pk, sc, ct = est.fetch(est.run_device(f))
        pt, st, cnt_t = twin.fetch(twin.run_device(f))
        check(pk.shape == (18, 33, 3) and sc.shape == ct.shape == (19, 32, 32), f"{tag} shapes")
        check(pt.shape == pk.shape and st.shape == sc.shape, f"{tag} plain-path shapes")
        np.testing.assert_array_equal(pk[:, 0, 0], pt[:, 0, 0], err_msg=f"{tag} peak counts")
        np.testing.assert_array_equal(ct, cnt_t, err_msg=f"{tag} pair counts")
        np.testing.assert_allclose(pk, pt, rtol=0, atol=TOL_FLOAT, err_msg=f"{tag} peaks")
        np.testing.assert_allclose(sc, st, rtol=0, atol=TOL_FLOAT, err_msg=f"{tag} pair scores")
        max_err = max(max_err, float(np.nanmax(np.abs(pk - pt))), float(np.abs(sc - st).max()))
        n = np.minimum(res.peaks[:, 0, 0].astype(int), res.peaks.shape[1] - 1)
        for p in range(18):
            check(np.isfinite(res.peaks[p, 1 : n[p] + 1]).all(), f"{tag} non-finite peak")
        check(np.isfinite(res.joints).all(), f"{tag} non-finite joints")
        total_peaks += int(res.peaks[:, 0, 0].sum())
    people = [r.num_people for r in results]
    print(f"{tag} {n_frames} frames: device {dev_ms:.3f} ms/frame (CUDA events, median), "
          f"end-to-end {e2e_ms:.3f} ms/frame (host clock), peak-mask launches {launches} "
          f"for {passes} passes, peaks {total_peaks}, people {people}, "
          f"max |kernel path - plain path| {max_err:.3g}")
    check(total_peaks > 0, f"{tag} no peaks at all")
    return dict(device_ms=dev_ms, e2e_ms=e2e_ms, launches=launches, peaks=total_peaks,
                people=people)


def main() -> int:
    import torch

    info = phase_device()
    check(info["nvidia_smi"], "nvidia-smi gave no name and power limit")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    t = phase_kernels()
    one = phase_slice(1, 8)
    three = phase_slice(3, 4)
    for name, r in (("1-scale", one), ("3-scale", three)):
        print(json.dumps({"slice": name, **{k: r[k] for k in
                                            ("device_ms", "e2e_ms", "launches", "peaks", "people")}}))
    print(json.dumps({"kernels": [{
        "name": "peak_mask_fused",
        "route": "cuda",
        "source": "caffe_rtpose_tpu_torch/csrc/peak_mask.cu",
        "replaces": "caffe_rtpose_tpu/ops/nms_pallas.py:136",
        "also_replaces": "caffe_rtpose_tpu/ops/nms_pallas.py:197",
        "launches": one["launches"],
        "max_abs_err": t["max_abs_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
    }]}))
    print(info["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
