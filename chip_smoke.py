#!/usr/bin/env python3
"""Smoke test of the PyTorch port (caffe_rtpose_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:

1. device    - the card's name and power limit (nvidia-smi), torch/CUDA
               versions and the nvcc path; refuses to run without CUDA.
2. build     - builds the CUDA kernels from csrc/ with nvcc.
3. kernels   - each hand-written kernel against its plain PyTorch version on
               the card, at the estimators' shapes (COCO 1 and 3 scales, MPI,
               small and ragged), with both timed at the COCO 1-scale and
               3-scale (gap 0.3) shapes (medians of 20, in the order plain,
               kernel, kernel, plain):
               * peak_mask_fused: masks equal except at near-ties;
               * upsample_peak_keys (57 channels, keys for 18; MPI 44 and
                 15): heat within 1e-5*max(1,|U|), keys equal except at
                 near-ties.
               A near-tie is a pixel where |U-thr| or |U-max8| <=
               1e-5*max(1,|U|), with U the plain version's upsample there.
4. slice     - the full-width COCO estimator (656x368, 1 scale, u8 input,
               pair_cap=32, f32) over 8 synthetic frames through
               estimate_from_net_input, with the peak-mask kernel's launch
               count read around that run; its packed outputs against the
               same estimator with the plain peak mask; device and
               end-to-end ms/frame.  Then once more at 3 scales.
5. heatmap   - the full-width COCO estimator with keep_heatmap=True (656x368,
               1 scale, f32 input: the 1-scale slice's first 4 canvases,
               normalised and masked on the host, with its weights) through
               estimate_from_net_input, with the upsample kernel's launch
               count read around that run (the peak-mask kernel must not
               launch); its outputs against the same estimator with the
               plain version, and against the packed realtime estimator
               (u8 input, no pair_cap) on the same frames.  Device and
               end-to-end ms/frame, and the heatmap fetch's ms alone.
6. render    - the views the rtpose demo dispatches (pose, part 1, all
               parts, accumulated PAFs, one PAF pair) from the heatmap run's
               last frame, on the card, on a 656x368 canvas: shape, finite
               values and ms of each.

Weights are seeded numpy at fan-in scale.  In each realtime slice run the
part-heatmap head's bias is set from that run's frames so that 0.05% of the
scale-averaged full-res part-map pixels clear the NMS threshold, as a
trained model's maps give a few peaks per person (random maps would put
hundreds of peaks in every part).

The last three lines are: a JSON object with one entry per kernel, the
card's name and power limit as nvidia-smi prints them, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np

TOL_NEAR_TIE = 1e-5
TOL_FLOAT = 1e-4
TOL_HEAT = 1e-5  # relative to max(1, |U|): two f32 sums of the same taps
TOL_BRANCH_PEAKS = 1e-3  # heatmap vs packed branch, as tests/test_optimized_path.py
TOL_BRANCH_SCORES = 5e-3
HEAT_FRAC = 5e-4  # share of full-res part-map pixels above the NMS threshold
HEATMAP_FRAMES = 4


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


def keys_to_mask(keys, th, tw):
    """(K, th*(tw//2)) pair-layout peak keys -> (K, th, tw) bool mask."""
    import torch

    hw = th * tw
    mask = torch.zeros(keys.shape[0] * hw, dtype=torch.bool, device=keys.device)
    nz = keys > 0
    chan = torch.arange(keys.shape[0], device=keys.device)[:, None].expand_as(keys)[nz]
    mask[chan * hw + (hw - keys[nz].long())] = True
    return mask.reshape(keys.shape[0], th, tw)


def time_pair(plain, kernel):
    """Medians of 20 in the order plain, kernel, kernel, plain -> the four."""
    ms_p = cuda_ms(plain)
    ms_k = cuda_ms(kernel)
    ms_k2 = cuda_ms(kernel)
    ms_p2 = cuda_ms(plain)
    return ms_p, ms_k, ms_k2, ms_p2


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
            ms_p, ms_k, ms_k2, ms_p2 = time_pair(
                lambda: nms_cuda.peak_mask_fused_reference(*args),
                lambda: nms_cuda.peak_mask_fused(*args))
            print(f"[kernels] {name} median of 20 (plain, kernel, kernel, plain): "
                  f"{ms_p:.4f} {ms_k:.4f} {ms_k2:.4f} {ms_p2:.4f} ms")
        if name == "coco_1scale":
            max_err = float((got.to(torch.int8) - ref.to(torch.int8)).abs().max())
            timing = dict(ms=min(ms_k, ms_k2), plain_ms=min(ms_p, ms_p2), max_abs_err=max_err)
    return timing


def phase_upsample_keys(device="cuda"):
    import torch

    from caffe_rtpose_tpu_torch.ops import nms_cuda

    dev = torch.device(device)
    cases = [  # name, S, start, gap, h, w, factor, C, key channels
        ("coco_1scale", 1, 1.0, 0.3, 46, 82, 8, 57, 18),
        ("coco_3scale_gap0.3", 3, 1.0, 0.3, 46, 82, 8, 57, 18),
        ("mpi_3scale", 3, 0.9, 0.1, 46, 82, 8, 44, 15),
        ("small", 1, 1.0, 0.3, 12, 16, 8, 7, 7),
        ("small_3scale", 3, 0.9, 0.1, 12, 16, 8, 7, 7),
        ("ragged", 1, 1.0, 0.3, 13, 17, 8, 8, 5),
        ("ragged_3scale", 3, 0.9, 0.1, 13, 17, 8, 8, 5),
    ]
    thr = 0.05
    timing = None
    for i, (name, s, start, gap, h, w, f, c, kc) in enumerate(cases):
        rs = np.random.RandomState(200 + i)
        low = torch.from_numpy(rs.rand(s, h, w, c).astype(np.float32) * 2 - 1).to(dev)
        th, tw = h * f, w * f
        heat, keys = nms_cuda.upsample_peak_keys(low, (th, tw), start, gap, thr, key_channels=kc)
        torch.cuda.synchronize()
        r_heat, r_keys = nms_cuda.upsample_peak_keys_reference(low, (th, tw), start, gap, thr, kc)
        check(heat.shape == r_heat.shape == (c, th, tw) and keys.shape == r_keys.shape
              == (kc, th * (tw // 2)) and keys.dtype == torch.int32, f"{name}: output shapes")
        err = (heat - r_heat).abs()
        max_err = float(err.max())
        heat_ok = bool((err <= TOL_HEAT * r_heat.abs().clamp_min(1.0)).all())
        got_m, ref_m = keys_to_mask(keys, th, tw), keys_to_mask(r_keys, th, tw)
        n_diff, n_bad = near_tie_violations(got_m, ref_m, r_heat[:kc], thr)
        n_slots = int((keys != r_keys).sum())
        print(f"[kernels] upsample_peak_keys {name}: S={s} {h}x{w}->{th}x{tw} C={c} keys for "
              f"{kc}: max |heat - plain| {max_err:.3g}, {int(ref_m.sum())} peaks, {n_slots} key "
              f"slots and {n_diff} peak pixels differ, {n_bad} of them no near-tie")
        check(heat_ok, f"upsample kernel's heat disagrees with the plain version at {name}")
        check(n_bad == 0, f"upsample kernel's keys disagree with the plain version at {name}")
        check(int(ref_m.sum()) > 0, f"{name}: no peaks, the comparison is vacuous")
        if name in ("coco_1scale", "coco_3scale_gap0.3"):
            args = (low, (th, tw), start, gap, thr, kc)
            ms_p, ms_k, ms_k2, ms_p2 = time_pair(
                lambda: nms_cuda.upsample_peak_keys_reference(*args),
                lambda: nms_cuda.upsample_peak_keys(*args))
            print(f"[kernels] upsample_peak_keys {name} median of 20 (plain, kernel, kernel, "
                  f"plain): {ms_p:.4f} {ms_k:.4f} {ms_k2:.4f} {ms_p2:.4f} ms")
        if name == "coco_1scale":
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
                people=people, weights=weights, frames=frames)


def real_pairs(desc, peaks):
    """(L, M, M) bool: the pairs of real peaks ([:na, :nb] of each limb)."""
    m = peaks.shape[1] - 1
    n = np.minimum(peaks[:, 0, 0].astype(int), m)
    out = np.zeros((desc.num_limbs, m, m), bool)
    for k in range(desc.num_limbs):
        a, b = desc.limb(k)
        out[k, : n[a], : n[b]] = True
    return out


def pair_dots(heat, peaks, desc, k, i, j):
    """The 10 sample dots of candidate pair (i, j) of limb k on the full-res
    maps, computed as connect.score_pairs does (C rounding, clamps)."""
    _, h, w = heat.shape
    a, b = desc.limb(k)
    cx, cy = desc.paf_channels(k)
    ax, ay = peaks[a, i + 1, :2]
    dx, dy = peaks[b, j + 1, :2] - peaks[a, i + 1, :2]
    norm = np.sqrt(dx * dx + dy * dy)
    vx, vy = (dx / norm, dy / norm) if norm >= 1e-6 else (0.0, 0.0)
    lm = np.arange(10, dtype=np.float32)
    sx = np.clip(np.floor(ax + lm * dx / 10 + 0.5).astype(int), 0, w - 1)
    sy = np.clip(np.floor(ay + lm * dy / 10 + 0.5).astype(int), 0, h - 1)
    return vx * heat[cx, sy, sx] + vy * heat[cy, sy, sx]


def count_near_ties(tag, c1, c2, real, heat, peaks, desc, thr):
    """Pair counts over the real peaks may differ only where one of the
    pair's 10 samples has a dot within TOL_NEAR_TIE of inter_threshold (the
    two sides sample heat maps that differ by f32 rounding).  Returns the
    number of differing counts; raises if one of them is no such near-tie."""
    diff = np.argwhere((c1 != c2) & real)
    for k, i, j in diff:
        dots = pair_dots(heat, peaks, desc, k, i, j)
        check(np.abs(dots - thr).min() <= TOL_NEAR_TIE,
              f"{tag} pair count of limb {k} ({i}, {j}) differs, no near-tie")
    return len(diff)


def phase_heatmap(weights, canvases_u8, device="cuda", net_resolution=(656, 368), stages=6):
    import torch

    from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
    from caffe_rtpose_tpu_torch.ops import nms_cuda
    from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator
    from caffe_rtpose_tpu_torch.pose.preprocess import region_boxes

    tag = "[heatmap]"
    res = net_resolution
    cfg = dict(net_resolution=res, num_scales=1, dtype=torch.float32, device=device)
    proto = make_pose_deploy_net("COCO", stages=stages)
    est = PoseEstimator(proto, weights=weights, keep_heatmap=True, peak_kernel=True, **cfg)
    twin = PoseEstimator(proto, weights=weights, keep_heatmap=True, peak_kernel=False, **cfg)
    packed = PoseEstimator(proto, weights=weights, input_u8=True, peak_kernel=True, **cfg)
    # the realtime estimator's normalisation, on the host: u8/256 - 0.5 in
    # the image region, 0 in the padding
    mask = np.zeros((1, res[1], res[0], 1), np.float32)
    for y0, y1, x0, x1 in region_boxes(res[0], res[1], 1, 1.0, 0.3):
        mask[0, y0:y1, x0:x1] = 1.0
    inputs = [np.ascontiguousarray(((u8.astype(np.float32) / 256.0 - 0.5) * mask)
                                   .transpose(0, 3, 1, 2)) for u8 in canvases_u8]
    check(est.input_shape() == inputs[0].shape and not est.input_u8, f"{tag} input format")

    est.estimate_from_net_input(inputs[0])  # warm-up
    torch.cuda.synchronize()
    nms_cuda.launches = 0
    nms_cuda.upsample_launches = 0
    t0 = time.perf_counter()
    results = [est.estimate_from_net_input(x) for x in inputs]
    e2e_ms = (time.perf_counter() - t0) * 1000.0 / len(inputs)
    launches, mask_launches = nms_cuda.upsample_launches, nms_cuda.launches
    check(launches == len(inputs),
          f"{tag} upsample kernel launched {launches} times for {len(inputs)} device passes")
    check(mask_launches == 0, f"{tag} the peak-mask kernel launched {mask_launches} times")

    dev_ms = cuda_ms(lambda: est.run_device(inputs[1]), reps=len(inputs))
    fetch = []
    for x in inputs:
        out = est.run_device(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out["heatmap"].cpu()
        fetch.append((time.perf_counter() - t1) * 1000.0)
    fetch_ms = statistics.median(fetch)

    desc, thr = est.descriptor, est.params_connect.inter_threshold
    max_err, max_heat_err, n_ties_plain, n_ties_packed, total_peaks = 0.0, 0.0, 0, 0, 0
    for u8, x, r in zip(canvases_u8, inputs, results):
        o_k, o_p = est.run_device(x), twin.run_device(x)
        (pk, sk, ck), (pp, sp, cp) = est.fetch(o_k), twin.fetch(o_p)
        hk, hp = o_k["heatmap"].cpu().numpy(), o_p["heatmap"].cpu().numpy()
        check(pk.shape == (18, 65, 3) and sk.shape == ck.shape == (19, 64, 64)
              and hk.shape == (57, *est.target_hw), f"{tag} shapes")
        check(r.heatmap is not None and r.heatmap.shape == hk.shape, f"{tag} PoseResult.heatmap")
        check(np.isfinite(hk).all() and np.isfinite(r.heatmap).all(), f"{tag} non-finite heat")
        herr = np.abs(hk - hp)
        check((herr <= TOL_HEAT * np.maximum(1.0, np.abs(hp))).all(), f"{tag} heat vs plain")
        max_heat_err = max(max_heat_err, float(herr.max()))
        real = real_pairs(desc, pp)
        # kernel vs plain version of the same branch
        np.testing.assert_array_equal(pk[:, 0, 0], pp[:, 0, 0], err_msg=f"{tag} peak counts")
        np.testing.assert_allclose(pk, pp, rtol=0, atol=TOL_FLOAT, err_msg=f"{tag} peaks")
        np.testing.assert_allclose(sk[real], sp[real], rtol=TOL_FLOAT, atol=TOL_FLOAT,
                                   err_msg=f"{tag} pair scores")
        n_ties_plain += count_near_ties(f"{tag} vs plain:", ck, cp, real, hp, pp, desc, thr)
        max_err = max(max_err, float(np.nanmax(np.abs(pk - pp))),
                      float(np.abs(sk[real] - sp[real]).max(initial=0.0)))
        # against the packed realtime branch on the same frame
        p1, s1, c1 = packed.fetch(packed.run_device(u8))
        np.testing.assert_array_equal(p1[:, 0, 0], pk[:, 0, 0], err_msg=f"{tag} packed counts")
        np.testing.assert_allclose(p1, pk, rtol=0, atol=TOL_BRANCH_PEAKS,
                                   err_msg=f"{tag} packed peaks")
        real = real_pairs(desc, pk)
        np.testing.assert_allclose(s1[real], sk[real], rtol=TOL_BRANCH_SCORES,
                                   atol=TOL_BRANCH_SCORES, err_msg=f"{tag} packed scores")
        n_ties_packed += count_near_ties(f"{tag} vs packed:", c1, ck, real, hk, pk, desc, thr)
        check(np.isfinite(r.joints).all(), f"{tag} non-finite joints")
        total_peaks += int(r.peaks[:, 0, 0].sum())
    people = [r.num_people for r in results]
    print(f"{tag} {len(inputs)} frames: device {dev_ms:.3f} ms/frame (CUDA events, median), "
          f"end-to-end {e2e_ms:.3f} ms/frame (host clock, heatmap fetch included), heatmap "
          f"fetch {fetch_ms:.3f} ms (median), upsample launches {launches} for {len(inputs)} "
          f"passes, peak-mask launches {mask_launches}, peaks {total_peaks}, people {people}, "
          f"max |kernel - plain| heat {max_heat_err:.3g}, peaks/scores {max_err:.3g}; pair "
          f"counts differing at near-ties: {n_ties_plain} vs plain, {n_ties_packed} vs packed")
    check(total_peaks > 0, f"{tag} no peaks at all")
    return dict(device_ms=dev_ms, e2e_ms=e2e_ms, fetch_ms=fetch_ms, launches=launches,
                peaks=total_peaks, people=people, canvas=canvases_u8[-1][0],
                result=results[-1])


def phase_render(canvas_u8, result, device="cuda"):
    """The views runner._render dispatches for COCO, from one frame."""
    import torch

    from caffe_rtpose_tpu_torch.pose import render as R
    from caffe_rtpose_tpu_torch.pose.descriptor import RENDER_MAX_PEOPLE

    P = 18
    canvas = torch.from_numpy(canvas_u8.astype(np.float32)).to(device)
    maps = torch.from_numpy(result.heatmap).to(device)
    poses = np.zeros((RENDER_MAX_PEOPLE, P, 3), np.float32)
    n = min(result.num_people, RENDER_MAX_PEOPLE)
    poses[:n] = result.joints[:n]
    poses = torch.from_numpy(poses).to(device)
    views = {
        "pose (0)": lambda: R.render_pose(canvas, poses, n, num_parts=P),
        "part 1": lambda: R.render_heatmap(canvas, maps, 0, num_parts=P),
        "all parts (19)": lambda: R.render_all_parts(canvas, maps, num_parts=P),
        "accumulated PAFs (20)": lambda: R.render_paf(canvas, maps, P + 1, num_parts_accum=P + 1),
        "PAF pair (21)": lambda: R.render_paf(canvas, maps, P + 1),
    }
    times = {}
    for name, fn in views.items():
        out = fn()
        torch.cuda.synchronize()
        check(out.shape == canvas.shape and out.device == canvas.device, f"[render] {name} shape")
        check(bool(torch.isfinite(out).all()), f"[render] {name} non-finite")
        times[name] = cuda_ms(fn, reps=10)
    print(f"[render] {canvas.shape[1]}x{canvas.shape[0]} canvas, {n} people, ms (CUDA events, median of 10): "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    return times


def main() -> int:
    import torch

    info = phase_device()
    check(info["nvidia_smi"], "nvidia-smi gave no name and power limit")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    t_mask = phase_kernels()
    t_up = phase_upsample_keys()
    one = phase_slice(1, 8)
    three = phase_slice(3, 4)
    heat = phase_heatmap(one["weights"], one["frames"][:HEATMAP_FRAMES])
    render = phase_render(heat["canvas"], heat["result"])
    keys = ("device_ms", "e2e_ms", "launches", "peaks", "people")
    for name, r in (("1-scale", one), ("3-scale", three)):
        print(json.dumps({"slice": name, **{k: r[k] for k in keys}}))
    print(json.dumps({"slice": "heatmap", "fetch_ms": heat["fetch_ms"],
                      **{k: heat[k] for k in keys}}))
    print(json.dumps({"render_ms": render}))
    print(json.dumps({"kernels": [{
        "name": "peak_mask_fused",
        "route": "cuda",
        "source": "caffe_rtpose_tpu_torch/csrc/peak_mask.cu",
        "replaces": "caffe_rtpose_tpu/ops/nms_pallas.py:136",
        "also_replaces": "caffe_rtpose_tpu/ops/nms_pallas.py:197",
        "launches": one["launches"],
        **t_mask,
    }, {
        "name": "upsample_peak_keys",
        "route": "cuda",
        "source": "caffe_rtpose_tpu_torch/csrc/upsample_peak_keys.cu",
        "replaces": "caffe_rtpose_tpu/ops/nms_pallas.py:82",
        "launches": heat["launches"],
        **t_up,
    }]}))
    print(info["nvidia_smi"])
    # one card drives every phase
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
