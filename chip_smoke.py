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
7. conv1     - the fused conv1 block kernel (bf16) against its plain version
               at COCO 656x368 with B*S = 1, 3 and 8 and at (2, 64, 96) and
               (3, 48, 64), within two bf16 ulps (2^-7 relative, 2^-13
               absolute), and against the cuDNN bf16 chain (largest
               difference printed); timed at B = 1 and 8 (plain, kernel,
               kernel, plain, medians of 20) beside the cuDNN bf16 chain.
8. bf16      - bench.py's configuration: bf16, u8, 1 scale, pair_cap=32,
               batch=8, 16 frames through run_device + fetch_batch (with the
               overflow refetch) and through estimate_from_net_input, with
               the conv1 kernel's launches (one per device pass) and the
               peak-mask kernel's (one per frame row) read around each run.
               Against the same estimator with conv1_kernel=False and
               peak_kernel=False, and against the f32 estimator on the same
               frames: the low-res maps' relative L2 distances, and the
               share of the other side's peaks reproduced within the
               project's joint budget (a peak within 1 px and 0.01 score,
               or none where the other side's score is within 0.01 of the
               threshold), which must reach MATCH_FLOOR.  Device ms/frame (whole pass and CNN
               alone) and end-to-end ms/frame.  Then the 3-scale quality
               mode with pack_u8 in bf16 (launch counts; packed outputs
               bit-identical to the canvas upload) and the heatmap branch in
               bf16 (upsample and conv1 kernel launch counts; against its
               plain twin).

Weights are seeded numpy at fan-in scale.  In each realtime slice run the
part-heatmap head's bias is set from that run's frames so that 0.05% of the
scale-averaged full-res part-map pixels clear the NMS threshold, as a
trained model's maps give a few peaks per person (random maps would put
hundreds of peaks in every part).

The bf16 phases reuse the 1-scale f32 slice's weights and frames.

The last three lines are: a JSON object with one entry per kernel, the
card's name and power limit as nvidia-smi prints them, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import re
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
TOL_CONV1_REL = 2.0 ** -7  # two bf16 ulps, as tests/test_torch_conv1.py
TOL_CONV1_ABS = 2.0 ** -13
BF16_FRAMES = 16
BF16_BATCH = 8  # bench.py's batch
MATCH_PX = 1.0  # the project's joint budget: 1 px, 0.01 confidence
MATCH_SCORE = 0.01
# share of the other side's peaks reproduced within that budget (match_share);
# measured 0.860 against f32 and 0.897 against the plain path at COCO 656x368
# (H100 80GB HBM3, 700.00 W), and never set under 0.80
MATCH_FLOOR = 0.80
L2_RATIO = 1.5  # kernel-path vs plain-path distance, against bf16 vs f32
CONV1_CASES = [("coco_b1", 1, 368, 656), ("coco_b3", 3, 368, 656), ("coco_b8", 8, 368, 656),
               ("small_b2", 2, 64, 96), ("small_b3", 3, 48, 64)]  # name, B*S, H, W


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
    kernel = "?"
    for line in _build.build_log.get("crt_kernels", "").splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(conv1_block|upsample_peak_keys|peak_mask)_kernel", line)
            kernel = m.group(0) if m else "?"
        elif "registers" in line or "spill" in line or "smem" in line:
            print(f"[build] {kernel}: {line.replace('ptxas info    :', '').strip()}")
    lib = _build.load_kernels()
    print(f"[build] conv1_block: {lib.crt_conv1_smem_bytes()} B of dynamic shared memory a "
          f"block; peak_mask/upsample_peak_keys at low-res width 82: "
          f"{lib.crt_tile_smem_bytes(82)} B")
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
            low = est.net({"image": x}, outputs=[heat_layer])[heat_layer][:, :P].float()
            u = imresize_average(low.permute(0, 2, 3, 1), th, tw, est.start_scale, est.scale_gap)
        maps.append(u.reshape(-1, P))
    u = torch.cat(maps)
    q = u.kthvalue(int(u.shape[0] * (1.0 - frac)), dim=0).values
    bias = weights[heat_layer][1].copy()
    bias[:P] += est.params_connect.nms_threshold - q.cpu().numpy()
    weights[heat_layer] = [weights[heat_layer][0], bias]
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


def conv1_inputs(b, h, w, seed, device):
    """(B, 3, H, W) bf16 channels_last input and packed conv1 weights, in the
    draws of tests/test_torch_conv1.py."""
    import torch

    from caffe_rtpose_tpu_torch.ops.conv1_cuda import Conv1Weights

    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.rand(b, 3, h, w).astype(np.float32) - 0.5).to(device, torch.bfloat16)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    cw = Conv1Weights.pack(t(rs.randn(64, 3, 3, 3) * 0.1), t(rs.randn(64) * 0.1),
                           t(rs.randn(64, 64, 3, 3) * 0.05), t(rs.randn(64) * 0.1))
    return x.contiguous(memory_format=torch.channels_last), cw


def cudnn_chain(cw):
    """The unfused bf16 chain as the net runs it layer by layer (bf16
    operands made once), as a function of x."""
    import torch
    import torch.nn.functional as F

    bf = torch.bfloat16
    w1, b1, w2, b2 = (t.to(bf) for t in (cw.w1, cw.b1, cw.w2, cw.b2))
    w1, w2 = (w.contiguous(memory_format=torch.channels_last) for w in (w1, w2))

    def run(x):
        h = F.conv2d(x, w1, b1, padding=1).relu_()
        return F.max_pool2d(F.conv2d(h, w2, b2, padding=1).relu_(), 2, 2)

    return run


def phase_conv1(device="cuda"):
    import torch

    from caffe_rtpose_tpu_torch.ops import conv1_cuda

    timing = {}
    for i, (name, b, h, w) in enumerate(CONV1_CASES):
        x, cw = conv1_inputs(b, h, w, 300 + i, device)
        chain = cudnn_chain(cw)
        got = conv1_cuda.conv1_block(x, cw)
        torch.cuda.synchronize()
        ref = conv1_cuda.conv1_block_reference(x, cw)
        check(tuple(got.shape) == (b, 64, h // 2, w // 2) and got.dtype == torch.bfloat16
              and got.is_contiguous(memory_format=torch.channels_last), f"[conv1] {name}: output")
        a, r = got.float(), ref.float()
        err = (a - r).abs()
        tol = torch.clamp_min(torch.maximum(a.abs(), r.abs()) * TOL_CONV1_REL, TOL_CONV1_ABS)
        n_bad = int((err > tol).sum())
        err_c = float((a - chain(x).float()).abs().max())
        frac = float((r > 0).float().mean())
        print(f"[conv1] {name}: ({b}, 3, {h}, {w}) -> ({b}, 64, {h // 2}, {w // 2}): max |kernel - "
              f"plain| {float(err.max()):.4g}, {n_bad} beyond two bf16 ulps; max |kernel - cuDNN "
              f"bf16 chain| {err_c:.4g}; {frac:.3f} of outputs > 0")
        check(n_bad == 0, f"[conv1] kernel disagrees with the plain version at {name}")
        check(frac > 0.2, f"[conv1] {name}: too few non-zero outputs, the comparison is vacuous")
        if name in ("coco_b1", "coco_b8"):
            ms_p, ms_k, ms_k2, ms_p2 = time_pair(lambda: conv1_cuda.conv1_block_reference(x, cw),
                                                 lambda: conv1_cuda.conv1_block(x, cw))
            ms_c = cuda_ms(lambda: chain(x))
            print(f"[conv1] {name} median of 20 (plain, kernel, kernel, plain; cuDNN bf16 chain): "
                  f"{ms_p:.4f} {ms_k:.4f} {ms_k2:.4f} {ms_p2:.4f}; {ms_c:.4f} ms")
            sfx = "" if name == "coco_b1" else "_b8"
            timing.update({f"ms{sfx}": min(ms_k, ms_k2), f"plain_ms{sfx}": min(ms_p, ms_p2),
                           f"cudnn_ms{sfx}": ms_c})
            if name == "coco_b1":
                timing["max_abs_err"] = float(err.max())
    return timing


def match_share(ref_peaks, peaks, thr):
    """How many of the peaks in ``ref_peaks`` (a list of (P, M+1, 3) arrays)
    ``peaks`` reproduces within the joint budget: a peak of the same part
    within MATCH_PX and MATCH_SCORE, or none where the reference peak's
    score is within MATCH_SCORE of the threshold ``thr`` (a change within
    the budget may take it under).  Returns (share, reference peaks, share
    within MATCH_PX alone, peaks counted by the threshold rule, share
    without that rule)."""
    hit = hit_px = near = total = 0
    for a, b in zip(ref_peaks, peaks):
        for p in range(a.shape[0]):
            na = min(int(a[p, 0, 0]), a.shape[1] - 1)
            nb = min(int(b[p, 0, 0]), b.shape[1] - 1)
            if na == 0:
                continue
            pa, pb = a[p, 1 : na + 1], b[p, 1 : nb + 1]
            total += na
            d = np.hypot(pa[:, None, 0] - pb[None, :, 0], pa[:, None, 1] - pb[None, :, 1])
            ok = ((d <= MATCH_PX) & (np.abs(pa[:, None, 2] - pb[None, :, 2]) <= MATCH_SCORE)).any(1)
            low = ~ok & (pa[:, 2] <= thr + MATCH_SCORE)
            hit += int(ok.sum())
            near += int(low.sum())
            hit_px += int((d <= MATCH_PX).any(1).sum())
    f = (lambda n: n / total) if total else (lambda n: 0.0)  # noqa: E731
    return f(hit + near), total, f(hit_px), near, f(hit)


def run_batched(est, batches):
    """The batched realtime loop: run_device + fetch_batch per batch, the
    uncapped refetch for an overflowed frame, host assembly -> per frame
    (peaks, num_people, joints)."""
    from caffe_rtpose_tpu_torch.pose import connect as C

    out = []
    for xs in batches:
        for x, (pk, sc, ct) in zip(xs, est.fetch_batch(est.run_device(xs))):
            if est.overflowed(pk):
                pk, sc, ct = est.refetch_full(x)
            r = C.assemble_fast(pk, sc, ct, est.descriptor, est.params_connect)
            out.append((pk, r.num_people, r.joints))
    return out


def lowres_maps(est, x_host):
    """The estimator's (F, S, h, w, C) f32 low-res maps of uploaded frames."""
    import torch

    with torch.inference_mode():
        return est._lowres(est._canvases(torch.from_numpy(x_host).to(est.device)))


def rel_l2(a, b):
    import torch

    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def phase_bf16(weights, device="cuda", net_resolution=(656, 368), stages=6,
               n_frames=BF16_FRAMES, batch=BF16_BATCH):
    import torch

    from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
    from caffe_rtpose_tpu_torch.ops import conv1_cuda, nms_cuda
    from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator

    tag = f"[bf16 batch {batch}]"
    proto = make_pose_deploy_net("COCO", stages=stages)
    cfg = dict(net_resolution=net_resolution, num_scales=1, input_u8=True, pair_cap=32,
               device=device)
    f32 = PoseEstimator(proto, weights=weights, **cfg)
    # the first 8 are the f32 slice's frames, on which its weights were set
    frames = canvases(np.random.RandomState(0), n_frames, f32.input_shape())
    est = PoseEstimator(proto, weights=weights, dtype=torch.bfloat16, batch=batch, **cfg)
    twin = PoseEstimator(proto, weights=weights, dtype=torch.bfloat16, batch=batch,
                         conv1_kernel=False, peak_kernel=False, **cfg)
    check(est.net.conv1_kernel and est.peak_kernel and list(est.net.conv1_blocks) == ["conv1_1"]
          and not twin.net.conv1_kernel, f"{tag} kernel switches")
    batches = [np.stack(frames[i : i + batch]) for i in range(0, n_frames, batch)]

    est.fetch_batch(est.run_device(batches[0]))  # warm-up (cuDNN autotune, allocator)
    torch.cuda.synchronize()
    conv1_cuda.launches = nms_cuda.launches = 0
    refetch0 = est._overflow_refetches
    t0 = time.perf_counter()
    results = run_batched(est, batches)
    e2e_ms = (time.perf_counter() - t0) * 1000.0 / n_frames
    k4, k1 = conv1_cuda.launches, nms_cuda.launches
    refetches = est._overflow_refetches - refetch0
    passes = len(batches) + refetches
    check(k4 == passes, f"{tag} conv1 kernel launched {k4} times for {passes} device passes")
    check(k1 == n_frames + refetches,
          f"{tag} peak-mask kernel launched {k1} times for {n_frames + refetches} frames")

    conv1_cuda.launches = nms_cuda.launches = 0
    refetch0 = est._overflow_refetches
    t0 = time.perf_counter()
    single = [est.estimate_from_net_input(f) for f in frames]
    e2e_one_ms = (time.perf_counter() - t0) * 1000.0 / n_frames
    refetches1 = est._overflow_refetches - refetch0
    k4_one, k1_one = conv1_cuda.launches, nms_cuda.launches
    check(k4_one == n_frames + refetches1, f"{tag} estimate_from_net_input: conv1 kernel "
          f"launched {k4_one} times for {n_frames + refetches1} passes")
    check(k1_one == batch * n_frames + refetches1, f"{tag} estimate_from_net_input: peak-mask "
          f"kernel launched {k1_one} times for {batch * n_frames + refetches1} frame rows")
    same = sum(np.array_equal(a.peaks, b[0], equal_nan=True) for a, b in zip(single, results))

    xd = torch.from_numpy(batches[0]).to(device)
    dev_ms = cuda_ms(lambda: est.run_device(batches[0]), reps=10) / batch
    cnn_ms = cuda_ms(lambda: est._lowres(est._canvases(xd)), reps=10) / batch
    x1 = torch.from_numpy(batches[0][:1]).to(device)
    cnn_f32_ms = cuda_ms(lambda: f32._lowres(f32._canvases(x1)), reps=10)
    dev_f32_ms = cuda_ms(lambda: f32.run_device(frames[0]), reps=10)

    twin_res = run_batched(twin, batches)
    f32_peaks = [f32.estimate_from_net_input(f).peaks for f in frames]
    peaks = [r[0] for r in results]
    thr = est.params_connect.nms_threshold
    share_twin, n_twin, px_twin, near_twin, strict_twin = match_share(
        [r[0] for r in twin_res], peaks, thr)
    share_f32, n_f32, px_f32, near_f32, strict_f32 = match_share(f32_peaks, peaks, thr)
    low_k = torch.cat([lowres_maps(est, b) for b in batches])
    low_p = torch.cat([lowres_maps(twin, b) for b in batches])
    low_f = torch.cat([lowres_maps(f32, f[None]) for f in frames])
    d_twin, d_f32, d_twin_f32 = rel_l2(low_k, low_p), rel_l2(low_k, low_f), rel_l2(low_p, low_f)
    total = 0
    for pk, people, joints in results:
        n = np.minimum(pk[:, 0, 0].astype(int), pk.shape[1] - 1)
        for p in range(pk.shape[0]):
            check(np.isfinite(pk[p, 1 : n[p] + 1]).all(), f"{tag} non-finite peak")
        check(np.isfinite(joints).all(), f"{tag} non-finite joints")
        total += int(pk[:, 0, 0].sum())
    people = [r[1] for r in results]
    print(f"{tag} {n_frames} frames: device {dev_ms:.3f} ms/frame (CUDA events, median of a "
          f"batch pass / {batch}), CNN alone {cnn_ms:.3f} ms/frame (f32 CNN {cnn_f32_ms:.3f} ms, "
          f"f32 pass {dev_f32_ms:.3f} ms/frame), end-to-end {e2e_ms:.3f} ms/frame through "
          f"run_device + fetch_batch, {e2e_one_ms:.3f} ms/frame through estimate_from_net_input "
          f"(one padded batch a frame); conv1 launches {k4} for {passes} passes and {k4_one} "
          f"for {n_frames + refetches1}; peak-mask launches {k1} and {k1_one}; overflow "
          f"refetches {refetches} and {refetches1}; frames with identical peaks on both "
          f"paths {same}/{n_frames}; peaks {total}, people {people}")
    print(f"{tag} low-res maps, relative L2: kernel path vs plain path {d_twin:.4g}, kernel path "
          f"vs f32 {d_f32:.4g}, plain path vs f32 {d_twin_f32:.4g}; peaks within {MATCH_PX:g} "
          f"px / {MATCH_SCORE:g}: {share_twin:.4f} of the plain path's {n_twin}, "
          f"{share_f32:.4f} of the f32 estimator's {n_f32} (within {MATCH_PX:g} px alone: "
          f"{px_twin:.4f}, {px_f32:.4f}); counted as matched for lying within {MATCH_SCORE:g} "
          f"of the threshold: {near_twin} and {near_f32}; the strict shares without them: "
          f"{strict_twin:.4f}, {strict_f32:.4f}")
    check(total > 0, f"{tag} no peaks at all")
    check(d_twin <= L2_RATIO * d_twin_f32, f"{tag} kernel path too far from the plain path")
    check(share_twin >= MATCH_FLOOR, f"{tag} {share_twin:.4f} of the plain path's peaks matched")
    check(share_f32 >= MATCH_FLOOR, f"{tag} {share_f32:.4f} of the f32 peaks matched")
    return dict(device_ms=dev_ms, cnn_ms=cnn_ms, cnn_f32_ms=cnn_f32_ms, f32_device_ms=dev_f32_ms,
                e2e_ms=e2e_ms, e2e_single_ms=e2e_one_ms, launches=k4, peak_mask_launches=k1,
                peaks=total, people=people, share_plain=share_twin, share_f32=share_f32,
                share_f32_strict=strict_f32, l2_plain=d_twin, l2_f32=d_f32, weights=weights,
                frames=frames)


def packed_frames(canvases_u8, regions):
    """(S, H, W, 3) canvases -> the flat live-region buffers of pack_u8."""
    return [np.concatenate([c[i, ph : ph + rh, pw : pw + rw].reshape(-1)
                            for i, (rh, rw, ph, pw, _) in enumerate(regions)])
            for c in canvases_u8]


def phase_bf16_3scale(weights, device="cuda", net_resolution=(656, 368), stages=6, n_frames=4):
    import torch

    from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
    from caffe_rtpose_tpu_torch.ops import conv1_cuda, nms_cuda
    from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator
    from caffe_rtpose_tpu_torch.pose.preprocess import region_boxes

    tag = "[bf16 3-scale pack_u8]"
    proto = make_pose_deploy_net("COCO", stages=stages)
    cfg = dict(net_resolution=net_resolution, num_scales=3, input_u8=True, pair_cap=32,
               dtype=torch.bfloat16, device=device)
    est = PoseEstimator(proto, weights=weights, **cfg)
    canvas = PoseEstimator(proto, weights=weights, pack_u8=False, **cfg)
    check(est.pack_u8 and not canvas.pack_u8, f"{tag} pack_u8 is the 3-scale u8 default")
    canv = canvases(np.random.RandomState(3), n_frames, canvas.input_shape())
    for c in canv:  # zero padding outside each scale's live region, as make_net_input_u8
        keep = np.zeros(c.shape[:3] + (1,), bool)
        for i, (y0, y1, x0, x1) in enumerate(region_boxes(*net_resolution, 3, 1.0, 0.3)):
            keep[i, y0:y1, x0:x1] = True
        c *= keep
    frames = packed_frames(canv, est._regions)
    check(frames[0].shape == est.input_shape(), f"{tag} packed input shape")
    weights = calibrate_heat_head(canvas, dict(weights), canv, HEAT_FRAC)
    est.net.load_weights(weights)
    canvas.net.load_weights(weights)

    est.estimate_from_net_input(frames[0])  # warm-up
    torch.cuda.synchronize()
    conv1_cuda.launches = nms_cuda.launches = 0
    refetch0 = est._overflow_refetches
    t0 = time.perf_counter()
    results = [est.estimate_from_net_input(f) for f in frames]
    e2e_ms = (time.perf_counter() - t0) * 1000.0 / n_frames
    passes = n_frames + est._overflow_refetches - refetch0
    k4, k1 = conv1_cuda.launches, nms_cuda.launches
    check(k4 == passes, f"{tag} conv1 kernel launched {k4} times for {passes} passes")
    check(k1 == passes, f"{tag} peak-mask kernel launched {k1} times for {passes} passes")
    dev_ms = cuda_ms(lambda: est.run_device(frames[1 % n_frames]), reps=n_frames)
    for f, c in zip(frames, canv):
        check(torch.equal(est.run_device(f)["packed"], canvas.run_device(c)["packed"]),
              f"{tag} packed upload differs from the canvas upload")
    total = sum(int(r.peaks[:, 0, 0].sum()) for r in results)
    check(all(np.isfinite(r.joints).all() for r in results), f"{tag} non-finite joints")
    print(f"{tag} {n_frames} frames: device {dev_ms:.3f} ms/frame (CUDA events, median), "
          f"end-to-end {e2e_ms:.3f} ms/frame, conv1 launches {k4} and peak-mask launches {k1} "
          f"for {passes} passes, packed outputs bit-identical to the canvas upload, "
          f"upload {frames[0].nbytes} B vs {canv[0].nbytes} B, peaks {total}, "
          f"people {[r.num_people for r in results]}")
    check(total > 0, f"{tag} no peaks at all")
    return dict(device_ms=dev_ms, e2e_ms=e2e_ms, launches=k4, peaks=total,
                people=[r.num_people for r in results])


def phase_bf16_heatmap(weights, canvases_u8, device="cuda", net_resolution=(656, 368), stages=6):
    import torch

    from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
    from caffe_rtpose_tpu_torch.ops import conv1_cuda, nms_cuda
    from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator
    from caffe_rtpose_tpu_torch.pose.preprocess import region_boxes

    tag = "[bf16 heatmap]"
    res = net_resolution
    cfg = dict(net_resolution=res, num_scales=1, dtype=torch.bfloat16, keep_heatmap=True,
               device=device)
    proto = make_pose_deploy_net("COCO", stages=stages)
    est = PoseEstimator(proto, weights=weights, **cfg)
    twin = PoseEstimator(proto, weights=weights, conv1_kernel=False, peak_kernel=False, **cfg)
    mask = np.zeros((1, res[1], res[0], 1), np.float32)
    for y0, y1, x0, x1 in region_boxes(res[0], res[1], 1, 1.0, 0.3):
        mask[0, y0:y1, x0:x1] = 1.0
    inputs = [np.ascontiguousarray(((u8.astype(np.float32) / 256.0 - 0.5) * mask)
                                   .transpose(0, 3, 1, 2)) for u8 in canvases_u8]
    est.estimate_from_net_input(inputs[0])  # warm-up
    torch.cuda.synchronize()
    conv1_cuda.launches = nms_cuda.launches = nms_cuda.upsample_launches = 0
    t0 = time.perf_counter()
    results = [est.estimate_from_net_input(x) for x in inputs]
    e2e_ms = (time.perf_counter() - t0) * 1000.0 / len(inputs)
    k4, k3, k1 = conv1_cuda.launches, nms_cuda.upsample_launches, nms_cuda.launches
    check(k4 == len(inputs), f"{tag} conv1 kernel launched {k4} times for {len(inputs)} passes")
    check(k3 == len(inputs), f"{tag} upsample kernel launched {k3} times for {len(inputs)} passes")
    check(k1 == 0, f"{tag} the peak-mask kernel launched {k1} times")
    dev_ms = cuda_ms(lambda: est.run_device(inputs[1 % len(inputs)]), reps=len(inputs))
    plain = [twin.estimate_from_net_input(x) for x in inputs]
    share, n_ref, _, _, _ = match_share([r.peaks for r in plain], [r.peaks for r in results],
                                        est.params_connect.nms_threshold)
    heat_d = max(float(np.abs(a.heatmap - b.heatmap).max()) for a, b in zip(results, plain))
    heat_amp = max(float(np.abs(b.heatmap).max()) for b in plain)
    for r in results:
        check(r.heatmap.shape == (57, *est.target_hw) and np.isfinite(r.heatmap).all()
              and np.isfinite(r.joints).all(), f"{tag} heatmap / joints")
    total = sum(int(r.peaks[:, 0, 0].sum()) for r in results)
    print(f"{tag} {len(inputs)} frames: device {dev_ms:.3f} ms/frame (CUDA events, median), "
          f"end-to-end {e2e_ms:.3f} ms/frame (heatmap fetch included), conv1 launches {k4}, "
          f"upsample launches {k3}, peak-mask launches {k1}; against the plain twin: max "
          f"|heat diff| {heat_d:.4g} (maps up to {heat_amp:.4g}), {share:.4f} of its {n_ref} "
          f"peaks matched within {MATCH_PX:g} px / {MATCH_SCORE:g}; peaks {total}, "
          f"people {[r.num_people for r in results]}")
    check(total > 0, f"{tag} no peaks at all")
    check(share >= MATCH_FLOOR, f"{tag} {share:.4f} of the plain twin's peaks matched")
    return dict(device_ms=dev_ms, e2e_ms=e2e_ms, launches=k4, upsample_launches=k3,
                peaks=total, people=[r.num_people for r in results], share_plain=share)


def main() -> int:
    import torch

    info = phase_device()
    check(info["nvidia_smi"], "nvidia-smi gave no name and power limit")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    t_mask = phase_kernels()
    t_up = phase_upsample_keys()
    t_conv1 = phase_conv1()
    one = phase_slice(1, 8)
    three = phase_slice(3, 4)
    heat = phase_heatmap(one["weights"], one["frames"][:HEATMAP_FRAMES])
    render = phase_render(heat["canvas"], heat["result"])
    bf16 = phase_bf16(one["weights"])
    bf16_three = phase_bf16_3scale(bf16["weights"])
    bf16_heat = phase_bf16_heatmap(bf16["weights"], bf16["frames"][:HEATMAP_FRAMES])
    keys = ("device_ms", "e2e_ms", "launches", "peaks", "people")
    for name, r in (("1-scale", one), ("3-scale", three)):
        print(json.dumps({"slice": name, **{k: r[k] for k in keys}}))
    print(json.dumps({"slice": "heatmap", "fetch_ms": heat["fetch_ms"],
                      **{k: heat[k] for k in keys}}))
    print(json.dumps({"render_ms": render}))
    print(json.dumps({"slice": "bf16 batch 8",
                      **{k: v for k, v in bf16.items() if k not in ("weights", "frames")}}))
    print(json.dumps({"slice": "bf16 3-scale pack_u8", **bf16_three}))
    print(json.dumps({"slice": "bf16 heatmap", **bf16_heat}))
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
    }, {
        "name": "conv1_block",
        "route": "cuda",
        "source": "caffe_rtpose_tpu_torch/csrc/conv1_block.cu",
        "replaces": "caffe_rtpose_tpu/ops/conv1_pallas.py:56",
        "launches": bf16["launches"],
        **t_conv1,
    }]}))
    print(info["nvidia_smi"])
    # one card drives every phase
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
