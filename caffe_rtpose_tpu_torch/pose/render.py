"""Skeleton / heatmap / PAF overlay rendering in PyTorch, on the device.

Counterpart of ``caffe_rtpose_tpu/pose/render.py``, which is pixel-parity
with the reference CUDA kernels (src/rtpose/renderFunctions.cu):

* :func:`render_pose` (COCO, render_pose_coco_parts:394-636): per-person
  bbox cull + size-adaptive scale factor; ellipse limbs (alpha 0.5) then
  joint circles (alpha 0.6), radius = 2*h/200, stickwidth = h/120; googly
  eyes REPLACE the normal eye circles (:588-611).
* :func:`render_pose_mpi` (render_pose_29parts:124-242): no bbox cull or
  scale factor, radius = 3*h/200, stickwidth = h/60, limb alpha 0.6, the
  l == 0 head limb drawn as an ellipse RING, 9-colour table cycled.
* :func:`render_heatmap`: one channel bicubically sampled onto the canvas,
  jet colormap.  COCO blends alpha 0.7 with getColor's B and R SWAPPED;
  MPI blends alpha 0.5 unswapped.  Out-of-box pixels keep the default
  value, which is 1 only for part == num_parts-1 (the reference's quirk,
  :659/:259 — not the background channel).
* :func:`render_all_parts`: nearest-sampled sum of value-weighted part
  colours, alpha 0.7, out-of-box pixels blend toward black, values NOT
  clamped (render_pose_coco_heatmap2:726-836).
* :func:`render_paf`: flow-coloured PAF overlay, bilinear for a single limb
  field, nearest when accumulating, alpha 0.7, B and R swapped
  (render_pose_coco_affinity:838-975).

Canvas layout is (H, W, 3) float32 BGR in 0..255 on the maps' device.  The
skeleton views loop over the people in Python (people blend in order) and
build each person's limb and joint masks in one batched pass; the people
past ``num_people`` draw nothing, as in the reference, and are skipped.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..ops.imresize import _axis_matrix

# (R, G, B) per part/limb color wheel (renderFunctions.cu:460-479)
COLORS = np.array([
    [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0],
    [170, 255, 0], [85, 255, 0], [0, 255, 0], [0, 255, 85],
    [0, 255, 170], [0, 255, 255], [0, 170, 255], [0, 85, 255],
    [0, 0, 255], [85, 0, 255], [170, 0, 255], [255, 0, 255],
    [255, 0, 170], [255, 0, 85],
], np.float32)

# limb tables (renderFunctions.cu:7-9)
LIMB_MPI = [0, 1, 2, 3, 3, 4, 5, 6, 6, 7, 8, 9, 9, 10, 11, 12, 12, 13]
LIMB_COCO_NOEAR = [1, 2, 1, 5, 2, 3, 3, 4, 5, 6, 6, 7, 1, 8, 8, 9, 9, 10,
                   1, 11, 11, 12, 12, 13, 1, 0, 0, 14, 14, 16, 0, 15, 15, 17]

# (R, G, B) 9-colour table of the MPI pose kernel (renderFunctions.cu:147-155)
MPI_COLORS = np.array([
    [255, 0, 0], [255, 170, 0], [170, 255, 0], [0, 255, 0],
    [0, 255, 170], [0, 170, 255], [0, 0, 255], [170, 0, 255],
    [255, 0, 170],
], np.float32)


def jet_color(v: torch.Tensor, vmin: float, vmax: float) -> torch.Tensor:
    """getColor (renderFunctions.cu:12-43): returns (..., 3) BGR floats."""
    v = torch.clamp(v, vmin, vmax)
    dv = vmax - vmin
    b = torch.where(v < vmin + 0.125 * dv, 256 * (0.5 + v * 4),
        torch.where(v < vmin + 0.375 * dv, 255.0,
        torch.where(v < vmin + 0.625 * dv, 256 * (-4 * v + 2.5), 0.0)))
    g = torch.where(v < vmin + 0.125 * dv, 0.0,
        torch.where(v < vmin + 0.375 * dv, 256 * (v - 0.125) * 4,
        torch.where(v < vmin + 0.625 * dv, 255.0,
        torch.where(v < vmin + 0.875 * dv, 256 * (-4 * v + 3.5), 0.0))))
    r = torch.where(v < vmin + 0.625 * dv,
        torch.where(v < vmin + 0.375 * dv, 0.0, 256 * 4 * (v - 0.375)),
        torch.where(v < vmin + 0.875 * dv, 255.0, 256 * (-4 * v + 4.5)))
    return torch.stack([b, g, r], dim=-1)


def flow_color(vx: torch.Tensor, vy: torch.Tensor) -> torch.Tensor:
    """getColorXY (renderFunctions.cu:94-109): (..., 3) BGR floats."""
    rad = torch.clamp_max(torch.sqrt(vx * vx + vy * vy), 1.0)
    a = torch.atan2(-vy, -vx) / np.pi
    fk = torch.nan_to_num((a + 1.0) / 2.0)
    v = 55.0 * torch.clamp(fk, 0.0, 1.0)
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    s = [RY, RY + YG, RY + YG + GC, RY + YG + GC + CB, RY + YG + GC + CB + BM,
         RY + YG + GC + CB + BM + MR]
    b = torch.where(v < s[0], 255.0,
        torch.where(v < s[1], 255 - 255 * (v - s[0]) / YG,
        torch.where(v < s[3], 0.0,
        torch.where(v < s[4], 255 * (v - s[3]) / BM, 255.0))))
    g = torch.where(v < s[0], 255 * v / RY,
        torch.where(v < s[2], 255.0,
        torch.where(v < s[3], 255 - 255 * (v - s[2]) / CB, 0.0)))
    r = torch.where(v < s[1], 0.0,
        torch.where(v < s[2], 255 * (v - s[1]) / GC,
        torch.where(v < s[4], 255.0,
        torch.where(v < s[5], 255 - 255 * (v - s[4]) / MR, 255.0))))
    return torch.stack([rad * b, rad * g, rad * r], dim=-1)


def _pixel_grid(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    return yy, xx


def _bgr(table: np.ndarray, idx, device) -> torch.Tensor:
    """(n, 3) BGR rows of an RGB colour table, cycled."""
    rows = table[np.asarray(idx) % len(table)]
    return torch.from_numpy(np.ascontiguousarray(rows[:, ::-1])).to(device)


def _blend_in_order(canv, masks, alpha, colors):
    """Blend colour k where masks[k], one mask after another (later ones
    over earlier ones, as the reference's loop draws them)."""
    for m, col in zip(masks, colors):
        canv = torch.where(m[..., None], (1 - alpha) * canv + alpha * col, canv)
    return canv


def _limb_judge(pose, limb_a, limb_b, xx, yy):
    """Per-limb ellipse terms over the canvas: (judge numerators A², B²,
    a_sqrt, endpoint scores va, vb), each limb along dim 0."""
    pa, pb = pose[limb_a], pose[limb_b]  # (nlimb, 3)
    xa, ya, va = pa[:, 0, None, None], pa[:, 1, None, None], pa[:, 2]
    xb, yb, vb = pb[:, 0, None, None], pb[:, 1, None, None], pb[:, 2]
    x_p = (xa + xb) / 2
    y_p = (ya + yb) / 2
    angle = torch.atan2(yb - ya, xb - xa)
    sine, cosine = torch.sin(angle), torch.cos(angle)
    a_sqrt = (xa - x_p) ** 2 + (ya - y_p) ** 2
    A = cosine * (xx - x_p) + sine * (yy - y_p)
    B = sine * (xx - x_p) - cosine * (yy - y_p)
    return A * A, B * B, a_sqrt, va, vb


def render_pose(
    canvas: torch.Tensor,  # (H, W, 3) f32 BGR 0..255
    poses: torch.Tensor,  # (MAXP, num_parts, 3) display coords
    num_people: int,
    num_parts: int = 18,
    threshold: float = 0.01,
    googly_eyes: bool = False,
) -> torch.Tensor:
    h, w, _ = canvas.shape
    dev = canvas.device
    poses = poses.to(device=dev, dtype=torch.float32)
    limb = LIMB_COCO_NOEAR if num_parts == 18 else LIMB_MPI
    nlimb = len(limb) // 2
    limb_a, limb_b = limb[0::2], limb[1::2]
    limb_col = _bgr(COLORS, range(nlimb), dev)[:, None, None, :]  # (nlimb, 1, 1, 3)
    part_col = _bgr(COLORS, range(num_parts), dev)[:, None, None, :]
    radius = 2 * h / 200.0
    stickwidth = h / 120.0
    yy, xx = _pixel_grid(h, w, dev)
    googly = googly_eyes and num_parts == 18
    is_eye = torch.zeros(num_parts, dtype=torch.bool, device=dev)
    if googly:
        is_eye[14:16] = True

    # per-person bbox + scale factor (renderFunctions.cu:413-440)
    vis = poses[:, :, 2] > threshold
    big = torch.tensor(1e9, dtype=torch.float32, device=dev)
    mins_x = torch.clamp_max(torch.where(vis, poses[:, :, 0], big).amin(1), w)
    mins_y = torch.clamp_max(torch.where(vis, poses[:, :, 1], big).amin(1), h)
    maxs_x = torch.clamp_min(torch.where(vis, poses[:, :, 0], -big).amax(1), 0)
    maxs_y = torch.clamp_min(torch.where(vis, poses[:, :, 1], -big).amax(1), 0)
    scalef = (maxs_x - mins_x + maxs_y - mins_y) / 2.0
    scalef = torch.where(scalef < 200, torch.clamp_min(scalef / 200, 0.33),
                         torch.ones_like(scalef))
    mins_x, mins_y = mins_x - 50, mins_y - 50
    maxs_x, maxs_y = maxs_x + 50, maxs_y + 50

    canv = canvas.to(torch.float32)
    for p in range(min(int(num_people), poses.shape[0])):
        inbox = (xx >= mins_x[p]) & (xx <= maxs_x[p]) & (yy >= mins_y[p]) & (yy <= maxs_y[p])
        pose_p = poses[p]
        sf = scalef[p]

        AA, BB, a_sqrt, va, vb = _limb_judge(pose_p, limb_a, limb_b, xx, yy)
        b_sqrt = sf * sf * stickwidth * stickwidth
        # raw IEEE division: coincident endpoints give a_sqrt == 0 -> judge
        # inf/nan -> comparisons false, exactly as the kernel
        judge = AA / a_sqrt + BB / b_sqrt
        draw = ((va > threshold) & (vb > threshold))[:, None, None]
        inside = draw & inbox & (judge >= 0) & (judge <= 1)
        canv = _blend_in_order(canv, inside, 0.5, limb_col)

        lx, ly, val = (pose_p[:, k, None, None] for k in range(3))
        dist2 = (xx - lx) ** 2 + (yy - ly) ** 2  # (num_parts, H, W)
        draw = (val > threshold) & inbox
        circle = draw & (dist2 <= sf * sf * radius * radius) & ~is_eye[:, None, None]
        if not googly:
            canv = _blend_in_order(canv, circle, 0.6, part_col)
            continue
        # googly eyes (renderFunctions.cu:592-612) replace the normal circle
        # of parts 14/15 (:588 else-branch)
        emaxr2 = sf * sf * (2.5 * radius) ** 2
        eminr2 = sf * sf * (2.5 * radius - 2) ** 2
        dist3 = (xx - 4 - lx) ** 2 + (yy - ly + 4) ** 2
        white = ((dist2 <= eminr2) & ~((dist2 <= eminr2 * 0.6) & (dist3 > 3.75 * 3.75)))
        eye_col = white[..., None].to(torch.float32) * 255.0  # (num_parts, H, W, 1)
        eye = draw & is_eye[:, None, None] & (dist2 <= emaxr2)
        for i in range(num_parts):
            canv = torch.where(circle[i, ..., None], 0.4 * canv + 0.6 * part_col[i], canv)
            canv = torch.where(eye[i, ..., None], 0.1 * canv + 0.9 * eye_col[i], canv)
    return canv


def render_pose_mpi(
    canvas: torch.Tensor,  # (H, W, 3) f32 BGR 0..255
    poses: torch.Tensor,  # (MAXP, 15, 3) display coords
    num_people: int,
    threshold: float = 0.0,
) -> torch.Tensor:
    """MPI skeleton overlay (render_pose_29parts, renderFunctions.cu:124-242).

    Geometry differs from the COCO kernel: radius = 3*h/200, stickwidth =
    h/60, limb alpha 0.6, no per-person bbox cull or size-adaptive scale,
    and the head limb (l == 0) is an ellipse RING: a_sqrt scaled by 1.2,
    b_sqrt = a_sqrt, judge accepted in [0.8, 1].  The host wrapper
    (render_mpi_parts:366) passes threshold 0.
    """
    h, w, _ = canvas.shape
    dev = canvas.device
    poses = poses.to(device=dev, dtype=torch.float32)
    num_parts = 15
    nlimb = len(LIMB_MPI) // 2
    limb_col = _bgr(MPI_COLORS, range(nlimb), dev)[:, None, None, :]
    part_col = _bgr(MPI_COLORS, range(num_parts), dev)[:, None, None, :]
    radius = 3 * h / 200.0
    stickwidth = h / 60.0
    yy, xx = _pixel_grid(h, w, dev)
    head = torch.zeros((nlimb, 1, 1), dtype=torch.bool, device=dev)
    head[0] = True

    canv = canvas.to(torch.float32)
    for p in range(min(int(num_people), poses.shape[0])):
        pose_p = poses[p]
        AA, BB, a_sqrt, va, vb = _limb_judge(pose_p, LIMB_MPI[0::2], LIMB_MPI[1::2], xx, yy)
        a_sqrt = torch.where(head, a_sqrt * 1.2, a_sqrt)
        b_sqrt = torch.where(head, a_sqrt, torch.full_like(a_sqrt, stickwidth * stickwidth))
        min_v = torch.where(head, 0.8, 0.0)
        judge = AA / a_sqrt + BB / b_sqrt
        draw = ((va > threshold) & (vb > threshold))[:, None, None]
        inside = draw & (judge >= min_v) & (judge <= 1)
        canv = _blend_in_order(canv, inside, 0.6, limb_col)

        lx, ly, val = (pose_p[:, k, None, None] for k in range(3))
        dist2 = (xx - lx) ** 2 + (yy - ly) ** 2
        circle = (val > threshold) & (dist2 <= radius * radius)
        canv = _blend_in_order(canv, circle, 0.4, part_col)
    return canv


@lru_cache(maxsize=32)
def _box_matrices(h_net: int, w_net: int, h_canvas: int, w_canvas: int):
    """Canvas->net bicubic matrices; the kernels' x_on_box mapping equals the
    ImResize axis convention with pad 0."""
    return _axis_matrix(h_net, 0, h_canvas), _axis_matrix(w_net, 0, w_canvas)


def _box_valid(h_net, w_net, h_canvas, w_canvas):
    ys = (np.arange(h_canvas) + 0.5) * (h_net / h_canvas) - 0.5
    xs = (np.arange(w_canvas) + 0.5) * (w_net / w_canvas) - 0.5
    vy = (ys >= 0) & (ys < h_net)
    vx = (xs >= 0) & (xs < w_net)
    return np.outer(vy, vx)


def _nearest_idx(size_net, size_canvas):
    t = (np.arange(size_canvas) + 0.5) * (size_net / size_canvas) - 0.5
    n1 = np.trunc(t + 1e-5).astype(np.int64)
    return np.clip(n1, 0, size_net - 1)


def _on(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _nearest(maps: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(C, h_net, w_net) -> (C, h, w) nearest samples (the kernels' x_on_box
    truncation)."""
    _, h_net, w_net = maps.shape
    iy = _on(_nearest_idx(h_net, h), maps.device)
    ix = _on(_nearest_idx(w_net, w), maps.device)
    return maps.index_select(1, iy).index_select(2, ix)


def render_heatmap(canvas: torch.Tensor, net_maps: torch.Tensor, part: int,
                   num_parts: int = 18) -> torch.Tensor:
    """Overlay one net-res channel (part index into the resized maps)."""
    h, w, _ = canvas.shape
    c, h_net, w_net = net_maps.shape
    dev = canvas.device
    Ay, Ax = _box_matrices(h_net, w_net, h, w)
    plane = net_maps[part].to(device=dev, dtype=torch.float32)
    up = _on(Ay, dev) @ plane @ _on(Ax, dev).T  # (h, w)
    # reference quirk: the out-of-box default is 1 only for the LAST part
    # channel, not the background (renderFunctions.cu:659 / :259)
    default = 1.0 if part == num_parts - 1 else 0.0
    up = torch.where(_on(_box_valid(h_net, w_net, h, w), dev), up, default)
    vmin, vmax = (0.0, 1.0) if part < num_parts + 1 else (-1.0, 1.0)
    col = jet_color(up, vmin, vmax)
    if num_parts == 18:
        # COCO blends alpha 0.7 with getColor's B/R channels swapped
        # (b <- c[2], renderFunctions.cu:715-717)
        return 0.3 * canvas + 0.7 * col.flip(-1)
    # MPI blends alpha 0.5 unswapped (renderFunctions.cu:320-322)
    return 0.5 * canvas + 0.5 * col


def render_all_parts(canvas: torch.Tensor, net_maps: torch.Tensor,
                     num_parts: int = 18) -> torch.Tensor:
    """Sum of value-weighted part colors, nearest-sampled (heatmap2)."""
    h, w, _ = canvas.shape
    _, h_net, w_net = net_maps.shape
    dev = canvas.device
    sampled = _nearest(net_maps[:num_parts].to(device=dev, dtype=torch.float32), h, w)
    colors = _on(COLORS[:num_parts], dev)  # (P, 3) RGB
    acc_bgr = torch.einsum("phw,pc->hwc", sampled, colors).flip(-1)
    # out-of-box pixels accumulate nothing and blend toward black
    # (the kernel's bounds check, renderFunctions.cu:786)
    valid = _on(_box_valid(h_net, w_net, h, w), dev)
    acc_bgr = torch.where(valid[..., None], acc_bgr, 0.0)
    return 0.3 * canvas + 0.7 * acc_bgr


def render_paf(canvas: torch.Tensor, net_maps: torch.Tensor, in_part: int,
               num_parts_accum: int = 1) -> torch.Tensor:
    """Flow-colored PAF overlay; bilinear for a single field, nearest for the
    accumulated view (render_pose_coco_affinity)."""
    h, w, _ = canvas.shape
    _, h_net, w_net = net_maps.shape
    dev = canvas.device
    maps = net_maps.to(device=dev, dtype=torch.float32)
    valid = _on(_box_valid(h_net, w_net, h, w), dev)[..., None]
    if num_parts_accum == 1:
        f = np.float32  # source coords in f32, as the JAX version computes them
        ys = (np.arange(h, dtype=f) + f(0.5)) * f(h_net / h) - f(0.5)
        xs = (np.arange(w, dtype=f) + f(0.5)) * f(w_net / w) - f(0.5)
        y1 = np.clip(np.trunc(ys + f(1e-5)).astype(np.int64), 0, h_net - 1)
        x1 = np.clip(np.trunc(xs + f(1e-5)).astype(np.int64), 0, w_net - 1)
        y2 = np.minimum(y1 + 1, h_net - 1)
        x2 = np.minimum(x1 + 1, w_net - 1)
        dy = _on(ys - y1.astype(f), dev)[:, None]
        dx = _on(xs - x1.astype(f), dev)[None, :]
        y1, x1, y2, x2 = (_on(a, dev) for a in (y1, x1, y2, x2))
        pair = maps[in_part : in_part + 2]  # (2, h_net, w_net): x and y fields

        def at(iy, ix):
            return pair.index_select(1, iy).index_select(2, ix)

        v = ((1 - dx) * (1 - dy) * at(y1, x1) + dx * (1 - dy) * at(y1, x2)
             + (1 - dx) * dy * at(y2, x1) + dx * dy * at(y2, x2))
        col = torch.where(valid, flow_color(v[0], v[1]), 0.0)
    else:
        fields = _nearest(maps[in_part : in_part + 2 * num_parts_accum], h, w)
        cols = torch.where(valid, flow_color(fields[0::2], fields[1::2]), 0.0)  # (K, h, w, 3)
        acc = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
        for k in range(num_parts_accum):  # summed in the JAX version's order
            acc = acc + cols[k]
        col = torch.clamp_max(acc, 255.0)
    # the kernel blends getColorXY's output with B/R swapped
    # (b <- c[2], renderFunctions.cu:965-967), like the COCO heatmap
    return 0.3 * canvas + 0.7 * col.flip(-1)
