"""CPM label rasterization on the device.

The port of ``caffe_rtpose_tpu/training/labels_device.py``: the host ships
the augmented joint coordinates (~1 KB a sample) and the 2*(np+1) = 114
label channels of a 46x46 grid are rasterized on the device inside the train
step (the solver's ``input_transform``), instead of in scalar host loops
(DataTransformer::generateLabelMap, data_transformer.cpp:2117-2264, with
putGaussianMaps :2002 and putVecMaps :2063).

The arithmetic is the host reference's (``transformer.generate_label_map``),
so the two agree bit for bit on the CPU:

* part gaussians: the squared distance and the exponent in f64, as numpy
  does there, each person's contribution rounded to f32 and added in person
  order; the sum is clamped at 1 (clamping after each add, as the reference
  does, gives the same f32 result), contributions with exponent > 4.6052
  skipped;
* PAF corridors: the box from f32 endpoints rounded half away from zero,
  the distance to the limb's line in f64, and overlapping people resolved
  by LAST WRITER in person order (the reference's count matrix never
  increments on first write): each (limb, pixel) takes the highest person
  index whose corridor covers it;
* weight channels gated on the main person's visibility != 3;
* background = max(1 - max(part gaussians), 0).

Labels come out NCHW (B, 2*(np+1), grid_y, grid_x), the port's layout.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from .transformer import MID_1, MID_2, AugParams, transform_meta


def _cround(v: torch.Tensor) -> torch.Tensor:
    """std::round: half away from zero."""
    return torch.sign(v) * torch.floor(torch.abs(v) + 0.5)


def make_label_fn(prm: AugParams, max_people: int = 12):
    """A function ``(joints, vis, weight) -> label`` on tensors of one
    device:

    * joints: (B, max_people, 18, 2) f32 augmented input-pixel coordinates
      (person 0 = the main person);
    * vis:    (B, max_people, 18) int reference visibility codes (<= 1
      usable, 2 outside, 3 absent; pad people with 3);
    * weight: (B, grid_y, grid_x) f32 mask_miss grid in [0, 1];
    * label:  (B, 2*(np+1), grid_y, grid_x) f32.
    """
    np_, stride, sigma = prm.np, prm.stride, float(prm.sigma)
    gx_n, gy_n = prm.crop_size_x // stride, prm.crop_size_y // stride
    mid1 = torch.tensor(MID_1) - 1
    mid2 = torch.tensor(MID_2) - 1
    thre = 1.0
    start = stride / 2.0 - 0.5  # putGaussianMaps sample positions (:2007)

    def gaussians(joints, usable):
        """(B, P, 18, 2), (B, P, 18) -> (B, 18, gy, gx)."""
        dev = joints.device
        gxs = start + torch.arange(gx_n, dtype=torch.float64, device=dev) * stride
        gys = start + torch.arange(gy_n, dtype=torch.float64, device=dev) * stride
        j = joints.to(torch.float64)
        d2 = ((gxs[None, None, None, None, :] - j[..., 0, None, None]) ** 2
              + (gys[None, None, None, :, None] - j[..., 1, None, None]) ** 2)
        expo = d2 / 2.0 / sigma / sigma
        contrib = torch.where(expo > 4.6052, torch.zeros_like(expo), torch.exp(-expo))
        contrib = contrib.to(torch.float32) * usable[..., None, None]
        acc = contrib[:, 0]
        for p in range(1, contrib.shape[1]):  # f32 adds in person order
            acc = acc + contrib[:, p]
        return torch.clamp(acc, max=1.0)

    def pafs(joints, usable):
        """(B, P, 18, 2), (B, P, 18) -> (B, 2L, gy, gx) last-writer corridors."""
        dev = joints.device
        a = joints[:, :, mid1.to(dev)] * 0.125  # (B, P, L, 2) grid coordinates
        b = joints[:, :, mid2.to(dev)] * 0.125
        bc = b - a
        sq = bc[..., 0] * bc[..., 0] + bc[..., 1] * bc[..., 1]  # f32, as the host
        u = bc / torch.sqrt(sq.to(torch.float64)).to(torch.float32)[..., None]
        valid = (usable[:, :, mid1.to(dev)] > 0) & (usable[:, :, mid2.to(dev)] > 0) & (sq > 0)
        min_x = torch.clamp(_cround(torch.minimum(a[..., 0], b[..., 0]) - thre), min=0)
        max_x = torch.clamp(_cround(torch.maximum(a[..., 0], b[..., 0]) + thre), max=gx_n)
        min_y = torch.clamp(_cround(torch.minimum(a[..., 1], b[..., 1]) - thre), min=0)
        max_y = torch.clamp(_cround(torch.maximum(a[..., 1], b[..., 1]) + thre), max=gy_n)
        xs = torch.arange(gx_n, dtype=torch.float32, device=dev)
        ys = torch.arange(gy_n, dtype=torch.float32, device=dev)
        in_x = (xs >= min_x[..., None]) & (xs < max_x[..., None])  # (B, P, L, gx)
        in_y = (ys >= min_y[..., None]) & (ys < max_y[..., None])  # (B, P, L, gy)
        a64, u64 = a.to(torch.float64), u.to(torch.float64)
        xs64, ys64 = xs.to(torch.float64), ys.to(torch.float64)
        dist = torch.abs((xs64 - a64[..., 0, None])[..., None, :] * u64[..., 1, None, None]
                         - (ys64 - a64[..., 1, None])[..., :, None] * u64[..., 0, None, None])
        sel = (in_y[..., :, None] & in_x[..., None, :] & (dist <= thre)
               & valid[..., None, None])  # (B, P, L, gy, gx)
        order = torch.arange(1, sel.shape[1] + 1, device=dev).view(1, -1, 1, 1, 1)
        last = (sel * order).amax(dim=1)  # (B, L, gy, gx): 1 + the last writer, 0 none
        pick = (last - 1).clamp(min=0)
        ut = u.transpose(1, 2)  # (B, L, P, 2)
        ux = torch.gather(ut[..., 0], 2, pick.flatten(2)).view_as(pick)
        uy = torch.gather(ut[..., 1], 2, pick.flatten(2)).view_as(pick)
        ux = torch.where(last > 0, ux, torch.zeros_like(ux))
        uy = torch.where(last > 0, uy, torch.zeros_like(uy))
        return torch.stack([ux, uy], dim=2).flatten(1, 2)  # x, y interleaved per limb

    def label_fn(joints: torch.Tensor, vis: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        joints = joints.to(torch.float32)
        vis = vis.to(torch.int32)
        weight = weight.to(torch.float32)
        usable = (vis <= 1).to(torch.float32)
        g = gaussians(joints, usable)
        paf = pafs(joints, usable)
        main_on = (vis[:, 0, :] != 3).to(torch.float32)  # (B, 18)
        # channels [0, 18): weights gated by the main person; [18, np]: the
        # plain weight (generate_label_map); then PAFs, gaussians, background
        bsz = weight.shape[0]
        w18 = weight[:, None] * main_on[..., None, None]
        w_rest = weight[:, None].expand(bsz, np_ - 18 + 1, gy_n, gx_n)
        bkg = torch.clamp(1.0 - g.amax(dim=1, keepdim=True), min=0.0)
        return torch.cat([w18, w_rest, paf, g, bkg], dim=1)

    return label_fn


def make_input_transform(prm: AugParams, max_people: int = 12, data_u8: bool = False):
    """The solver's ``input_transform``: {data, joints, vis, weight} ->
    {data, label}, the label rasterized on the device.  ``data_u8``: the
    host ships the augmented u8 images (a quarter of the f32 bytes) and the
    exact ``(x - 128) / 256`` (Transform_nv :1358-1361) runs here."""
    label_fn = make_label_fn(prm, max_people)

    def tf(inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = {k: v for k, v in inputs.items() if k not in ("joints", "vis", "weight")}
        if data_u8:
            out["data"] = (out["data"].to(torch.float32) - 128.0) / 256.0
        out["label"] = label_fn(inputs["joints"], inputs["vis"], inputs["weight"])
        return out

    return tf


def pose_batches_jointfeed(source, prm: AugParams, batch_size: int, max_people: int = 12,
                           seed: int = 0, train: bool = True,
                           data_u8: bool = False) -> Iterator[Dict[str, np.ndarray]]:
    """Endless {data, joints, vis, weight} numpy batches: the host runs the
    augmentation chain, the device rasterizes the labels.  Pair with
    :func:`make_input_transform` on the Solver (the same ``data_u8``)."""
    from .datasets import _clone_meta  # lazy: datasets imports this module's neighbours

    rs = np.random.RandomState(seed)
    n = len(source)
    gy, gx = prm.crop_size_y // prm.stride, prm.crop_size_x // prm.stride
    while True:
        datas = np.zeros((batch_size, 3, prm.crop_size_y, prm.crop_size_x),
                         np.uint8 if data_u8 else np.float32)
        joints = np.zeros((batch_size, max_people, 18, 2), np.float32)
        vis = np.full((batch_size, max_people, 18), 3, np.int32)
        weight = np.ones((batch_size, gy, gx), np.float32)
        for bi in range(batch_size):
            img, meta, mask = source[int(rs.randint(n))]
            d, people, mask_grid = transform_meta(img, _clone_meta(meta), prm, rng=rs,
                                                  mask_miss=mask, train=train,
                                                  normalize=not data_u8)
            datas[bi] = d
            for pi, p in enumerate(people[:max_people]):
                joints[bi, pi] = p.joints[:18]
                vis[bi, pi] = p.visible[:18]
            if mask_grid is not None:
                weight[bi] = mask_grid.astype(np.float32)[:gy, :gx] / 255.0
        yield {"data": datas, "joints": joints, "vis": vis, "weight": weight}
