"""Legacy single-person CPM helpers.

Counterpart of ``caffe_rtpose_tpu/ops/cpm_legacy.py``: the crop-around-peak
functions behind the original (pre-PAF) single-person CPM head (reference
src/caffe/cpm/util/math_functions.cu: ``fill_image``, ``fill_gassian``,
``fill_pose_net``; the last is dead code there, behind ``CHECK(0)``).  They
pair with the ``Maximum`` layer (each channel's argmax): crop a boxsize
patch around each person centre and append a centred gaussian as a 4th
channel.  JAX maps one crop over the people with ``vmap``; here every
person's patch is one batched gather.
"""

from __future__ import annotations

import torch


def fill_gaussian(boxsize: int, sigma: float = 21.0,
                  device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """(boxsize, boxsize) gaussian centred at boxsize/2, zero where the
    exponent passes 4.6052 (fill_gassian, math_functions.cu:37-52)."""
    c = boxsize / 2
    xs = torch.arange(boxsize, dtype=torch.float32, device=device)
    d2 = (xs[None, :] - c) ** 2 + (xs[:, None] - c) ** 2
    expo = d2 / (2.0 * sigma * sigma)
    return torch.where(expo > 4.6052, torch.zeros_like(expo), torch.exp(-expo))


def fill_images(image_chw: torch.Tensor, centers_xy: torch.Tensor, boxsize: int) -> torch.Tensor:
    """(P, 2) centres (x, y) -> (P, C, boxsize, boxsize) patches centred on
    each, zero outside the image (fill_image, math_functions.cu:7-35; the
    centre rounded with +0.5 as the kernel)."""
    _, h, w = image_chw.shape
    centers = torch.floor(centers_xy.to(torch.float32) + 0.5).to(torch.int64)
    offs = torch.arange(boxsize, device=image_chw.device) - boxsize // 2
    xs = centers[:, 0:1] + offs  # (P, box)
    ys = centers[:, 1:2] + offs
    inside = (((ys >= 0) & (ys < h))[:, :, None] & ((xs >= 0) & (xs < w))[:, None, :])
    yc, xc = ys.clamp(0, h - 1), xs.clamp(0, w - 1)
    patches = image_chw[:, yc[:, :, None], xc[:, None, :]]  # (C, P, box, box)
    return patches.permute(1, 0, 2, 3) * inside[:, None].to(image_chw.dtype)


def fill_image(image_chw: torch.Tensor, center_xy: torch.Tensor, boxsize: int) -> torch.Tensor:
    """One (C, boxsize, boxsize) patch centred on ``center_xy``."""
    return fill_images(image_chw, torch.as_tensor(center_xy).reshape(1, 2), boxsize)[0]


def fill_pose_net(image_chw: torch.Tensor, centers_xy: torch.Tensor, boxsize: int,
                  sigma: float = 21.0) -> torch.Tensor:
    """Every person at once: (P, 2) centres -> (P, C + 1, boxsize, boxsize),
    the centred gaussian as the last channel (fill_pose_net,
    math_functions.cu:55-95, without the reference's dead-code CHECK)."""
    image_chw = torch.as_tensor(image_chw)
    patches = fill_images(image_chw, torch.as_tensor(centers_xy), boxsize)
    g = fill_gaussian(boxsize, sigma, image_chw.device).to(patches.dtype)
    return torch.cat([patches, g.expand(patches.shape[0], 1, boxsize, boxsize)], dim=1)
