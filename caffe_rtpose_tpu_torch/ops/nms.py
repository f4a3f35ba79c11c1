"""Heatmap peak extraction (the reference's Nms layer, GPU path) in PyTorch.

Counterpart of ``caffe_rtpose_tpu/ops/nms.py``; semantics reproduced from
reference src/caffe/cpm/layers/nms_layer.cu:

1. a pixel is a peak iff it is interior (not on any border), its value is
   > threshold, and it is strictly greater than all 8 neighbors
   (nms_register_kernel, nms_layer.cu:15-46);
2. peaks are emitted in raster-scan order (exclusive-scan compaction,
   nms_layer.cu:173-176), at most ``max_peaks`` per part channel;
3. each peak gets sub-pixel refinement: a score-weighted centroid over the
   7x7 window, counting only samples with score > 0 and with the reference's
   boundary conditions — the reference checks both x and y offsets against
   *width* and excludes row/column 0 (``(p+d) > 0 && (p+d) < width``,
   nms_layer.cu:78-94).  For wide maps (W > H) a peak within 3 px of the
   bottom edge therefore reads past the channel — the blob is contiguous
   NCHW, so the read lands in channel c+1 at row y-H.  When the caller
   provides the channels beyond ``num_parts`` that read is replicated;
   otherwise those taps are masked out;
4. output is [num_parts, max_peaks+1, 3]; slot 0 holds the peak count,
   capped at max_peaks.

Compaction is a cumsum rank plus a scatter into a fixed (C, max_peaks)
buffer: fixed shapes, no host sync (``torch.nonzero`` would sync), and the
same positions, counts and raster order as the JAX ``compact_keys``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .imresize import axis_weights_dense, scale_pads


def find_peaks_mask(heat: torch.Tensor, threshold) -> torch.Tensor:
    """heat: (C, H, W) -> bool mask of strict-8-neighbor local maxima.

    Borders are never peaks, and ``x > all 8 neighbors`` is
    ``x > max(8 neighbors)``, built separably: a horizontal 3-max, its
    vertical pairs (rows y-1, y+1 cover 6 taps), plus the same-row x+-1
    pair."""
    hf = heat.to(torch.float32)
    ctr = hf[:, 1:-1, 1:-1]
    row3 = torch.maximum(torch.maximum(hf[:, :, :-2], hf[:, :, 1:-1]), hf[:, :, 2:])
    vert = torch.maximum(row3[:, :-2, :], row3[:, 2:, :])  # rows y-1, y+1
    horz = torch.maximum(hf[:, 1:-1, :-2], hf[:, 1:-1, 2:])  # x-1, x+1
    n8 = torch.maximum(vert, horz)
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=hf.device)
    mask = (ctr > thr) & (ctr > n8)
    return torch.nn.functional.pad(mask, (1, 1, 1, 1))


def block_keys(mask: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(C, H, W) bool peak mask -> (C, nb) int32 keys in raster-position order.

    Each horizontal pixel pair (y, 2bx)/(y, 2bx+1) collapses to one key
    (= ``hw - pos`` of its peak, 0 if none): adjacent pixels are 8-neighbors,
    so two strict maxima never share a pair, and the flattened (y, bx) order
    is ascending-position order, which :func:`compact_keys` needs."""
    c = mask.shape[0]
    w2 = w - (w % 2)  # odd trailing col is border (never peaks)
    mb = mask[:, :, :w2].reshape(c, h, w2 // 2, 2)
    m0, m1 = mb[..., 0], mb[..., 1]
    dev = mask.device
    base = (torch.arange(h, dtype=torch.int32, device=dev)[:, None] * w
            + torch.arange(w2 // 2, dtype=torch.int32, device=dev)[None, :] * 2)
    pos = torch.where(m0, base, base + 1)
    return torch.where(m0 | m1, h * w - pos, torch.zeros_like(pos)).reshape(c, h * (w2 // 2))


def compact_keys(kb: torch.Tensor, hw: int, max_peaks: int):
    """Raster-order compaction of position-ordered keys.

    kb: (C, nb) keys (= hw - pos, 0 where empty) whose flattened order is
    ascending-position order (see :func:`block_keys`).  The r-th set slot is
    the r-th peak: rank with an inclusive cumsum, scatter the first
    ``topk`` into a fixed buffer (everything else lands in a spill column).

    Returns (peak_pos (C, topk) int32, valid (C, topk) bool, counts (C,)
    int32) with uncapped counts, as the JAX ``compact_keys``.
    """
    c, nb = kb.shape
    topk = min(max_peaks, hw)
    set_ = kb > 0
    counts = set_.sum(dim=1, dtype=torch.int32)
    rank = torch.cumsum(set_.to(torch.int32), dim=1) - 1  # 0-based slot
    slot = torch.where(set_ & (rank < topk), rank, torch.full_like(rank, topk)).to(torch.int64)
    buf = torch.zeros((c, topk + 1), dtype=torch.int32, device=kb.device)
    buf.scatter_(1, slot, hw - kb.to(torch.int32))
    ranks = torch.arange(topk, dtype=torch.int32, device=kb.device)
    valid = counts[:, None] > ranks[None, :]
    peak_pos = torch.where(valid, buf[:, :topk], torch.zeros_like(buf[:, :topk]))
    return peak_pos, valid, counts


def nms_peaks(heat: torch.Tensor, threshold, max_peaks: int,
              num_parts: Optional[int] = None) -> torch.Tensor:
    """heat: (C, H, W) confidence maps -> (num_parts, max_peaks+1, 3) peaks.

    ``num_parts`` (default C) selects the channels NMS runs on (the Nms
    layer uses the first num_parts of its 57-channel bottom,
    nms_layer.cu:144); the full map lets refinement replicate the
    reference's past-the-channel window reads."""
    c, h, w = heat.shape
    p = c if num_parts is None else int(num_parts)
    heatf = heat.to(torch.float32)
    kb = block_keys(find_peaks_mask(heatf[:p], threshold), h, w)
    return peaks_from_keys(heatf, kb, max_peaks, ordered=True)


def peaks_from_keys(heatf: torch.Tensor, kb: torch.Tensor, max_peaks: int,
                    ordered: bool = False) -> torch.Tensor:
    """Compaction + refinement half of the NMS.

    ``heatf`` is (C_all, H, W) with C_all >= P = kb.shape[0]: the first P
    channels are the peak channels, and the 7x7 windows are one flat gather
    over the whole (C_all*H*W) buffer, so a window row past a channel's
    bottom reads channel c+1 as the reference's pointer arithmetic does
    (nms_layer.cu:82).  Taps past the end of the buffer are masked out.

    ``ordered=True``: kb's flattened order is position order
    (:func:`block_keys`, or the upsample kernel's keys) and compaction is
    the sort-free :func:`compact_keys`.  ``ordered=False``: kb is any
    arrangement of keys, compacted by ``topk`` over the key values.
    """
    heatf = heatf.to(torch.float32)
    c_all, h, w = heatf.shape
    hw = h * w
    kb = kb.reshape(kb.shape[0], -1)
    p = kb.shape[0]
    if ordered:
        peak_pos, valid, counts = compact_keys(kb, hw, max_peaks)
    else:
        counts = (kb > 0).sum(dim=1, dtype=torch.int32)
        topk = min(max_peaks, hw)
        if kb.shape[1] < topk:
            kb = torch.nn.functional.pad(kb, (0, topk - kb.shape[1]))
        kvals = torch.topk(kb, topk, dim=1).values  # descending key = ascending pos
        valid = kvals > 0
        peak_pos = torch.where(valid, hw - kvals, torch.zeros_like(kvals)).to(torch.int32)
    topk = peak_pos.shape[1]

    yy, xx, in_bounds = _window_coords(peak_pos, h, w)
    chan = torch.arange(p, dtype=torch.int64, device=heatf.device)[:, None, None]
    flat_idx = chan * hw + yy.to(torch.int64) * w + xx.to(torch.int64)  # yy may exceed h-1
    in_buffer = flat_idx < c_all * hw
    flat_idx = torch.clamp(flat_idx, 0, c_all * hw - 1)
    scores = heatf.reshape(-1).index_select(0, flat_idx.reshape(-1)).reshape(p, topk, 49)
    center = torch.gather(heatf[:p].reshape(p, hw), 1, peak_pos.to(torch.int64))
    return _refine_and_pack(scores, center, yy, xx, in_bounds & in_buffer, valid, counts,
                            max_peaks)


def _window_coords(peak_pos: torch.Tensor, h: int, w: int):
    """(C, topk) peak raster positions -> 7x7 window coords + bounds mask.

    Reference bounds quirk kept exactly: both axes checked against *width*,
    strict > 0 (nms_layer.cu:78-94).  yy may exceed h-1 on wide maps — the
    caller resolves those taps as flat-buffer reads into the next channel.
    """
    offs = np.stack(np.meshgrid(np.arange(-3, 4), np.arange(-3, 4), indexing="ij"), -1).reshape(-1, 2)
    dys = torch.as_tensor(offs[:, 0], dtype=torch.int32, device=peak_pos.device)
    dxs = torch.as_tensor(offs[:, 1], dtype=torch.int32, device=peak_pos.device)
    pos = peak_pos.to(torch.int32)[..., None]
    yy = torch.div(pos, w, rounding_mode="floor") + dys  # (C, topk, 49)
    xx = torch.remainder(pos, w) + dxs
    in_bounds = (yy > 0) & (yy < w) & (xx > 0) & (xx < w)
    return yy, xx, in_bounds


def _refine_and_pack(scores, center, yy, xx, in_bounds, valid, counts, max_peaks):
    """Score-weighted 7x7 centroid + output packing (nms_layer.cu:74-113)."""
    c, topk = center.shape
    use = in_bounds & (scores > 0)
    scores = torch.where(use, scores, torch.zeros_like(scores))
    wsum = scores.sum(dim=-1)
    x_acc = (scores * xx.to(torch.float32)).sum(dim=-1)
    y_acc = (scores * yy.to(torch.float32)).sum(dim=-1)
    # the reference divides unguarded (nms_layer.cu:97-98): a peak whose 7x7
    # window is fully truncated by the y-vs-width quirk (y >= W+3, only
    # possible on tall maps) gets 0/0 = NaN coords, score intact.  Invalid
    # rows also hit 0/0 here but are masked to 0 by `valid` below.
    x_ref = x_acc / wsum
    y_ref = y_acc / wsum
    zero = torch.zeros_like(center)
    rows = torch.stack(
        [torch.where(valid, x_ref, zero), torch.where(valid, y_ref, zero),
         torch.where(valid, center, zero)], dim=-1)  # (C, topk, 3)
    if topk < max_peaks:
        rows = torch.nn.functional.pad(rows, (0, 0, 0, max_peaks - topk))
    head = torch.zeros((c, 1, 3), dtype=torch.float32, device=center.device)
    head[:, 0, 0] = torch.clamp_max(counts, max_peaks).to(torch.float32)
    return torch.cat([head, rows], dim=1)  # (C, max_peaks+1, 3)


def refine_from_low(
    parts_low: torch.Tensor,  # (S, h, w, >=P) low-res maps (NHWC)
    peak_pos: torch.Tensor,  # (P, topk) raster positions from compact_keys
    valid: torch.Tensor,
    counts: torch.Tensor,
    target_hw: Tuple[int, int],
    max_peaks: int,
    start_scale: float,
    scale_gap: float,
) -> torch.Tensor:
    """7x7 centroid refinement + packing with the windows recomputed from the
    low-res maps: the upsampled value at integer (Y, X) is
    ``mean_n Ay_n[Y] @ src_n @ Ax_n[X]^T``, so the 49 window values per peak
    are two small batched matmuls instead of a gather from a full-res map."""
    s, h, w, p_all = parts_low.shape
    th, tw = target_hw
    c, topk = peak_pos.shape

    yy, xx, in_bounds = _window_coords(peak_pos, th, tw)
    # 49 = dy-major: yy varies along the dy axis, xx along the dx axis
    yyr = yy.reshape(c, topk, 7, 7)[:, :, :, 0]  # (C, topk, 7), unclamped
    xxc = torch.clamp(xx, 0, tw - 1).reshape(c, topk, 7, 7)[:, :, 0, :]  # (C, topk, 7)
    planes = parts_low.to(torch.float32).permute(0, 3, 1, 2)  # (S, C_all, h, w)
    # window rows past the channel bottom (yy >= th, wide maps only) read
    # channel c+1 at row yy-th in the reference's contiguous buffer; we
    # replicate when the caller provided the extra channel(s)
    has_next = p_all > c
    if has_next:
        if tw > 2 * th:
            raise ValueError("channel-continuation refinement supports one "
                             "channel of overflow (tw <= 2*th)")
        over = yyr >= th
        y_main = torch.where(over, torch.full_like(yyr, th - 1), yyr)
        y_next = torch.clamp(yyr - th, 0, th - 1)
    else:
        y_main = torch.clamp(yyr, 0, th - 1)
        in_bounds = in_bounds & (yy < th)

    win = torch.zeros((c, topk, 7, 7), dtype=torch.float32, device=parts_low.device)
    for n in range(s):
        padh, padw = scale_pads(h, w, n, start_scale, scale_gap)
        Yw = axis_weights_dense(y_main.reshape(-1), h, padh, th).reshape(c, topk * 7, h)
        Xw = axis_weights_dense(xxc.reshape(-1), w, padw, tw).reshape(c, topk, 7, w)
        t1 = torch.einsum("cmh,chw->cmw", Yw, planes[n, :c]).reshape(c, topk, 7, w)
        if has_next:
            Yw_n = axis_weights_dense(y_next.reshape(-1), h, padh, th).reshape(c, topk * 7, h)
            t1n = torch.einsum("cmh,chw->cmw", Yw_n, planes[n, 1 : c + 1]).reshape(c, topk, 7, w)
            t1 = torch.where(over[..., None], t1n, t1)
        win = win + torch.einsum("ckyw,ckxw->ckyx", t1, Xw)
    win = win / s

    scores = win.reshape(c, topk, 49)
    center = win[:, :, 3, 3]
    return _refine_and_pack(scores, center, yy, xx, in_bounds, valid, counts, max_peaks)


def refined_peaks_lowres(
    parts_low: torch.Tensor,  # (S, h, w, >=P) low-res maps (NHWC)
    heat: torch.Tensor,  # (P, th, tw) the upsampled scale-averaged maps
    threshold,
    max_peaks: int,
    start_scale: float,
    scale_gap: float,
) -> torch.Tensor:
    """NMS peaks of ``heat`` with the refinement windows read from low-res."""
    c, th, tw = heat.shape
    mask = find_peaks_mask(heat, threshold)
    kb = block_keys(mask, th, tw)
    peak_pos, valid, counts = compact_keys(kb, th * tw, max_peaks)
    return refine_from_low(parts_low, peak_pos, valid, counts, (th, tw),
                           max_peaks, start_scale, scale_gap)

