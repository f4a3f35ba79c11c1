"""PAF limb assembly: candidate scoring on the device + greedy bipartite
matching and person subset growth on the host.

Counterpart of ``caffe_rtpose_tpu/pose/connect.py`` (a faithful
re-expression of connectLimbsCOCO / connectLimbs, reference
examples/rtpose/rtpose.cpp:808-1076 / 549-751):

* :func:`score_pairs_lowres` — the O(limbs * nA * nB * 10) PAF line
  integrals, in torch on the device, sampling the upsampled maps straight
  from the low-res network output (the realtime path);
* :func:`score_pairs` — the same integrals gathered from the full-res maps
  (the heatmap path);
* :func:`assemble` — the sequential greedy matching, numpy, copied from the
  JAX package; :func:`assemble_fast` runs the native C++ version of it
  (``native/pose_host.cpp``) when that builds.

Numerical notes kept bit-faithful:
* sample coordinates use C ``round()`` = half-away-from-zero; coordinates are
  non-negative so ``floor(x + 0.5)`` is exact;
* the COCO variant clamps sample coords to the map (rtpose.cpp:920-927), the
  MPI variant does not;
* candidate rows are sorted by connection score (double) descending
  (ColumnCompare, rtpose.cpp:144-152); we use a stable sort, which fixes the
  reference's unspecified tie order;
* subset bookkeeping is float64, matching the reference's
  ``vector<vector<double>>``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.imresize import axis_weights_dense, scale_pads
from .descriptor import RENDER_MAX_PEOPLE, ConnectParams, ModelDescriptor

NUM_INTER = 10  # line-integral samples (rtpose.cpp num_inter)


def _sample_geometry(peaks: torch.Tensor, desc: ModelDescriptor, th: int, tw: int):
    """Every limb's candidate pairs -> unit vectors (vx, vy), the pair
    distance ``norm`` (all (L, P, P)) and the 10 integer sample coords
    (sy, sx) on each segment (L, P, P, 10), rounded and clamped as the
    reference does."""
    L = desc.num_limbs
    dev = peaks.device
    limb_a = _index([desc.limb(k)[0] for k in range(L)], dev)
    limb_b = _index([desc.limb(k)[1] for k in range(L)], dev)

    cand_a = peaks[limb_a, 1:, :]
    cand_b = peaks[limb_b, 1:, :]
    ax = cand_a[:, :, None, 0]
    ay = cand_a[:, :, None, 1]
    bx = cand_b[:, None, :, 0]
    by = cand_b[:, None, :, 1]
    dx = bx - ax
    dy = by - ay
    norm = torch.sqrt(dx * dx + dy * dy)
    inv = torch.where(norm < 1e-6, torch.zeros_like(norm), 1.0 / torch.clamp_min(norm, 1e-12))

    lm = torch.arange(NUM_INTER, dtype=torch.float32, device=dev).reshape(1, 1, 1, NUM_INTER)
    # C round() of non-negative values
    sx = torch.floor(ax[..., None] + lm * dx[..., None] / NUM_INTER + 0.5).to(torch.int32)
    sy = torch.floor(ay[..., None] + lm * dy[..., None] / NUM_INTER + 0.5).to(torch.int32)
    if desc.clamp_samples:  # COCO (rtpose.cpp:920-927); MPI does not clamp
        sx = torch.clamp_max(sx, tw - 1)
        sy = torch.clamp_max(sy, th - 1)
    # always clamp for memory safety; the unclamped MPI path would read OOB
    sx = torch.clamp(sx, 0, tw - 1)
    sy = torch.clamp(sy, 0, th - 1)
    return dx * inv, dy * inv, norm, sy, sx


def _score(vx, vy, norm, px, py, inter_threshold):
    """Sample dots -> (pair_score, pair_count): the sum of the dots above
    ``inter_threshold`` and how many there were (0 for coincident peaks)."""
    dots = vx[..., None] * px + vy[..., None] * py
    thr = torch.as_tensor(inter_threshold, dtype=torch.float32, device=dots.device)
    qual = dots > thr
    pair_score = torch.where(qual, dots, torch.zeros_like(dots)).sum(dim=-1)
    pair_count = qual.sum(dim=-1, dtype=torch.int32)
    distinct = norm >= 1e-6
    pair_count = torch.where(distinct, pair_count, torch.zeros_like(pair_count))
    return pair_score, pair_count


def _index(vals, dev):
    return torch.as_tensor(vals, dtype=torch.int64, device=dev)


def _paf_index(desc: ModelDescriptor, dev):
    """(paf_x, paf_y): each limb's x and y PAF channel."""
    return tuple(_index([desc.paf_channels(k)[i] for k in range(desc.num_limbs)], dev)
                 for i in (0, 1))


def score_pairs(
    heatmap: torch.Tensor,  # (C_total, H, W) resized maps (parts + bkg + PAFs)
    peaks: torch.Tensor,  # (num_parts, max_peaks+1, 3)
    desc: ModelDescriptor,
    inter_threshold,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate scoring for every limb and peak pair on the full-res maps:
    each sample is a gather from the limb's two PAF planes.

    Returns (pair_score, pair_count), both (num_limbs, max_peaks, max_peaks)
    float32/int32, as :func:`score_pairs_lowres`.
    """
    c_total, h, w = heatmap.shape
    max_peaks = peaks.shape[1] - 1
    L = desc.num_limbs
    dev = heatmap.device
    vx, vy, norm, sy, sx = _sample_geometry(peaks, desc, h, w)
    flat = (sy.to(torch.int64) * w + sx).reshape(L, -1)  # (L, P*P*10)
    paf_x, paf_y = _paf_index(desc, dev)
    hm = heatmap.to(torch.float32).reshape(-1)
    shape = (L, max_peaks, max_peaks, NUM_INTER)
    px = hm.index_select(0, (paf_x[:, None] * (h * w) + flat).reshape(-1)).reshape(shape)
    py = hm.index_select(0, (paf_y[:, None] * (h * w) + flat).reshape(-1)).reshape(shape)
    return _score(vx, vy, norm, px, py, inter_threshold)


def score_pairs_lowres(
    lowres: torch.Tensor,  # (S, h, w, C_total) net-output maps, NHWC (concat_stage7)
    peaks: torch.Tensor,  # (num_parts, max_peaks+1, 3)
    desc: ModelDescriptor,
    target_hw: Tuple[int, int],
    start_scale: float,
    scale_gap: float,
    inter_threshold,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate scoring for every limb and peak pair, sampling the
    upsampled, scale-averaged PAF maps from the low-res network output: the
    upsampled value at integer (Y, X) is ``mean_n Ay_n[Y] @ src_n @ Ax_n[X]^T``.

    Returns (pair_score, pair_count): both (num_limbs, max_peaks, max_peaks)
    float32/int32, pair_score = sum of the sample dots above
    ``inter_threshold`` and pair_count = how many there were (0 for
    coincident peaks).  The host applies the count and slot gates.
    """
    s, h, w, c_total = lowres.shape
    th, tw = target_hw
    max_peaks = peaks.shape[1] - 1
    L = desc.num_limbs
    dev = lowres.device
    src = lowres.to(torch.float32)
    vx, vy, norm, sy, sx = _sample_geometry(peaks, desc, th, tw)

    M = max_peaks * max_peaks * NUM_INTER
    paf_x, paf_y = _paf_index(desc, dev)
    chw = src.permute(0, 3, 1, 2)  # (S, C_total, h, w)
    planes = torch.stack([chw[:, paf_x], chw[:, paf_y]], dim=2)  # (S, L, 2, h, w)

    ys_all = sy.reshape(L * M)
    xs_all = sx.reshape(L * M)
    val_x = torch.zeros((L, M), dtype=torch.float32, device=dev)
    val_y = torch.zeros((L, M), dtype=torch.float32, device=dev)
    for n in range(s):
        padh, padw = scale_pads(h, w, n, start_scale, scale_gap)
        Yd = axis_weights_dense(ys_all, h, padh, th).reshape(L, M, h)
        Xd = axis_weights_dense(xs_all, w, padw, tw).reshape(L, M, w)
        # contract the wide axis (w) first, then multiply-reduce over h
        tmp = torch.einsum("lchw,lmw->lcmh", planes[n], Xd)  # (L, 2, M, h)
        v = torch.einsum("lcmh,lmh->lcm", tmp, Yd)
        val_x = val_x + v[:, 0]
        val_y = val_y + v[:, 1]

    px = (val_x / s).reshape(L, max_peaks, max_peaks, NUM_INTER)
    py = (val_y / s).reshape(L, max_peaks, max_peaks, NUM_INTER)
    return _score(vx, vy, norm, px, py, inter_threshold)


@dataclass
class AssembleResult:
    joints: np.ndarray  # (num_people, num_parts, 3): x, y (net coords scaled), score
    num_people: int
    subsets: List[np.ndarray]


def assemble(
    peaks: np.ndarray,  # (num_parts, max_peaks+1, 3)
    pair_score: np.ndarray,  # (L, P, P) summed qualified dots
    pair_count: np.ndarray,  # (L, P, P)
    desc: ModelDescriptor,
    params: ConnectParams,
    scale_xy: Tuple[float, float] = (1.0, 1.0),
    dedup_single_endpoint: Optional[bool] = None,
    max_people: int = RENDER_MAX_PEOPLE,
) -> AssembleResult:
    """Host-side greedy matching + subset growth (connectLimbs[COCO]).

    ``scale_xy`` mirrors the display rescale (DISPLAY_RES / NET_RES) baked
    into the reference joint output (rtpose.cpp:1058-1060).
    ``dedup_single_endpoint``: the COCO variant skips re-adding single-part
    subsets whose peak is already claimed (rtpose.cpp:849-895); defaults to
    the descriptor's variant.
    """
    num_parts = desc.num_parts
    L = desc.num_limbs
    max_peaks = peaks.shape[1] - 1
    peaks_flat = np.asarray(peaks, np.float64).reshape(-1)
    peaks_offset = 3 * (max_peaks + 1)
    if dedup_single_endpoint is None:
        dedup_single_endpoint = desc.clamp_samples  # COCO behavior

    SUBSET_CNT = num_parts + 2
    SUBSET_SCORE = num_parts + 1
    SUBSET_SIZE = num_parts + 3
    subsets: List[np.ndarray] = []

    for k in range(L):
        part_a, part_b = desc.limb(k)
        cand_a = peaks[part_a]
        cand_b = peaks[part_b]
        nA = min(int(cand_a[0, 0]), max_peaks)
        nB = min(int(cand_b[0, 0]), max_peaks)

        if nA == 0 and nB == 0:
            continue
        if nA == 0:
            for i in range(1, nB + 1):
                off = part_b * peaks_offset + i * 3 + 2
                if dedup_single_endpoint and any(s[part_b] == off for s in subsets):
                    continue
                row = np.zeros(SUBSET_SIZE, np.float64)
                row[part_b] = off
                row[SUBSET_CNT] = 1
                row[SUBSET_SCORE] = cand_b[i, 2]
                subsets.append(row)
            continue
        if nB == 0:
            for i in range(1, nA + 1):
                off = part_a * peaks_offset + i * 3 + 2
                if dedup_single_endpoint and any(s[part_a] == off for s in subsets):
                    continue
                row = np.zeros(SUBSET_SIZE, np.float64)
                row[part_a] = off
                row[SUBSET_CNT] = 1
                row[SUBSET_SCORE] = cand_a[i, 2]
                subsets.append(row)
            continue

        # candidate rows: [i, j, connection_score, total_score]
        temp: List[Tuple[int, int, float]] = []
        for i in range(1, nA + 1):
            for j in range(1, nB + 1):
                cnt = int(pair_count[k, i - 1, j - 1])
                if cnt > params.inter_min_above_threshold:
                    temp.append((i, j, float(pair_score[k, i - 1, j - 1]) / cnt))
        # sort by connection score descending (stable)
        temp.sort(key=lambda r: -r[2])

        connection_k: List[Tuple[float, float, float]] = []
        occur_a = np.zeros(nA, bool)
        occur_b = np.zeros(nB, bool)
        num = min(nA, nB)
        for i, j, score in temp:
            if len(connection_k) == num:
                break
            if not occur_a[i - 1] and not occur_b[j - 1]:
                connection_k.append(
                    (part_a * peaks_offset + i * 3 + 2, part_b * peaks_offset + j * 3 + 2, score)
                )
                occur_a[i - 1] = True
                occur_b[j - 1] = True

        if k == 0:
            for idx_a, idx_b, score in connection_k:
                row = np.zeros(SUBSET_SIZE, np.float64)
                row[desc.limb_sequence[0]] = idx_a
                row[desc.limb_sequence[1]] = idx_b
                row[SUBSET_CNT] = 2
                row[SUBSET_SCORE] = peaks_flat[int(idx_a)] + peaks_flat[int(idx_b)] + score
                subsets.append(row)
        else:
            if not connection_k:
                continue
            for idx_a, idx_b, score in connection_k:
                found = 0
                for s in subsets:
                    if s[part_a] == idx_a:
                        s[part_b] = idx_b
                        found += 1
                        s[SUBSET_CNT] += 1
                        s[SUBSET_SCORE] += peaks_flat[int(idx_b)] + score
                if found == 0:
                    row = np.zeros(SUBSET_SIZE, np.float64)
                    row[part_a] = idx_a
                    row[part_b] = idx_b
                    row[SUBSET_CNT] = 2
                    row[SUBSET_SCORE] = peaks_flat[int(idx_a)] + peaks_flat[int(idx_b)] + score
                    subsets.append(row)

    # final filter + joint emission (rtpose.cpp:1044-1070)
    sx, sy = scale_xy
    people = []
    for s in subsets:
        if s[SUBSET_CNT] >= params.min_subset_cnt and (s[SUBSET_SCORE] / s[SUBSET_CNT]) > params.min_subset_score:
            joints = np.zeros((num_parts, 3), np.float32)
            for j in range(num_parts):
                idx = int(s[j])
                if idx:
                    joints[j, 2] = peaks_flat[idx]
                    joints[j, 1] = peaks_flat[idx - 1] * sy
                    joints[j, 0] = peaks_flat[idx - 2] * sx
            people.append(joints)
            if len(people) == max_people:
                break
    joints_arr = np.stack(people) if people else np.zeros((0, num_parts, 3), np.float32)
    return AssembleResult(joints=joints_arr, num_people=len(people), subsets=subsets)


def assemble_fast(
    peaks: np.ndarray,
    pair_score: np.ndarray,
    pair_count: np.ndarray,
    desc: ModelDescriptor,
    params: ConnectParams,
    scale_xy: Tuple[float, float] = (1.0, 1.0),
    max_people: int = RENDER_MAX_PEOPLE,
) -> AssembleResult:
    """Greedy assembly via the native C++ runtime when available (see
    native/pose_host.cpp), else the numpy path."""
    from .. import native

    nat = native.assemble_native(peaks, pair_score, pair_count, desc, params,
                                 scale_xy, max_people)
    if nat is not None:
        joints, n = nat
        return AssembleResult(joints=joints, num_people=n, subsets=[])
    return assemble(peaks, pair_score, pair_count, desc, params, scale_xy,
                    max_people=max_people)
