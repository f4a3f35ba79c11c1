"""Joint-order conversion and left/right flip-swap tables for EVERY np mode
the reference CPM training transformer supports.

``transform_joints`` reimplements DataTransformer::TransformJoints
(reference src/caffe/data_transformer.cpp:718-1145): it converts a person's
annotation from the stored ``np_in_lmdb`` order (MPII 16-joint or COCO
17-keypoint) into the ``num_parts`` (np) training layout, synthesizing
averaged/interpolated auxiliary points per mode.  ``SWAP_TABLES`` carries
the per-np left/right part exchanges applied on horizontal flips
(swapLeftRight, :1708-1907).

Faithfulness notes (quirks preserved on purpose, they are the behavior a
reference-trained model saw):
- visibility merge for the MPI modes 27/28/29 is two-valued (2 wins, else
  logical AND) while the COCO-era modes also propagate 3 ("absent");
- the np==33 and np==34 midpoint loops contain an indexing bug upstream:
  their ==3 else-if tests the SOURCE visibility at index i (not the
  midpoint endpoints) and assigns jo.isVisible[i] — clobbering base-joint
  visibility and leaving the midpoint's at its default — transcribed
  literally;
- modes that fill fewer slots than np (37 and 56 fill 18) leave the rest
  default-initialized (point (0,0), visibility 0), exactly like
  ``std::vector::resize``.

A copy of ``caffe_rtpose_tpu/training/joints.py`` (numpy only), which cannot
be imported without jax.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# ---------------------------------------------------------------- tables

# swapLeftRight right/left part id pairs (1-indexed), :1708-1907
SWAP_TABLES: Dict[int, Tuple[List[int], List[int]]] = {
    9: ([1, 2, 3, 7], [4, 5, 6, 8]),
    14: ([3, 4, 5, 9, 10, 11], [6, 7, 8, 12, 13, 14]),
    27: ([3, 4, 5, 9, 10, 11, 15, 18, 19, 20, 24, 25],
         [6, 7, 8, 12, 13, 14, 16, 21, 22, 23, 26, 27]),
    28: ([3, 4, 5, 9, 10, 11, 18, 19, 20, 24, 25],
         [6, 7, 8, 12, 13, 14, 21, 22, 23, 26, 27]),
    29: ([3, 4, 5, 9, 10, 11, 15, 18, 19, 20, 24, 25],
         [6, 7, 8, 12, 13, 14, 16, 21, 22, 23, 26, 27]),
    33: ([3, 4, 5, 9, 10, 11, 15, 17, 20, 21, 22, 26, 27, 30, 32],
         [6, 7, 8, 12, 13, 14, 16, 18, 23, 24, 25, 28, 29, 31, 33]),
    34: ([3, 4, 5, 9, 10, 11, 15, 17, 20, 21, 22, 26, 27, 32],
         [6, 7, 8, 12, 13, 14, 16, 18, 23, 24, 25, 28, 29, 33]),
    36: ([1, 3, 5, 7, 10, 11, 12, 13, 14, 15, 23, 24, 25, 26, 32, 33],
         [2, 4, 6, 8, 17, 16, 19, 18, 21, 20, 28, 27, 30, 29, 35, 34]),
    37: ([3, 4, 5, 9, 10, 11, 15, 17], [6, 7, 8, 12, 13, 14, 16, 18]),
    43: ([3, 4, 5, 9, 10, 11, 18, 19, 20, 21, 22, 23, 32, 33, 34, 35, 36, 37],
         [6, 7, 8, 12, 13, 14, 24, 25, 26, 27, 28, 29, 38, 39, 40, 41, 42, 43]),
    52: ([3, 4, 5, 9, 10, 11, 15, 17, 19, 20, 21, 22, 23, 24, 31, 32, 33, 34,
          35, 36, 37, 38, 49, 51],
         [6, 7, 8, 12, 13, 14, 16, 18, 25, 26, 27, 28, 29, 30, 39, 40, 41, 42,
          43, 44, 45, 46, 50, 52]),
    56: ([3, 4, 5, 9, 10, 11, 15, 17], [6, 7, 8, 12, 13, 14, 16, 18]),
    75: ([3, 4, 5, 9, 10, 11, 15, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 37,
          38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 64, 65, 66, 70, 71, 72],
         [6, 7, 8, 12, 13, 14, 16, 18, 28, 29, 30, 31, 32, 33, 34, 35, 36, 49,
          50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 67, 68, 69, 73, 74, 75]),
    78: ([1, 3, 5, 7, 9, 11, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 35, 36,
          37, 38, 39, 40, 41, 42, 52, 53, 54, 55, 56, 57, 65, 66, 67, 68, 74,
          75],
         [2, 4, 6, 8, 10, 12, 25, 24, 27, 26, 29, 28, 31, 30, 33, 32, 44, 43,
          46, 45, 48, 47, 50, 49, 59, 58, 61, 60, 63, 62, 70, 69, 72, 71, 77,
          76]),
}

# MPII 16-joint source -> "ours" base order (:732, :741-746, :760-765, ...)
_MPI14 = [9, 8, 12, 11, 10, 13, 14, 15, 2, 1, 0, 3, 4, 5]
_MPI27_1 = _MPI14 + [8, 8, 9, 8, 12, 11, 8, 13, 14, 2, 1, 3, 4]
_MPI27_2 = _MPI14 + [2, 3, 8, 12, 11, 10, 13, 14, 15, 1, 0, 4, 5]
_MPI28_1 = _MPI14 + [7, 6, 9, 8, 12, 11, 8, 13, 14, 2, 1, 3, 4, 6]
_MPI28_2 = _MPI14 + [7, 6, 8, 12, 11, 10, 13, 14, 15, 1, 0, 4, 5, 7]
_MPI43_1 = _MPI14 + [7]
_MPI43_2 = _MPI14 + [6]

# COCO 17-keypoint source -> 18-part "ours" order (1-indexed, :808-809 etc.)
COCO_TO_OURS_1 = [1, 6, 7, 9, 11, 6, 8, 10, 13, 15, 17, 12, 14, 16, 3, 2, 5, 4]
COCO_TO_OURS_2 = [1, 7, 7, 9, 11, 6, 8, 10, 13, 15, 17, 12, 14, 16, 3, 2, 5, 4]


def _merge_vis2(va: int, vb: int) -> int:
    """MPI-style: 2 wins, else logical AND (:745-751)."""
    if va == 2 or vb == 2:
        return 2
    return int(bool(va) and bool(vb))


def _merge_vis3(va: int, vb: int) -> int:
    """COCO-style: 2 wins, then 3, else logical AND (:816-826)."""
    if va == 2 or vb == 2:
        return 2
    if va == 3 or vb == 3:
        return 3
    return int(bool(va) and bool(vb))


def _avg_map(j, v, idx1, idx2, one_indexed: bool, merge):
    n = len(idx1)
    jo = np.zeros((n, 2), np.float32)
    vo = np.zeros(n, np.int32)
    off = 1 if one_indexed else 0
    for i in range(n):
        a, b = idx1[i] - off, idx2[i] - off
        jo[i] = (j[a] + j[b]) * 0.5
        vo[i] = merge(int(v[a]), int(v[b]))
    return jo, vo


def transform_joints(joints: np.ndarray, visible: np.ndarray,
                     np_target: int) -> Tuple[np.ndarray, np.ndarray]:
    """TransformJoints: (np_in_lmdb, 2) + (np_in_lmdb,) -> np_target arrays.

    MPI modes (14/27/28/29/43) expect 16-joint MPII annotations; COCO
    modes (33/34/37/52/56) expect 17 keypoints; 36 is a COCO torso subset.
    Unknown np (e.g. np == np_in_lmdb, or 75/78 whose TransformJoints
    branch doesn't exist upstream) passes annotations through unchanged —
    exactly the reference's fall-through.
    """
    j = np.asarray(joints, np.float32)
    v = np.asarray(visible, np.int32)
    npx = int(np_target)

    if npx == 14:
        jo = j[_MPI14].copy()
        vo = v[_MPI14].copy()
        return jo, vo

    if npx in (27, 28):
        i1 = _MPI27_1 if npx == 27 else _MPI28_1
        i2 = _MPI27_2 if npx == 27 else _MPI28_2
        return _avg_map(j, v, i1, i2, False, _merge_vis2)

    if npx == 29:
        jo28, vo28 = _avg_map(j, v, _MPI28_1, _MPI28_2, False, _merge_vis2)
        jo = np.zeros((29, 2), np.float32)
        vo = np.zeros(29, np.int32)
        jo[:28], vo[:28] = jo28, vo28
        jo[28], vo[28] = jo[27], vo[27]
        corr_1 = [8, 11, 1]
        change = [14, 15, 27]
        for i in range(3):
            jo[change[i]] = (jo[corr_1[i]] + jo[28]) * 0.5
            vo[change[i]] = _merge_vis2(int(vo[corr_1[i]]), int(vo[28]))
        return jo, vo

    if npx in (33, 34):
        jo = np.zeros((npx, 2), np.float32)
        vo = np.zeros(npx, np.int32)
        jo18, vo18 = _avg_map(j, v, COCO_TO_OURS_1, COCO_TO_OURS_2, True,
                              _merge_vis3)
        jo[:18], vo[:18] = jo18, vo18
        if npx == 33:
            mid_1 = [1, 3, 3, 4, 6, 6, 7, 9, 10, 12, 13, 3, 6, 15, 16]
            mid_2 = [2, 17, 4, 5, 18, 7, 8, 10, 11, 13, 14, 9, 12, 17, 18]
        else:
            mid_1 = [15, 3, 3, 4, 6, 6, 7, 9, 10, 12, 13, 9, 2, 15, 16, 1]
            mid_2 = [16, 17, 4, 5, 18, 7, 8, 10, 11, 13, 14, 12, 30, 17, 18, 2]
        for i in range(len(mid_1)):
            a, b = mid_1[i] - 1, mid_2[i] - 1
            # reference bug preserved (:833-838, :871-876): the ==3 case
            # tests the SOURCE joints at loop index i and writes
            # jo.isVisible[i], leaving the midpoint's visibility at 0
            if vo[a] == 2 or vo[b] == 2:
                vo[i + 18] = 2
            elif (v[COCO_TO_OURS_1[i] - 1] == 3
                  or v[COCO_TO_OURS_2[i] - 1] == 3):
                vo[i] = 3
            else:
                vo[i + 18] = _merge_vis2(int(vo[a]), int(vo[b]))
            # np==34 indexes jo.joints[30-1] before slot 29 is written —
            # reads the default (0,0), as the C++ resize leaves it
            jo[i + 18] = jo[a] * 0.5 + jo[b] * 0.5
        return jo, vo

    if npx == 36:
        coco = [7, 6, 9, 8, 11, 10, 13, 12]
        jo = np.zeros((36, 2), np.float32)
        vo = np.zeros(36, np.int32)
        for i in range(8):
            jo[i] = j[coco[i] - 1]
            vo[i] = v[coco[i] - 1]
        cnt = 8
        for a in range(1, 8):
            for b in range(a + 1, 9):
                vo[cnt] = _merge_vis3(int(vo[a - 1]), int(vo[b - 1]))
                jo[cnt] = jo[a - 1] * 0.5 + jo[b - 1] * 0.5
                cnt += 1
        return jo, vo

    if npx in (37, 56):
        jo = np.zeros((npx, 2), np.float32)
        vo = np.zeros(npx, np.int32)
        jo18, vo18 = _avg_map(j, v, COCO_TO_OURS_1, COCO_TO_OURS_2, True,
                              _merge_vis3)
        jo[:18], vo[:18] = jo18, vo18
        return jo, vo

    if npx == 43:
        jo = np.zeros((43, 2), np.float32)
        vo = np.zeros(43, np.int32)
        jo15, vo15 = _avg_map(j, v, _MPI43_1, _MPI43_2, False, _merge_vis3)
        jo[:15], vo[:15] = jo15, vo15
        mid_1 = [0, 1, 2, 3, 1, 5, 6, 1, 14, 8, 9, 14, 11, 12]
        mid_2 = [1, 2, 3, 4, 5, 6, 7, 14, 8, 9, 10, 11, 12, 13]
        for i in range(14):
            a, b = mid_1[i], mid_2[i]
            if vo[a] == 2 or vo[b] == 2:
                vo[2 * i + 15] = vo[2 * i + 16] = 2
            elif vo[a] == 3 or vo[b] == 3:
                vo[2 * i + 15] = vo[2 * i + 16] = 3
            else:
                vo[2 * i + 15] = _merge_vis2(int(vo[a]), int(vo[b]))
                vo[2 * i + 16] = vo[2 * i + 15]
            # cv::Point2f * double multiplies in f64 then casts to f32,
            # THEN the two points add in f32 — replicated exactly
            a23 = (jo[a].astype(np.float64) * 0.6667).astype(np.float32)
            a13 = (jo[a].astype(np.float64) * 0.3333).astype(np.float32)
            b23 = (jo[b].astype(np.float64) * 0.6667).astype(np.float32)
            b13 = (jo[b].astype(np.float64) * 0.3333).astype(np.float32)
            jo[2 * i + 15] = a23 + b13
            jo[2 * i + 16] = a13 + b23
        return jo, vo

    if npx == 52:
        jo = np.zeros((52, 2), np.float32)
        vo = np.zeros(52, np.int32)
        jo18, vo18 = _avg_map(j, v, COCO_TO_OURS_1, COCO_TO_OURS_2, True,
                              _merge_vis3)
        jo[:18], vo[:18] = jo18, vo18
        mid_1 = [2, 9, 10, 2, 12, 13, 2, 3, 4, 3, 2, 6, 7, 6, 2, 1, 1, 15, 16]
        mid_2 = [9, 10, 11, 12, 13, 14, 3, 4, 5, 17, 6, 7, 8, 18, 1, 15, 16,
                 17, 18]
        for i in range(15):  # thirds, slots 18..47 (:996-1012)
            a, b = mid_1[i] - 1, mid_2[i] - 1
            if vo[a] == 2 or vo[b] == 2:
                vo[2 * i + 18] = vo[2 * i + 19] = 2
            elif vo[a] == 3 or vo[b] == 3:
                vo[2 * i + 18] = vo[2 * i + 19] = 3
            else:
                vo[2 * i + 18] = _merge_vis2(int(vo[a]), int(vo[b]))
                vo[2 * i + 19] = vo[2 * i + 18]
            a23 = (jo[a].astype(np.float64) * 0.6667).astype(np.float32)
            a13 = (jo[a].astype(np.float64) * 0.3333).astype(np.float32)
            b23 = (jo[b].astype(np.float64) * 0.6667).astype(np.float32)
            b13 = (jo[b].astype(np.float64) * 0.3333).astype(np.float32)
            jo[2 * i + 18] = a23 + b13
            jo[2 * i + 19] = a13 + b23
        for i in range(15, 19):  # halves, slots 48..51 (:1014-1022)
            a, b = mid_1[i] - 1, mid_2[i] - 1
            vo[i + 33] = _merge_vis2(int(vo[a]), int(vo[b]))
            if vo[a] == 2 or vo[b] == 2:
                vo[i + 33] = 2
            jo[i + 33] = jo[a] * 0.5 + jo[b] * 0.5
        return jo, vo

    # fall-through: no conversion branch upstream
    return j.copy(), v.copy()


def swap_left_right(joints: np.ndarray, visible: np.ndarray,
                    np_target: int) -> None:
    """In-place flip-swap for the given np mode (swapLeftRight); nps
    without a table (the reference's fall-through) swap nothing."""
    table = SWAP_TABLES.get(int(np_target))
    if table is None:
        return
    right, left = table
    for r, l in zip(right, left):
        ri, li = r - 1, l - 1
        joints[[ri, li]] = joints[[li, ri]]
        visible[[ri, li]] = visible[[li, ri]]
