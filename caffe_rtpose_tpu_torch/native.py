"""ctypes binding to the native host runtime (``native/pose_host.cpp``, the
greedy limb assembly shared with the JAX package).

The library is built with g++ at first use into the port's git-ignored
``_build/`` directory (never into ``native/``).  When the source or the
toolchain is unavailable the callers fall back to the numpy
``pose.connect.assemble``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import Optional

import numpy as np

from . import _build

SRC = os.path.join(os.path.dirname(_build.PKG_DIR), "native", "pose_host.cpp")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def load() -> Optional[ctypes.CDLL]:
    """The assembly library, or None when it cannot be built here."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        gxx = shutil.which("g++")
        if gxx is None or not os.path.exists(SRC):
            return None
        try:
            path = _build.build_library(
                "pose_host", [SRC], gxx, ("-O2", "-shared", "-fPIC", "-std=c++17"))
            lib = ctypes.CDLL(path)
        except (RuntimeError, OSError):
            return None
        lib.crt_assemble.restype = ctypes.c_int
        lib.crt_assemble.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        _lib = lib
        return lib


def assemble_native(peaks, pair_score, pair_count, desc, params, scale_xy=(1.0, 1.0),
                    max_people: int = 96):
    """Native greedy assembly; returns (joints (n, parts, 3), num_people) or
    None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    peaks = np.ascontiguousarray(peaks, np.float32)
    pair_score = np.ascontiguousarray(pair_score, np.float32)
    pair_count = np.ascontiguousarray(pair_count, np.int32)
    limb_seq = np.ascontiguousarray(desc.limb_sequence, dtype=np.int32)
    num_parts = desc.num_parts
    max_peaks = peaks.shape[1] - 1
    L = desc.num_limbs
    if peaks.shape != (num_parts, max_peaks + 1, 3) or \
            pair_score.shape != (L, max_peaks, max_peaks) or \
            pair_count.shape != (L, max_peaks, max_peaks):
        raise ValueError(f"assemble_native: shapes {peaks.shape} {pair_score.shape} "
                         f"{pair_count.shape} do not fit {desc.name}")
    joints = np.zeros((max_people, num_parts, 3), np.float32)
    n = lib.crt_assemble(
        peaks.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_parts, max_peaks,
        pair_score.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        pair_count.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        limb_seq.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), L,
        params.min_subset_cnt, params.min_subset_score,
        params.inter_min_above_threshold,
        1 if desc.clamp_samples else 0,
        float(scale_xy[0]), float(scale_xy[1]),
        joints.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_people,
    )
    return joints[:n].copy(), n
