"""Build the port's native code at first use.

* ``load_kernels()``: every ``csrc/*.cu`` (K1 ``peak_mask.cu``, K3
  ``upsample_peak_keys.cu``, K4 ``conv1_block.cu``) compiled for Hopper
  (``sm_90a``), one ``nvcc`` a source, all started together, and linked
  into one shared library with a plain C interface, loaded with ctypes; the
  ``csrc/*.cuh`` headers they include count towards the hash.
  Missing ``nvcc`` or a failed build raises with the compiler's output.
* ``build_library()``: the shared compile-and-cache step, also used with
  g++ by ``native.py`` for the host assembly library and by the host codecs
  (``pipeline/jpeg.py``, ``pipeline/mpeg4.py``, ``utils/text.py``); the
  JPEG and MPEG-4 ones pass the header they share, ``csrc/ffmpeg_dsp.h``,
  so that an edit of it rebuilds both.

Libraries go to ``caffe_rtpose_tpu_torch/_build/`` (git-ignored); each file
name carries a hash of its sources and flags, so a stale library is never
loaded.  The build writes to a temporary name and renames it into place, so
a concurrent or interrupted build never leaves a half-written library.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

from .utils.device import nvcc_path

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_kernels: Optional[ctypes.CDLL] = None
build_log: Dict[str, str] = {}  # stem -> compiler output of the last build in this process


def build_library(stem: str, sources: Sequence[str], compiler: str,
                  flags: Sequence[str], timeout: float = 600.0,
                  headers: Sequence[str] = ()) -> str:
    """Compile ``sources`` into ``_build/lib<stem>_<hash>.so`` unless that
    file exists; returns its path.  The hash covers ``sources``, the
    ``headers`` they include and ``flags``.  Each source compiles to an
    object (``flags`` without ``-shared``, plus ``-c``), all in parallel,
    and one more call links them."""
    h = hashlib.sha256()
    for src in [*sources, *headers]:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    h.update("\0".join(flags).encode())
    path = os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    objs = [f"{tmp}.{i}.o" for i in range(len(sources))]
    obj_flags = [f for f in flags if f != "-shared"] + ["-c"]
    with ThreadPoolExecutor(len(sources)) as pool:
        steps = list(pool.map(lambda so: _run([compiler, *obj_flags, "-o", so[1], so[0]],
                                              timeout),
                              zip(sources, objs)))
    if all(ok for ok, _ in steps):
        steps.append(_run([compiler, *flags, "-o", tmp, *objs], timeout))
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    build_log[stem] = "".join(log for _, log in steps) + f"({time.perf_counter() - t0:.1f} s)\n"
    if not all(ok for ok, _ in steps):
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"build of {stem} failed:\n{build_log[stem]}")
    os.replace(tmp, path)
    return path


def _run(cmd: List[str], timeout: float):
    """One compiler call -> (succeeded, its command line and output)."""
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return False, f"{' '.join(cmd)}\ntimed out after {timeout:.0f} s\n"
    return res.returncode == 0, (f"{' '.join(cmd)}\n{res.stdout}{res.stderr}"
                                 + ("" if res.returncode == 0 else f"(exit {res.returncode})\n"))


def load_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the CUDA kernel library.  After the
    first call, a plain read: no lock and no file system access."""
    global _kernels
    if _kernels is not None:
        return _kernels
    with _lock:
        if _kernels is not None:
            return _kernels
        nvcc = nvcc_path()
        if nvcc is None:
            raise RuntimeError("nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): "
                               "the CUDA kernels cannot be built")
        sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
        headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
        lib = ctypes.CDLL(build_library("crt_kernels", sources, nvcc, NVCC_FLAGS,
                                        headers=headers))
        _declare(lib)
        _kernels = lib
        return lib


def _declare(lib: ctypes.CDLL) -> None:
    vp, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.crt_cuda_error_string.restype = ctypes.c_char_p
    lib.crt_cuda_error_string.argtypes = [i]
    lib.crt_tile_smem_bytes.restype = ll
    lib.crt_tile_smem_bytes.argtypes = [i, i, i]  # S, widest window rows, columns
    lib.crt_peak_mask.restype = i
    lib.crt_peak_mask.argtypes = [
        vp, ll, ll, ll, ll, ll,  # low + strides (f, s, y, x, c) in elements
        i, i, i, i, i,       # F, S, C, th, tw
        vp, vp, vp, vp,      # y tap idx/w, x tap idx/w
        vp, vp, i, i, i,     # y/x windows, widest window rows/columns, 16-byte loads
        f, vp, vp, vp,       # inv_s, thr (f32 device scalar), mask, stream
    ]
    lib.crt_keys_smem_bytes.restype = ll
    lib.crt_keys_smem_bytes.argtypes = [i, i, i, i]  # S, tile rows, window rows, pitch
    lib.crt_upsample_peak_keys.restype = i
    lib.crt_upsample_peak_keys.argtypes = [
        vp, ll, ll, ll, ll,  # low + strides (s, y, x, c) in elements
        i, i, i, i, i, i,    # S, C, th, tw, key_channels, tile rows
        vp, vp, vp, vp,      # y tap w/offsets, x tap w/offsets
        vp, vp, i, i,        # y/x windows, widest window rows, window pitch
        f, i, vp, vp, vp, vp,  # inv_s, TMA stores, thr (f32 device scalar), heat, keys, stream
    ]
    lib.crt_conv1_smem_bytes.restype = ll
    lib.crt_conv1_smem_bytes.argtypes = []
    lib.crt_conv1_prepare.restype = i
    lib.crt_conv1_prepare.argtypes = []
    lib.crt_conv1_block.restype = i
    lib.crt_conv1_block.argtypes = [
        vp, ll, ll, ll, ll,  # x (bf16) + strides (b, c, y, x) in elements
        i, i, i,             # B, H, W
        vp, vp, vp, vp,      # w1 packed (64, 64) bf16, b1, w2 packed (9, 64, 64) bf16, b2
        vp, i, vp,           # out (B, H/2, W/2, 64) bf16, grid cap (SM count), stream
    ]
