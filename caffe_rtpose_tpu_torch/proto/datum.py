"""Datum <-> numpy array helpers.

Parity with pycaffe's ``caffe.io.datum_to_array`` / ``array_to_datum``
(reference python/caffe/io.py:61-97) and the C++ ``CVMatToDatum`` /
``ReadImageToDatum`` helpers (src/caffe/util/io.cpp:125-248), built on the
clean-room wire codec.

A copy of ``caffe_rtpose_tpu/proto/datum.py``; ``cv2`` is imported only for
encoded (JPEG/PNG) datums.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import caffe_pb
from .wire import decode, encode


def array_to_datum(arr: np.ndarray, label: Optional[int] = None) -> dict:
    """3-D (C, H, W) array -> Datum message dict.  uint8 arrays go into
    ``data`` bytes; anything else into repeated ``float_data``."""
    if arr.ndim != 3:
        raise ValueError("array_to_datum expects a 3-D (C, H, W) array")
    datum = {
        "channels": int(arr.shape[0]),
        "height": int(arr.shape[1]),
        "width": int(arr.shape[2]),
    }
    if arr.dtype == np.uint8:
        datum["data"] = arr.tobytes()
    else:
        datum["float_data"] = [float(v) for v in arr.astype(np.float64).flat]
    if label is not None:
        datum["label"] = int(label)
    return datum


def datum_to_array(datum: dict) -> np.ndarray:
    """Datum message dict -> (C, H, W) array (u8 or f32)."""
    c = int(datum.get("channels", 0))
    h = int(datum.get("height", 0))
    w = int(datum.get("width", 0))
    data = datum.get("data", b"")
    if data:
        return np.frombuffer(data, np.uint8).reshape(c, h, w)
    return np.asarray(datum.get("float_data", []), np.float32).reshape(c, h, w)


def serialize_datum(datum: dict) -> bytes:
    return encode(datum, caffe_pb.SCHEMA, "Datum")


def parse_datum(buf: bytes) -> dict:
    return decode(buf, caffe_pb.SCHEMA, "Datum")


def image_to_datum(img_bgr: np.ndarray, label: int = 0, encode_fmt: str = "") -> dict:
    """HWC BGR u8 image -> Datum (optionally JPEG/PNG-encoded like
    ReadImageToDatum's encode path, io.cpp:141-170)."""
    if encode_fmt:
        import cv2

        ok, buf = cv2.imencode("." + encode_fmt.lstrip("."), img_bgr)
        if not ok:
            raise IOError("image encode failed")
        return {
            "channels": int(img_bgr.shape[2]) if img_bgr.ndim == 3 else 1,
            "height": int(img_bgr.shape[0]),
            "width": int(img_bgr.shape[1]),
            "data": buf.tobytes(),
            "label": int(label),
            "encoded": True,
        }
    chw = np.ascontiguousarray(np.transpose(img_bgr, (2, 0, 1)))
    return array_to_datum(chw, label)


def datum_to_image(datum: dict) -> np.ndarray:
    """Datum -> HWC BGR u8 (decoding JPEG/PNG when ``encoded``)."""
    if datum.get("encoded"):
        import cv2

        arr = np.frombuffer(datum["data"], np.uint8)
        gray = int(datum.get("channels", 3)) == 1
        img = cv2.imdecode(arr, cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
        if img is None:
            raise IOError("image decode failed")
        if img.ndim == 2:
            img = img[:, :, None]
        return img
    return np.transpose(datum_to_array(datum), (1, 2, 0))
