"""Datum <-> numpy array helpers.

Parity with pycaffe's ``caffe.io.datum_to_array`` / ``array_to_datum``
(reference python/caffe/io.py:61-97) and the C++ ``CVMatToDatum`` /
``ReadImageToDatum`` helpers (src/caffe/util/io.cpp:125-248), built on the
clean-room wire codec.

A copy of ``caffe_rtpose_tpu/proto/datum.py``, except that encoded datums
are written and read without OpenCV: PNG by ``pipeline/image_io.py``'s
``encode_png``, JPEG by the port's codec (``pipeline/jpeg.py``, the bytes of
``cv2.imencode`` at its default quality 95), BMP and PNM (``bmp``, ``pbm``,
``pgm``, ``ppm``, ``pnm``) by ``image_io``'s ``encode_bmp``/``encode_pnm``
(``cv2.imencode``'s bytes); every datum in those formats decodes by its
signature as ``cv2.imdecode`` decodes it (``image_io.decode_image``).
Other formats go through ``cv2`` where it is installed and raise
``ImportError`` naming the format without it.
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


def _cv2(fmt: str):
    """OpenCV, for the formats the port does not read or write."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{fmt!r}-encoded datums need OpenCV (cv2), which is not installed; "
                          "use png, jpg, bmp or pnm (--encode_type) or raw datums") from e
    return cv2


def image_to_datum(img_bgr: np.ndarray, label: int = 0, encode_fmt: str = "") -> dict:
    """HWC BGR u8 image -> Datum (optionally encoded like
    ReadImageToDatum's encode path, io.cpp:141-170)."""
    if encode_fmt:
        from ..pipeline import image_io

        fmt = encode_fmt.lstrip(".").lower()
        if fmt == "png":
            data = image_io.encode_png(img_bgr[:, :, 0] if img_bgr.ndim == 3 and img_bgr.shape[2] == 1
                                       else img_bgr)
        elif fmt in ("jpg", "jpeg"):
            from ..pipeline.jpeg import encode_jpeg

            data = encode_jpeg(img_bgr)
        elif fmt == "bmp":
            data = image_io.encode_bmp(img_bgr)
        elif fmt in image_io.PNM_KINDS:
            try:
                data = image_io.encode_pnm(img_bgr, fmt)
            except ValueError as e:  # cv2.imencode refuses it too
                raise IOError(f"image encode failed: {e}") from e
        else:
            ok, buf = _cv2(fmt).imencode("." + fmt, img_bgr)
            if not ok:
                raise IOError("image encode failed")
            data = buf.tobytes()
        return {
            "channels": int(img_bgr.shape[2]) if img_bgr.ndim == 3 else 1,
            "height": int(img_bgr.shape[0]),
            "width": int(img_bgr.shape[1]),
            "data": data,
            "label": int(label),
            "encoded": True,
        }
    chw = np.ascontiguousarray(np.transpose(img_bgr, (2, 0, 1)))
    return array_to_datum(chw, label)


def datum_to_image(datum: dict) -> np.ndarray:
    """Datum -> HWC BGR u8 (decoding it when ``encoded``)."""
    if datum.get("encoded"):
        from ..pipeline import image_io

        data = bytes(datum["data"])
        gray = int(datum.get("channels", 3)) == 1
        fmt = image_io.image_format(data)
        if fmt in ("png", "jpeg", "bmp", "pnm"):
            img = image_io.decode_image(data, gray=gray, name="encoded datum")
        else:
            cv2 = _cv2(fmt)
            img = cv2.imdecode(np.frombuffer(data, np.uint8),
                               cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
            if img is None:
                raise IOError("image decode failed")
        if img.ndim == 2:
            img = img[:, :, None]
        return img
    return np.transpose(datum_to_array(datum), (1, 2, 0))
