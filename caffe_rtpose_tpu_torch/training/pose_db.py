"""Pose training records in a kvdb — the analog of the CPM LMDB.

The reference trains from an LMDB whose Datum packs the image plus binary
metadata rows (ReadMetaData, data_transformer.cpp:581-676: objpos, scale,
joints, counts for the main person and the others).  Here each kvdb value is
a self-describing record: a JSON metadata header (human-debuggable, no
binary-row quirks) followed by the PNG-encoded image (and optional
PNG-encoded mask_miss), so one file carries the whole dataset like the LMDB
did.

* :func:`build_pose_db` — pack a ``JsonPoseSource``-style annotation index
  (image paths + people) into one kvdb;
* :class:`PoseDbSource` — train-time reader with the same ``(img, Meta,
  mask)`` item protocol as the other sources in ``training.datasets``;
* CLI (JAX package): ``python -m caffe_rtpose_tpu.tools.aux_tools build_pose_db ...``.

The port of ``caffe_rtpose_tpu/training/pose_db.py`` without OpenCV: the PNG
images are encoded and decoded by ``pipeline/image_io.py`` (numpy and zlib),
and records either package writes read in the other.
"""

from __future__ import annotations

import json
import struct
from typing import Optional

import numpy as np

from ..pipeline.image_io import decode_png, encode_png
from ..utils.db import open_db
from .transformer import Meta, Person

_MAGIC = b"CRTPOSE1"


def _encode_record(img_bgr: np.ndarray, meta: Meta,
                   mask_miss: Optional[np.ndarray]) -> bytes:
    header = {
        "scale_self": float(meta.scale_self),
        "people": [
            {
                "joints": np.asarray(p.joints, np.float32).tolist(),
                "visible": np.asarray(p.visible, np.int32).tolist(),
                "objpos": np.asarray(p.objpos, np.float32).tolist(),
            }
            for p in meta.people
        ],
    }
    hdr = json.dumps(header).encode()
    img_png = encode_png(img_bgr)
    mask_png = b"" if mask_miss is None else encode_png(mask_miss)
    return (_MAGIC + struct.pack("<III", len(hdr), len(img_png), len(mask_png))
            + hdr + img_png + mask_png)


def _decode_record(buf: bytes):
    if buf[:8] != _MAGIC:
        raise ValueError("not a pose record")
    hl, il, ml = struct.unpack("<III", buf[8:20])
    off = 20
    header = json.loads(buf[off : off + hl])
    off += hl
    img = decode_png(buf[off : off + il])
    off += il
    mask = None
    if ml:
        mask = decode_png(buf[off : off + ml], gray=True)
    people = [
        Person(
            joints=np.asarray(p["joints"], np.float32),
            visible=np.asarray(p["visible"], np.int32),
            objpos=np.asarray(p["objpos"], np.float32),
        )
        for p in header["people"]
    ]
    return img, Meta(people=people, scale_self=header.get("scale_self", 1.0)), mask


def build_pose_db(index_path: str, out_path: str, root: str = "") -> int:
    """Annotation index (JsonPoseSource format) -> one kvdb. Returns count."""
    from .datasets import JsonPoseSource

    src = JsonPoseSource(index_path, root=root)
    db = open_db(out_path, "w", backend="kvdb")
    txn = db.new_transaction()
    n = 0
    for i in range(len(src)):
        img, meta, mask = src[i]
        txn.put(f"{i:08d}", _encode_record(img, meta, mask))
        n += 1
        if n % 500 == 0:
            txn.commit()
    txn.commit()
    db.close()
    return n


class PoseDbSource:
    """Train-time reader over a pose kvdb (same item protocol as
    JsonPoseSource/SyntheticPoseSource: ``src[i] -> (img, Meta, mask)``)."""

    def __init__(self, path: str):
        self.db = open_db(path, "r", backend="kvdb")

    def __len__(self):
        return len(self.db)

    def __getitem__(self, i: int):
        # keys are zero-padded ordinals; direct get avoids a scan
        rec = self.db.get(f"{i:08d}")
        if rec is None:
            raise IndexError(i)
        return _decode_record(rec)
