"""Reference CPM training-LMDB record codec (the genLMDB.py binary layout).

The reference trains from an LMDB whose ``Datum`` packs six u8 planes:
BGR image (planes 0-2), a metadata plane (plane 3) holding binary rows
decoded by ``ReadMetaData`` (reference src/caffe/data_transformer.cpp:577-676),
``mask_miss`` (plane 4, mode>=5) and ``mask_all`` (plane 5, mode==6) — the
plane unpack lives in ``Transform_nv`` (data_transformer.cpp:1243-1287; the
shipped build hardcodes ``mode = 5``, :1228).

This module is the byte-exact decoder for that layout plus its inverse, so

* a user with an existing genLMDB dataset can train directly
  (:class:`CpmDatumSource` plugs into ``training.datasets`` / PoseSolver), and
* tests can fabricate reference-format records and check the decoded metadata
  drives ``training.transformer`` identically to natively-constructed ``Meta``.

Metadata plane layout (rows are ``offset1 = datum_width`` bytes, starting at
byte offset ``offset3 = 3*H*W`` of ``Datum.data``; all floats little-endian
f32, ReadMetaData :577-676):

====  =========================================================
row   contents
====  =========================================================
0     dataset name, NUL-terminated ASCII
1     f32 height, f32 width (of the image the annots refer to)
2     u8 isValidation, u8 numOtherPeople, u8 people_index,
      f32 annolist_index @+3, f32 write_number @+7,
      f32 total_write_number @+11
3     f32 objpos.x, f32 objpos.y        (1-indexed; decode -= 1)
4     f32 scale_self
5     f32 joint_self.x[np_in_lmdb]      (1-indexed)
6     f32 joint_self.y[np_in_lmdb]
7     f32 joint_self.isVisible[np_in_lmdb]
8+p   f32 objpos_other[p].{x,y}         p in [0, numOtherPeople)
8+n   f32 scale_other[n] (4 bytes each, packed in one row)
9+n+3p, +1, +2   joint_others[p] x / y / isVisible rows
====  =========================================================

Visibility decode rules (:625-640, :662-670): the main person maps raw 3 -> 3
(absent), 0 -> 0 (occluded), else 1, then out-of-image coords force 2;
*other* people have no absent state — 0 -> 0 else 1, then out-of-image -> 2.

A copy of ``caffe_rtpose_tpu/training/cpm_lmdb.py``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..proto.datum import parse_datum, serialize_datum
from .transformer import Meta, Person, transform_joints_coco


@dataclass
class RecordInfo:
    """Bookkeeping fields of ReadMetaData not needed for training math."""

    dataset: str = "COCO"
    img_height: float = 0.0
    img_width: float = 0.0
    is_validation: bool = False
    people_index: int = 0
    annolist_index: int = 0
    write_number: int = 0
    total_write_number: int = 0
    scale_other: List[float] = field(default_factory=list)


def _f32(buf: bytes, off: int) -> float:
    return struct.unpack_from("<f", buf, off)[0]


def _vis_main(raw: float, x: float, y: float, w: float, h: float) -> int:
    # ReadMetaData :625-640
    if raw == 3:
        return 3
    v = 0 if raw == 0 else 1
    if x < 0 or y < 0 or x >= w or y >= h:
        v = 2
    return v


def _vis_other(raw: float, x: float, y: float, w: float, h: float) -> int:
    # ReadMetaData :662-670 (no absent state for other people)
    v = 0 if raw == 0 else 1
    if x < 0 or y < 0 or x >= w or y >= h:
        v = 2
    return v


def decode_cpm_meta(data: bytes, offset3: int, offset1: int,
                    np_in_lmdb: int) -> Tuple[Meta, RecordInfo]:
    """ReadMetaData (data_transformer.cpp:577-676) over raw Datum bytes."""
    # dataset name: NUL-terminated at row 0
    end = data.index(0, offset3)
    info = RecordInfo(dataset=data[offset3:end].decode("ascii", "replace"))
    info.img_height = _f32(data, offset3 + offset1)
    info.img_width = _f32(data, offset3 + offset1 + 4)
    w, h = info.img_width, info.img_height
    r2 = offset3 + 2 * offset1
    info.is_validation = data[r2] != 0
    num_other = data[r2 + 1]
    info.people_index = data[r2 + 2]
    info.annolist_index = int(_f32(data, r2 + 3))
    info.write_number = int(_f32(data, r2 + 7))
    info.total_write_number = int(_f32(data, r2 + 11))

    objpos = np.array([_f32(data, offset3 + 3 * offset1) - 1,
                       _f32(data, offset3 + 3 * offset1 + 4) - 1], np.float32)
    scale_self = _f32(data, offset3 + 4 * offset1)
    joints = np.zeros((np_in_lmdb, 2), np.float32)
    vis = np.zeros(np_in_lmdb, np.int32)
    for i in range(np_in_lmdb):
        joints[i, 0] = _f32(data, offset3 + 5 * offset1 + 4 * i) - 1
        joints[i, 1] = _f32(data, offset3 + 6 * offset1 + 4 * i) - 1
        raw = _f32(data, offset3 + 7 * offset1 + 4 * i)
        vis[i] = _vis_main(raw, joints[i, 0], joints[i, 1], w, h)
    people = [Person(joints=joints, visible=vis, objpos=objpos)]

    for p in range(num_other):
        op = np.array(
            [_f32(data, offset3 + (8 + p) * offset1) - 1,
             _f32(data, offset3 + (8 + p) * offset1 + 4) - 1], np.float32)
        info.scale_other.append(
            _f32(data, offset3 + (8 + num_other) * offset1 + 4 * p))
        oj = np.zeros((np_in_lmdb, 2), np.float32)
        ov = np.zeros(np_in_lmdb, np.int32)
        base = 9 + num_other + 3 * p
        for i in range(np_in_lmdb):
            oj[i, 0] = _f32(data, offset3 + base * offset1 + 4 * i) - 1
            oj[i, 1] = _f32(data, offset3 + (base + 1) * offset1 + 4 * i) - 1
            raw = _f32(data, offset3 + (base + 2) * offset1 + 4 * i)
            ov[i] = _vis_other(raw, oj[i, 0], oj[i, 1], w, h)
        people.append(Person(joints=oj, visible=ov, objpos=op))

    return Meta(people=people, scale_self=scale_self), info


def decode_cpm_datum(datum: dict, np_in_lmdb: int = 17, mode: int = 5):
    """6-channel Datum -> (img_bgr u8 HWC, mask_miss, mask_all, Meta, info).

    Plane unpack per Transform_nv (data_transformer.cpp:1243-1287): planes
    0-2 BGR image, plane 3 metadata, plane 4 mask_miss (mode>=5), plane 5
    mask_all (mode==6).  Masks default to ones/zeros like :1245-1250.
    """
    c, h, w = int(datum["channels"]), int(datum["height"]), int(datum["width"])
    if c != 6:
        raise ValueError(f"CPM datum must have 6 channels, got {c}")
    data = datum.get("data", b"")
    if data:
        planes = np.frombuffer(data, np.uint8, count=6 * h * w).reshape(6, h, w)
    else:  # float_data path (:1262-1266) — values cast to u8 planes
        planes = np.asarray(datum["float_data"], np.float32).reshape(6, h, w)
        planes = planes.astype(np.uint8)
        data = planes.tobytes()
    img = np.ascontiguousarray(planes[:3].transpose(1, 2, 0))  # HWC BGR
    mask_miss = np.ones((h, w), np.uint8) if mode >= 5 else None
    mask_all = np.zeros((h, w), np.uint8) if mode == 6 else None
    if mode >= 5:
        mask_miss = planes[4].copy()
    if mode == 6:
        mask_all = planes[5].copy()
    meta, info = decode_cpm_meta(bytes(data), 3 * h * w, w, np_in_lmdb)
    return img, mask_miss, mask_all, meta, info


def encode_cpm_datum(img_bgr: np.ndarray, meta: Meta,
                     mask_miss: Optional[np.ndarray] = None,
                     mask_all: Optional[np.ndarray] = None,
                     info: Optional[RecordInfo] = None) -> dict:
    """Exact inverse of :func:`decode_cpm_datum` — fabricates a record in the
    reference genLMDB layout (1-indexed coords, raw visibility floats).

    ``meta`` people carry ``np_in_lmdb``-joint annotations (e.g. raw COCO 17).
    Visibility 2 (out-of-image) is stored as raw 1 — the decoder re-derives 2
    from the coordinates, as the reference does.
    """
    h, w = img_bgr.shape[:2]
    npl = meta.main.joints.shape[0]
    num_other = len(meta.others)
    rows_needed = 9 + 4 * num_other if num_other else 8
    if rows_needed > h:
        raise ValueError(f"image height {h} too small for {num_other} other "
                         f"people ({rows_needed} metadata rows needed)")
    if 4 * max(npl, num_other) > w or w < 15:
        raise ValueError(f"image width {w} too small for {npl} joints")
    info = info or RecordInfo(img_height=float(h), img_width=float(w))

    planes = np.zeros((6, h, w), np.uint8)
    planes[:3] = img_bgr.transpose(2, 0, 1)
    if mask_miss is not None:
        planes[4] = mask_miss
    else:
        planes[4] = 255  # all-valid
    if mask_all is not None:
        planes[5] = mask_all

    md = planes[3].reshape(-1)  # rows of width w inside plane 3

    def put(row: int, off: int, payload: bytes):
        md[row * w + off : row * w + off + len(payload)] = np.frombuffer(
            payload, np.uint8)

    def raw_vis(v: int) -> float:
        return 3.0 if v == 3 else (0.0 if v == 0 else 1.0)

    name = info.dataset.encode("ascii")[: w - 1]
    put(0, 0, name + b"\x00")
    put(1, 0, struct.pack("<ff", info.img_height or float(h),
                          info.img_width or float(w)))
    put(2, 0, struct.pack("<BBBfff", 1 if info.is_validation else 0,
                          num_other, info.people_index,
                          float(info.annolist_index),
                          float(info.write_number),
                          float(info.total_write_number)))
    main = meta.main
    put(3, 0, struct.pack("<ff", main.objpos[0] + 1, main.objpos[1] + 1))
    put(4, 0, struct.pack("<f", float(meta.scale_self)))
    put(5, 0, np.asarray(main.joints[:, 0] + 1, "<f4").tobytes())
    put(6, 0, np.asarray(main.joints[:, 1] + 1, "<f4").tobytes())
    put(7, 0, np.asarray([raw_vis(v) for v in main.visible], "<f4").tobytes())
    scale_other = list(info.scale_other) + [1.0] * (
        num_other - len(info.scale_other))
    for p, other in enumerate(meta.others):
        put(8 + p, 0, struct.pack("<ff", other.objpos[0] + 1,
                                  other.objpos[1] + 1))
        put(8 + num_other, 4 * p, struct.pack("<f", float(scale_other[p])))
        base = 9 + num_other + 3 * p
        put(base, 0, np.asarray(other.joints[:, 0] + 1, "<f4").tobytes())
        put(base + 1, 0, np.asarray(other.joints[:, 1] + 1, "<f4").tobytes())
        put(base + 2, 0,
            np.asarray([raw_vis(v) for v in other.visible], "<f4").tobytes())

    return {"channels": 6, "height": int(h), "width": int(w),
            "data": planes.tobytes()}


class CpmDatumSource:
    """Train-time reader over a DB of reference-format CPM Datums.

    Yields the ``src[i] -> (img, Meta, mask_miss)`` item protocol of
    ``training.datasets`` sources, with joints converted from the stored
    np_in_lmdb order to the 18-part 'ours' order (TransformMetaJoints,
    data_transformer.cpp:709-715) when ``to_ours`` — matching the shipped
    ``transform_body_joint: true`` configs.

    ``path`` may be any backend ``utils.db.open_db`` understands (a real
    LMDB directory, a kvdb, ...).
    """

    def __init__(self, path: str, np_in_lmdb: int = 17, mode: int = 5,
                 to_ours: bool = True, backend: str = "auto",
                 np_parts: int = 56):
        from ..utils.db import open_db

        self.db = open_db(path, "r", backend=backend)
        self.np_in_lmdb = np_in_lmdb
        self.mode = mode
        self.to_ours = to_ours
        self.np_parts = int(np_parts)
        cur = self.db.new_cursor()
        cur.seek_to_first()
        self._keys = []
        while cur.valid():
            self._keys.append(cur.key())
            cur.next()

    def __len__(self):
        return len(self._keys)

    def __getitem__(self, i: int):
        datum = parse_datum(self.db.get(self._keys[i]))
        img, mask_miss, _, meta, _ = decode_cpm_datum(
            datum, self.np_in_lmdb, self.mode)
        if self.to_ours:
            # TransformMetaJoints (data_transformer.cpp:709-715): every
            # person's annotation converts from the stored np_in_lmdb order
            # to the np_parts training layout (all reference np modes —
            # MPI 14/27/28/29/43, COCO 33/34/36/37/52/56 — see
            # training.joints.transform_joints)
            from .joints import transform_joints

            people = []
            for p in meta.people:
                jt, vt = transform_joints(p.joints, p.visible, self.np_parts)
                people.append(Person(joints=jt, visible=vt,
                                     objpos=p.objpos))
            meta = Meta(people=people, scale_self=meta.scale_self)
        return img, meta, mask_miss


def write_cpm_db(records, out_path: str, backend: str = "kvdb") -> int:
    """Pack an iterable of (img_bgr, Meta, mask_miss) into a DB of
    reference-format CPM Datums (keys '%07d' like genLMDB).  Returns count."""
    from ..utils.db import open_db

    db = open_db(out_path, "w", backend=backend)
    txn = db.new_transaction()
    n = 0
    for img, meta, mask in records:
        datum = encode_cpm_datum(img, meta, mask_miss=mask,
                                 info=RecordInfo(write_number=n,
                                                 annolist_index=n))
        txn.put(f"{n:07d}", serialize_datum(datum))
        n += 1
        if n % 500 == 0:
            txn.commit()
    txn.commit()
    db.close()
    return n
