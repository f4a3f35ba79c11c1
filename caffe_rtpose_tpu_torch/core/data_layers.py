"""Host-side data layers: Data, ImageData, MemoryData, HDF5Data, WindowData
and CPMData.

Counterpart of ``caffe_rtpose_tpu/core/data_layers.py``.  In the reference
these are graph nodes whose Forward pops a batch a background thread
prefetched (BasePrefetchingDataLayer, base_data_layer.hpp:55-83).  Here, as
in JAX, a data layer is a host source bound to the graph: at build it
declares its tops and their shapes, and ``Net.forward`` pulls the next
batch (``training.datasets.prefetch_loader``, a ring of 3, the reference's
PREFETCH_COUNT) and feeds it as inputs.

The standard transform (DataTransformer::Transform, data_transformer.cpp:
57-220): mean file or mean values subtracted, then a crop (the centre in
TEST, random in TRAIN), a random mirror (any phase, as the reference) and
the scale.  No OpenCV: images are read by ``pipeline/image_io.py`` (PNG and
BMP in numpy, JPEG by the port's codec, ``pipeline/jpeg.py``) and resized in
numpy by ``cv2.resize``'s INTER_LINEAR in OpenCV's u8 fixed point, bit for
bit (``utils/imgproc.py``).  HDF5Data reads its files
with the port's HDF5 codec (``utils/hdf5.py``).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..proto import caffe_pb
from ..proto import datum as datum_io
from ..proto.wire import decode, encode
from ..utils import imgproc

DATA_LAYER_TYPES = {"Data", "ImageData", "MemoryData", "HDF5Data", "WindowData", "CPMData"}


def read_mean_binaryproto(path: str) -> np.ndarray:
    """A ``.binaryproto`` (BlobProto) -> the (C, H, W) f32 mean
    (compute_image_mean's output)."""
    with open(path, "rb") as f:
        msg = decode(f.read(), caffe_pb.SCHEMA, "BlobProto")
    bv = caffe_pb.view(msg, "BlobProto")
    data = np.asarray(list(bv.data), np.float32)
    shape = [int(d) for d in (bv.shape.dim if bv.has("shape") else [])]
    if not shape:
        shape = [d for d in (int(bv.num), int(bv.channels), int(bv.height), int(bv.width)) if d]
    return data.reshape(shape[-3:])


def write_mean_binaryproto(path: str, mean_chw: np.ndarray) -> None:
    """A (C, H, W) mean -> ``.binaryproto``, the inverse of
    :func:`read_mean_binaryproto`."""
    m = np.asarray(mean_chw, np.float32)
    if m.ndim != 3:
        raise ValueError("mean must be (C, H, W)")
    msg = {"num": 1, "channels": int(m.shape[0]), "height": int(m.shape[1]),
           "width": int(m.shape[2]), "data": [float(v) for v in m.flat]}
    with open(path, "wb") as f:
        f.write(encode(msg, caffe_pb.SCHEMA, "BlobProto"))


def linear_taps(n_out: int, n_src: int):
    """One axis of ``cv2.resize`` INTER_LINEAR: output i samples the f32
    coordinate (i + 0.5) * src/out - 0.5, clamped to the edge -> (n_out, 2)
    source indices and (n_out, 2) f32 weights."""
    scale = 1.0 / (n_out / float(n_src))
    c = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(c).astype(np.int64)
    fr = (c - i0).astype(np.float32)
    fr[i0 < 0] = 0.0
    i0 = np.maximum(i0, 0)
    fr[i0 >= n_src - 1] = 0.0
    i0 = np.minimum(i0, n_src - 1)
    return np.stack([i0, np.minimum(i0 + 1, n_src - 1)], 1), np.stack([1.0 - fr, fr], 1)


def apply_taps(img: np.ndarray, idx: np.ndarray, w: np.ndarray, axis: int) -> np.ndarray:
    """The weighted sum of ``img``'s rows (or columns) ``idx`` along
    ``axis``: one axis of a separable resize, in f32."""
    out = None
    for j in range(idx.shape[1]):
        shape = [1] * img.ndim
        shape[axis] = -1
        t = img.take(idx[:, j], axis=axis) * w[:, j].astype(np.float32).reshape(shape)
        out = t if out is None else out + t
    return out


def read_image(path: str, color: bool = True) -> np.ndarray:
    """An image file -> BGR u8 (H, W, 3), or (H, W, 1) gray: the plane
    ``cv2.IMREAD_GRAYSCALE`` gives (a JPEG's is libjpeg's Y plane, a colour
    PNG's or BMP's the reader's own fixed point; ``pipeline/image_io.py``)."""
    from ..pipeline.image_io import read_image as _read

    img = _read(path, gray=not color)
    return img if color else img[:, :, None]


def datum_chw(d: dict) -> np.ndarray:
    """A parsed Datum -> its (C, H, W) array; an encoded PNG or JPEG decodes
    without OpenCV (``proto/datum.py``)."""
    if d.get("encoded"):
        return np.ascontiguousarray(np.transpose(datum_io.datum_to_image(d), (2, 0, 1)))
    return datum_io.datum_to_array(d)


class StandardTransformer:
    """The crop, mirror, mean and scale chain (data_transformer.cpp:57-220)."""

    def __init__(self, tp: Optional[caffe_pb.View], phase: str):
        self.phase = phase
        self.scale = float(tp.scale) if tp is not None else 1.0
        self.mirror = bool(tp.mirror) if tp is not None else False
        self.crop_size = int(tp.crop_size) if tp is not None else 0
        self.mean: Optional[np.ndarray] = None
        self.mean_values: Optional[np.ndarray] = None
        if tp is not None and tp.has("mean_file") and tp.mean_file:
            self.mean = read_mean_binaryproto(tp.mean_file)
        elif tp is not None and list(tp.mean_value):
            self.mean_values = np.asarray(list(tp.mean_value), np.float32)

    def out_shape(self, c: int, h: int, w: int) -> Tuple[int, int, int]:
        if self.crop_size:
            return (c, self.crop_size, self.crop_size)
        return (c, h, w)

    def __call__(self, chw: np.ndarray, rs: np.random.RandomState) -> np.ndarray:
        x = chw.astype(np.float32)
        if self.mean is not None:
            x = x - self.mean
        elif self.mean_values is not None:
            mv = self.mean_values
            x = x - (mv[0] if mv.size == 1 else mv[: x.shape[0], None, None])
        cs = self.crop_size
        if cs:
            _, h, w = x.shape
            if self.phase == "TRAIN":
                off_h, off_w = rs.randint(h - cs + 1), rs.randint(w - cs + 1)
            else:
                off_h, off_w = (h - cs) // 2, (w - cs) // 2
            x = x[:, off_h: off_h + cs, off_w: off_w + cs]
        # do_mirror = mirror && Rand(2), in every phase (data_transformer.cpp:66)
        if self.mirror and rs.randint(2):
            x = x[:, :, ::-1]
        return x * self.scale


def _transformer(lv: caffe_pb.View, phase: str) -> StandardTransformer:
    return StandardTransformer(lv.transform_param if lv.has("transform_param") else None, phase)


class HostDataLayer:
    """Base: named tops with their shapes, and a prefetched batch stream."""

    def __init__(self, name: str, tops: Sequence[str], shapes: Sequence[Tuple[int, ...]]):
        self.name = name
        self.tops = list(tops)
        self.top_shapes = {t: tuple(s) for t, s in zip(tops, shapes)}
        self._iter: Optional[Iterator[Dict[str, np.ndarray]]] = None
        self._lock = threading.Lock()

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        raise NotImplementedError

    def next_batch(self) -> Dict[str, np.ndarray]:
        with self._lock:
            if self._iter is None:
                from ..training.datasets import prefetch_loader

                self._iter = prefetch_loader(self.batches())
            return next(self._iter)

    def _batch(self, datas: List[np.ndarray], labels: List[float]) -> Dict[str, np.ndarray]:
        out = {self.tops[0]: np.stack(datas)}
        if len(self.tops) > 1:
            out[self.tops[1]] = np.asarray(labels, np.float32)
        return out


class DataLayer(HostDataLayer):
    """'Data': Datum records from a key-value DB (data_layer.cpp and
    data_reader.cpp: one sequential cursor, wrapping, ``rand_skip``)."""

    def __init__(self, lv: caffe_pb.View, phase: str):
        from ..utils import db as dbmod

        p = lv.data_param
        self.source = p.source
        self.batch_size = int(p.batch_size)
        self.rand_skip = int(p.rand_skip)
        self.db = dbmod.open_db(self.source, "r", backend="lmdb" if int(p.backend) == 1 else "auto")
        cur = self.db.new_cursor()
        cur.seek_to_first()
        c, h, w = datum_chw(datum_io.parse_datum(cur.value())).shape
        self.tf = _transformer(lv, phase)
        tops = list(lv.top)
        shapes = [(self.batch_size,) + self.tf.out_shape(c, h, w)]
        super().__init__(lv.name, tops, shapes + ([(self.batch_size,)] if len(tops) > 1 else []))

    def batches(self):
        rs = np.random.RandomState(0)
        cur = self.db.new_cursor()
        cur.seek_to_first()
        # rand_skip skips a random count in [0, rand_skip) (data_layer.cpp)
        for _ in range(rs.randint(self.rand_skip) if self.rand_skip else 0):
            cur.next()
            if not cur.valid():
                cur.seek_to_first()
        while True:
            datas, labels = [], []
            for _ in range(self.batch_size):
                if not cur.valid():
                    cur.seek_to_first()
                d = datum_io.parse_datum(cur.value())
                datas.append(self.tf(datum_chw(d), rs))
                labels.append(d.get("label", 0))
                cur.next()
            yield self._batch(datas, labels)


class ImageDataLayer(HostDataLayer):
    """'ImageData': a "path label" list file (image_data_layer.cpp)."""

    def __init__(self, lv: caffe_pb.View, phase: str):
        p = lv.image_data_param
        self.batch_size = int(p.batch_size)
        self.root = p.root_folder
        self.new_h, self.new_w = int(p.new_height), int(p.new_width)
        self.is_color = bool(p.is_color)
        self.shuffle = bool(p.shuffle)
        self.rand_skip = int(p.rand_skip)
        self.lines: List[Tuple[str, int]] = []
        with open(p.source) as f:
            for line in f:
                parts = line.split()
                if parts:
                    self.lines.append((parts[0], int(parts[1]) if len(parts) > 1 else 0))
        if not self.lines:
            raise ValueError(f"ImageData source {p.source!r} is empty")
        h, w, c = self._load(self.lines[0][0]).shape
        self.tf = _transformer(lv, phase)
        tops = list(lv.top)
        shapes = [(self.batch_size,) + self.tf.out_shape(c, h, w)]
        super().__init__(lv.name, tops, shapes + ([(self.batch_size,)] if len(tops) > 1 else []))

    def _load(self, rel: str) -> np.ndarray:
        img = read_image(os.path.join(self.root, rel), self.is_color)
        if self.new_h and self.new_w:
            img = imgproc.resize_linear_u8(img, self.new_h, self.new_w)
        return img

    def batches(self):
        rs = np.random.RandomState(0)
        order = list(range(len(self.lines)))
        # a random skip in [0, rand_skip), as image_data_layer.cpp
        pos = (rs.randint(self.rand_skip) if self.rand_skip else 0) % len(order)
        if self.shuffle:
            rs.shuffle(order)
        while True:
            datas, labels = [], []
            for _ in range(self.batch_size):
                if pos >= len(order):
                    pos = 0
                    if self.shuffle:
                        rs.shuffle(order)
                rel, label = self.lines[order[pos]]
                pos += 1
                datas.append(self.tf(np.transpose(self._load(rel), (2, 0, 1)), rs))
                labels.append(label)
            yield self._batch(datas, labels)


class MemoryDataLayer(HostDataLayer):
    """'MemoryData': arrays bound by ``Net.set_input_arrays``
    (memory_data_layer.cpp, pycaffe's _Net_set_input_arrays)."""

    def __init__(self, lv: caffe_pb.View, phase: str):
        p = lv.memory_data_param
        self.batch_size = int(p.batch_size)
        shape = (self.batch_size, int(p.channels), int(p.height), int(p.width))
        tops = list(lv.top)
        super().__init__(lv.name, tops, [shape] + ([(self.batch_size,)] if len(tops) > 1 else []))
        self._data: Optional[np.ndarray] = None
        self._labels: Optional[np.ndarray] = None
        self._pos = 0

    def set_arrays(self, data: np.ndarray, labels: Optional[np.ndarray] = None) -> None:
        if data.shape[0] % self.batch_size:
            raise ValueError("array count must be a multiple of batch_size "
                             "(memory_data_layer.cpp:AddMatVector)")
        self._data, self._labels, self._pos = np.asarray(data), labels, 0

    def next_batch(self) -> Dict[str, np.ndarray]:
        if self._data is None:
            raise RuntimeError("MemoryData layer has no arrays; call "
                               "net.set_input_arrays(data, labels) first")
        n = self._data.shape[0]
        i = self._pos % n
        self._pos = (self._pos + self.batch_size) % n
        sl = slice(i, i + self.batch_size)
        out = {self.tops[0]: self._data[sl].astype(np.float32)}
        if len(self.tops) > 1:
            lab = self._labels[sl] if self._labels is not None else np.zeros(self.batch_size)
            out[self.tops[1]] = np.asarray(lab, np.float32)
        return out


class HDF5DataLayer(HostDataLayer):
    """'HDF5Data': datasets from a list of ``.h5`` files
    (hdf5_data_layer.cpp)."""

    def __init__(self, lv: caffe_pb.View, phase: str):
        from ..training.datasets import HDF5Source

        p = lv.hdf5_data_param
        self.batch_size = int(p.batch_size)
        self.shuffle = bool(p.shuffle)
        tops = list(lv.top)
        self.src = HDF5Source(p.source, keys=tops)
        shapes = [(self.batch_size,) + tuple(self.src.shapes[t]) for t in tops]
        super().__init__(lv.name, tops, shapes)

    def batches(self):
        return self.src.batches(self.batch_size, shuffle=self.shuffle)


class WindowDataLayer(HostDataLayer):
    """'WindowData': foreground and background windows, context-padded and
    warped to the crop (window_data_layer.cpp).  The window file::

        # <index>
        <image path>
        <channels> <height> <width>
        <num windows>
        <label> <overlap> <x1> <y1> <x2> <y2>
    """

    def __init__(self, lv: caffe_pb.View, phase: str):
        p = lv.window_data_param
        self.batch_size = int(p.batch_size)
        self.crop_size = int(p.crop_size) or 227
        self.fg_threshold = float(p.fg_threshold)
        self.bg_threshold = float(p.bg_threshold)
        self.fg_fraction = float(p.fg_fraction)
        self.context_pad = int(p.context_pad)
        self.mirror = bool(p.mirror)
        self.scale = float(p.scale)
        self.root = p.root_folder
        self.mean = read_mean_binaryproto(p.mean_file) if p.has("mean_file") and p.mean_file else None
        self.images: List[str] = []
        self.fg: List[Tuple[int, int, float, Tuple[int, int, int, int]]] = []
        self.bg: List[Tuple[int, int, float, Tuple[int, int, int, int]]] = []
        self._parse(p.source)
        tops = list(lv.top)
        shapes = [(self.batch_size, 3, self.crop_size, self.crop_size), (self.batch_size,)]
        super().__init__(lv.name, tops, shapes[: len(tops)])

    def _parse(self, source: str) -> None:
        with open(source) as f:
            lines = [line.rstrip("\n") for line in f]
        i = 0
        while i < len(lines):
            if not lines[i].startswith("#"):
                i += 1
                continue
            img_idx = len(self.images)
            self.images.append(lines[i + 1].strip())
            num = int(lines[i + 3].split()[0])
            for j in range(num):
                parts = lines[i + 4 + j].split()
                label, overlap = int(parts[0]), float(parts[1])
                box = tuple(int(v) for v in parts[2:6])
                if overlap >= self.fg_threshold:
                    self.fg.append((img_idx, label, overlap, box))
                elif overlap < self.bg_threshold:
                    # background windows take label 0 (window_data_layer.cpp:221)
                    self.bg.append((img_idx, 0, overlap, box))
            i += 4 + num
        if not self.fg and not self.bg:
            raise ValueError(f"window file {source!r} has no windows")

    def _crop(self, img: np.ndarray, box, rs) -> np.ndarray:
        x1, y1, x2, y2 = box
        if self.context_pad:
            # the box scaled so the warped crop keeps context_pad pixels of
            # context a side (window_data_layer.cpp:301-320)
            scale = self.crop_size / float(self.crop_size - 2 * self.context_pad)
            cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
            hw, hh = (x2 - x1 + 1) * scale / 2.0, (y2 - y1 + 1) * scale / 2.0
            x1, x2 = int(round(cx - hw)), int(round(cx + hw))
            y1, y2 = int(round(cy - hh)), int(round(cy + hh))
        h, w = img.shape[:2]
        px1, py1 = max(0, x1), max(0, y1)
        px2, py2 = min(w - 1, x2), min(h - 1, y2)
        patch = img[py1: py2 + 1, px1: px2 + 1]
        canvas = np.zeros((y2 - y1 + 1, x2 - x1 + 1, 3), img.dtype)
        canvas[py1 - y1: py1 - y1 + patch.shape[0], px1 - x1: px1 - x1 + patch.shape[1]] = patch
        warped = imgproc.resize_linear_u8(canvas, self.crop_size, self.crop_size)
        x = np.transpose(warped, (2, 0, 1)).astype(np.float32)
        if self.mean is not None:
            mc = self.mean
            if mc.shape[1:] != x.shape[1:]:
                off_h, off_w = (mc.shape[1] - x.shape[1]) // 2, (mc.shape[2] - x.shape[2]) // 2
                mc = mc[:, off_h: off_h + x.shape[1], off_w: off_w + x.shape[2]]
            x = x - mc
        if self.mirror and rs.randint(2):
            x = x[:, :, ::-1]
        return x * self.scale

    def batches(self):
        rs = np.random.RandomState(0)
        num_fg = int(round(self.batch_size * self.fg_fraction))
        while True:
            datas, labels = [], []
            for k in range(self.batch_size):
                pool = self.fg if (k < num_fg and self.fg) else (self.bg or self.fg)
                img_idx, label, _, box = pool[rs.randint(len(pool))]
                img = read_image(os.path.join(self.root, self.images[img_idx]))
                datas.append(self._crop(img, box, rs))
                labels.append(label)
            yield self._batch(datas, labels)


class CpmDataLayer(HostDataLayer):
    """'CPMData', the companion caffe_train repository's layer: 6-plane
    genLMDB Datum records (``training/cpm_lmdb.py``) through the
    augmentation chain and the heatmap and PAF labels (``training/``), so
    the reference's CPM training prototxts train unchanged.  Tops data (N,
    3, crop_y, crop_x) and label (N, 2*(num_parts+1), gy, gx)."""

    def __init__(self, lv: caffe_pb.View, phase: str):
        from ..training.cpm_lmdb import CpmDatumSource
        from ..training.transformer import AugParams

        p, tp = lv.data_param, lv.transform_param
        self.batch_size = int(p.batch_size)
        self.source = CpmDatumSource(p.source, np_in_lmdb=int(tp.np_in_lmdb),
                                     to_ours=bool(tp.transform_body_joint),
                                     backend="lmdb" if int(p.backend) == 1 else "auto",
                                     np_parts=int(tp.num_parts))
        self.prm = AugParams(
            stride=int(tp.stride), crop_size_x=int(tp.crop_size_x),
            crop_size_y=int(tp.crop_size_y), target_dist=float(tp.target_dist),
            scale_prob=float(tp.scale_prob), scale_min=float(tp.scale_min),
            scale_max=float(tp.scale_max), max_rotate_degree=float(tp.max_rotate_degree),
            center_perterb_max=float(tp.center_perterb_max), flip_prob=float(tp.flip_prob),
            sigma=float(tp.sigma), transform_body_joint=bool(tp.transform_body_joint),
            np=int(tp.num_parts), do_clahe=bool(tp.do_clahe),
            clahe_tile_size=int(tp.clahe_tile_size), clahe_clip_limit=int(tp.clahe_clip_limit))
        self._train = phase == "TRAIN"
        gy, gx = self.prm.crop_size_y // self.prm.stride, self.prm.crop_size_x // self.prm.stride
        tops = list(lv.top)
        shapes = [(self.batch_size, 3, self.prm.crop_size_y, self.prm.crop_size_x),
                  (self.batch_size, 2 * (self.prm.np + 1), gy, gx)]
        super().__init__(lv.name, tops, shapes[: len(tops)])

    def batches(self):
        from ..training.datasets import pose_batches

        for batch in pose_batches(self.source, self.prm, self.batch_size, train=self._train):
            yield {self.tops[0]: batch["data"],
                   **({self.tops[1]: batch["label"]} if len(self.tops) > 1 else {})}


_BUILDERS = {"Data": DataLayer, "ImageData": ImageDataLayer, "MemoryData": MemoryDataLayer,
             "HDF5Data": HDF5DataLayer, "WindowData": WindowDataLayer, "CPMData": CpmDataLayer}


def build(lv: caffe_pb.View, phase: str) -> HostDataLayer:
    return _BUILDERS[lv.type](lv, phase)
