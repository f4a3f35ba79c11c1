"""Training data sources + background prefetching.

Replaces the reference's LMDB DataReader + BasePrefetchingDataLayer
(data_reader.hpp, base_data_layer.hpp: background thread, PREFETCH_COUNT=3
ring) with host-side Python sources feeding the jitted train step:

* :class:`JsonPoseSource` — images + a JSON annotation index (the portable
  stand-in for the genLMDB.py LMDB; see ``docs`` for the format);
* :class:`SyntheticPoseSource` — procedurally generated people, used by
  tests and benchmarks;
* :class:`HDF5Source` — HDF5DataLayer parity, files read by the port's
  HDF5 codec (``utils/hdf5.py``);
* :func:`prefetch_loader` — background-thread batch prefetch;
* :func:`stage_batches` — the prefetch ring that also uploads each batch
  to the card from pinned host memory on a side CUDA stream.

The port of ``caffe_rtpose_tpu/training/datasets.py`` without OpenCV: images
are read by ``pipeline/image_io.py`` (PNG, BMP and PNM in numpy, JPEG by
the port's codec, by signature; a mask is read gray, as ``cv2.IMREAD_GRAYSCALE``) and the
synthetic figures are drawn by ``utils/imgproc.line_u8``, ``cv2.line`` in
numpy, bit for bit.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from ..pipeline.image_io import read_image
from ..utils import hdf5, imgproc
from .transformer import AugParams, Meta, Person, transform, transform_joints_coco

class JsonPoseSource:
    """Annotation index format (one JSON file):

    [{"image": "path.jpg", "scale_self": 0.8, "objpos": [x, y],
      "joints": [[x, y, v], ... 17 or 18], "others": [{...same...}]}, ...]

    ``joints`` with 17 rows are treated as raw COCO keypoints and converted
    to the 18-part order (neck synthesized); 18 rows are used as-is.
    ``v`` follows the reference visibility codes (0/1 usable, 2 outside,
    3 absent).  ``mask`` may name a single-channel PNG (mask_miss).
    """

    def __init__(self, index_path: str, root: str = ""):
        with open(index_path) as f:
            self.entries = json.load(f)
        self.root = root or os.path.dirname(os.path.abspath(index_path))

    def __len__(self):
        return len(self.entries)

    @staticmethod
    def _person(rec) -> Person:
        joints = np.asarray(rec["joints"], np.float32)
        if joints.shape[0] == 17:
            j, v = transform_joints_coco(joints[:, :2], joints[:, 2].astype(np.int32))
        else:
            j, v = joints[:, :2], joints[:, 2].astype(np.int32)
        objpos = np.asarray(rec.get("objpos", j[v <= 1].mean(0) if (v <= 1).any() else [0, 0]),
                            np.float32)
        return Person(joints=j, visible=v, objpos=objpos)

    def __getitem__(self, i: int):
        rec = self.entries[i]
        img = read_image(os.path.join(self.root, rec["image"]))
        people = [self._person(rec)] + [self._person(o) for o in rec.get("others", [])]
        meta = Meta(people=people, scale_self=float(rec.get("scale_self", 1.0)))
        mask = None
        if rec.get("mask"):
            mask = read_image(os.path.join(self.root, rec["mask"]), gray=True)
        return img, meta, mask


class SyntheticPoseSource:
    """Procedural stick figures on noise backgrounds for tests/benchmarks:
    the JAX source's images and people for every seed (the limbs are
    ``cv2.line``'s thickness-3 strokes, ``utils/imgproc.line_u8``)."""

    def __init__(self, n: int = 64, size: int = 368, seed: int = 0):
        self.n = n
        self.size = size
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, i: int):
        rs = np.random.RandomState(self.seed + i)
        size = self.size
        img = (rs.rand(size, size, 3) * 60).astype(np.uint8)
        people = []
        for _ in range(rs.randint(1, 4)):
            cx, cy = rs.uniform(80, size - 80), rs.uniform(100, size - 60)
            s = rs.uniform(0.6, 1.1)
            base = {
                0: (0, -95), 1: (0, -70), 2: (-22, -70), 3: (-30, -35),
                4: (-33, 0), 5: (22, -70), 6: (30, -35), 7: (33, 0),
                8: (-14, -5), 9: (-15, 38), 10: (-16, 80), 11: (14, -5),
                12: (15, 38), 13: (16, 80), 14: (-7, -101), 15: (7, -101),
                16: (-15, -97), 17: (15, -97),
            }
            joints = np.zeros((18, 2), np.float32)
            vis = np.zeros(18, np.int32)
            for k, (dx, dy) in base.items():
                joints[k] = (cx + s * dx + rs.randn() * 2, cy + s * dy + rs.randn() * 2)
            for a, b in ((1, 2), (2, 3), (3, 4), (1, 5), (5, 6), (6, 7),
                         (1, 8), (8, 9), (9, 10), (1, 11), (11, 12), (12, 13),
                         (1, 0)):
                imgproc.line_u8(img, tuple(joints[a].astype(int)), tuple(joints[b].astype(int)),
                                tuple(int(c) for c in rs.randint(100, 255, 3)), 3)
            people.append(Person(joints=joints, visible=vis,
                                 objpos=np.array([cx, cy], np.float32)))
        return img, Meta(people=people, scale_self=1.0), None


class HDF5Source:
    """HDF5DataLayer parity: iterates datasets from an .h5 file list
    (reference src/caffe/layers/hdf5_data_layer.cpp)."""

    def __init__(self, source_list: str, keys: Optional[List[str]] = None):
        with open(source_list) as f:
            self.files = [l.strip() for l in f if l.strip()]
        with hdf5.File(self.files[0], "r") as first:
            self.keys = keys or sorted(first.keys())
            self.n = first[self.keys[0]].shape[0]
            self.shapes = {k: first[k].shape[1:] for k in self.keys}

    def __len__(self):
        total = 0
        for p in self.files:
            with hdf5.File(p, "r") as f:
                total += f[self.keys[0]].shape[0]
        return total

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        rs = np.random.RandomState(seed)
        while True:
            for p in self.files:
                with hdf5.File(p, "r") as f:
                    n = f[self.keys[0]].shape[0]
                    order = rs.permutation(n) if shuffle else np.arange(n)
                    for i in range(0, n - batch_size + 1, batch_size):
                        idx = np.sort(order[i : i + batch_size])
                        yield {k: np.asarray(f[k][idx]) for k in self.keys}


def _clone_meta(meta: Meta) -> Meta:
    """Deep copy — the augmentation chain mutates joints in place."""
    people = [Person(p.joints.copy(), p.visible.copy(), p.objpos.copy())
              for p in meta.people]
    return Meta(people=people, scale_self=meta.scale_self)


def pose_batches(
    source,
    prm: AugParams,
    batch_size: int,
    seed: int = 0,
    train: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Endless (data, label) batch stream through the CPM transformer."""
    rs = np.random.RandomState(seed)
    n = len(source)
    while True:
        datas, labels = [], []
        for _ in range(batch_size):
            img, meta, mask = source[int(rs.randint(n))]
            m = _clone_meta(meta)  # transform mutates joints
            d, l, _ = transform(img, m, prm, rng=rs, mask_miss=mask, train=train)
            datas.append(d)
            labels.append(l)
        yield {"data": np.stack(datas), "label": np.stack(labels)}


PREFETCH_COUNT = 3  # base_data_layer.hpp PREFETCH_COUNT


class _PrefetchError:
    """Carries a worker-thread exception across the ring to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch_loader(batch_iter: Iterator, depth: int = PREFETCH_COUNT,
                    stage: Optional[Callable] = None) -> Iterator:
    """Background-thread prefetch ring (BasePrefetchingDataLayer parity).

    ``stage``, when given, is applied to each batch INSIDE the worker
    thread — used by :func:`stage_batches` to issue the host->device
    transfer there, overlapping it with the consumer's train step."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        try:
            for b in batch_iter:
                if stop.is_set():
                    return
                b = stage(b) if stage is not None else b
                while not stop.is_set():  # bounded put: exit cleanly on
                    try:                  # stop instead of blocking forever
                        q.put(b, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 — propagate to consumer:
            # a device error in stage() (OOM, layout) or a source error must
            # surface in the training loop, not masquerade as end-of-data
            err = _PrefetchError(e)
            while not stop.is_set():
                try:
                    q.put(err, timeout=0.2)
                    break
                except queue.Full:
                    continue
            return
        finally:
            while not stop.is_set():  # sentinel for a live consumer;
                try:                  # skipped when shutting down
                    q.put(None, timeout=0.2)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            b = q.get()
            if isinstance(b, _PrefetchError):
                raise b.exc
            if b is None:
                return
            yield b
    finally:
        stop.set()


class StagedBatch(dict):
    """A batch of tensors already on the net's device.  ``event`` (CUDA) is
    recorded on the staging stream after the uploads: the step's stream
    waits on it before reading (:meth:`wait`)."""

    event: Optional["torch.cuda.Event"] = None

    def wait(self) -> "StagedBatch":
        if self.event is not None:
            stream = torch.cuda.current_stream()
            stream.wait_event(self.event)
            for t in self.values():
                t.record_stream(stream)  # the allocator must not reuse it early
        return self


def stage_batches(batch_iter: Iterator, device: Union[str, torch.device],
                  depth: int = PREFETCH_COUNT) -> Iterator[StagedBatch]:
    """Device-staging prefetch ring.  The plain ring overlaps the host
    augmentation with the train step, but the upload still happens inside
    ``Solver.step``.  Here the prefetch thread also copies each batch into
    pinned host tensors and issues the host-to-device copies on a side CUDA
    stream, so the upload rides behind the previous step; the step waits on
    the batch's event.  On the CPU the batch is only converted to tensors."""
    dev = torch.device(device)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def stage(batch):
        out = StagedBatch()
        if stream is None:
            for k, v in batch.items():
                out[k] = torch.from_numpy(np.ascontiguousarray(v))
            return out
        with torch.cuda.stream(stream):
            for k, v in batch.items():
                host = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                out[k] = host.to(dev, non_blocking=True)
            out.event = torch.cuda.Event()
            out.event.record(stream)
        return out

    return prefetch_loader(batch_iter, depth=depth, stage=stage)
