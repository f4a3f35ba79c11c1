"""Aux dataset tools, the port of ``caffe_rtpose_tpu/tools/aux_tools.py``
(analogs of the reference tools/ binaries):

* convert_imageset  (tools/convert_imageset.cpp): image list -> a kvdb of
  Datum records (the DB behind ``utils/db.py``, replacing LMDB/LevelDB) or
  an .h5 pack when the output path ends in .h5/.hdf5
* compute_image_mean (tools/compute_image_mean.cpp): mean over a pack,
  written as .binaryproto (BlobProto) like the reference, or .npy
* build_pose_db: a pose annotation index packed into one kvdb
* db_convert: a dataset copied between DB backends
* extract_features  (tools/extract_features.cpp): dump named blobs to .npz

    python -m caffe_rtpose_tpu_torch aux convert_imageset LIST ROOT OUT [--encoded]
    python -m caffe_rtpose_tpu_torch aux compute_image_mean DB --out mean.binaryproto
    python -m caffe_rtpose_tpu_torch aux extract_features --model P --weights W \\
        --blobs fc7,prob --out feats.npz --iterations 2 [--device cpu]

Images are read without OpenCV (``core/data_layers.read_image``: PNG, BMP
and PNM in numpy, JPEG by the port's codec) and resized by ``cv2.resize``'s u8
INTER_LINEAR in OpenCV's fixed point, bit for bit
(``utils/imgproc.resize_linear_u8``).  ``--encoded`` Datums are PNG, or JPEG with
``--encode_type jpg`` (quality 95), BMP or PNM (``bmp``, ``pbm``, ``pgm``,
``ppm``, ``pnm``), each the bytes ``cv2.imencode`` writes, all
written and read without OpenCV (``proto/datum.py``).  ``extract_features`` builds the
net on the card unless ``--device cpu``.  HDF5 packs are written and read by the
port's HDF5 codec (``utils/hdf5.py``).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np

from ..utils import hdf5


def read_list(listfile: str):
    """``path [label]`` lines -> [(path, label)] (label 0 when absent)."""
    entries = []
    with open(listfile) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.rsplit(None, 1)
            if len(parts) == 2 and parts[1].lstrip("-").isdigit():
                entries.append((parts[0], int(parts[1])))
            else:
                entries.append((line, 0))
    return entries


def convert_imageset(listfile: str, root: str, out_path: str,
                     resize_h: int = 0, resize_w: int = 0,
                     gray: bool = False, shuffle: bool = False, seed: int = 0,
                     encoded: bool = False, encode_type: str = "",
                     backend: str = "kvdb") -> int:
    from ..core.data_layers import read_image
    from ..utils import imgproc

    entries = read_list(listfile)
    if shuffle:
        np.random.RandomState(seed).shuffle(entries)
    to_h5 = out_path.endswith((".h5", ".hdf5"))
    imgs, labels = [], []
    db = txn = None
    if not to_h5:
        from ..proto import datum as datum_io
        from ..utils.db import open_db

        db = open_db(out_path, "w", backend=backend)
        txn = db.new_transaction()
    count = 0
    for idx, (path, label) in enumerate(entries):
        full = os.path.join(root, path)
        if not os.path.isfile(full):
            print(f"skipping unreadable {path}", file=sys.stderr)
            continue
        img = read_image(full, color=not gray)
        if resize_h and resize_w:
            img = imgproc.resize_linear_u8(img, resize_h, resize_w)
        if img.ndim == 2:
            img = img[..., None]
        if to_h5:
            imgs.append(img.transpose(2, 0, 1))  # CHW, BGR
            labels.append(label)
        else:
            fmt = encode_type or ("png" if encoded else "")
            d = datum_io.image_to_datum(img, label, fmt)
            # key format matches convert_imageset.cpp:143: %08d_<path>
            txn.put(f"{idx:08d}_{path}", datum_io.serialize_datum(d))
            if (count + 1) % 1000 == 0:
                txn.commit()
        count += 1
    if to_h5:
        data = np.stack(imgs).astype(np.uint8)
        with hdf5.File(out_path, "w") as f:
            f.create_dataset("data", data=data, compression="gzip")
            f.create_dataset("label", data=np.asarray(labels, np.int64))
    else:
        txn.commit()
        db.close()
    print(f"Processed {count} files -> {out_path}")
    return 0


def compute_image_mean(src: str, out: Optional[str] = None) -> np.ndarray:
    """Mean image over an .h5 pack or a kvdb of Datum records; writes
    .binaryproto (BlobProto, like compute_image_mean.cpp) / .npy."""
    if src.endswith((".h5", ".hdf5")):
        with hdf5.File(src, "r") as f:
            data = f["data"]
            total = np.zeros(data.shape[1:], np.float64)
            n = data.shape[0]
            step = data.chunks[0] if data.chunks else 1  # each chunk decoded once
            for i in range(0, n, step):
                for row in data[i : i + step]:
                    total += row
    else:
        from ..core.data_layers import datum_chw
        from ..proto import datum as datum_io
        from ..utils.db import open_db

        with open_db(src, "r") as db:
            cur = db.new_cursor()
            cur.seek_to_first()
            total, n = None, 0
            while cur.valid():
                arr = datum_chw(datum_io.parse_datum(cur.value()))
                total = arr.astype(np.float64) if total is None else total + arr
                n += 1
                cur.next()
        if total is None:
            raise ValueError(f"db {src!r} is empty")
    mean = (total / n).astype(np.float32)
    if out:
        if out.endswith(".binaryproto"):
            from ..core.data_layers import write_mean_binaryproto

            write_mean_binaryproto(out, mean)
        else:
            np.save(out, mean)
    print("Channel means:", [float(m) for m in mean.reshape(mean.shape[0], -1).mean(1)])
    return mean


def extract_features(model: str, weights: str, blobs: List[str],
                     data: str, out_npz: str, iterations: int = 10,
                     device: str = "cuda") -> int:
    """``iterations`` forwards of the TEST net on ``device``; each blob's
    batches concatenated (Caffe's N x C x H x W, f32) into ``out_npz``."""
    import torch

    from ..core.net import Net
    from .caffe_tool import make_data_iter

    net = Net(model, phase="TEST", device=device)
    if weights:
        net.load_weights(weights)
    it = make_data_iter(data, net)
    feats = {b: [] for b in blobs}
    for _ in range(iterations):
        feed = {k: torch.as_tensor(np.asarray(v)).to(net.device) for k, v in next(it).items()}
        with torch.no_grad():
            out = net.forward(feed, outputs=blobs)
        for b in blobs:
            feats[b].append(out[b].float().cpu().numpy())
    np.savez(out_npz, **{b: np.concatenate(v) for b, v in feats.items()})
    print(f"Extracted {blobs} over {iterations} batches -> {out_npz}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="caffe-aux", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    c = sub.add_parser("convert_imageset")
    c.add_argument("listfile")
    c.add_argument("root")
    c.add_argument("out_path", help="kvdb path, or .h5/.hdf5 for an HDF5 pack")
    c.add_argument("--resize_height", type=int, default=0)
    c.add_argument("--resize_width", type=int, default=0)
    c.add_argument("--gray", action="store_true")
    c.add_argument("--shuffle", action="store_true")
    c.add_argument("--encoded", action="store_true")
    c.add_argument("--encode_type", default="")
    c.add_argument("--backend", default="kvdb",
                   choices=["kvdb", "lmdb", "leveldb"],
                   help="output DB format (reference convert_imageset.cpp "
                        "--backend {lmdb,leveldb})")
    c.set_defaults(fn=lambda a: convert_imageset(
        a.listfile, a.root, a.out_path, a.resize_height, a.resize_width,
        a.gray, a.shuffle, encoded=a.encoded, encode_type=a.encode_type,
        backend=a.backend))

    m = sub.add_parser("compute_image_mean")
    m.add_argument("src", help="kvdb path or .h5 pack")
    m.add_argument("--out", default="", help=".binaryproto or .npy")
    m.set_defaults(fn=lambda a: (compute_image_mean(a.src, a.out or None), 0)[1])

    b = sub.add_parser("build_pose_db",
                       help="pack a pose annotation index into one kvdb "
                            "(the CPM training-LMDB analog)")
    b.add_argument("index", help="JsonPoseSource annotation index (.json)")
    b.add_argument("out_path")
    b.add_argument("--root", default="")

    def _build(a):
        from ..training.pose_db import build_pose_db

        n = build_pose_db(a.index, a.out_path, root=a.root)
        print(f"Packed {n} pose records -> {a.out_path}")
        return 0
    b.set_defaults(fn=_build)

    dc = sub.add_parser("db_convert",
                        help="copy a dataset between DB backends "
                             "(leveldb/lmdb/kvdb) — the migration path for "
                             "reference-generated data")
    dc.add_argument("src")
    dc.add_argument("dst")
    dc.add_argument("--src_backend", default="auto",
                    choices=["auto", "kvdb", "lmdb", "leveldb"])
    dc.add_argument("--dst_backend", default="kvdb",
                    choices=["kvdb", "lmdb", "leveldb"])

    def _convert(a):
        from ..utils.db import convert_db

        n = convert_db(a.src, a.dst, a.src_backend, a.dst_backend)
        print(f"Copied {n} records {a.src} -> {a.dst}")
        return 0
    dc.set_defaults(fn=_convert)

    e = sub.add_parser("extract_features")
    e.add_argument("--model", required=True)
    e.add_argument("--weights", default="")
    e.add_argument("--blobs", required=True, help="comma-separated blob names")
    e.add_argument("--data", default="synthetic-pose")
    e.add_argument("--out", required=True)
    e.add_argument("--iterations", type=int, default=10)
    e.add_argument("--device", default="cuda", help="cuda (a card) or cpu")
    e.set_defaults(fn=lambda a: extract_features(
        a.model, a.weights, a.blobs.split(","), a.data, a.out, a.iterations, a.device))

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
