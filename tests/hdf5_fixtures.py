"""libhdf5's own files for the port's HDF5 codec (``caffe_rtpose_tpu_torch/
utils/hdf5_fmt.py``), written with h5py into ``tests/hdf5_fixtures/``, and
the sha256, shape and dtype of every array in them (``digests.json``).

    python tests/hdf5_fixtures.py      # (re)writes the files and digests.json

The grid: every numeric dtype in both byte orders at ranks 0-4 and h5py's
boolean; compact, contiguous and chunked storage with and without
``maxshape``; gzip at levels 1, 4 and 9, shuffle with gzip, fletcher32;
partially written chunks, unwritten and zero-sized datasets and a fill value;
nested groups, groups of 40 and 1,000 members, an empty group; B-trees of
several levels (small K values, which also give a version 1 superblock);
attributes and modification times (skipped) and an object header continued
in a second block; scalars, variable- and fixed-length strings and a
solverstate as Caffe's C++ writes it; a user block; and one file for each
refused feature, with the words its error must hold.

Importing this module needs numpy alone (``chip_smoke.py`` reads the digests
on the card's machine, which has no h5py); writing needs h5py.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
from typing import Callable, Dict

import numpy as np

DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hdf5_fixtures")
DIGESTS = os.path.join(DIR, "digests.json")
NUMERIC = ["i1", "u1", "i2", "u2", "i4", "u4", "i8", "u8", "f2", "f4", "f8"]
RANK_SHAPES = [(), (5,), (2, 3), (2, 1, 3), (1, 2, 2, 2)]
# refused feature -> (file, words its ValueError holds)
REFUSED = {
    "superblock version 3": ("refuse_latest.h5", "superblock version 3"),
    "lzf": ("refuse_lzf.h5", "the lzf filter"),
    "szip": ("refuse_szip.h5", "the szip filter"),
    "scaleoffset": ("refuse_scaleoffset.h5", "the scaleoffset filter"),
    "nbit": ("refuse_nbit.h5", "the nbit filter"),
    "compound": ("refuse_compound.h5", "a compound datatype"),
    "array": ("refuse_array.h5", "an array datatype"),
    "opaque": ("refuse_opaque.h5", "an opaque datatype"),
    "reference": ("refuse_reference.h5", "a reference datatype"),
    "bitfield": ("refuse_bitfield.h5", "a bitfield datatype"),
    "enum": ("refuse_enum.h5", "an enum type other than h5py's boolean"),
    "vlen sequence": ("refuse_vlen_seq.h5", "a variable-length sequence type"),
    "external storage": ("refuse_external.h5", "external data storage"),
    "committed datatype": ("refuse_committed.h5", "a committed datatype"),
    "null dataspace": ("refuse_null_space.h5", "a null dataspace"),
    "new-style group": ("refuse_new_group.h5", "version 2 object header"),
}


def digest(arr) -> str:
    """sha256 of an array's elements: the raw bytes, or for an object array
    of ``bytes`` each element's length (8 bytes, little-endian) and bytes."""
    arr = np.asarray(arr)
    h = hashlib.sha256()
    if arr.dtype == object:
        for x in arr.ravel().tolist():
            h.update(len(x).to_bytes(8, "little") + x)
    else:
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def record(arr) -> Dict[str, object]:
    arr = np.asarray(arr)
    return {"sha256": digest(arr), "shape": list(arr.shape), "dtype": arr.dtype.str}


def load_digests() -> Dict[str, Dict[str, object]]:
    with open(DIGESTS) as f:
        return json.load(f)


def _libhdf5(h5py):
    """The libhdf5 h5py loaded, for the calls h5py does not wrap
    (H5Pset_sym_k, H5Pset_istore_k, H5Pset_nbit)."""
    import glob

    libs = os.path.join(os.path.dirname(h5py.__file__), os.pardir, "h5py.libs")
    return ctypes.CDLL(sorted(glob.glob(os.path.join(libs, "libhdf5-*.so*")))[0])


def _files(h5py):
    """name -> a function that writes the file at a path."""
    rs = np.random.RandomState(14)

    def values(dt, shape):
        dt = np.dtype(dt)
        if dt.kind == "f":
            return (rs.standard_normal(shape) * 100).astype(dt)
        info = np.iinfo(dt)
        return rs.randint(info.min, info.max, shape, dtype=np.int64 if dt.kind == "i" or
                          dt.itemsize < 8 else np.uint64).astype(dt)

    def dtypes(path):
        with h5py.File(path, "w") as f:
            for dt in NUMERIC:
                for order in "<>":
                    for rank, shape in enumerate(RANK_SHAPES):
                        f[f"{dt}{'le' if order == '<' else 'be'}_r{rank}"] = \
                            values(order + dt, shape)
            f["bool"] = rs.rand(7) > 0.5
            f["bool_scalar"] = np.bool_(True)

    def layouts(path):
        with h5py.File(path, "w") as f:
            space = h5py.h5s.create_simple((4, 5))
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            h5py.h5d.create(f.id, b"compact", h5py.h5t.STD_I32LE, space, dcpl=dcpl)
            f["compact"][...] = np.arange(20, dtype="<i4").reshape(4, 5)
            f["contiguous"] = values("<f4", (6, 7))
            f.create_dataset("chunked", data=values("<f8", (9, 11)), chunks=(4, 3))
            f.create_dataset("chunked_maxshape", data=values("<i2", (10, 3)),
                             maxshape=(None, 3))
            part = f.create_dataset("partial", shape=(10, 10), chunks=(4, 4), dtype="<f4")
            part[1:3, 5:9] = 1.5
            part[9, 9] = 2.0
            f.create_dataset("filled", shape=(3, 4), dtype="<i4", fillvalue=-7)
            fc = f.create_dataset("filled_chunked", shape=(5, 6), chunks=(2, 2), dtype="<f8",
                                  fillvalue=0.25)
            fc[0:2, 0:2] = 3.0
            f.create_dataset("unwritten", shape=(4, 3), dtype="<u2")
            f.create_dataset("empty_contiguous", shape=(0,), dtype="<f4")
            f.create_dataset("empty_unlimited", shape=(0, 3), maxshape=(None, 3), dtype="<f8")
            f.create_dataset("empty_chunked", shape=(2, 0), maxshape=(2, None), chunks=(2, 4),
                             dtype="<u1")
            f["scalar"] = np.float64(2.5)

    def filters(path):
        data = np.cumsum(values("<i2", (40, 30)) // 256, axis=1).astype("<i2")
        with h5py.File(path, "w") as f:
            for level in (1, 4, 9):
                f.create_dataset(f"gzip{level}", data=data, chunks=(16, 8), compression="gzip",
                                 compression_opts=level)
            f.create_dataset("shuffle_gzip", data=data.astype("<f4"), chunks=(10, 30),
                             shuffle=True, compression="gzip")
            f.create_dataset("fletcher32", data=data, chunks=(7, 9), fletcher32=True)
            f.create_dataset("all_three", data=data.astype(">i4"), chunks=(13, 11),
                             shuffle=True, compression="gzip", fletcher32=True)
            ds = f.create_dataset("gzip_partial", shape=(20, 20), chunks=(8, 8),
                                  compression="gzip", dtype="<f4")
            ds[3:12, 2:5] = 7.0

    def groups(path):
        with h5py.File(path, "w") as f:
            f.create_group("a/b/c/d")["leaf"] = np.arange(3, dtype="<i8")
            f["a/b/x"] = np.float32(1.0)
            forty = f.create_group("forty")
            for i in rs.permutation(40):
                forty[f"m{i}"] = np.int32(i)
            thousand = f.create_group("thousand")
            target = f["a/b/c/d/leaf"]
            for i in rs.permutation(1000):
                thousand[f"link{i:04d}" if i % 3 else f"L{i}"] = target
            f.create_group("empty")

    def deep(path):
        fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
        lib = _libhdf5(h5py)
        check = [lib.H5Pset_sym_k(ctypes.c_int64(fcpl.id), ctypes.c_uint(2), ctypes.c_uint(2)),
                 lib.H5Pset_istore_k(ctypes.c_int64(fcpl.id), ctypes.c_uint(2))]
        assert check == [0, 0], check
        fid = h5py.h5f.create(path.encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl)
        with h5py.File(fid) as f:
            g = f.create_group("members")
            target = f.create_dataset("target", data=np.arange(4, dtype="<u4"))
            for i in rs.permutation(200):
                g[f"n{i:03d}"] = target
            f.create_dataset("chunks", data=values("<f4", (30, 20)), chunks=(3, 4),
                             maxshape=(None, None))

    def extras(path):
        with h5py.File(path, "w", track_order=False) as f:
            ds = f.create_dataset("with_attrs", data=values("<f4", (3, 3)), track_times=True)
            for i in range(40):
                ds.attrs[f"attribute_{i:02d}"] = np.arange(i + 1)
            f.attrs["note"] = "a file attribute"
            f.create_group("g").create_dataset("v", data=np.int8(4), track_times=True)

    def strings(path):
        with h5py.File(path, "w") as f:
            f["vlen_utf8"] = "a path/with ünïcode.caffemodel.h5"
            f["vlen_list"] = [b"first.png", b"", b"third image.jpg"]
            f["vlen_str_list"] = ["x", "yz"]
            f["fixed_nullpad"] = np.array([b"ab", b"cde", b""], "S4")
            for name, pad in (("fixed_nullterm", h5py.h5t.STR_NULLTERM),
                              ("fixed_spacepad", h5py.h5t.STR_SPACEPAD)):
                t = h5py.h5t.C_S1.copy()
                t.set_size(12)
                t.set_strpad(pad)
                h5py.h5d.create(f.id, name.encode(), t, h5py.h5s.create(h5py.h5s.SCALAR))
                raw = b"learned_net" + (b"\x00" if pad == h5py.h5t.STR_NULLTERM else b" ")
                f[name].id.write(h5py.h5s.ALL, h5py.h5s.ALL, np.array(raw, "S12"))

    def caffe_state(path):
        # what SGDSolver::SnapshotSolverStateToHDF5 writes through H5LT:
        # int datasets of dims [1], a null-terminated fixed-length string and
        # float history blobs
        with h5py.File(path, "w") as f:
            f.create_dataset("iter", data=np.array([1200], "<i4"))
            t = h5py.h5t.C_S1.copy()
            name = b"snapshots/caffenet_iter_1200.caffemodel.h5"
            t.set_size(len(name) + 1)
            h5py.h5d.create(f.id, b"learned_net", t, h5py.h5s.create(h5py.h5s.SCALAR))
            f["learned_net"].id.write(h5py.h5s.ALL, h5py.h5s.ALL,
                                      np.array(name + b"\x00", f"S{len(name) + 1}"))
            f.create_dataset("current_step", data=np.array([2], "<i4"))
            hist = f.create_group("history")
            for i, shape in enumerate([(8, 3, 3, 3), (8,), (4, 8), (4,)]):
                hist.create_dataset(str(i), data=values("<f4", shape))

    def userblock(path):
        with h5py.File(path, "w", userblock_size=512) as f:
            f["x"] = values("<f8", (3, 4))
            f.create_group("g")["y"] = values("<i2", (5,))
        with open(path, "r+b") as fh:
            fh.write(b"a user block before the superblock")

    def refused(kind):
        def write(path):
            if kind == "superblock version 3":
                with h5py.File(path, "w", libver="latest") as f:
                    f["x"] = np.arange(3)
                return
            if kind == "new-style group":
                with h5py.File(path, "w") as f:
                    f.create_group("ordered", track_order=True)["x"] = np.arange(3)
                return
            with h5py.File(path, "w") as f:
                if kind == "lzf":
                    f.create_dataset("x", data=np.arange(100), chunks=(10,), compression="lzf")
                elif kind == "szip":
                    f.create_dataset("x", data=np.arange(100), chunks=(10,), compression="szip")
                elif kind == "scaleoffset":
                    f.create_dataset("x", data=np.arange(100), chunks=(10,), scaleoffset=0)
                elif kind == "nbit":
                    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
                    dcpl.set_chunk((10,))
                    assert _libhdf5(h5py).H5Pset_nbit(ctypes.c_int64(dcpl.id)) == 0
                    h5py.h5d.create(f.id, b"x", h5py.h5t.STD_I32LE,
                                    h5py.h5s.create_simple((20,)), dcpl=dcpl)
                elif kind == "compound":
                    f["x"] = np.zeros(3, [("a", "<i4"), ("b", "<f8")])
                elif kind == "array":
                    f.create_dataset("x", shape=(2,), dtype=np.dtype(("<f4", (3,))))
                elif kind == "opaque":
                    f["x"] = np.zeros(3, "V4")
                elif kind == "reference":
                    f["target"] = np.arange(2)
                    f.create_dataset("x", data=[f["target"].ref], dtype=h5py.ref_dtype)
                elif kind == "bitfield":
                    h5py.h5d.create(f.id, b"x", h5py.h5t.STD_B8LE, h5py.h5s.create_simple((4,)))
                elif kind == "enum":
                    f.create_dataset("x", data=np.array([0, 1, 2], "i1"),
                                     dtype=h5py.enum_dtype({"R": 0, "G": 1, "B": 2}, "i1"))
                elif kind == "vlen sequence":
                    f.create_dataset("x", (2,), dtype=h5py.vlen_dtype("<i4"))
                elif kind == "external storage":
                    f.create_dataset("x", shape=(4,), dtype="<i4",
                                     external=[(os.path.basename(path) + ".raw", 0, 16)])
                elif kind == "committed datatype":
                    f["t"] = np.dtype("<f4")
                    f.create_dataset("x", (3,), dtype=f["t"])
                elif kind == "null dataspace":
                    f["x"] = h5py.Empty("<f4")
        return write

    files = {"dtypes.h5": dtypes, "layouts.h5": layouts, "filters.h5": filters,
             "groups.h5": groups, "deep_btrees.h5": deep, "extras.h5": extras,
             "strings.h5": strings, "caffe_solverstate.h5": caffe_state,
             "userblock.h5": userblock}
    for kind, (name, _) in REFUSED.items():
        files[name] = refused(kind)
    return files


def contents(lib, path: str, addr_of: Callable) -> Dict[str, object]:
    """Every group (its members in order) and dataset of a file, as ``lib``
    (h5py, or the port's ``utils/hdf5.py``) reads them; a second link to a
    dataset (``addr_of(dataset)``: its object header's address) as
    ``{"link": first path}``."""
    out: Dict[str, object] = {}
    seen: Dict[int, str] = {}
    with lib.File(path, "r") as f:
        def visit(g, prefix):
            out[prefix or "/"] = {"members": list(g.keys())}
            for k in g:
                obj, name = g[k], f"{prefix}/{k}"
                if isinstance(obj, lib.Group):
                    visit(obj, name)
                    continue
                addr = addr_of(obj)
                out[name] = {"link": seen[addr]} if addr in seen else record(obj[()])
                seen.setdefault(addr, name)
        visit(f, "")
    return out


def write_all() -> Dict[str, object]:
    import h5py

    os.makedirs(DIR, exist_ok=True)
    digests: Dict[str, object] = {}
    refused_files = {name: words for name, words in REFUSED.values()}
    for name, write in _files(h5py).items():
        path = os.path.join(DIR, name)
        write(path)
        digests[name] = ({"refused": refused_files[name]} if name in refused_files
                         else contents(h5py, path, lambda d: h5py.h5o.get_info(d.id).addr))
    with open(DIGESTS, "w") as f:
        json.dump(digests, f, sort_keys=True, separators=(",", ":"))
    return digests


if __name__ == "__main__":
    d = write_all()
    total = sum(os.path.getsize(os.path.join(DIR, n)) for n in os.listdir(DIR))
    print(f"{len(d)} files, {total} bytes in {DIR}")
