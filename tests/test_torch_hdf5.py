"""The port's HDF5 codec (``caffe_rtpose_tpu_torch/utils/hdf5_fmt.py`` behind
``utils/hdf5.py``) against libhdf5 through h5py, the witness on this machine:

* every file libhdf5 wrote in ``tests/hdf5_fixtures/`` (``hdf5_fixtures.py``)
  reads equal to h5py and to the pinned digests: values, dtype, shape, group
  members and their order;
* each refused feature raises ValueError naming it and the file;
* h5py reads what the port writes, also after the port changed an h5py file
  in place (mode ``a``: groups whose symbol-table nodes and B-tree roots
  split, grown chunked datasets, chunks written into gzip and fletcher32
  datasets), and the port reads it again after h5py changed it;
* random shapes, dtypes, chunks, selections and appends written by each
  library and read by both (hypothesis);
* HDF5Output-style appends stay within 1.25x of h5py's file and never move
  or rewrite a chunk written before.
"""

import os
import shutil

import h5py
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from h5py._hl.filters import guess_chunk as h5py_guess_chunk

import hdf5_fixtures as hf
from caffe_rtpose_tpu_torch.utils import hdf5, hdf5_fmt

DIGESTS = hf.load_digests()
READ_FILES = sorted(n for n, d in DIGESTS.items() if "refused" not in d)


def assert_same_values(got, want, where=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (where, got.dtype, want.dtype,
                                                                 got.shape, want.shape)
    if got.dtype == object:
        assert got.ravel().tolist() == want.ravel().tolist(), where
    else:
        assert got.tobytes() == want.tobytes(), where


def assert_files_equal(path_port_reads, path_h5py_reads=None):
    """Every group and dataset the port reads in one file equals what h5py
    reads in the other (the same file by default)."""
    path_h5py_reads = path_h5py_reads or path_port_reads
    with hdf5.File(path_port_reads) as a, h5py.File(path_h5py_reads, "r") as b:
        def walk(ga, gb, name):
            assert list(ga.keys()) == list(gb.keys()), name
            for k in gb:
                oa, ob = ga[k], gb[k]
                if isinstance(ob, h5py.Group):
                    assert isinstance(oa, hdf5.Group), f"{name}/{k}"
                    walk(oa, ob, f"{name}/{k}")
                else:
                    assert oa.shape == ob.shape and oa.maxshape == ob.maxshape \
                        and oa.chunks == ob.chunks, f"{name}/{k}"
                    assert_same_values(oa[()], ob[()], f"{name}/{k}")
        walk(a, b, "")


# ---------------------------------------------------------------- reading


@pytest.mark.parametrize("name", READ_FILES)
def test_reads_libhdf5_fixtures(name):
    path = os.path.join(hf.DIR, name)
    assert hf.contents(hdf5, path, lambda d: d._obj.addr) == DIGESTS[name]
    assert_files_equal(path)


@pytest.mark.parametrize("kind", sorted(hf.REFUSED))
def test_refuses_unsupported_features(kind):
    name, words = hf.REFUSED[kind]
    path = os.path.join(hf.DIR, name)
    with pytest.raises(ValueError) as err:
        with hdf5.File(path) as f:
            def walk(g):
                for k in g:
                    obj = g[k]
                    walk(obj) if isinstance(obj, hdf5.Group) else obj[()]
            walk(f)
    assert words in str(err.value) and path in str(err.value), str(err.value)


def test_selections_match_h5py():
    """Integers (negative too), slices with steps, sorted index arrays,
    ``()`` and ``...`` on compact, contiguous, chunked and gzip data."""
    path = os.path.join(hf.DIR, "layouts.h5")
    keys = [(), Ellipsis, 0, -1, (slice(1, None, 2),), (slice(None), 2),
            (np.array([0, 2, 3]),), (1, slice(0, 3)), (Ellipsis, -1),
            (slice(2, 2),), (np.array([1, 3]), slice(1, None, 3))]
    with hdf5.File(path) as a, h5py.File(path, "r") as b:
        for name in ("compact", "contiguous", "chunked", "partial", "filled_chunked"):
            for key in keys:
                assert_same_values(a[name][key], b[name][key], f"{name}[{key}]")
        assert_same_values(a["scalar"][()], b["scalar"][()])
        assert_same_values(a["scalar"][...], b["scalar"][...])
        assert type(a["scalar"][()]) is type(b["scalar"][()])
        assert len(a["contiguous"]) == len(b["contiguous"]) == 6
        assert_same_values(np.asarray(a["chunked"]), np.asarray(b["chunked"]))
    path = os.path.join(hf.DIR, "strings.h5")
    with hdf5.File(path) as a, h5py.File(path, "r") as b:
        for name in b:
            assert a[name][()] == b[name][()] if b[name].shape == () else \
                a[name][()].tolist() == b[name][()].tolist(), name


@pytest.mark.parametrize("shape", [(0,), (1,), (5, 3), (0, 3), (512, 3, 227, 227), (3, 4, 5, 2),
                                   (100, 1000), (1, 1, 1, 1), (7, 0, 9), (10 ** 6,),
                                   (2, 3, 368, 368), (1024, 1024, 3)])
@pytest.mark.parametrize("itemsize", [1, 4, 8])
def test_guess_chunk_is_h5pys(shape, itemsize):
    assert hdf5_fmt.guess_chunk(shape, itemsize) == h5py_guess_chunk(shape, None, itemsize)


# ---------------------------------------------------------------- writing


def write_grid(lib, path):
    """The same content through either library's interface."""
    rs = np.random.RandomState(3)
    with lib.File(path, "w") as f:
        for dt in hf.NUMERIC:
            for order in "<>":
                for rank, shape in enumerate(hf.RANK_SHAPES):
                    f[f"{dt}{order == '>' and 'be' or 'le'}_r{rank}"] = \
                        (rs.standard_normal(shape) * 50).astype(order + dt)
        f["bool"] = rs.rand(9) > 0.5
        f["iter"] = np.int64(1200)
        f["learned_net"] = "snapshots/caffenet_iter_1200.caffemodel.h5"
        f["filename"] = [b"a.png", b"", b"some dir/b.jpg"]
        f["names"] = ["ü", "xyz"]
        f["fixed"] = np.array([b"ab", b"cde"], "S5")
        f.create_dataset("gzip", data=rs.randint(0, 255, (40, 3, 9, 9)).astype(np.uint8),
                         compression="gzip")
        f.create_dataset("chunks", data=rs.rand(33, 17), chunks=(8, 5))
        f.create_dataset("unlimited", shape=(0, 4), maxshape=(None, 4), dtype="f4")
        d = f.create_dataset("grown", data=rs.rand(3, 2).astype("f4"), maxshape=(None, 2))
        d.resize(10, axis=0)
        d[3:7] = 2.0
        f.create_dataset("unwritten", shape=(5, 3), dtype="i2")
        part = f.create_dataset("partial", shape=(12, 12), chunks=(5, 5), dtype=">f8")
        part[2:4, 6:11] = 1.25
        data = f.create_group("data")
        for i in range(60):
            data.create_group(f"conv{i}_{i % 7}").create_dataset("0", data=rs.rand(2, i % 3 + 1))
        big = f.create_group("big")
        for i in rs.permutation(1000):
            big[f"m{i}"] = np.int16(i)
        f.create_group("a/b/c")["leaf"] = np.arange(4)
        f.create_group("empty")


def test_h5py_reads_what_the_port_writes(tmp_path):
    write_grid(hdf5, tmp_path / "port.h5")
    write_grid(h5py, tmp_path / "h5py.h5")
    assert_files_equal(tmp_path / "port.h5", tmp_path / "h5py.h5")  # the port reads its own
    assert_files_equal(tmp_path / "h5py.h5", tmp_path / "port.h5")  # h5py reads the port's
    with h5py.File(tmp_path / "port.h5", "r") as f:
        assert f["learned_net"][()] == b"snapshots/caffenet_iter_1200.caffemodel.h5"
        assert f["gzip"].compression == "gzip" and f["gzip"].compression_opts == 4
        assert f["unlimited"].maxshape == (None, 4)
    assert os.path.getsize(tmp_path / "port.h5") <= 1.1 * os.path.getsize(tmp_path / "h5py.h5")


@pytest.mark.parametrize("name", ["groups.h5", "layouts.h5", "filters.h5", "deep_btrees.h5",
                                  "userblock.h5", "strings.h5", "extras.h5"])
def test_append_mode_on_h5py_files(tmp_path, name):
    """The port changes libhdf5's file in place; h5py reads the result, then
    changes it again, and the port reads that."""
    port, ref = tmp_path / "port.h5", tmp_path / "ref.h5"
    shutil.copy(os.path.join(hf.DIR, name), port)
    shutil.copy(os.path.join(hf.DIR, name), ref)
    rs = np.random.RandomState(9)

    def change(lib, path):
        with lib.File(path, "a") as f:
            for i in range(45):  # the root's symbol-table nodes and B-tree split
                f[f"added{i:02d}"] = np.arange(i, dtype="<i4")
            sub = f.create_group("added_group")
            sub["x"] = rs.rand(3)
            for key in list(f.keys()):
                obj = f[key]
                if not isinstance(obj, (h5py.Group, hdf5.Group)):
                    continue
                obj[f"new_member_{key}"] = np.float32(len(key))
            for key in list(f.keys()):
                obj = f[key]
                if isinstance(obj, (h5py.Group, hdf5.Group)) or obj.chunks is None:
                    continue
                if obj.maxshape[0] is None:
                    n = obj.shape[0]
                    obj.resize(n + 5, axis=0)
                    obj[n:] = np.ones((5,) + obj.shape[1:], obj.dtype)
                elif 0 not in obj.shape:
                    rank = len(obj.shape)
                    obj[(slice(0, 1),) * rank] = np.zeros((1,) * rank, obj.dtype)
    change(hdf5, port)
    rs = np.random.RandomState(9)
    change(h5py, ref)
    assert_files_equal(port, ref)
    assert_files_equal(ref, port)
    with h5py.File(port, "a") as f:
        f["after_h5py"] = np.arange(3)
        f["added_group"].create_dataset("y", data=np.ones(4), maxshape=(None,))
    assert_files_equal(port)


def test_many_chunks_deepen_the_index(tmp_path):
    """A chunk index of several levels (splits at the root and below), built
    by appends and by writes in the middle, in a new file and in one
    libhdf5 made with K = 2."""
    rs = np.random.RandomState(5)
    full = rs.rand(300, 9).astype("<f4")
    with hdf5.File(tmp_path / "new.h5", "w") as f:
        d = f.create_dataset("x", shape=(0, 9), maxshape=(None, 9), chunks=(2, 3), dtype="<f4")
        for i in range(0, 300, 10):
            d.resize(i + 10, axis=0)
            d[i : i + 10] = full[i : i + 10]
        e = f.create_dataset("y", shape=(300, 9), chunks=(2, 3), dtype="<f4")
        for i in rs.permutation(150):
            e[2 * i : 2 * i + 2] = full[2 * i : 2 * i + 2]
    with h5py.File(tmp_path / "new.h5", "r") as f:
        np.testing.assert_array_equal(f["x"][()], full)
        np.testing.assert_array_equal(f["y"][()], full)
    shutil.copy(os.path.join(hf.DIR, "deep_btrees.h5"), tmp_path / "deep.h5")
    with hdf5.File(tmp_path / "deep.h5", "a") as f:
        before = f["chunks"][()]
        f["chunks"].resize((60, 30))
        f["chunks"][30:, 20:] = 1.0
        f["chunks"][:30, 20:] = 2.0
    with h5py.File(tmp_path / "deep.h5", "r") as f:
        got = f["chunks"][()]
    assert (got[:30, :20] == before).all() and (got[30:, 20:] == 1).all()
    assert (got[:30, 20:] == 2).all() and (got[30:, :20] == 0).all()


# ---------------------------------------------------------------- properties

DTYPES = ["<i1", ">u2", "<i4", ">i8", "<f2", ">f4", "<f8", "|b1"]


@st.composite
def cases(draw):
    rank = draw(st.integers(1, 3))
    chunked = draw(st.booleans())
    shape = tuple(draw(st.integers(0 if k == 0 or not chunked else 1, 7)) for k in range(rank))
    dtype = draw(st.sampled_from(DTYPES))
    chunks = tuple(draw(st.integers(1, 4 if k == 0 else n)) for k, n in enumerate(shape)) \
        if chunked else None
    gzip = chunked and draw(st.booleans())
    grow = [draw(st.integers(1, 5)) for _ in range(draw(st.integers(0, 3)))] if chunked else []
    sels = []
    for _ in range(3):
        sel = []
        for n in shape[1:]:
            a = draw(st.integers(0, n))
            sel.append(slice(a, draw(st.integers(a, n)), draw(st.integers(1, 3))))
        sels.append(tuple(sel))
    return shape, dtype, chunks, gzip, grow, sels, draw(st.integers(0, 2 ** 16))


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow,
                                                                  HealthCheck.function_scoped_fixture])
@given(case=cases())
def test_random_datasets_both_ways(tmp_path, case):
    """Each library writes a dataset (random shape, dtype, chunks, gzip),
    grows it along the first axis with a write each time, writes slices;
    both read both files equal to a numpy model."""
    shape, dtype, chunks, gzip, grow, sels, seed = case
    rs = np.random.RandomState(seed)

    def values(shape_):
        return (rs.standard_normal(shape_) * 20).astype(dtype) if dtype != "|b1" \
            else np.asarray(rs.rand(*shape_) > 0.5)
    model = values(shape)
    steps = []
    for n in grow:
        steps.append(values((n,) + shape[1:]))
    slices = [(sel, values(tuple(len(range(*s.indices(m))) for s, m in zip(sel, shape[1:]))))
              for sel in sels]
    paths = {}
    for lib in (hdf5, h5py):
        path = tmp_path / f"{lib.__name__.rsplit('.', 1)[-1]}.h5"
        with lib.File(path, "w") as f:
            kw = dict(maxshape=(None,) + shape[1:], chunks=chunks) if chunks else {}
            d = f.create_dataset("x", data=model, compression="gzip" if gzip else None, **kw)
            for step in steps:
                n = d.shape[0]
                d.resize(n + len(step), axis=0)
                d[n:] = step
            for sel, v in slices:
                if d.shape[0]:
                    d[(slice(0, 1),) + sel] = v[None]
        paths[lib] = path
    want = np.concatenate([model] + steps) if steps else model.copy()
    for sel, v in slices:
        if want.shape[0]:
            want[(slice(0, 1),) + sel] = v[None]
    for reader in (hdf5, h5py):
        for path in paths.values():
            with reader.File(path, "r") as f:
                got = f["x"][()]
                assert_same_values(got, want.astype(got.dtype), f"{reader.__name__} {path.name}")
                assert got.dtype == np.dtype(dtype)
                if want.shape[0] > 1:
                    idx = np.sort(rs.choice(want.shape[0], 2, replace=False))
                    assert_same_values(f["x"][idx], want[idx].astype(got.dtype))


# ---------------------------------------------------------------- appends


def test_output_appends_stay_small_and_in_place(tmp_path):
    """100 HDF5Output-style appends (the file opened in mode 'a' each time):
    no larger than 1.25x h5py's file for the same appends, and every chunk
    written keeps its address and bytes."""
    rs = np.random.RandomState(0)
    batches = [rs.rand(2, 5).astype(np.float32) for _ in range(100)]
    sizes = {}
    for lib in (hdf5, h5py):
        path = tmp_path / f"{lib.__name__.rsplit('.', 1)[-1]}.h5"
        seen = {}
        for arr in batches:
            with lib.File(path, "a") as f:
                for name in ("data", "label"):
                    if name in f:
                        ds = f[name]
                        n = ds.shape[0]
                        ds.resize(n + arr.shape[0], axis=0)
                        ds[n:] = arr
                    else:
                        f.create_dataset(name, data=arr, maxshape=(None,) + arr.shape[1:])
            if lib is hdf5:
                with hdf5.File(path, "r") as f, open(path, "rb") as raw:
                    tree = f["data"]._obj.chunk_tree()
                    for leaf in tree.leaves():
                        for key, addr in zip(leaf.keys, leaf.kids):
                            raw.seek(addr)
                            stored = raw.read(key[1])
                            assert seen.setdefault(key[0], (addr, stored)) == (addr, stored)
        sizes[lib] = os.path.getsize(path)
        with h5py.File(path, "r") as f:
            np.testing.assert_array_equal(f["data"][()], np.concatenate(batches))
    assert sizes[hdf5] <= 1.25 * sizes[h5py], sizes
