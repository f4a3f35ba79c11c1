"""The port's data layers (``core/data_layers.py``) against JAX's on the
same sources written here: a kvdb of Datums (raw and PNG-encoded) with a
mean file, crop and mirror; a list of PNGs; arrays; an HDF5 file; a window
file; a CPM genLMDB-format DB.  The batches are equal where both sides run
the same numpy (Data, MemoryData, HDF5Data), and where the port's numpy
repeats ``cv2``'s fixed-point u8 INTER_LINEAR (ImageData's resize,
WindowData's warped crop).  Also the mean ``.binaryproto`` codec, the
self-feeding net and ``resize_image``'s three orders against JAX's cv2."""

import numpy as np
import pytest

from caffe_rtpose_tpu_torch.core import data_layers as PD
from caffe_rtpose_tpu_torch.pipeline.image_io import encode_png
from caffe_rtpose_tpu_torch.proto import caffe_pb
from caffe_rtpose_tpu_torch.proto import datum as datum_io
from caffe_rtpose_tpu_torch.utils import db as dbmod


def write_db(path, n=8, c=3, h=10, w=9, encoded=False, seed=0):
    rs = np.random.RandomState(seed)
    d = dbmod.open_db(path, "w", backend="kvdb")
    txn = d.new_transaction()
    arrays = []
    for i in range(n):
        arr = rs.randint(0, 256, (c, h, w)).astype(np.uint8)
        arrays.append(arr)
        if encoded:
            rec = {"channels": c, "height": h, "width": w, "label": i, "encoded": True,
                   "data": encode_png(np.transpose(arr, (1, 2, 0)))}
        else:
            rec = datum_io.array_to_datum(arr, label=i)
        txn.put(f"{i:08d}", datum_io.serialize_datum(rec))
    txn.commit()
    d.close()
    return arrays


def both(layer, phase):
    from caffe_rtpose_tpu.core import data_layers as JD
    from caffe_rtpose_tpu.proto import caffe_pb as jpb

    return (PD.build(caffe_pb.view(layer, "LayerParameter"), phase),
            JD.build(jpb.view(layer, "LayerParameter"), phase))


def same_batches(p, j, n=3, atol=0.0):
    assert p.top_shapes == j.top_shapes
    for _ in range(n):
        a, b = p.next_batch(), j.next_batch()
        assert list(a) == list(b)
        for k in a:
            assert a[k].shape == b[k].shape
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("encoded", [False, True], ids=["raw", "png"])
@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
def test_data_layer_matches_jax(tmp_path, phase, encoded):
    src = str(tmp_path / "db")
    arrays = write_db(src, encoded=encoded)
    mean = np.stack(arrays).mean(0).astype(np.float32)
    PD.write_mean_binaryproto(str(tmp_path / "mean.binaryproto"), mean)
    layer = {"name": "data", "type": "Data", "top": ["data", "label"],
             "data_param": {"source": src, "batch_size": 3, "rand_skip": 3},
             "transform_param": {"crop_size": 6, "mirror": True, "scale": 0.5,
                                 "mean_file": str(tmp_path / "mean.binaryproto")}}
    same_batches(*both(layer, phase), n=4)


def test_mean_values_and_codec(tmp_path):
    from caffe_rtpose_tpu.core import data_layers as JD

    m = np.random.RandomState(1).rand(3, 4, 5).astype(np.float32)
    PD.write_mean_binaryproto(str(tmp_path / "p.binaryproto"), m)
    JD.write_mean_binaryproto(str(tmp_path / "j.binaryproto"), m)
    assert (tmp_path / "p.binaryproto").read_bytes() == (tmp_path / "j.binaryproto").read_bytes()
    np.testing.assert_array_equal(PD.read_mean_binaryproto(str(tmp_path / "j.binaryproto")), m)
    src = str(tmp_path / "db")
    write_db(src)
    layer = {"name": "data", "type": "Data", "top": ["data"],
             "data_param": {"source": src, "batch_size": 2},
             "transform_param": {"mean_value": [100.0, 120.0, 90.0]}}
    same_batches(*both(layer, "TEST"))


def write_pngs(tmp_path, n=3, h=10, w=12):
    rs = np.random.RandomState(0)
    names = []
    for i in range(n):
        (tmp_path / f"img{i}.png").write_bytes(encode_png(rs.randint(0, 256, (h, w, 3))
                                                          .astype(np.uint8)))
        names.append(f"img{i}.png")
    (tmp_path / "list.txt").write_text("".join(f"{n} {i}\n" for i, n in enumerate(names)))
    return names


@pytest.mark.parametrize("resize", [False, True])
def test_image_data_layer_matches_jax(tmp_path, resize):
    write_pngs(tmp_path)
    p = {"source": str(tmp_path / "list.txt"), "batch_size": 2,
         "root_folder": str(tmp_path) + "/", "shuffle": True}
    if resize:
        p.update(new_height=7, new_width=9)
    layer = {"name": "data", "type": "ImageData", "top": ["data", "label"],
             "image_data_param": p, "transform_param": {"mirror": True}}
    # the port's fixed-point u8 resize against cv2's: equal
    same_batches(*both(layer, "TRAIN"))


@pytest.mark.parametrize("is_color", [True, False])
def test_image_data_layer_jpeg_matches_jax(tmp_path, is_color):
    """A JPEG list (4:2:0 colour files, odd sizes): the port's codec against
    JAX's cv2.imread, IMREAD_COLOR or IMREAD_GRAYSCALE (libjpeg's Y plane):
    equal batches."""
    from caffe_rtpose_tpu_torch.pipeline.jpeg import encode_jpeg

    rs = np.random.RandomState(1)
    for i in range(3):
        img = rs.randint(0, 256, (11, 13, 3)).astype(np.uint8)
        img[:5] = img[:5] // 4 + 90  # a smoother band
        (tmp_path / f"img{i}.jpg").write_bytes(encode_jpeg(img, 90))
    (tmp_path / "list.txt").write_text("".join(f"img{i}.jpg {i}\n" for i in range(3)))
    layer = {"name": "data", "type": "ImageData", "top": ["data", "label"],
             "image_data_param": {"source": str(tmp_path / "list.txt"), "batch_size": 2,
                                  "root_folder": str(tmp_path) + "/", "is_color": is_color},
             "transform_param": {"mirror": True}}
    p, j = both(layer, "TRAIN")
    assert p.top_shapes["data"] == ((2, 3, 11, 13) if is_color else (2, 1, 11, 13))
    same_batches(p, j)


@pytest.mark.parametrize("ext", ["png", "bmp"])
def test_image_data_layer_gray_matches_jax(tmp_path, ext):
    """ROADMAP C7: ImageData with is_color false over colour PNG and BMP
    files: the port's gray read (libpng's and OpenCV's BMP fixed point)
    against JAX's cv2.imread(IMREAD_GRAYSCALE): equal batches, resized and
    not."""
    cv2 = pytest.importorskip("cv2")  # JAX's side
    rs = np.random.RandomState(2)
    for i in range(3):
        assert cv2.imwrite(str(tmp_path / f"img{i}.{ext}"),
                           rs.randint(0, 256, (11, 13, 3)).astype(np.uint8))
    (tmp_path / "list.txt").write_text("".join(f"img{i}.{ext} {i}\n" for i in range(3)))
    for resize in ({}, {"new_height": 7, "new_width": 9}):
        layer = {"name": "data", "type": "ImageData", "top": ["data", "label"],
                 "image_data_param": {"source": str(tmp_path / "list.txt"), "batch_size": 2,
                                      "root_folder": str(tmp_path) + "/", "is_color": False,
                                      **resize},
                 "transform_param": {"mirror": True}}
        p, j = both(layer, "TRAIN")
        assert p.top_shapes["data"][1] == 1
        same_batches(p, j)


def test_memory_data_layer_matches_jax():
    from caffe_rtpose_tpu.core.net import Net as JNet

    from caffe_rtpose_tpu_torch.core.net import Net

    proto = {"layer": [{"name": "data", "type": "MemoryData", "top": ["data", "label"],
                        "memory_data_param": {"batch_size": 2, "channels": 1, "height": 3,
                                              "width": 3}},
                       {"name": "a", "type": "AbsVal", "bottom": ["data"], "top": ["out"]}]}
    data = np.arange(36, dtype=np.float32).reshape(4, 1, 3, 3) - 10
    labels = np.array([5, 6, 7, 8], np.float32)
    net, jnet = Net(proto, device="cpu"), JNet(proto)
    for n in (net, jnet):
        n.set_input_arrays(data, labels)
    for _ in range(3):
        a = net.forward({}, outputs=["out", "label"])
        b = jnet.forward({}, outputs=["out", "label"])
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), b[k])


def test_hdf5_data_layer_matches_jax(tmp_path):
    from caffe_rtpose_tpu_torch.utils import hdf5

    rs = np.random.RandomState(0)
    with hdf5.File(tmp_path / "d.h5", "w") as f:  # the port's codec; JAX reads it with h5py
        f["data"] = rs.rand(6, 2, 4, 4).astype(np.float32)
        f["label"] = np.arange(6, dtype=np.float32)
    (tmp_path / "files.txt").write_text(str(tmp_path / "d.h5") + "\n")
    layer = {"name": "data", "type": "HDF5Data", "top": ["data", "label"],
             "hdf5_data_param": {"source": str(tmp_path / "files.txt"), "batch_size": 3}}
    pytest.importorskip("h5py")  # JAX's side
    same_batches(*both(layer, "TEST"))


def test_window_data_layer_matches_jax(tmp_path):
    rs = np.random.RandomState(0)
    (tmp_path / "a.png").write_bytes(encode_png(rs.randint(0, 256, (40, 50, 3))
                                                .astype(np.uint8)))
    (tmp_path / "win.txt").write_text(f"# 0\n{tmp_path}/a.png\n3 40 50\n3\n"
                                      "1 0.9 5 5 30 30\n2 0.7 10 3 45 35\n0 0.1 0 0 10 10\n")
    layer = {"name": "w", "type": "WindowData", "top": ["data", "label"],
             "window_data_param": {"source": str(tmp_path / "win.txt"), "batch_size": 4,
                                   "crop_size": 16, "fg_fraction": 0.5, "context_pad": 2,
                                   "mirror": True}}
    p, j = both(layer, "TRAIN")
    # the warped crop: the port's fixed-point u8 resize against cv2's, equal
    same_batches(p, j)


def test_window_data_layer_jpeg_matches_jax(tmp_path):
    """WindowData over a JPEG (JAX reads its windows' images with
    cv2.imread, IMREAD_COLOR, the layer's only mode)."""
    from caffe_rtpose_tpu_torch.pipeline.jpeg import encode_jpeg

    rs = np.random.RandomState(0)
    (tmp_path / "a.jpg").write_bytes(encode_jpeg(rs.randint(0, 256, (40, 50, 3))
                                                 .astype(np.uint8), 95))
    (tmp_path / "win.txt").write_text(f"# 0\n{tmp_path}/a.jpg\n3 40 50\n3\n"
                                      "1 0.9 5 5 30 30\n2 0.7 10 3 45 35\n0 0.1 0 0 10 10\n")
    layer = {"name": "w", "type": "WindowData", "top": ["data", "label"],
             "window_data_param": {"source": str(tmp_path / "win.txt"), "batch_size": 4,
                                   "crop_size": 16, "fg_fraction": 0.5, "context_pad": 2,
                                   "mirror": True}}
    p, j = both(layer, "TRAIN")
    # the warped crop: the port's fixed-point u8 resize against cv2's, equal
    same_batches(p, j)


def test_cpm_data_layer_reads_what_jax_reads(tmp_path):
    """CPMData: the same genLMDB records and augmentation knobs as JAX's
    layer, and batches of the declared shapes (the chain itself is held
    against JAX in test_torch_transformer.py)."""
    from caffe_rtpose_tpu_torch.training.cpm_lmdb import write_cpm_db
    from caffe_rtpose_tpu_torch.training.transformer import Meta, Person

    rs = np.random.RandomState(2)
    recs = []
    for _ in range(3):
        j = rs.uniform(10, 90, size=(17, 2)).astype(np.float32)
        recs.append((rs.randint(0, 256, (96, 96, 3)).astype(np.uint8),
                     Meta(people=[Person(j, np.ones(17, np.int32), j.mean(0))], scale_self=1.0),
                     np.full((96, 96), 255, np.uint8)))
    write_cpm_db(recs, str(tmp_path / "cpm"))
    layer = {"name": "data", "type": "CPMData", "top": ["data", "label"],
             "data_param": {"source": str(tmp_path / "cpm"), "batch_size": 2},
             "transform_param": {"stride": 8, "crop_size_x": 64, "crop_size_y": 64,
                                 "num_parts": 56, "np_in_lmdb": 17, "max_rotate_degree": 10}}
    p, j = both(layer, "TRAIN")
    assert p.top_shapes == j.top_shapes == {"data": (2, 3, 64, 64), "label": (2, 114, 8, 8)}
    assert vars(p.prm) == vars(j.prm)
    for i in range(3):
        a, b = p.source[i], j.source[i]
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1].people[0].joints, b[1].people[0].joints)
    batch = p.next_batch()
    assert batch["data"].shape == (2, 3, 64, 64) and batch["label"].shape == (2, 114, 8, 8)
    assert np.isfinite(batch["label"]).all()


def test_net_feeds_itself_from_its_data_layers(tmp_path):
    """A net with Data layers pulls a batch a forward (TRAIN and TEST
    filtered by their include rules), as JAX's net does."""
    from caffe_rtpose_tpu.core.net import Net as JNet

    from caffe_rtpose_tpu_torch.core.net import Net

    src = str(tmp_path / "db")
    write_db(src, h=6, w=5)
    proto = {"layer": [
        {"name": "d", "type": "Data", "top": ["data", "label"], "include": [{"phase": 0}],
         "data_param": {"source": src, "batch_size": 4}, "transform_param": {"scale": 0.5}},
        {"name": "d", "type": "Data", "top": ["data", "label"], "include": [{"phase": 1}],
         "data_param": {"source": src, "batch_size": 2}},
        {"name": "pool", "type": "Pooling", "bottom": ["data"], "top": ["pooled"],
         "pooling_param": {"kernel_size": 2, "stride": 2}}]}
    for phase in ("TRAIN", "TEST"):
        net, jnet = Net(proto, phase=phase, device="cpu"), JNet(proto, phase=phase)
        assert net.input_names == jnet.input_names == ["data", "label"]
        for _ in range(2):
            a = net.forward({}, outputs=["pooled", "label"])
            b = jnet.forward({}, outputs=["pooled", "label"])
            for k in a:
                np.testing.assert_allclose(a[k].numpy(), b[k], rtol=1e-6)


@pytest.mark.parametrize("order", [0, 1, 2])
@pytest.mark.parametrize("dims", [(13, 17), (5, 4), (10, 12)])
def test_resize_image_matches_jax_cv2(order, dims):
    """``api.resize_image`` (numpy) against JAX's (``cv2.resize`` on a
    float image): within 1e-5 of the image's range."""
    from caffe_rtpose_tpu import api as japi

    from caffe_rtpose_tpu_torch import api

    im = np.random.RandomState(3).rand(10, 12, 3).astype(np.float32)
    got, ref = api.resize_image(im, dims, order), japi.resize_image(im, dims, order)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


# ROADMAP C5: the u8 INTER_CUBIC resampler is within one level of cv2 on at
# most this share of values
C5_SHARE = 0.000872


@pytest.mark.parametrize("dtype", ["uint8", "float32", "float64"])
@pytest.mark.parametrize("order", [0, 1, 2])
def test_resize_image_keeps_dtype_and_matches_jax(dtype, order):
    """ROADMAP C8: ``api.resize_image`` returns the input's dtype, as JAX's
    ``cv2.resize`` does. u8: nearest and bilinear equal cv2, bicubic within
    C5 (one level, on at most C5_SHARE of the values); f32 and f64 within
    1e-5 of values in [0, 1). Up, down, each axis, 1, 3 and 4 channels."""
    from caffe_rtpose_tpu import api as japi

    from caffe_rtpose_tpu_torch import api

    rs = np.random.RandomState(order)
    for shape, dims in (((10, 12, 3), (13, 17)), ((10, 12, 3), (5, 4)), ((31, 29, 1), (20, 44)),
                        ((40, 50, 3), (81, 21)), ((9, 7, 4), (5, 11)), ((64, 48, 3), (32, 24))):
        im = (rs.randint(0, 256, shape) if dtype == "uint8" else rs.rand(*shape)).astype(dtype)
        got, ref = api.resize_image(im, dims, order), japi.resize_image(im, dims, order)
        assert got.dtype == ref.dtype == np.dtype(dtype) and got.shape == ref.shape
        diff = np.abs(got.astype(np.float64) - ref)
        if dtype != "uint8":
            assert diff.max() <= 1e-5
        elif order == 2:
            assert diff.max() <= 1 and (diff > 0).mean() <= C5_SHARE
        else:
            np.testing.assert_array_equal(got, ref)


def test_native_kvdb_binding_matches_the_python_twin(tmp_path):
    """ROADMAP A.3: ``native/kvdb.cpp`` built into the port's ``_build/``
    and bound by ctypes; the pure-Python store is its twin.  A DB written by
    either reads the same through the other (keys sorted, the last write of
    a key wins, a second commit merges), byte for byte on disk."""
    import shutil

    from caffe_rtpose_tpu_torch import native
    from caffe_rtpose_tpu_torch.utils import db as pdb

    if shutil.which("g++") is None:
        pytest.skip("no g++: the native store cannot be built here")
    lib = native.load_lib("kvdb")
    assert lib is not None
    rs = np.random.RandomState(0)
    batches = [[(f"{rs.randint(1000):05d}".encode(), rs.bytes(rs.randint(1, 64)))
                for _ in range(40)] for _ in range(2)]
    paths = {}
    for kind, make in (("native", lambda p, w: pdb._NativeKvdb(lib, p, w)),
                       ("python", pdb._PyKvdb)):
        paths[kind] = str(tmp_path / f"{kind}.kvdb")
        store = make(paths[kind], True)
        for batch in batches:
            for k, v in batch:
                store.put(k, v)
            store.commit()
        store.close()
    want = {}
    for k, v in batches[0] + batches[1]:
        want[k] = v
    for path in paths.values():
        for store in (pdb._NativeKvdb(lib, path, False), pdb._PyKvdb(path, False)):
            assert store.count() == len(want)
            assert [store.at(i) for i in range(store.count())] == sorted(want.items())
            k = sorted(want)[7]
            assert store.find(k) == 7 and store.find(b"zzz") < 0
            store.close()
    with open(paths["native"], "rb") as a, open(paths["python"], "rb") as b:
        assert a.read() == b.read()
    assert isinstance(pdb._kvdb_impl(paths["native"], False), pdb._NativeKvdb)
