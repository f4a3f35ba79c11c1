"""The port's OpenCV-free augmentation chain
(``caffe_rtpose_tpu_torch/training/transformer.py``, ``datasets.py``)
against the JAX package's, which calls OpenCV (5.0 here), on the same
images and ``RandomState``.

* joints, visibility, the augmentation draws and every label channel: exact
  (the rotation matrix is ``getRotationMatrix2D``'s closed form, bit for bit);
* images and the mask grid: within one u8 level on every pixel, equal on at
  least 99.9 % of them (measured against OpenCV 5.0.0: the
  chain's images 99.95-100 %, 99.99 % on average, its mask grids 100 %;
  the cubic resize alone 99.91-100 %, the rotation warp 99.93-99.97 %);
* CLAHE (``do_clahe``) and the synthetic source's images: equal, with
  ``cv2`` blocked on the port's side (OpenCV's u8 Lab, CLAHE and
  ``cv2.line`` in numpy, ``utils/imgproc.py``)."""

import sys

import cv2
import numpy as np
import pytest

from caffe_rtpose_tpu.training import datasets as JD
from caffe_rtpose_tpu.training import labels_device as JL
from caffe_rtpose_tpu.training import transformer as JT
from caffe_rtpose_tpu_torch.training import datasets as PD
from caffe_rtpose_tpu_torch.training import labels_device as PL
from caffe_rtpose_tpu_torch.training import transformer as PT

EQUAL_SHARE = 0.999


def _within_one_level(got, ref):
    """Max |diff| <= 1 and the share of equal values; returns the share."""
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert got.shape == ref.shape and d.max() <= 1
    return float((d == 0).mean())


# ------------------------------------------------------------- resamplers


@pytest.mark.parametrize("shape,fx", [((368, 368, 3), 0.4237), ((480, 640, 3), 0.55),
                                      ((200, 300, 3), 1.7), ((368, 368), 0.125),
                                      ((123, 77), 0.9), ((90, 120, 3), 1.0)])
def test_resize_cubic_against_cv2(shape, fx):
    rs = np.random.RandomState(0)
    img = (rs.rand(*shape) * 255).astype(np.uint8)
    got = PT.resize_cubic(img, fx)
    ref = cv2.resize(img, (0, 0), fx=fx, fy=fx, interpolation=cv2.INTER_CUBIC)
    assert _within_one_level(got, ref) >= EQUAL_SHARE


@pytest.mark.parametrize("center,degree", [((110.0, 100.0), 17.3), ((125.0, 150.0), -38.2),
                                           ((75.0, 75.0), 3.0), ((320.0, 240.0), 40.0),
                                           ((13.5, 7.5), -0.1)])
def test_rotation_matrix_exact(center, degree):
    np.testing.assert_array_equal(PT.rotation_matrix_2d(center, degree, 1.0),
                                  cv2.getRotationMatrix2D(center, degree, 1.0))


@pytest.mark.parametrize("shape,degree,border", [((200, 220, 3), 17.3, (128, 128, 128)),
                                                 ((300, 250, 3), -38.2, (128, 128, 128)),
                                                 ((150, 150), 3.0, (255,)),
                                                 ((240, 320), -25.0, (255,))])
def test_warp_affine_cubic_against_cv2(shape, degree, border):
    rs = np.random.RandomState(1)
    img = (rs.rand(*shape) * 255).astype(np.uint8)
    h, w = shape[:2]
    center = (w / 2.0, h / 2.0)
    m = PT.rotation_matrix_2d(center, degree)
    bw, bh = int(w * 1.4), int(h * 1.3)
    m[0, 2] += bw / 2.0 - center[0]
    m[1, 2] += bh / 2.0 - center[1]
    got = PT.warp_affine_cubic(img, m, (bw, bh), border)
    ref = cv2.warpAffine(img, m, (bw, bh), flags=cv2.INTER_CUBIC,
                         borderMode=cv2.BORDER_CONSTANT, borderValue=border + (0,) * (4 - len(border)))
    assert _within_one_level(got, ref) >= EQUAL_SHARE


# ------------------------------------------------------------ the chain


class SharedSource:
    """The JAX synthetic source's images, with masks, for both chains."""

    def __init__(self, n=6, size=200):
        self.src = JD.SyntheticPoseSource(n=n, size=size, seed=0)
        self.size = size

    def __len__(self):
        return len(self.src)

    def __getitem__(self, i):
        img, meta, _ = self.src[i]
        rs = np.random.RandomState(50 + i)
        mask = np.full((self.size, self.size), 255, np.uint8)
        if i % 2:  # a random mask_miss on every other sample
            mask = ((rs.rand(self.size, self.size) > 0.1) * 255).astype(np.uint8)
        return img, meta, mask


@pytest.fixture(scope="module")
def shared():
    return SharedSource()


def _port_meta(meta):
    return PT.Meta(people=[PT.Person(p.joints.copy(), p.visible.copy(), p.objpos.copy())
                           for p in meta.people], scale_self=meta.scale_self)


def test_transform_meta_against_jax(shared):
    jprm = JT.AugParams(crop_size_x=96, crop_size_y=96)
    prm = PT.AugParams(crop_size_x=96, crop_size_y=96)
    shares = []
    for i in range(len(shared)):
        img, meta, mask = shared[i]
        for train in (True, False):
            jd, jpeople, jgrid = JT.transform_meta(img, JD._clone_meta(meta), jprm,
                                                   rng=np.random.RandomState(i), mask_miss=mask,
                                                   train=train, normalize=False)
            pd, ppeople, pgrid = PT.transform_meta(img, _port_meta(meta), prm,
                                                   rng=np.random.RandomState(i), mask_miss=mask,
                                                   train=train, normalize=False)
            for jp, pp in zip(jpeople, ppeople):
                np.testing.assert_array_equal(pp.joints, jp.joints)
                np.testing.assert_array_equal(pp.visible, jp.visible)
                np.testing.assert_array_equal(pp.objpos, jp.objpos)
            shares.append(_within_one_level(pd, jd))
            shares.append(_within_one_level(pgrid, jgrid))
    assert min(shares) >= EQUAL_SHARE


def test_transform_against_jax(shared):
    """The full Transform_nv: data within a level, labels exact (the mask
    grids are compared apart above, so the labels use JAX's grid where the
    grids differ by a level)."""
    jprm = JT.AugParams(crop_size_x=96, crop_size_y=96)
    prm = PT.AugParams(crop_size_x=96, crop_size_y=96)
    for i in range(len(shared)):
        img, meta, mask = shared[i]
        rj, rp = np.random.RandomState(100 + i), np.random.RandomState(100 + i)
        jd, jl, ja = JT.transform(img, JD._clone_meta(meta), jprm, rng=rj, mask_miss=mask)
        pm = _port_meta(meta)
        pd, pl, pa = PT.transform(img, pm, prm, rng=rp, mask_miss=mask)
        assert (pa.scale, pa.degree, pa.crop, pa.flip) == (ja.scale, ja.degree, ja.crop, ja.flip)
        assert _within_one_level(np.rint(pd * 256 + 128), np.rint(jd * 256 + 128)) >= EQUAL_SHARE
        _, _, jgrid = JT.transform_meta(img, JD._clone_meta(meta), jprm,
                                        rng=np.random.RandomState(100 + i), mask_miss=mask)
        np.testing.assert_array_equal(PT.generate_label_map(pm, prm, jgrid), jl)
        if i % 2 == 0:  # constant masks: the grids are equal, so are the labels
            np.testing.assert_array_equal(pl, jl)


@pytest.mark.parametrize("shape,tile,clip", [((32, 32, 3), 8, 4), ((97, 131, 3), 8, 4),
                                             ((60, 45, 3), 4, 2)])
def test_clahe_without_cv2(monkeypatch, shape, tile, clip):
    """do_clahe's step equals JAX's (cv2's Lab and CLAHE) with cv2 blocked."""
    rs = np.random.RandomState(0)
    img = (rs.rand(*shape) * 255).astype(np.uint8)
    img[: shape[0] // 3] //= 5  # a dark band, where CLAHE lifts the most
    ref = JT.clahe(img, tile, clip)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(PT.clahe(img, tile, clip), ref)


@pytest.mark.parametrize("train", [False, True])
def test_transform_meta_do_clahe_against_jax(shared, train):
    """do_clahe through Transform_nv: equal without augmentation (CLAHE and
    the centre crop are exact), within a level with it (the cubic
    resamplers)."""
    jprm = JT.AugParams(crop_size_x=96, crop_size_y=96, do_clahe=True)
    prm = PT.AugParams(crop_size_x=96, crop_size_y=96, do_clahe=True)
    for i in range(4):
        img, meta, mask = shared[i]
        jd, _, jgrid = JT.transform_meta(img, JD._clone_meta(meta), jprm, rng=np.random.RandomState(i),
                                         mask_miss=mask, train=train, normalize=False)
        pd, _, pgrid = PT.transform_meta(img, _port_meta(meta), prm, rng=np.random.RandomState(i),
                                         mask_miss=mask, train=train, normalize=False)
        if train:
            assert _within_one_level(pd, jd) >= EQUAL_SHARE
        else:
            np.testing.assert_array_equal(pd, jd)
            np.testing.assert_array_equal(pgrid, jgrid)


def test_json_source_jpeg_image_and_mask_match_jax(tmp_path):
    """JsonPoseSource over a JPEG image and a colour-JPEG mask: the port's
    codec reads what JAX's cv2.imread reads (datasets.py:66-73), the mask as
    IMREAD_GRAYSCALE, libjpeg's Y plane."""
    import json

    rs = np.random.RandomState(6)
    img = rs.randint(0, 256, (45, 61, 3)).astype(np.uint8)
    mask = np.zeros((45, 61, 3), np.uint8)
    mask[10:30, 5:40] = (255, 200, 90)
    cv2.imwrite(str(tmp_path / "a.jpg"), img)
    cv2.imwrite(str(tmp_path / "m.jpg"), mask)
    joints = [[float(x), float(y), 1] for x, y in rs.uniform(5, 40, (17, 2))]
    (tmp_path / "index.json").write_text(json.dumps(
        [{"image": "a.jpg", "mask": "m.jpg", "scale_self": 0.8, "joints": joints}]))
    (pimg, pmeta, pmask), (jimg, jmeta, jmask) = (
        src(str(tmp_path / "index.json"))[0] for src in (PD.JsonPoseSource, JD.JsonPoseSource))
    np.testing.assert_array_equal(pimg, jimg)
    assert pmask.shape == jmask.shape == (45, 61)
    np.testing.assert_array_equal(pmask, jmask)
    np.testing.assert_array_equal(pmeta.people[0].joints, jmeta.people[0].joints)


@pytest.mark.parametrize("ext", ["png", "bmp"])
def test_json_source_colour_mask_matches_jax(tmp_path, ext):
    """ROADMAP C7: a colour PNG or BMP mask (datasets.py:77) is read gray as
    JAX's cv2.imread(IMREAD_GRAYSCALE) reads it: equal."""
    import json

    rs = np.random.RandomState(7)
    mask = rs.randint(0, 256, (45, 61, 3)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "a.png"), rs.randint(0, 256, (45, 61, 3)).astype(np.uint8))
    cv2.imwrite(str(tmp_path / f"m.{ext}"), mask)
    joints = [[float(x), float(y), 1] for x, y in rs.uniform(5, 40, (17, 2))]
    (tmp_path / "index.json").write_text(json.dumps(
        [{"image": "a.png", "mask": f"m.{ext}", "scale_self": 0.8, "joints": joints}]))
    (pimg, _, pmask), (jimg, _, jmask) = (
        src(str(tmp_path / "index.json"))[0] for src in (PD.JsonPoseSource, JD.JsonPoseSource))
    np.testing.assert_array_equal(pimg, jimg)
    assert pmask.shape == jmask.shape == (45, 61)
    np.testing.assert_array_equal(pmask, jmask)


def test_synthetic_source_same_people():
    """The same people and, limbs drawn by the port's cv2.line, the same
    images as JAX's source."""
    jsrc, psrc = JD.SyntheticPoseSource(n=4, size=240, seed=3), PD.SyntheticPoseSource(n=4, size=240, seed=3)
    for i in range(4):
        jimg, jmeta, _ = jsrc[i]
        pimg, pmeta, pmask = psrc[i]
        assert pmask is None and pimg.shape == jimg.shape and pimg.dtype == np.uint8
        assert len(pmeta.people) == len(jmeta.people)
        for jp, pp in zip(jmeta.people, pmeta.people):
            np.testing.assert_array_equal(pp.joints, jp.joints)
            np.testing.assert_array_equal(pp.visible, jp.visible)
            np.testing.assert_array_equal(pp.objpos, jp.objpos)
        np.testing.assert_array_equal(pimg, jimg)
        assert (pimg.max(-1) >= 100).sum() > 0  # the limbs' colours are >= 100


def test_jointfeed_batches_against_jax(shared):
    """pose_batches_jointfeed: the same joints, visibility and weight grids
    (to a level of the mask), u8 data within a level."""
    jprm = JT.AugParams(crop_size_x=64, crop_size_y=64)
    prm = PT.AugParams(crop_size_x=64, crop_size_y=64)
    jb = next(JL.pose_batches_jointfeed(shared, jprm, 3, max_people=4, seed=2, data_u8=True))
    pb = next(PL.pose_batches_jointfeed(shared, prm, 3, max_people=4, seed=2, data_u8=True))
    for k in ("joints", "vis"):
        np.testing.assert_array_equal(pb[k], jb[k])
    np.testing.assert_allclose(pb["weight"], jb["weight"], atol=1.0 / 255 + 1e-7)
    assert _within_one_level(pb["data"], jb["data"]) >= EQUAL_SHARE


def test_pose_batches_against_jax(shared):
    jprm = JT.AugParams(crop_size_x=64, crop_size_y=64)
    prm = PT.AugParams(crop_size_x=64, crop_size_y=64)
    jb = next(JD.pose_batches(shared, jprm, 2, seed=5))
    pb = next(PD.pose_batches(shared, prm, 2, seed=5))
    assert pb["data"].shape == jb["data"].shape and pb["label"].shape == jb["label"].shape
    assert np.abs(pb["data"] - jb["data"]).max() <= 1.0 / 256 + 1e-7
    # labels: the PAF and gaussian channels come from the joints alone
    np.testing.assert_array_equal(pb["label"][:, 57:113], jb["label"][:, 57:113])
