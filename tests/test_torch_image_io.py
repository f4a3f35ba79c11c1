"""The pipeline's image reader (pipeline/image_io.py) against cv2.imread on
files that cv2.imwrite wrote (gray, RGB and RGBA, odd widths), and on PNGs
whose rows use each of the five scanline filters."""

import struct
import sys
import zlib

import numpy as np
import pytest

from caffe_rtpose_tpu_torch.pipeline.image_io import read_image

cv2 = pytest.importorskip("cv2")

SHAPES = [(23, 37), (23, 37, 3), (23, 37, 4), (64, 31, 3), (5, 1, 3), (17, 33, 4), (9, 6)]


def _image(shape, seed):
    img = (np.random.RandomState(seed).rand(*shape) * 255).astype(np.uint8)
    img[: shape[0] // 3] = 40  # a flat band, which makes the encoder choose other filters
    return img


@pytest.mark.parametrize("ext", [".png", ".bmp"])
@pytest.mark.parametrize("shape", SHAPES)
def test_matches_cv2_imread(tmp_path, ext, shape):
    path = str(tmp_path / f"img{ext}")
    assert cv2.imwrite(path, _image(shape, len(shape) * 100 + shape[1]))
    ref = cv2.imread(path, cv2.IMREAD_COLOR)
    got = read_image(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def _png_with_filters(path, rgb):
    """Encode (H, W, 3) RGB with row y filtered by type y % 5."""
    h, w, _ = rgb.shape
    px = rgb.reshape(h, w * 3).astype(np.int32)
    rows = []
    for y in range(h):
        ft = y % 5
        cur, up = px[y], px[y - 1] if y else np.zeros(w * 3, np.int32)
        left = np.concatenate([np.zeros(3, np.int32), cur[:-3]])
        ul = np.concatenate([np.zeros(3, np.int32), up[:-3]])
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        rows.append(bytes([ft]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def test_every_png_filter(tmp_path):
    path = str(tmp_path / "filters.png")
    rgb = (np.random.RandomState(3).rand(11, 13, 3) * 255).astype(np.uint8)
    _png_with_filters(path, rgb)
    np.testing.assert_array_equal(read_image(path), cv2.imread(path, cv2.IMREAD_COLOR))
    np.testing.assert_array_equal(read_image(path), rgb[:, :, ::-1])


def test_jpeg_through_cv2_and_named_without_it(tmp_path, monkeypatch):
    """JPEG is read by the port's codec, cv2 blocked: the pixels cv2.imread
    gave before the block, in colour and as the IMREAD_GRAYSCALE plane."""
    path = str(tmp_path / "f.jpg")
    cv2.imwrite(path, _image((16, 24, 3), 5))
    ref = cv2.imread(path, cv2.IMREAD_COLOR)
    ref_gray = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(read_image(path), ref)
    np.testing.assert_array_equal(read_image(path, gray=True), ref_gray)
    (tmp_path / "bad.jpg").write_bytes(b"\xff\xd8\xff")
    with pytest.raises(ValueError, match="bad.jpg"):
        read_image(str(tmp_path / "bad.jpg"))


def test_refuses_what_it_cannot_read(tmp_path):
    bad = tmp_path / "x.png"
    bad.write_bytes(b"not a png")
    with pytest.raises(ValueError, match="x.png"):
        read_image(str(bad))
    with pytest.raises(ValueError):
        read_image(str(tmp_path / "x.gif"))
