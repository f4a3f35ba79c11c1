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


def _gray_case(path: str, kind: str, img: np.ndarray) -> None:
    if kind == "bmp8":  # an 8-bit BMP with a colour palette
        from PIL import Image

        idx = (img[..., 0] // 4).astype(np.uint8)
        pal = np.random.RandomState(9).randint(0, 256, (256, 3)).astype(np.uint8)
        im = Image.fromarray(idx, "P")
        im.putpalette(pal.ravel().tolist())
        im.save(path)
    elif kind == "jpg444":
        assert cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])
    elif kind == "bmp32":
        assert cv2.imwrite(path, np.concatenate([img, img[..., :1]], 2))
    else:
        assert cv2.imwrite(path, img[..., 0] if kind.endswith("gray") else img)


@pytest.mark.parametrize("kind", ["png", "png_gray", "bmp", "bmp_gray", "bmp8", "bmp32",
                                  "jpg", "jpg444", "jpg_gray"])
def test_gray_read_matches_cv2(tmp_path, kind, monkeypatch):
    """ROADMAP C7: read_image(gray=True) against cv2.imread(IMREAD_GRAYSCALE)
    on colour and gray PNG, BMP (8-bit palette, 24- and 32-bit) and JPEG
    (4:2:0, 4:4:4, gray) files, cv2 blocked for the port: 0 levels apart.
    Noise and a full ramp of each channel, odd sizes."""
    rs = np.random.RandomState(len(kind))
    img = rs.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    img[:4] = np.arange(53 * 4 * 3).reshape(4, 53, 3) % 256
    path = str(tmp_path / f"img.{kind[:3]}")
    _gray_case(path, kind, img)
    ref = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = read_image(path, gray=True)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    if kind == "png":
        from caffe_rtpose_tpu_torch.pipeline.image_io import decode_png

        with open(path, "rb") as f:
            np.testing.assert_array_equal(decode_png(f.read(), gray=True), ref)
