"""The pipeline's image reader (pipeline/image_io.py) against cv2.imread on
files that cv2.imwrite wrote (gray, RGB and RGBA, odd widths), on PNGs
whose rows use each of the five scanline filters, on files whose extension
names another format (the decoder is chosen by the signature), on the BMP
layouts and PNM files of tests/image_cases.py (colour and gray, against
the pins too); and the BMP and PNM encoders and Datums against
cv2.imencode/imdecode and the JAX package's datum helpers, cv2 blocked for
the port."""

import struct
import sys
import zlib

import numpy as np
import pytest

import image_cases as C
from caffe_rtpose_tpu.proto import datum as jax_datum
from caffe_rtpose_tpu_torch.pipeline import image_io
from caffe_rtpose_tpu_torch.pipeline.image_io import read_image
from caffe_rtpose_tpu_torch.proto import datum

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


# ------------------------------------------------- the decoder by signature

@pytest.mark.parametrize("write_ext,name_ext", [(".jpg", ".png"), (".png", ".jpg"),
                                                (".bmp", ".ppm"), (".ppm", ".bmp"),
                                                (".pgm", ".jpeg")])
def test_reads_by_signature_not_extension(tmp_path, write_ext, name_ext, monkeypatch):
    """A JPEG named .png (common in scraped datasets) and the like: read as
    cv2.imread reads them, by their signature."""
    img = _image((19, 27, 3), 8)
    src = str(tmp_path / f"src{write_ext}")
    assert cv2.imwrite(src, img[..., 0] if write_ext == ".pgm" else img)
    path = str(tmp_path / f"named{name_ext}")
    with open(src, "rb") as a, open(path, "wb") as b:
        b.write(a.read())
    refs = [cv2.imread(path, flag) for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE)]
    monkeypatch.setitem(sys.modules, "cv2", None)
    for gray, ref in zip((False, True), refs):
        np.testing.assert_array_equal(read_image(path, gray=gray), ref)


@pytest.mark.parametrize("ext,fmt", [(".tiff", "TIFF"), (".webp", "WebP")])
def test_other_formats_named(tmp_path, ext, fmt):
    path = str(tmp_path / "img.png")  # the name does not matter
    ok, buf = cv2.imencode(ext, _image((8, 8, 3), 1))
    assert ok
    with open(path, "wb") as f:
        f.write(buf.tobytes())
    assert image_io.image_format(buf.tobytes()) == fmt
    with pytest.raises(ValueError) as e:
        read_image(path)
    assert path in str(e.value) and fmt in str(e.value)


# ------------------------------------------------------- BMP and PNM reads

DECODE = C.decode_files()


@pytest.mark.parametrize("name", list(DECODE))
def test_bmp_and_pnm_read_as_cv2(tmp_path, name, monkeypatch):
    """Every crafted BMP layout and PNM file: read_image (cv2 blocked) equals
    cv2.imread with IMREAD_COLOR and IMREAD_GRAYSCALE, and both equal the
    pins; where cv2 reads nothing the port raises naming the file."""
    path = str(tmp_path / ("img.bmp" if name.startswith("bmp") else "img.pnm"))
    with open(path, "wb") as f:
        f.write(DECODE[name])
    refs = [cv2.imread(path, flag) for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE)]
    assert tuple(None if r is None else C.sha256(r) for r in refs) == C.PINNED[name]
    monkeypatch.setitem(sys.modules, "cv2", None)
    for gray, ref in zip((False, True), refs):
        if ref is None:
            with pytest.raises(ValueError, match="img"):
                read_image(path, gray=gray)
            continue
        got = read_image(path, gray=gray)
        assert got.dtype == np.uint8 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


# ------------------------------------------------- BMP and PNM writes, Datums

IMAGES = C.encode_images()


@pytest.mark.parametrize("name,ext", C.encode_cases(), ids="".join)
def test_bmp_and_pnm_datums_as_cv2(name, ext, monkeypatch):
    """image_to_datum(img, fmt) holds cv2.imencode's bytes (the JAX package's
    Datum), and datum_to_image of it equals cv2.imdecode's array (the JAX
    package's), cv2 blocked for the port; the pins hold both."""
    img, fmt = IMAGES[name], ext[1:]
    ref = jax_datum.image_to_datum(img, 5, fmt)
    ref_img = jax_datum.datum_to_image(ref)
    assert (C.sha256(bytes(ref["data"])), C.sha256(ref_img[..., 0] if ref["channels"] == 1
                                                   else ref_img)) == C.PINNED[name + ext]
    monkeypatch.setitem(sys.modules, "cv2", None)
    encode = image_io.encode_bmp if fmt == "bmp" else lambda x: image_io.encode_pnm(x, fmt)
    assert encode(img) == bytes(ref["data"])
    got = datum.image_to_datum(img, 5, fmt)
    assert got == ref
    back = datum.datum_to_image(got)
    assert back.dtype == np.uint8
    np.testing.assert_array_equal(back, ref_img)


@pytest.mark.parametrize("fmt", ["pbm", "pgm", "ppm"])
def test_pnm_kind_refused_as_cv2(fmt, monkeypatch):
    """A colour image as PBM or PGM, a gray one as PPM: cv2.imencode fails,
    and both Datum helpers raise IOError."""
    img = IMAGES["gray" if fmt == "ppm" else "bgr"]
    assert not cv2.imencode("." + fmt, img)[0]
    with pytest.raises(IOError):
        jax_datum.image_to_datum(img, 0, fmt)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(IOError, match=fmt):
        datum.image_to_datum(img, 0, fmt)
