"""The port's JPEG codec (``pipeline/jpeg.py``, ``csrc/jpeg_codec.cpp``)
against OpenCV's libjpeg-turbo: ``decode_jpeg`` equals ``cv2.imdecode``
(IMREAD_COLOR and IMREAD_GRAYSCALE) exactly over sampling factors,
qualities, baseline and progressive files, optimized Huffman tables,
restart intervals, odd sizes, EXIF orientations, CMYK and Adobe RGB files;
a truncated file reads as ``cv2.imread`` reads it; a malformed header
raises where ``cv2.imdecode`` gives None; ``encode_jpeg`` equals
``cv2.imencode`` byte for byte (4:2:0 colour and gray)."""

import io
import os
import pickle
import struct
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from caffe_rtpose_tpu_torch.pipeline.jpeg import decode_jpeg, encode_jpeg, read_jpeg
from jpeg_frames import DIGEST_FRAMES, DIGEST_QUALITY, DIGESTS, frame, sha256

cv2 = pytest.importorskip("cv2")

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
            "gray": None}
QUALITIES = (1, 10, 50, 95, 98, 100)
SIZES = ((1, 1), (7, 9), (17, 1), (37, 53))


def _cv2_encode(img, quality=95, sampling=None, progressive=0, optimize=0, rst=0) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
              cv2.IMWRITE_JPEG_OPTIMIZE, optimize, cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _assert_decodes_as_cv2(data: bytes, what) -> None:
    for gray, flag in ((False, cv2.IMREAD_COLOR), (True, cv2.IMREAD_GRAYSCALE)):
        ref = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        got = decode_jpeg(data, gray=gray)
        assert got.shape == ref.shape and np.array_equal(got, ref), (what, gray)


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_decode_matches_cv2(sampling, quality):
    """Every size, baseline and progressive, standard and optimized tables,
    restart interval 0, 1 and 7, at one sampling and quality."""
    for h, w in SIZES:
        img = frame(h, w, h * w + quality, 1 if sampling == "gray" else 3)
        for progressive in (0, 1):
            for optimize in (0, 1):
                for rst in (0, 1, 7):
                    data = _cv2_encode(img, quality, SAMPLING[sampling], progressive, optimize,
                                       rst)
                    _assert_decodes_as_cv2(data, (h, w, progressive, optimize, rst))


@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_decode_matches_cv2_net_size(sampling):
    """One 368x656 frame (the net's input) a sampling: baseline with a
    restart interval, and progressive with optimized tables."""
    img = frame(368, 656, 11, 1 if sampling == "gray" else 3)
    _assert_decodes_as_cv2(_cv2_encode(img, 90, SAMPLING[sampling], rst=5), "baseline")
    _assert_decodes_as_cv2(_cv2_encode(img, 90, SAMPLING[sampling], 1, 1), "progressive")


@pytest.mark.parametrize("quality", (95, 98))
@pytest.mark.parametrize("channels", (3, 1))
def test_encode_matches_cv2_bytes(channels, quality):
    """cv2.imencode's bytes: 4:2:0 colour and gray, at the Datum quality (95)
    and the --write_frames quality (98), odd sizes and the net's."""
    for h, w in SIZES + ((368, 656),):
        img = frame(h, w, 3 * h + w, channels)
        assert encode_jpeg(img, quality) == _cv2_encode(img, quality), (h, w)
    assert encode_jpeg(img[:, :, None] if channels == 1 else img) == _cv2_encode(img)


def _with_exif(data: bytes, orientation: int, little_endian: bool) -> bytes:
    e = "<" if little_endian else ">"
    tiff = ((b"II" if little_endian else b"MM") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1) + struct.pack(e + "HHIH", 0x0112, 3, 1, orientation)
            + b"\0\0" + struct.pack(e + "I", 0))
    body = b"Exif\0\0" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + data[2:]


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation(orientation):
    """cv2.imdecode turns the image by the EXIF orientation tag, in colour and
    gray, for either TIFF byte order."""
    data = _cv2_encode(frame(16, 32, 1), 95)
    for little_endian in (True, False):
        _assert_decodes_as_cv2(_with_exif(data, orientation, little_endian), little_endian)
    turned = decode_jpeg(_with_exif(data, orientation, True))
    assert turned.shape[:2] == ((32, 16) if orientation >= 5 else (16, 32))


def test_cmyk_and_adobe_rgb():
    """PIL's 4-component CMYK files (OpenCV's CMYK to BGR and gray
    conversions) and an Adobe RGB file (transform 0, no JFIF marker)."""
    Image = pytest.importorskip("PIL.Image")
    rs = np.random.RandomState(4)
    for h, w in ((16, 24), (37, 53)):
        cmyk = (rs.rand(h, w, 4) * 255).astype(np.uint8)
        for quality in (50, 95):
            bio = io.BytesIO()
            Image.fromarray(cmyk, "CMYK").save(bio, "JPEG", quality=quality)
            _assert_decodes_as_cv2(bio.getvalue(), ("cmyk", h, w, quality))
    bio = io.BytesIO()
    Image.fromarray(frame(37, 53, 2)[:, :, ::-1].copy()).save(bio, "JPEG", quality=90,
                                                              keep_rgb=True, subsampling=0)
    assert b"Adobe" in bio.getvalue() and b"JFIF" not in bio.getvalue()
    _assert_decodes_as_cv2(bio.getvalue(), "adobe rgb")


def test_truncated(tmp_path):
    """Truncated data: cv2.imdecode gives None and decode_jpeg raises; a
    truncated baseline file reads as cv2.imread reads it (the missing blocks
    as zero coefficients, with and without restart markers), and so does a
    truncated progressive file (libjpeg's block smoothing)."""
    img = frame(64, 80, 3)
    path = str(tmp_path / "t.jpg")
    for rst in (0, 5):
        data = _cv2_encode(img, 95, rst=rst)
        for frac in (0.3, 0.77, 0.999):
            cut = data[: int(len(data) * frac)]
            assert cv2.imdecode(np.frombuffer(cut, np.uint8), cv2.IMREAD_COLOR) is None
            with pytest.raises(ValueError, match="premature end"):
                decode_jpeg(cut)
            with open(path, "wb") as f:
                f.write(cut)
            for gray, flag in ((False, cv2.IMREAD_COLOR), (True, cv2.IMREAD_GRAYSCALE)):
                np.testing.assert_array_equal(read_jpeg(path, gray), cv2.imread(path, flag))
    with open(path, "wb") as f:
        f.write(_cv2_encode(img, 95, progressive=1)[:2000])
    for gray, flag in ((False, cv2.IMREAD_COLOR), (True, cv2.IMREAD_GRAYSCALE)):
        np.testing.assert_array_equal(read_jpeg(path, gray), cv2.imread(path, flag))
    with pytest.raises(ValueError, match="premature end"):
        decode_jpeg(data[:100])  # inside the headers


@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_truncated_progressive(tmp_path, sampling):
    """A progressive file cut anywhere, in a scan, between scans or inside a
    marker segment, reads as cv2.imread reads it: libjpeg's file source
    reads fake EOI markers past the end, and its block smoothing estimates
    the low AC coefficients (and with no AC data the DC) of what is missing
    from the neighbouring DC values."""
    gray = sampling == "gray"
    data = _cv2_encode(frame(37, 53, 9, 1 if gray else 3), 90, SAMPLING[sampling],
                       progressive=1)
    path = str(tmp_path / "t.jpg")
    for cut in range(150, len(data), max(1, len(data) // 25)):
        with open(path, "wb") as f:
            f.write(data[:cut])
        for gray_out, flag in ((False, cv2.IMREAD_COLOR), (True, cv2.IMREAD_GRAYSCALE)):
            ref = cv2.imread(path, flag)
            if ref is None:
                with pytest.raises(ValueError):
                    read_jpeg(path, gray_out)
            else:
                np.testing.assert_array_equal(read_jpeg(path, gray_out), ref, err_msg=str(cut))


def test_refuses_what_cv2_refuses():
    """A frame header of more than 2^30 pixels (OpenCV's
    CV_IO_MAX_IMAGE_PIXELS) raises before anything is allocated for it, as
    cv2.imdecode raises; bytes that are no JPEG raise."""
    data = bytearray(_cv2_encode(frame(8, 8, 0)))
    sof = data.find(b"\xff\xc0")
    data[sof + 5 : sof + 9] = struct.pack(">HH", 40000, 40000)
    with pytest.raises(cv2.error):
        cv2.imdecode(np.frombuffer(bytes(data), np.uint8), cv2.IMREAD_COLOR)
    with pytest.raises(ValueError, match="2\\^30 pixels"):
        decode_jpeg(bytes(data))
    assert cv2.imdecode(np.frombuffer(b"not a jpeg", np.uint8), cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match="no SOI"):
        decode_jpeg(b"not a jpeg")


def _set(data: bytes, at: int, value: bytes) -> bytes:
    return data[:at] + value + data[at + len(value):]


def _malformed() -> dict:
    """Header segments of a 16x24 q95 file with restart markers, cut or
    with one field broken."""
    base = _cv2_encode(frame(16, 24, 3), 95, rst=2)
    at = {m: base.find(b"\xff" + bytes([m])) for m in (0xC0, 0xC4, 0xDB, 0xDA, 0xDD)}
    sof, dht, dqt, sos, dri = (at[m] for m in (0xC0, 0xC4, 0xDB, 0xDA, 0xDD))
    tiff = b"Exif\0\0MM\0\x2a\0\0\0\x08"

    def app1(body):
        return base[:2] + b"\xff\xe1" + struct.pack(">H", 2 + len(body)) + body + base[2:]

    cases = {f"{name} cut": base[: i + 5]
             for name, i in (("SOF", sof), ("DHT", dht), ("DQT", dqt), ("SOS", sos), ("DRI", dri))}
    cases.update({
        "SOF sampling 0": _set(base, sof + 11, b"\0"),
        "SOF 0 components": _set(base, sof + 9, b"\0"),
        "SOF 2 components": _set(base, sof + 9, b"\2"),
        "SOF width 0": _set(base, sof + 7, b"\0\0"),
        "SOF table 5": _set(base, sof + 12, b"\5"),
        "SOF length short": _set(base, sof + 2, struct.pack(">H", 8)),
        "SOF length long": (base[:sof + 2] + struct.pack(">H", 18) + base[sof + 4:sof + 19]
                            + b"\0" + base[sof + 19:]),
        "SOF duplicate id": _set(base, sof + 16, b"\2"),
        "DHT class 2": _set(base, dht + 4, b"\x20"),
        "DHT index 4": _set(base, dht + 4, b"\4"),
        "DHT over 256 codes": _set(base, dht + 20, b"\xff"),
        "DHT overfull": _set(base, dht + 5, b"\3"),
        "DHT DC symbol 16": _set(base, dht + 21, b"\x10"),
        "DHT marker lost": _set(base, dht, b"\0"),  # libjpeg-turbo's standard table
        "DQT index 4": _set(base, dqt + 4, b"\4"),
        "DQT precision 2": _set(base, dqt + 4, b"\x20"),
        "SOS 0 components": _set(base, sos + 4, b"\0"),
        "SOS unknown id": _set(base, sos + 5, b"\x09"),
        "SOS id twice": _set(base, sos + 9, b"\3"),
        "SOS out of order": _set(base, sos + 5, b"\2\0\1\x11"),
        "SOS table 4": _set(base, sos + 6, b"\x44"),
        "SOS length 2 at the end": base[:sos] + b"\xff\xda\0\x02",
        "SOS length long": (base[:sos + 2] + struct.pack(">H", 13) + base[sos + 4:sos + 14]
                            + b"\0" + base[sos + 14:]),
        "DRI length 3": _set(base, dri + 2, b"\0\3"),
        "DRI length 5": (base[:dri + 2] + b"\0\5" + base[dri + 4:dri + 6] + b"\0"
                         + base[dri + 6:]),
        "DRI interval 0": _set(base, dri + 4, b"\0\0"),
        "APP1 cut": base[:2] + b"\xff\xe1\0\x40" + tiff,
        "APP1 length 0": base[:2] + b"\xff\xe1\0\0" + base[2:],
        "APP1 IFD past the end": app1(b"Exif\0\0MM\0\x2a\xff\xff\xff\xf0"),
        "APP1 IFD count huge": app1(tiff + b"\xff\xff"),
        "APP1 entry cut": app1(tiff + b"\0\1\x01\x12\0\3"),
        "APP1 byte order": app1(b"Exif\0\0XX\0\x2a\0\0\0\x08"),
        "APP1 orientation 9": app1(tiff + b"\0\1\x01\x12\0\3\0\0\0\1\0\x09\0\0\0\0"),
        "second SOI": base[:2] + b"\xff\xd8" + base[2:],
        "unknown marker": base[:2] + b"\xff\x1f" + base[2:],
        "no FF after SOI": _set(base, 2, b"\0"),
        "stuffed zero before a marker": _set(base, dht + 1, b"\0"),
    })
    return cases


MALFORMED = _malformed()


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_header_as_cv2(case):
    """A header cut or broken: decode_jpeg raises ValueError where
    cv2.imdecode gives None, and gives cv2's pixels where it decodes."""
    data = MALFORMED[case]
    for gray, flag in ((False, cv2.IMREAD_COLOR), (True, cv2.IMREAD_GRAYSCALE)):
        ref = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        if ref is None:
            with pytest.raises(ValueError):
                decode_jpeg(data, gray=gray)
        else:
            np.testing.assert_array_equal(decode_jpeg(data, gray=gray), ref)


def _libjpeg_c_decodes(files, gray) -> list:
    """PIL's decodes with libjpeg-turbo's SIMD turned off (its C code, which
    the codec follows), as BGR or gray arrays."""
    code = ("import io, pickle, sys, numpy as np\n"
            "from PIL import Image\n"
            "files, gray = pickle.load(sys.stdin.buffer)\n"
            "out = [np.asarray(Image.open(io.BytesIO(d)).convert('L' if gray else 'RGB'))"
            " for d in files]\n"
            "pickle.dump(out, sys.stdout.buffer)\n")
    run = subprocess.run([sys.executable, "-c", code], input=pickle.dumps((files, gray)),
                         env=dict(os.environ, JSIMD_FORCENONE="1"), capture_output=True,
                         check=True)
    return [a if gray else a[..., ::-1] for a in pickle.loads(run.stdout)]


@pytest.mark.parametrize("kind", ("gray", "420", "444 progressive", "gray progressive"))
def test_header_byte_flips(kind):
    """Every header byte flipped three ways: decode_jpeg raises ValueError
    exactly where cv2.imdecode gives None and never crashes.  Where both
    decode, the pixels are cv2's, or, where a broken DQT or DHT sends
    coefficients out of range, libjpeg-turbo's C code's: its SIMD IDCT,
    which cv2 runs, wraps in 16-bit lanes there."""
    pytest.importorskip("PIL.Image")
    gray = kind.startswith("gray")
    sampling = None if gray else SAMPLING[kind.split()[0]]
    base = _cv2_encode(frame(16, 24, 5, 1 if gray else 3), 90, sampling,
                       progressive=int(kind.endswith("progressive")), rst=1)
    flag = cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR
    differ = []
    for i in range(2, base.find(b"\xff\xda") + 14):
        for x in (0xFF, 0x80, 0x01):
            data = _set(base, i, bytes([base[i] ^ x]))
            ref = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
            try:
                got = decode_jpeg(data, gray=gray)
            except ValueError:
                assert ref is None, (i, x)
                continue
            assert ref is not None, (i, x)
            if not np.array_equal(got, ref):
                differ.append((data, got))
    if differ:
        for (_, got), c in zip(differ, _libjpeg_c_decodes([d for d, _ in differ], gray)):
            np.testing.assert_array_equal(got, c)


def test_pinned_digests():
    """The digests chip_smoke.py holds the card host's build to: cv2's bytes
    and pixels for three seeded frames, and the port's."""
    for (h, w, seed), enc, dec in zip(DIGEST_FRAMES, DIGESTS["encode"], DIGESTS["decode"]):
        img = frame(h, w, seed)
        data = _cv2_encode(img, DIGEST_QUALITY)
        assert sha256(data) == enc
        assert sha256(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)) == dec
        assert sha256(encode_jpeg(img, DIGEST_QUALITY)) == enc
        assert sha256(decode_jpeg(data)) == dec


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(h=st.integers(1, 70), w=st.integers(1, 70), seed=st.integers(0, 2**16),
       quality=st.integers(0, 100), sampling=st.sampled_from(sorted(SAMPLING)),
       progressive=st.integers(0, 1), optimize=st.integers(0, 1), rst=st.integers(0, 9))
def test_random_sizes_and_settings(h, w, seed, quality, sampling, progressive, optimize, rst):
    img = frame(h, w, seed, 1 if sampling == "gray" else 3)
    _assert_decodes_as_cv2(_cv2_encode(img, quality, SAMPLING[sampling], progressive, optimize,
                                       rst), (h, w, seed, quality, sampling))
    if sampling in ("420", "gray"):
        assert encode_jpeg(img, quality) == _cv2_encode(img, quality)
