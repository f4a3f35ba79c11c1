"""printf image sequences for the port's sequence reader
(``caffe_rtpose_tpu_torch/pipeline/video.py`` ``SequenceReader``) and the
results pinned for them (numpy and the port's encoders only, so that
``chip_smoke.py`` can load this module on a machine without OpenCV).

:func:`write` writes each case of CASES into a directory: seeded frames
(``avi_cases.frames``) as q95 JPEGs (``encode_jpeg``, cv2.imencode's
bytes), PNGs, 24-bit BMPs and PPMs (cv2.imencode's bytes), 16-bit 565 BMPs
and maxval-15 PGMs (where FFmpeg's decoders widen samples otherwise than
cv2.imread).  ``tests/test_torch_sequence.py`` holds PINNED against the
JAX package's reader (``cv2.VideoCapture``, FFMPEG's image2 demuxer) and
against the port with cv2 blocked; ``chip_smoke.py``'s video phase holds
the port on the card's host to them.

The cases: the pattern forms ``%03d``, ``%d``, ``%05d`` and ``%%``; first
numbers 0 to 4; ``gap`` (file 3 of 0-9 missing: image2's range search
steps over it, so the count is 10 and reads stop at the gap) and
``gap_early`` (file 2 missing: the count is 2); ``long`` (40 frames: seeks
step back past 16); ``one`` (one image, no pattern: the count cv2 reports
is -2^63).
"""

import os

import numpy as np

import avi_cases as A
import image_cases as C

SIZE = (24, 32)  # (h, w)
SEEKS = A.SEEKS
LONG_SEEKS = A.LONG_SEEKS

# name -> (pattern, number of frames, first number, missing number, format)
CASES = {
    "png": ("f_%03d.png", 8, 1, None, "png"),
    "jpeg": ("f_%03d.jpg", 8, 0, None, "jpeg"),
    "bmp": ("img%d.bmp", 8, 4, None, "bmp"),
    "bmp565": ("b_%02d.bmp", 8, 0, None, "bmp565"),
    "ppm": ("p_%05d.ppm", 8, 2, None, "ppm"),
    "pgm15": ("g%d.pgm", 8, 0, None, "pgm15"),
    "percent": ("a%%b_%02d.png", 8, 3, None, "png"),
    "gap": ("g_%d.png", 10, 0, 3, "png"),
    "gap_early": ("g_%d.png", 10, 0, 2, "png"),
    "long": ("l_%04d.png", 40, 0, None, "png"),
    "one": ("one.png", 1, None, None, "png"),
}


def encode(img: np.ndarray, fmt: str) -> bytes:
    from caffe_rtpose_tpu_torch.pipeline.image_io import encode_bmp, encode_png, encode_pnm
    from caffe_rtpose_tpu_torch.pipeline.jpeg import encode_jpeg

    if fmt == "jpeg":
        return encode_jpeg(img, 95)
    if fmt == "png":
        return encode_png(img)
    if fmt == "bmp":
        return encode_bmp(img)
    if fmt == "ppm":
        return encode_pnm(img, "ppm")
    h, w = img.shape[:2]
    if fmt == "pgm15":
        return C.pnm(5, w, h, 15, img[..., 1] >> 4)
    b, g, r = (img[..., i].astype(np.uint16) for i in range(3))  # bmp565
    t = (r >> 3 << 11) | (g >> 2 << 5) | (b >> 3)
    raw = np.pad(t[::-1].astype("<u2").view(np.uint8).reshape(h, 2 * w),
                 ((0, 0), (0, (-2 * w) % 4))).tobytes()
    return C.bmp(w, h, 16, raw, comp=3, masks=(0xF800, 0x7E0, 0x1F))


def number(name: str, i: int):
    """The file number of frame ``i`` of case ``name`` (None: one image)."""
    first = CASES[name][2]
    return None if first is None else first + i


def write(name: str, root: str):
    """Writes case ``name`` into ``root``; returns (the path to open, the
    source frames, the files written by source index (None where one is
    missing))."""
    from caffe_rtpose_tpu_torch.pipeline.video import sequence_filename

    pattern, n, first, missing, fmt = CASES[name]
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, pattern)
    sources = A.frames(n, SIZE, seed=len(name))
    files = []
    for i, img in enumerate(sources):
        k = number(name, i)
        if k is not None and k == missing:
            files.append(None)
            continue
        f = path if k is None else sequence_filename(path, k)
        with open(f, "wb") as out:
            out.write(encode(img, fmt))
        files.append(f)
    return path, sources, files


def decoded(files):
    """Each source frame as FFMPEG decodes its file (the port's sequence
    decoder; None where the file is missing)."""
    from caffe_rtpose_tpu_torch.pipeline.jpeg import MjpegDecoder
    from caffe_rtpose_tpu_torch.pipeline.video import SequenceReader

    out = []
    for f in files:
        if f is None:
            out.append(None)
            continue
        with open(f, "rb") as fh:
            out.append(SequenceReader._decode(fh.read(), f, MjpegDecoder(f)))
    return out


def seeks(name: str):
    return LONG_SEEKS if CASES[name][1] > 10 else SEEKS


def observe(runner, name: str, path: str, files):
    """avi_cases.observe over the case, frames identified by equality with
    :func:`decoded` (no ui seeks for one image)."""
    return A.observe(runner, path, decoded(files), seeks(name), exact=True,
                     ui=CASES[name][2] is not None)


# What the JAX package's reader gives for each case: frame_count and fps as
# cv2.VideoCapture reports them, the frames a read from the start gives,
# the frames READ_AFTER_SEEK reads give after start_frame k and after a ui
# seek to k made once 2 frames were read (ids index the case's sources),
# and the sha256 of the frames read from the start.
PINNED = {
    'png': {'count': 8,
     'fps': 25.0,
     'order': (0, 1, 2, 3, 4, 5, 6, 7),
     'start': {0: (0, 1, 2),
               1: (1, 2, 3),
               2: (2, 3, 4),
               3: (3, 4, 5),
               5: (5, 6, 7),
               7: (7,),
               8: (),
               9: (),
               100: ()},
     'ui': {0: (0, 1, 2),
            1: (1, 2, 3),
            2: (2, 3, 4),
            3: (3, 4, 5),
            5: (5, 6, 7),
            7: (7,),
            8: (),
            9: (),
            100: ()},
     'sha256': 'e0cd2e8afcda1e071173fd46bdba881bc18bdd5d76849b1a5b36daf05452cc96'},
    'jpeg': {'count': 8,
     'fps': 25.0,
     'order': (0, 1, 2, 3, 4, 5, 6, 7),
     'start': {0: (0, 1, 2),
               1: (1, 2, 3),
               2: (2, 3, 4),
               3: (3, 4, 5),
               5: (5, 6, 7),
               7: (7,),
               8: (),
               9: (),
               100: ()},
     'ui': {0: (0, 1, 2),
            1: (1, 2, 3),
            2: (2, 3, 4),
            3: (3, 4, 5),
            5: (5, 6, 7),
            7: (7,),
            8: (),
            9: (),
            100: ()},
     'sha256': 'bf0b6a1ae912237f81927fc35be198082122f931d4dabf9fcaa59e244bb4714f'},
    'bmp': {'count': 8,
     'fps': 25.0,
     'order': (0, 1, 2, 3, 4, 5, 6, 7),
     'start': {0: (0, 1, 2),
               1: (1, 2, 3),
               2: (2, 3, 4),
               3: (3, 4, 5),
               5: (5, 6, 7),
               7: (7,),
               8: (),
               9: (),
               100: ()},
     'ui': {0: (0, 1, 2),
            1: (1, 2, 3),
            2: (2, 3, 4),
            3: (3, 4, 5),
            5: (5, 6, 7),
            7: (7,),
            8: (),
            9: (),
            100: ()},
     'sha256': 'e0cd2e8afcda1e071173fd46bdba881bc18bdd5d76849b1a5b36daf05452cc96'},
    'bmp565': {'count': 8,
     'fps': 25.0,
     'order': (0, 1, 2, 3, 4, 5, 6, 7),
     'start': {0: (0, 1, 2),
               1: (1, 2, 3),
               2: (2, 3, 4),
               3: (3, 4, 5),
               5: (5, 6, 7),
               7: (7,),
               8: (),
               9: (),
               100: ()},
     'ui': {0: (0, 1, 2),
            1: (1, 2, 3),
            2: (2, 3, 4),
            3: (3, 4, 5),
            5: (5, 6, 7),
            7: (7,),
            8: (),
            9: (),
            100: ()},
     'sha256': '756efc046363aff9a1cebb9726859c14cc5dbf1401d0350b71af5c508f7f9964'},
    'ppm': {'count': 8,
     'fps': 25.0,
     'order': (0, 1, 2, 3, 4, 5, 6, 7),
     'start': {0: (0, 1, 2),
               1: (1, 2, 3),
               2: (2, 3, 4),
               3: (3, 4, 5),
               5: (5, 6, 7),
               7: (7,),
               8: (),
               9: (),
               100: ()},
     'ui': {0: (0, 1, 2),
            1: (1, 2, 3),
            2: (2, 3, 4),
            3: (3, 4, 5),
            5: (5, 6, 7),
            7: (7,),
            8: (),
            9: (),
            100: ()},
     'sha256': 'e0cd2e8afcda1e071173fd46bdba881bc18bdd5d76849b1a5b36daf05452cc96'},
    'pgm15': {'count': 8,
     'fps': 25.0,
     'order': (0, 1, 2, 3, 4, 5, 6, 7),
     'start': {0: (0, 1, 2),
               1: (1, 2, 3),
               2: (2, 3, 4),
               3: (3, 4, 5),
               5: (5, 6, 7),
               7: (7,),
               8: (),
               9: (),
               100: ()},
     'ui': {0: (0, 1, 2),
            1: (1, 2, 3),
            2: (2, 3, 4),
            3: (3, 4, 5),
            5: (5, 6, 7),
            7: (7,),
            8: (),
            9: (),
            100: ()},
     'sha256': '00b8e98d1301ff107b7cf74fe993e4771640255524a71e22cb32f865fb4986ef'},
    'percent': {'count': 8,
     'fps': 25.0,
     'order': (0, 1, 2, 3, 4, 5, 6, 7),
     'start': {0: (0, 1, 2),
               1: (1, 2, 3),
               2: (2, 3, 4),
               3: (3, 4, 5),
               5: (5, 6, 7),
               7: (7,),
               8: (),
               9: (),
               100: ()},
     'ui': {0: (0, 1, 2),
            1: (1, 2, 3),
            2: (2, 3, 4),
            3: (3, 4, 5),
            5: (5, 6, 7),
            7: (7,),
            8: (),
            9: (),
            100: ()},
     'sha256': 'ab3b95f2c4590c16ed50f04976cb68f34938223356cfd16a398d1eafd6182834'},
    'gap': {'count': 10,
     'fps': 25.0,
     'order': (0, 1, 2),
     'start': {0: (0, 1, 2), 1: (1, 2), 2: (2,), 3: (), 5: (), 7: (), 8: (), 9: (), 100: ()},
     'ui': {0: (0, 1, 2), 1: (1, 2), 2: (2,), 3: (), 5: (), 7: (), 8: (), 9: (), 100: ()},
     'sha256': '9576caaade216735cf3768655edcf16dcaf3b3278411742ee2bb93b203d4616e'},
    'gap_early': {'count': 2,
     'fps': 25.0,
     'order': (0, 1),
     'start': {0: (0, 1), 1: (1,), 2: (), 3: (), 5: (), 7: (), 8: (), 9: (), 100: ()},
     'ui': {0: (0, 1), 1: (1,), 2: (), 3: (), 5: (), 7: (), 8: (), 9: (), 100: ()},
     'sha256': '3952979838cef111765a118dc8e828249ad551c3d5ba253e09494f138135c32d'},
    'long': {'count': 40,
     'fps': 25.0,
     'order': (0,
               1,
               2,
               3,
               4,
               5,
               6,
               7,
               8,
               9,
               10,
               11,
               12,
               13,
               14,
               15,
               16,
               17,
               18,
               19,
               20,
               21,
               22,
               23,
               24,
               25,
               26,
               27,
               28,
               29,
               30,
               31,
               32,
               33,
               34,
               35,
               36,
               37,
               38,
               39),
     'start': {0: (0, 1, 2),
               15: (15, 16, 17),
               17: (17, 18, 19),
               20: (20, 21, 22),
               30: (30, 31, 32),
               38: (38, 39),
               39: (39,),
               40: ()},
     'ui': {0: (0, 1, 2),
            15: (15, 16, 17),
            17: (17, 18, 19),
            20: (20, 21, 22),
            30: (30, 31, 32),
            38: (38, 39),
            39: (39,),
            40: ()},
     'sha256': '4483c5e31f035e35d533c7dd83ce6ab567cb74354b2908e8d7cea961e3ba2fb2'},
    'one': {'count': -9223372036854775808,
     'fps': 25.0,
     'order': (0,),
     'start': {0: (0,), 1: (0,), 2: (0,), 3: (0,), 5: (0,), 7: (0,), 8: (0,), 9: (0,), 100: (0,)},
     'sha256': 'df242cf0f5739b6d917016af1f412343bba7446689f8e5fa0ee87a7b21e7f49a'},
}
