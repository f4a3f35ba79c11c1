"""Seeded cases for OpenCV's u8 image operations and the digests pinned for
them (numpy only, so that ``chip_smoke.py`` can load this module on a
machine without OpenCV).

``tests/test_torch_imgproc.py`` computes every digest with ``cv2`` (and the
JAX package, for the synthetic source and ``do_clahe``) and with the port
(``caffe_rtpose_tpu_torch/utils/imgproc.py``, cv2 blocked) and holds both to
DIGESTS; ``chip_smoke.py``'s imgproc phase holds the port on the card's host
to them.

An ``ops`` argument is any object with the five operations under the port's
names: ``bgr2lab_u8(img)``, ``lab2bgr_u8(img)``, ``clahe_u8(gray, clip,
tiles)``, ``line_u8(img, p0, p1, color, thickness)`` (in place) and
``resize_linear_u8(img, out_h, out_w)``.
"""

import hashlib

import numpy as np

CUBE_CHUNKS = 8  # 2^21 pixels a chunk: a few hundred MB at most in the port

# (h, w) x kind x clip limit x tiles a side: sizes that divide the grid and
# sizes that do not (a 1-pixel-high and a 1-pixel-wide image among them)
CLAHE_SIZES = ((368, 368), (97, 131), (1, 50), (33, 1), (16, 17), (3, 5))
CLAHE_KINDS = ("const", "ramp", "noise", "dark")
CLAHE_CLIPS = (0.0, 1.0, 4.0, 40.0)
CLAHE_TILES = (1, 2, 8, 16)

LINE_CANVAS = ((48, 64, 3), (37, 29, 1))
LINE_RANDOM = 400  # random segments a canvas, on top of the fixed ones

# (source (h, w), output (h, w)): up, down, each axis alone and both; 1
# pixel sources and outputs; an exact halving; the tools' 256 -> 227
RESIZE_CASES = (((97, 131), (60, 80)), ((60, 80), (97, 131)), ((40, 50), (40, 123)),
                ((40, 50), (13, 50)), ((40, 50), (81, 21)), ((1, 1), (5, 7)),
                ((1, 9), (4, 3)), ((9, 1), (2, 6)), ((33, 17), (1, 1)), ((64, 48), (32, 24)),
                ((256, 256), (227, 227)), ((227, 227), (256, 256)), ((18, 26), (12, 14)))

SYNTHETIC = dict(n=4, size=368, seed=0)  # SyntheticPoseSource's first images
DO_CLAHE_FRAMES = ((368, 368, 5), (720, 1280, 6))  # transformer.clahe(frame, 8, 4)

# sha256 of each case set's outputs, computed with cv2 5.0.0 (and the JAX
# package), held by tests/test_torch_imgproc.py
DIGESTS = {
    "bgr2lab_cube": "b3067516fa862bb008af4ffb4da5555722524a70776bf7ffd523a90f4331480c",
    "lab2bgr_cube": "e19af18a8ebe8c9f84e90aab1eafa99cb240b4f302a0b9cb98e0f559b9ba48fd",
    "clahe": "9881569d33db581b32210bb929f42d62b1289bec904783e77cc5ef2e4fe41a72",
    "line": "19cc5dd559760cb5bcdb8e5b134e57bf1ebcbbfd1ce14e4f934e53c1e4cb4477",
    "resize": "fd6b622aacfd65f6c0ffa989e3fbe75f4593cb5389ac2ce4eddd997eb9a76031",
    "synthetic": "7f8bc3392cd6ddbb9c084fb6499d0c4b500e0aac0da15a3b12a5697da18e7154",
    "do_clahe": "4e99d93bac939a0fa9471c39ec67024d89cd93c09200356e6b5c353427e4694a",
}


def cube_chunk(i: int) -> np.ndarray:
    """Chunk i of the 2^24 byte triplets, as a (1024, 2048, 3) u8 image:
    pixel v holds (v & 255, v >> 8 & 255, v >> 16)."""
    n = (1 << 24) // CUBE_CHUNKS
    v = np.arange(i * n, (i + 1) * n, dtype=np.uint32)
    return np.stack([v & 255, (v >> 8) & 255, v >> 16], -1).astype(np.uint8).reshape(-1, 2048, 3)


def cube_digest(convert) -> str:
    """sha256 of ``convert`` over the whole cube, chunk by chunk."""
    h = hashlib.sha256()
    for i in range(CUBE_CHUNKS):
        h.update(np.ascontiguousarray(convert(cube_chunk(i))).tobytes())
    return h.hexdigest()


def clahe_image(h: int, w: int, kind: str, seed: int = 0) -> np.ndarray:
    rs = np.random.RandomState(seed)
    if kind == "const":
        return np.full((h, w), 77, np.uint8)
    if kind == "ramp":
        return ((np.arange(h)[:, None] * 3 + np.arange(w) * 2) % 256).astype(np.uint8)
    if kind == "noise":
        return rs.randint(0, 256, (h, w)).astype(np.uint8)
    return (rs.rand(h, w) * 20 + 30).astype(np.uint8)  # low contrast, dark


def clahe_cases():
    for h, w in CLAHE_SIZES:
        for kind in CLAHE_KINDS:
            img = clahe_image(h, w, kind, seed=h * 7 + w)
            for clip in CLAHE_CLIPS:
                for tiles in CLAHE_TILES:
                    yield img, clip, tiles


def line_cases():
    """(canvas shape, p0, p1, colour, thickness): every octant, horizontal,
    vertical and 45-degree lines, zero-length lines, endpoints off every side
    of the canvas, thickness 1-5 (3 most of all), then random segments."""
    for shape in LINE_CANVAS:
        h, w = shape[:2]
        cx, cy = w // 2, h // 2
        rs = np.random.RandomState(h * w)
        fixed = []
        for t in (1, 2, 3, 4, 5):
            for k in range(16):  # a ray every 22.5 degrees: every octant
                a = 2 * np.pi * k / 16
                fixed.append(((cx, cy), (cx + int(round(20 * np.cos(a))), cy + int(round(20 * np.sin(a)))), t))
            fixed += [((2, cy), (w - 3, cy), t), ((cx, 1), (cx, h - 2), t), ((3, 3), (20, 20), t),
                      ((20, 3), (3, 20), t), ((cx, cy), (cx, cy), t), ((0, 0), (0, 0), t),
                      ((-9, cy), (w + 9, cy + 3), t), ((cx, -12), (cx - 4, h + 7), t),
                      ((-30, -20), (w + 25, h + 40), t), ((w + 5, -5), (-5, h + 5), t),
                      ((-3, -3), (-40, -9), t), ((w - 1, h + t - 1), (2, h + t), t)]
        for p0, p1, t in fixed:
            yield shape, p0, p1, tuple(int(c) for c in rs.randint(0, 256, 3)), t
        for _ in range(LINE_RANDOM):
            r = int(rs.choice([5, 40, 400]))
            p0 = tuple(int(v) for v in rs.randint(-r, r + max(h, w), 2))
            p1 = tuple(int(v) for v in rs.randint(-r, r + max(h, w), 2))
            t = int(rs.choice([1, 2, 3, 3, 3, 3, 4, 5, 7]))
            yield shape, p0, p1, tuple(int(c) for c in rs.randint(0, 256, 3)), t


def resize_cases():
    for (h, w), (oh, ow) in RESIZE_CASES:
        rs = np.random.RandomState(h * 1000 + w)
        for cn in (1, 3):
            img = rs.randint(0, 256, (h, w, cn)).astype(np.uint8)
            yield (img[:, :, 0] if cn == 1 else img), oh, ow


def frame(h: int, w: int, seed: int) -> np.ndarray:
    """Ramps, a dark band and sparse noise: a u8 (h, w, 3) BGR frame."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w]
    base = (x * 3 + y * 2)[..., None] + np.array([0, 40, 80])
    noise = rs.randint(-30, 30, (h, w, 3)) * (rs.rand(h, w, 1) < 0.5)
    out = np.clip(base % 256 + noise, 0, 255).astype(np.uint8)
    out[: h // 3] //= 5
    return out


def case_digests(ops, names=("clahe", "line", "resize")) -> dict:
    """The clahe, line and resize digests of ``ops`` (those in ``names``)."""
    out = {}
    if "clahe" in names:
        h = hashlib.sha256()
        for img, clip, tiles in clahe_cases():
            h.update(np.ascontiguousarray(ops.clahe_u8(img, clip, tiles)).tobytes())
        out["clahe"] = h.hexdigest()
    if "line" in names:
        h = hashlib.sha256()
        rs = np.random.RandomState(1)
        for shape, p0, p1, color, t in line_cases():
            canvas = rs.randint(0, 256, shape).astype(np.uint8)
            if shape[2] == 1:
                canvas = np.ascontiguousarray(canvas[:, :, 0])
            ops.line_u8(canvas, p0, p1, color, t)
            h.update(canvas.tobytes())
        out["line"] = h.hexdigest()
    if "resize" in names:
        h = hashlib.sha256()
        for img, oh, ow in resize_cases():
            h.update(np.ascontiguousarray(ops.resize_linear_u8(img, oh, ow)).tobytes())
        out["resize"] = h.hexdigest()
    return out


def synthetic_digest(source_cls) -> str:
    """sha256 of the images of ``source_cls(**SYNTHETIC)``."""
    src = source_cls(**SYNTHETIC)
    return hashlib.sha256(b"".join(src[i][0].tobytes() for i in range(len(src)))).hexdigest()


def do_clahe_digest(clahe) -> str:
    """sha256 of ``clahe(frame, 8, 4)`` over DO_CLAHE_FRAMES."""
    return hashlib.sha256(b"".join(np.ascontiguousarray(clahe(frame(*f), 8, 4)).tobytes()
                                   for f in DO_CLAHE_FRAMES)).hexdigest()
