"""Seeded frames for the JPEG codec's checks, and the digests pinned for
them (numpy only, so that ``chip_smoke.py`` can load this module on a
machine without OpenCV).

``tests/test_torch_jpeg.py::test_pinned_digests`` holds DIGESTS against
``cv2.imencode``/``cv2.imdecode`` and against the port's codec;
``chip_smoke.py``'s jpeg phase holds the codec built on the card's host to
the same digests.
"""

import hashlib

import numpy as np

# (height, width, seed): a 720p frame, a VGA frame and the net's 656x368
DIGEST_FRAMES = ((720, 1280, 0), (480, 640, 1), (368, 656, 2))
DIGEST_QUALITY = 95

# sha256 of encode_jpeg(frame, 95), and of decode_jpeg of those bytes (BGR)
DIGESTS = {
    "encode": ("d961aed5fded597b55b01987e9109ff417ad51db1faebcb6e8314e905c92cbca",
               "6799e2fb24c167f1a4fee098f61ae5b36fdb375dd3aae73a965bc0a37803a3ea",
               "7e1fec715ba5b9b0c364e3178f6a47c8f44c23dbf1321132e9950bb88dc17370"),
    "decode": ("f1d45978ce7bd60186302c092c9ef2ab652fff63e720248f78f984a2677fa405",
               "59e9e20da618a3bc0c1c557e1b984a26503ad382b7d29a67d2045e08c9a4ac76",
               "84350e5efae9140aa31cd1ed6d4857e7ce4d3a1058ce453977421665014d3d45"),
}


def frame(h: int, w: int, seed: int, channels: int = 3) -> np.ndarray:
    """Smooth ramps plus sparse noise, so both flat and busy 8x8 blocks occur:
    u8 (h, w, 3) BGR, or (h, w) with ``channels`` 1."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w]
    base = (x * 3 + y * 2)[..., None] + np.array([0, 40, 80])[:channels]
    noise = rs.randint(-30, 30, (h, w, channels)) * (rs.rand(h, w, 1) < 0.5)
    out = np.clip(base % 256 + noise, 0, 255).astype(np.uint8)
    return out if channels == 3 else np.ascontiguousarray(out[:, :, 0])


def sha256(data) -> str:
    return hashlib.sha256(bytes(data)).hexdigest()
