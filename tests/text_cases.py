"""Seeded cases for OpenCV 5's ``putText`` and the digests pinned for them
(numpy only, so that ``chip_smoke.py`` can load this module on a machine
without OpenCV).

``tests/test_torch_text.py`` computes every digest with ``cv2.putText``
(cv2 5.0.0) and with the port (``caffe_rtpose_tpu_torch/utils/text.py``,
cv2 blocked) and holds both to DIGESTS; ``chip_smoke.py``'s text phase holds
the port on the card's host to them.

A ``put_text`` argument is any function with ``cv2.putText``'s first seven
arguments, ``(img, text, org, font_face, scale, color, thickness)``, that
draws in place.
"""

import hashlib

import numpy as np

FONT_HERSHEY_SIMPLEX = 0
CANVAS = (64, 200)  # (h, w): the overlay's positions hang off the right edge
KINDS = ("black", "white", "random")

# the overlay's four calls (pipeline/runner.py _overlay_text): text template,
# org as (x, y) with a negative x counted from the right edge, scale,
# colour, thickness
FPS = ((25, 35), 0.75, (255, 150, 150), 1)
PEOPLE = (((-98, 37), 0.75, (0, 0, 0), 2), ((-100, 35), 0.75, (150, 150, 255), 2))
NAME = ((-174, 56), 0.5, (255, 255, 255), 1)

# the part names the overlay can show (part_to_show 1-55) for COCO and MPI
COCO_PARTS = ("Nose", "Neck", "RShoulder", "RElbow", "RWrist", "LShoulder", "LElbow",
              "LWrist", "RHip", "RKnee", "RAnkle", "LHip", "LKnee", "LAnkle", "REye", "LEye",
              "REar", "LEar", "Bkg")
MPI_PARTS = ("Head", "Neck", "RShoulder", "RElbow", "RWrist", "LShoulder", "LElbow", "LWrist",
             "RHip", "RKnee", "RAnkle", "LHip", "LKnee", "LAnkle", "Chest", "Bkg")

# orgs near every edge of the canvas and past it, and the three
# (scale, thickness) pairs the overlay draws with
EDGE_ORGS = ((-30, 20), (-5, 3), (150, 30), (185, 60), (60, -3), (60, 4), (60, 70), (60, 80),
             (190, 10), (-200, 30), (20, 75), (-8, 66))
EDGE_STYLES = ((0.5, 1), (0.75, 1), (0.75, 2))
ASCII = "".join(chr(c) for c in range(32, 127))

# sha256 of each case group's canvases, computed with cv2 5.0.0,
# held by tests/test_torch_text.py
DIGESTS = {
    "fps": "8107e356826e764e3a88caac2b4c1f1f8daea0e7aea04e86424a75cb22b27fac",
    "s_gpu": "735d7a96c78f7b82ccdd4c29c8d17103d99096d273457293acd69f5eaae5ff5a",
    "people": "7113854d1900a9323dda7373a7cfa371da2e5754731c11c3d3999cb8b200f707",
    "names": "f34049936a7ef7241162525a462f3b311d991bff04bc79b5bf5b214357ac4af6",
    "edges": "49712c1d1761d9b3ca873deb71a7332e3f8ce5be91abbb5adec6913b0e97485f",
    "ascii": "b39b4e3d4160d5a51aba298c8cb0443efe4612a1742e89a785f4ffc54df6bc98",
}


def overlay_name(part_names, p2s: int) -> str:
    """The name ``_overlay_text`` shows for ``part_to_show`` = p2s > 0."""
    num_parts = len(part_names) - 1
    if p2s - 1 <= num_parts:
        return part_names[p2s - 1]
    aff = (p2s - 1 - num_parts - 1) * 2
    if aff == 0:
        return "PAFs"
    return part_names[min(aff - 2 + 1 + num_parts, len(part_names) - 1)].split("(")[0]


def overlay_names():
    """Every distinct name the overlay can show, COCO's and MPI's."""
    out = []
    for parts in (COCO_PARTS, MPI_PARTS):
        for p2s in range(1, 56):
            n = overlay_name(parts, p2s)
            if n not in out:
                out.append(n)
    return tuple(out)


def fps_values():
    rs = np.random.RandomState(16)
    return (0.0, 0.04, 0.05, 9.95, 10.0, 99.94, 99.96, 1000.0, 12345.6,
            *(float(v) for v in rs.uniform(0, 200, 24)))


def canvas(kind: str, seed: int) -> np.ndarray:
    h, w = CANVAS
    if kind == "black":
        return np.zeros((h, w, 3), np.uint8)
    if kind == "white":
        return np.full((h, w, 3), 255, np.uint8)
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


def _org(org, w: int):
    return (w + org[0], org[1]) if org[0] < 0 else tuple(org)


def group_cases(name: str):
    """The cases of one group: (seed, [(text, org, scale, colour,
    thickness), ...]) drawn in order on each canvas kind."""
    w = CANVAS[1]
    if name == "fps":
        for i, v in enumerate(fps_values()):
            yield i, [(f"{v:4.1f} fps", *FPS)]
    elif name == "s_gpu":
        for i, v in enumerate(fps_values()):
            yield i, [(f"{1.0 / max(v, 1e-6):4.2f} s/gpu", *FPS)]
    elif name == "people":
        for n in range(100):
            yield n, [(f"{n:4d}", _org(org, w), s, c, t) for org, s, c, t in PEOPLE]
    elif name == "names":
        for i, n in enumerate(overlay_names()):
            org, s, c, t = NAME
            yield i, [(f"{n:>10s}", _org(org, w), s, c, t)]
    elif name == "edges":
        rs = np.random.RandomState(7)
        for i, org in enumerate(EDGE_ORGS):
            for s, t in EDGE_STYLES:
                c = tuple(int(v) for v in rs.randint(0, 256, 3))
                yield i, [("Nose 12.3 fps", org, s, c, t)]
    elif name == "ascii":
        for i, (s, t) in enumerate(EDGE_STYLES):
            yield i, [(ASCII[k:k + 24], (2, 22 + 20 * (k // 24)), s,
                       (40 + 50 * k // 24, 220, 90), t) for k in range(0, len(ASCII), 24)]
    else:
        raise KeyError(name)


def group_digest(put_text, name: str) -> str:
    """sha256 of every canvas of group ``name`` drawn with ``put_text``."""
    h = hashlib.sha256()
    for seed, calls in group_cases(name):
        for k, kind in enumerate(KINDS):
            img = canvas(kind, seed * 3 + k)
            for text, org, scale, color, thickness in calls:
                put_text(img, text, org, FONT_HERSHEY_SIMPLEX, scale, color, thickness)
            h.update(img.tobytes())
    return h.hexdigest()


def digests(put_text) -> dict:
    return {name: group_digest(put_text, name) for name in DIGESTS}
