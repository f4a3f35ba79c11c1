"""MPEG-4 Part 2 and Motion-JPEG clips for the port's MP4/QuickTime reader
(``caffe_rtpose_tpu_torch/pipeline/bmff.py``), its MPEG-4 decoder
(``csrc/mpeg4_video.cpp``) and its AVI reader, and the results pinned for
them (numpy and ``struct`` only, so that ``chip_smoke.py`` can load this
module on a machine without OpenCV).

* CLIPS: files that cv2 5.0's FFMPEG writer wrote (``tests/data/``), from
  the seeded frames of :func:`clip_frames`: ``mp4v`` in ``.mp4`` and
  ``.mov``, ``XVID`` and ``DIVX`` in ``.avi`` (I/P, a key frame every 12),
  Motion-JPEG in ``.mov`` (the writer's tag ``jpeg``), a clip of large
  motion (``f_code`` 3 and 4, vectors out of the frame) and the 8 1280x720 frames
  of ``jpeg_frames.frame`` (``mp4v_720p.mp4``, chip_smoke's cli run).
  :func:`write_clips` rewrites them (it needs cv2).
* CASES: layouts :func:`write_mp4` builds around the samples of
  ``mp4v.mp4`` (its packets and VOL headers unchanged): ``moov`` first or
  last, ``co64``, several ``stsc`` runs, a uniform ``stsz`` (each sample
  padded with zero bytes to the largest), no ``stss``, an ``elst`` whose
  ``media_time`` skips 2 frames and one that ends after 20 of the 26, a
  30000/1001 timescale, a 64-bit ``mdat`` size, an ``mdat`` of size 0 (to
  the end of the file); and, refused, a fragmented file (``moof``),
  composition offsets (``ctts``) and an ``esds`` naming MPEG-2 video.

``tests/test_torch_mp4.py`` holds PINNED against the JAX package's reader
(``cv2.VideoCapture`` in ``caffe_rtpose_tpu.pipeline.runner.frame_source``)
and against the port; ``chip_smoke.py``'s video phase holds the port on
the card's host to them.
"""

import os
import struct

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CLIP_SIZE = (74, 100)  # (h, w): neither a multiple of 16
CLIP_FRAMES = 26  # key frames at 0, 12, 24
SEEKS = (0, 1, 3, 11, 12, 13, 20, 25, 26, 40)
READ_AFTER_SEEK = 3

# name -> (file under tests/data, frames, kind, fourcc for cv2's writer)
CLIPS = {
    "mp4v_mp4": ("mp4v.mp4", CLIP_FRAMES, "drift", "mp4v"),
    "mp4v_mov": ("mp4v.mov", CLIP_FRAMES, "drift", "mp4v"),
    "xvid_avi": ("xvid.avi", CLIP_FRAMES, "drift", "XVID"),
    "divx_avi": ("divx.avi", CLIP_FRAMES, "drift", "DIVX"),
    "mjpeg_mov": ("mjpeg.mov", CLIP_FRAMES, "drift", "MJPG"),
    "motion_mp4": ("motion.mp4", 14, "motion", "mp4v"),
    "mp4v_720p": ("mp4v_720p.mp4", 8, "jpeg_frames", "mp4v"),
}

# name -> write_mp4 keywords (around mp4v.mp4's samples)
CASES = {
    "moov_first": dict(moov_first=True),
    "moov_last": dict(),
    "co64": dict(co64=True),
    "stsc_runs": dict(chunks=(3, 3, 3, 5, 1, 1, 4, 6)),
    "uniform_stsz": dict(uniform=True),
    "no_stss": dict(stss=False),
    "elst_skip2": dict(media_time=2),
    "elst_short": dict(edit_frames=20),
    "ntsc": dict(timescale=30000, delta=1001),
    "large_box": dict(large_mdat=True),
    "open_mdat": dict(moov_first=True, open_mdat=True),
}
REFUSED_CASES = {"fragmented": dict(fragmented=True), "ctts": dict(ctts=True),
                 "mpeg2_esds": dict(object_type=0x61)}


def clip_frames(n: int, kind: str, size=CLIP_SIZE, seed: int = 7):
    """``n`` seeded u8 BGR frames.  ``drift``: a textured plane moving 3 px
    right and 2 down a frame; ``motion``: one moving 23 px right and 11 down
    a frame, with a dark disc crossing it; ``jpeg_frames``: the JPEG
    checks' frames (``jpeg_frames.frame(h, w, i)``)."""
    h, w = size
    if kind == "jpeg_frames":
        import jpeg_frames

        return [jpeg_frames.frame(h, w, i) for i in range(n)]
    rs = np.random.RandomState(seed)
    big = (h * 3, w * 3)
    y, x = np.mgrid[:big[0], :big[1]].astype(np.float64)
    tex = np.stack([128 + 90 * np.sin(x / 9 + y / 23), 128 + 80 * np.cos(y / 7 - x / 31),
                    128 + 70 * np.sin((x + 2 * y) / 13)], -1)
    tex += rs.randint(-25, 25, big + (3,)) * (rs.rand(*big, 1) < 0.2)
    tex = np.clip(tex, 0, 255).astype(np.uint8)
    step = (3, 2) if kind == "drift" else (23, 11)
    out = []
    for i in range(n):
        dx, dy = (i * step[0]) % (2 * w), (i * step[1]) % (2 * h)
        f = tex[dy:dy + h, dx:dx + w].copy()
        if kind == "motion":
            cy, cx = (i * 19) % h, (i * 37) % w
            yy, xx = np.mgrid[:h, :w]
            f[(yy - cy) ** 2 + (xx - cx) ** 2 < 15 ** 2] = 0
        out.append(f)
    return out


def clip_path(name: str) -> str:
    return os.path.join(DATA, CLIPS[name][0])


def sources(name: str):
    _, n, kind, _ = CLIPS[name]
    return clip_frames(n, kind, (720, 1280) if kind == "jpeg_frames" else CLIP_SIZE)


def write_clips(cv2) -> None:
    """Rewrites tests/data's clips with cv2's FFMPEG writer (25 fps)."""
    for name, (fname, n, kind, fourcc) in CLIPS.items():
        frames = sources(name)
        h, w = frames[0].shape[:2]
        wr = cv2.VideoWriter(os.path.join(DATA, fname), cv2.CAP_FFMPEG,
                             cv2.VideoWriter_fourcc(*fourcc), 25, (w, h))
        for f in frames:
            wr.write(f)
        wr.release()


# ------------------------------------------------------------------ reading

_CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts", b"dinf"}


def _walk(data: bytes, start: int, end: int, out: dict, path=()):
    pos = start
    while pos + 8 <= end:
        size, typ = struct.unpack_from(">I4s", data, pos)
        hdr = 8
        if size == 1:
            size, hdr = struct.unpack_from(">Q", data, pos + 8)[0], 16
        elif size == 0:
            size = end - pos
        p = path + (typ,)
        out.setdefault(p, (pos + hdr, pos + size))
        if typ in _CONTAINERS:
            _walk(data, pos + hdr, pos + size, out, p)
        pos += size


def samples(data: bytes):
    """(packets, the esds DecoderSpecificInfo, timescale, sample delta) of
    the first track of an MP4 that cv2's writer wrote: one stts entry, one
    stsd entry, a table stsz, stco (a plain reading, independent of
    bmff.py)."""
    boxes = {}
    _walk(data, 0, len(data), boxes)
    stbl = (b"moov", b"trak", b"mdia", b"minf", b"stbl")

    def body(*p):
        a, b = boxes[p]
        return data[a:b]

    mdhd = body(b"moov", b"trak", b"mdia", b"mdhd")
    timescale = struct.unpack_from(">I", mdhd, 12)[0]
    _, _, delta = struct.unpack_from(">III", body(*stbl, b"stts"), 4)
    stsz = body(*stbl, b"stsz")
    _, count = struct.unpack_from(">II", stsz, 4)
    sizes = struct.unpack_from(f">{count}I", stsz, 12)
    stsc = body(*stbl, b"stsc")
    runs = [struct.unpack_from(">III", stsc, 8 + 12 * i)
            for i in range(struct.unpack_from(">I", stsc, 4)[0])]
    stco = body(*stbl, b"stco")
    offsets = struct.unpack_from(f">{struct.unpack_from('>I', stco, 4)[0]}I", stco, 8)
    packets = []
    for i, (first, per, _) in enumerate(runs):
        last = runs[i + 1][0] - 1 if i + 1 < len(runs) else len(offsets)
        for c in range(first - 1, last):
            at = offsets[c]
            for _ in range(per):
                if len(packets) < count:
                    packets.append(data[at:at + sizes[len(packets)]])
                    at += sizes[len(packets) - 1]
    stsd = body(*stbl, b"stsd")
    j = stsd.find(b"esds")
    extra = b""
    if j >= 0:
        k = stsd.find(b"\x05", j + 8 + 5 + 2 + 1 + 13)  # DecSpecificInfo tag
        n, p = 0, k + 1
        while True:
            b = stsd[p]
            p += 1
            n = (n << 7) | (b & 0x7F)
            if not b & 0x80:
                break
        extra = stsd[p:p + n]
    return packets, extra, timescale, delta


# ------------------------------------------------------------------ writing

def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full(kind: bytes, body: bytes, version: int = 0, flags: int = 0) -> bytes:
    return _box(kind, struct.pack(">I", version << 24 | flags) + body)


def _desc(tag: int, body: bytes) -> bytes:
    n = len(body)
    return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                  0x80 | (n >> 7) & 0x7F, n & 0x7F]) + body


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def write_mp4(packets, w, h, fourcc=b"mp4v", extra=b"", timescale=12800, delta=512,
              moov_first=False, co64=False, chunks=None, uniform=False, stss=True,
              media_time=0, edit_frames=None, fragmented=False, large_mdat=False,
              open_mdat=False, keys=None, ctts=False, object_type=0x20, config=b"",
              brand=b"isom", ctts_version=0, elst=True) -> bytes:
    """An MP4 of one video track around ``packets``: see the module
    docstring; ``chunks`` gives the samples of each chunk in turn (the last
    repeated), ``media_time`` the edit's start in frames, ``edit_frames``
    its length in frames (default: to the end), ``keys`` the key
    frames' indices (default: the packets that hold an I-VOP or, for
    ``jpeg``, all); ``ctts`` adds composition offsets of one frame on every
    second sample, or (a list) the given offset of each sample, in a box of
    version ``ctts_version`` (1: signed); ``elst`` False leaves out the
    edit list; ``object_type`` is the esds objectTypeIndication,
    ``config`` a box added to the sample entry (H.264's ``avcC``) and
    ``brand`` the ftyp's major brand (``qt  `` for QuickTime)."""
    n = len(packets)
    if keys is None:
        keys = [i for i, p in enumerate(packets) if fourcc != b"mp4v" or _is_intra(p)]
    if uniform:
        top = max(len(p) for p in packets)
        packets = [p + bytes(top - len(p)) for p in packets]
    per = list(chunks or (n,))
    counts = []
    while sum(counts) < n:
        counts.append(min(per[min(len(counts), len(per) - 1)], n - sum(counts)))
    dur = n * delta
    movie_dur = _ceil_div(dur * 1000, timescale)

    def moov(mdat_body_at: int) -> bytes:
        offs, at, k = [], mdat_body_at, 0
        for c in counts:
            offs.append(at)
            at += sum(len(p) for p in packets[k:k + c])
            k += c
        entry_body = (bytes(6) + struct.pack(">H", 1) + bytes(16) + struct.pack(">HH", w, h)
                      + struct.pack(">II", 0x480000, 0x480000) + bytes(4) + struct.pack(">H", 1)
                      + bytes(32) + struct.pack(">Hh", 24, -1))
        if fourcc == b"mp4v":
            es = _desc(3, struct.pack(">HB", 1, 0) + _desc(
                4, struct.pack(">BB", object_type, 0x11) + bytes(3) + struct.pack(">II", 0, 0)
                + _desc(5, extra)) + _desc(6, b"\x02"))
            entry_body += _full(b"esds", es)
        entry_body += config
        stsd = _full(b"stsd", struct.pack(">I", 1) + _box(fourcc, entry_body))
        stts = _full(b"stts", struct.pack(">III", 1, n, delta))
        runs, prev = [], None
        for i, c in enumerate(counts):
            if c != prev:
                runs.append((i + 1, c, 1))
                prev = c
        stsc = _full(b"stsc", struct.pack(">I", len(runs)) + b"".join(
            struct.pack(">III", *r) for r in runs))
        if uniform:
            stsz = _full(b"stsz", struct.pack(">II", len(packets[0]), n))
        else:
            stsz = _full(b"stsz", struct.pack(">II", 0, n) + b"".join(
                struct.pack(">I", len(p)) for p in packets))
        if co64:
            stco = _full(b"co64", struct.pack(">I", len(offs)) + b"".join(
                struct.pack(">Q", o) for o in offs))
        else:
            stco = _full(b"stco", struct.pack(">I", len(offs)) + b"".join(
                struct.pack(">I", o) for o in offs))
        stbl = stsd + stts
        if stss:
            stbl += _full(b"stss", struct.pack(">I", len(keys)) + b"".join(
                struct.pack(">I", k + 1) for k in keys))
        if ctts:
            offsets = ctts if isinstance(ctts, (list, tuple)) else [delta * (i % 2) for i in range(n)]
            stbl += _full(b"ctts", struct.pack(">I", n) + b"".join(
                struct.pack(">Ii", 1, o) for o in offsets), version=ctts_version)
        stbl += stsc + stsz + stco
        minf = (_full(b"vmhd", bytes(8), flags=1)
                + _box(b"dinf", _full(b"dref", struct.pack(">I", 1) + _full(b"url ", b"", flags=1)))
                + _box(b"stbl", stbl))
        mdia = (_full(b"mdhd", struct.pack(">IIIIHH", 0, 0, timescale, dur, 0x55C4, 0))
                + _full(b"hdlr", bytes(4) + b"vide" + bytes(12) + b"VideoHandler\0")
                + _box(b"minf", minf))
        skip = media_time * delta
        span = dur - skip if edit_frames is None else edit_frames * delta
        elst_box = _full(b"elst", struct.pack(">IIiHH", 1, _ceil_div(span * 1000, timescale),
                                              skip, 1, 0))
        tkhd = _full(b"tkhd", struct.pack(">IIIII", 0, 0, 1, 0, movie_dur) + bytes(8)
                     + struct.pack(">hhhH", 0, 0, 0, 0) + _MATRIX
                     + struct.pack(">II", w << 16, h << 16), flags=3)
        trak = _box(b"trak", tkhd + (_box(b"edts", elst_box) if elst else b"") + _box(b"mdia", mdia))
        mvhd = _full(b"mvhd", struct.pack(">IIII", 0, 0, 1000, movie_dur)
                     + struct.pack(">IH", 0x10000, 0x100) + bytes(10) + _MATRIX + bytes(24)
                     + struct.pack(">I", 2))
        body = mvhd + trak
        if fragmented:
            body += _box(b"mvex", _full(b"trex", struct.pack(">IIIII", 1, 1, 0, 0, 0)))
        return _box(b"moov", body)

    ftyp = _box(b"ftyp", brand + struct.pack(">I", 512) + b"isomiso2mp41")
    payload = b"".join(packets)
    mdat_head = (struct.pack(">I4sQ", 1, b"mdat", 16 + len(payload)) if large_mdat
                 else struct.pack(">I4s", 0 if open_mdat else 8 + len(payload), b"mdat"))
    free = _box(b"free", b"")
    if moov_first:
        size = len(moov(0))
        head = ftyp + moov(len(ftyp) + size + len(free) + len(mdat_head)) + free
        out = head + mdat_head + payload
    else:
        out = ftyp + free + mdat_head + payload + moov(len(ftyp) + len(free) + len(mdat_head))
    if fragmented:
        out += _box(b"moof", _full(b"mfhd", struct.pack(">I", 1)))
    return out


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _is_intra(packet: bytes) -> bool:
    i = packet.find(b"\x00\x00\x01\xb6")
    return i >= 0 and packet[i + 4] >> 6 == 0


def build(name: str) -> bytes:
    """The bytes of CASES/REFUSED_CASES ``name``."""
    with open(clip_path("mp4v_mp4"), "rb") as f:
        packets, extra, timescale, delta = samples(f.read())
    kw = dict(timescale=timescale, delta=delta)
    kw.update(CASES[name] if name in CASES else REFUSED_CASES[name])
    h, w = CLIP_SIZE
    return write_mp4(packets, w, h, extra=extra, **kw)


def case_sources(name: str):
    return sources("mp4v_mp4")


def _reads(ids):
    """The reads PINNED holds for a clip that shows source frames ``ids``
    in turn: every start_frame and ui seek to k reads on from ids[k]."""
    ids = tuple(ids)
    after = {k: ids[k:k + READ_AFTER_SEEK] for k in SEEKS}
    return dict(order=ids, start=after, ui=dict(after))


# What the JAX package's reader gives for each clip and case (frame ids
# index the clip's source frames): frame_count and fps as cv2.VideoCapture
# reports them, the frames a read from the start gives, the frames
# READ_AFTER_SEEK reads give after start_frame k and after a ui seek to k
# made once 2 frames were read (not for the 1280x720 clip, whose frames
# differ too little to tell apart), and the sha256 of the port's frames in
# the read's order (they equal cv2's, MPEG-4 and Motion-JPEG alike).
PINNED = {
    "mp4v_mp4": dict(count=26, fps=25.0, **_reads(range(0, 26)),
                     sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "mp4v_mov": dict(count=26, fps=25.0, **_reads(range(0, 26)),
                     sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "xvid_avi": dict(count=26, fps=25.0, **_reads(range(0, 26)),
                     sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "divx_avi": dict(count=26, fps=25.0, **_reads(range(0, 26)),
                     sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "mjpeg_mov": dict(count=26, fps=25.0, **_reads(range(0, 26)),
                      sha256="07e2010779f808db0b33bfb02bc68b46a951616766a89c60f0a76eb9b4978e11"),
    "motion_mp4": dict(count=14, fps=25.0, **_reads(range(0, 14)),
                       sha256="7639297d24214c581dc8c7b11736d95cb466ce68aa84dd2141a05690ab490583"),
    "mp4v_720p": dict(count=8, fps=25.0,
                      sha256="345509702bb9e3b8a0f402baf9346af15fec63d48fe95b7f78422214c07ab7d2"),
    "moov_first": dict(count=26, fps=25.0, **_reads(range(0, 26)),
                       sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "moov_last": dict(count=26, fps=25.0, **_reads(range(0, 26)),
                      sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "co64": dict(count=26, fps=25.0, **_reads(range(0, 26)),
                 sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "stsc_runs": dict(count=26, fps=25.0, **_reads(range(0, 26)),
                      sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "uniform_stsz": dict(count=26, fps=25.0, **_reads(range(0, 26)),
                         sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "no_stss": dict(count=26, fps=25.0, **_reads(range(0, 26)),
                    sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "elst_skip2": dict(count=26, fps=25.0, **_reads(range(2, 26)),
                       sha256="950a2f7859dfa2a037987f6bad526bab663c7b6d8a124239cd46966f0dafb9c7"),
    "elst_short": dict(count=26, fps=25.0, **_reads(range(0, 20)),
                       sha256="1179971f99152a264bc0cf53ae799e6274cd8cf5a9b144fba2e58acf7dcc962b"),
    "ntsc": dict(count=26, fps=29.97002997002997, **_reads(range(0, 26)),
                 sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "large_box": dict(count=26, fps=25.0, **_reads(range(0, 26)),
                      sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "open_mdat": dict(count=26, fps=25.0, **_reads(range(0, 26)),
                      sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
}
