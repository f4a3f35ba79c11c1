"""Crafted Motion-JPEG AVI files for the port's reader
(``caffe_rtpose_tpu_torch/pipeline/video.py``) and the results pinned for
them (numpy and ``struct`` only, so that ``chip_smoke.py`` can load this
module on a machine without OpenCV).

:func:`build` writes each case of CASES around the q95 JPEG bytes of
:func:`frames` (``cv2.imencode`` and the port's ``encode_jpeg`` give the
same bytes).  ``tests/test_torch_video.py`` holds PINNED against the JAX
package's reader (``cv2.VideoCapture`` with its default backend, FFMPEG, in
``caffe_rtpose_tpu.pipeline.runner.frame_source``) and against the port;
``chip_smoke.py``'s video phase holds the port on the card's host to them.

The layouts:

* ``cv2``: OpenCV's own MJPEG writer's (``hdrl`` with ``avih``, one
  ``strl`` and an ``odml``/``dmlh`` list, ``JUNK`` up to offset 4096,
  ``movi``, ``idx1`` with offsets from the ``movi`` fourcc);
* ``ffmpeg``: libavformat's writer's (a 4,120-byte ``JUNK`` inside
  ``strl`` kept for an OpenDML ``indx``, ``JUNK``, ``LIST INFO``);
* ``idx1_absolute`` (file offsets), ``no_idx1``, ``odd_chunk`` (one
  odd-sized chunk, padded), ``zero_length`` and ``zero_first`` (a chunk of
  0 bytes after frame 2, or first), ``ntsc`` (dwRate/dwScale 30000/1001),
  ``odml`` (OpenDML: the frames split 3 + 5 over ``RIFF AVI`` and ``RIFF
  AVIX``, indexed by a super index ``indx`` and one ``ix00`` a part),
  ``long`` and ``zero_long`` (40 frames, the second with zero-length chunks
  at 5 and 25: seeks step back by timestamp past 16 frames),
  ``truncated`` (no ``idx1``, the file cut inside the last frame's scan),
  ``corrupt`` (frame 5's chunk holds bytes that are not a JPEG).
"""

import hashlib
import itertools
import struct

import numpy as np

QUALITY = 95
SIZE = (48, 64)  # (h, w)
LONG_SIZE = (16, 16)
SEEKS = (0, 1, 2, 3, 5, 7, 8, 9, 100)  # start_frame values, and ui seeks after 2 reads
LONG_SEEKS = (0, 15, 17, 20, 30, 38, 39, 40)
READ_AFTER_SEEK = 3  # frames read after each seek

# name -> (number of source frames, write_avi keywords)
CASES = {
    "cv2": (8, dict(layout="cv2")),
    "ffmpeg": (8, dict(layout="ffmpeg")),
    "idx1_absolute": (8, dict(idx1="absolute")),
    "no_idx1": (8, dict(idx1=None)),
    "odd_chunk": (8, dict(odd=(2,))),
    "zero_length": (8, dict(zero=(3,))),
    "zero_first": (8, dict(zero=(0,))),
    "ntsc": (8, dict(rate=30000, scale=1001)),
    "odml": (8, dict(odml=3)),
    "long": (40, dict()),
    "zero_long": (40, dict(zero=(5, 26))),
    "truncated": (8, dict(idx1=None, cut=5)),
    "corrupt": (8, dict(garbage=(5,))),
}


def frames(n: int, size=SIZE, seed: int = 0):
    """``n`` distinct u8 BGR frames: a level of its own each, over a seeded
    ramp and sparse noise."""
    rs = np.random.RandomState(seed)
    h, w = size
    y, x = np.mgrid[:h, :w]
    base = (x * 2 + y)[..., None] + np.array([0, 30, 60])
    out = []
    for i in range(n):
        noise = rs.randint(-12, 12, (h, w, 3)) * (rs.rand(h, w, 1) < 0.3)
        out.append(np.clip((base + i * 197 // max(n - 1, 1)) % 200 + noise, 0, 255)
                   .astype(np.uint8))
    return out


def case_frames(name: str):
    n = CASES[name][0]
    return frames(n, LONG_SIZE if n > 8 else SIZE, seed=n)


def _chunk(fcc: bytes, data: bytes) -> bytes:
    return fcc + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)


def _list(kind: bytes, body: bytes) -> bytes:
    return b"LIST" + struct.pack("<I", len(body) + 4) + kind + body


def _odd(jpeg: bytes) -> bytes:
    """The JPEG with a 1-byte COM segment after SOI where its length is even."""
    return jpeg if len(jpeg) & 1 else jpeg[:2] + b"\xff\xfe\x00\x03\x00" + jpeg[2:]


def write_avi(jpegs, w, h, layout="cv2", idx1="relative", rate=25, scale=1, odd=(), zero=(),
              odml=0, cut=0, garbage=(), fourcc=b"MJPG", keys=None, extradata=b"") -> bytes:
    """An AVI around ``jpegs``: see the module docstring for the keywords
    (``zero`` inserts a 0-byte chunk before the frame of that index,
    ``odml`` puts the frames from that index on into a RIFF AVIX part;
    ``fourcc`` names the codec in ``strh`` and ``strf``; ``keys`` lists the
    frames ``idx1`` flags AVIIF_KEYFRAME, by default all; ``extradata``
    follows the BITMAPINFOHEADER in ``strf``)."""
    jpegs = [_odd(j) if i in odd else j for i, j in enumerate(jpegs)]
    jpegs = [b"\x00not a jpeg\x00" * 7 if i in garbage else j for i, j in enumerate(jpegs)]
    datas = []
    for i, j in enumerate(jpegs):
        if i in zero:
            datas.append(b"")
        datas.append(j)
    n = len(datas)
    first = n if not odml else odml + sum(1 for z in zero if z < odml)
    period = round(1e6 * scale / rate)
    avih = _chunk(b"avih", struct.pack("<10I", period, 0, 0, 0x910, first, 0, 1, 1 << 20, w, h)
                  + bytes(16))
    strh = _chunk(b"strh", b"vids" + fourcc + struct.pack(
        "<IHHIIIIIIII4h", 0, 0, 0, 0, scale, rate, 0, n, 1 << 20, 0xFFFFFFFF, 0, 0, 0, w, h))
    strf = _chunk(b"strf", struct.pack("<IiiHH4sIiiII", 40 + len(extradata), w, h, 1, 24, fourcc,
                                       w * h * 3, 0, 0, 0, 0) + extradata)
    indx_at = None
    if odml:
        strl_extra = b"\0" * (24 + 16 * 2)  # the super index, filled in below
    elif layout == "ffmpeg":
        strl_extra = _chunk(b"JUNK", bytes(4120))
    else:
        strl_extra = b""
    strl = _list(b"strl", strh + strf + (_chunk(b"indx", strl_extra) if odml else strl_extra))
    if odml:
        indx_at = 12 + 12 + len(avih) + 12 + len(strh) + len(strf)  # the indx chunk's offset
    if layout == "ffmpeg":
        hdrl = _list(b"hdrl", avih + strl + _chunk(b"JUNK", bytes(260)))
        pre = _list(b"INFO", _chunk(b"ISFT", b"Lavf61.7.100\0")) + _chunk(b"JUNK", bytes(1016))
    else:
        hdrl = _list(b"hdrl", avih + strl + _list(b"odml", _chunk(b"dmlh", struct.pack(
            "<I", n) + bytes(244))))
        pre = _chunk(b"JUNK", bytes(4096 - 12 - len(hdrl) - 8))  # movi at 4096
    head = b"AVI " + hdrl + pre
    parts = [datas[:first], datas[first:]] if odml else [datas]
    out, entries, ix_at = bytearray(), [], []
    for p, part in enumerate(parts):
        riff_start = len(out)
        movi_at = riff_start + 8 + (len(head) if p == 0 else 4) + 8  # the 'movi' fourcc
        body, ix = bytearray(), []
        for d in part:
            pos = movi_at + 4 + len(body)
            body += _chunk(b"00dc", d)
            entries.append((pos, len(d), keys is None or len(entries) in keys))
            ix.append((pos + 8, len(d)))
        if odml:
            ix_at.append((movi_at + 4 + len(body), len(part)))
            base = movi_at  # libavformat's writer: offsets from the 'movi' fourcc
            body += _chunk(b"ix00", struct.pack("<HBBI4sQI", 2, 0, 1, len(ix), b"00dc", base, 0)
                           + b"".join(struct.pack("<II", o - base, ln) for o, ln in ix))
        movi = _list(b"movi", body)
        if p == 0:
            tail = b""
            if idx1:
                off = 0 if idx1 == "absolute" else movi_at
                tail = _chunk(b"idx1", b"".join(
                    struct.pack("<4sIII", b"00dc", 0x10 if key else 0, pos - off, ln)
                    for pos, ln, key in entries))
            riff = head + movi + tail
        else:
            riff = b"AVIX" + movi
        out += b"RIFF" + struct.pack("<I", len(riff)) + riff
    if odml:
        sup = struct.pack("<HBBI4sQI", 4, 0, 0, len(ix_at), b"00dc", 0, 0) + b"".join(
            struct.pack("<QII", at, 8 + 24 + 8 * cnt, cnt) for at, cnt in ix_at)
        out = out[:indx_at + 8] + sup + out[indx_at + 8 + len(sup):]
    return bytes(out[:len(out) - cut] if cut else out)


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def write_mp4(fourcc: bytes = b"avc1", w: int = 64, h: int = 48) -> bytes:
    """The boxes of an ISO BMFF file (ftyp, moov with one video track whose
    sample entry is ``fourcc``, an empty mdat): enough to name its codec."""
    hdlr = _box(b"hdlr", bytes(8) + b"vide" + bytes(12) + b"VideoHandler\0")
    entry = _box(fourcc, bytes(6) + struct.pack(">H", 1) + bytes(16) + struct.pack(">HH", w, h)
                 + bytes(50))
    stbl = _box(b"stbl", _box(b"stsd", bytes(4) + struct.pack(">I", 1) + entry))
    trak = _box(b"trak", _box(b"mdia", hdlr + _box(b"minf", stbl)))
    return (_box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2avc1mp41")
            + _box(b"moov", trak) + _box(b"mdat", b""))


def build(name: str, encode):
    """(the AVI bytes of case ``name``, the source frames); ``encode(img,
    quality)`` gives a frame's JPEG bytes."""
    imgs = case_frames(name)
    h, w = imgs[0].shape[:2]
    return write_avi([encode(f, QUALITY) for f in imgs], w, h, **CASES[name][1]), imgs


def sha256(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def seeks(name: str):
    return LONG_SEEKS if CASES[name][0] > 8 else SEEKS


def chunks(data: bytes):
    """The bytes of every non-empty ``00dc`` chunk in file order (a chunk the
    end of the file cuts, as far as it goes): a plain walk that descends into
    each RIFF and LIST, independent of the port's reader."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        fcc, size = struct.unpack_from("<4sI", data, pos)
        if fcc in (b"RIFF", b"LIST"):
            pos += 12
            continue
        if fcc == b"00dc" and size:
            out.append(data[pos + 8:pos + 8 + size])
        pos += 8 + size + (size & 1)
    return out


def decoded(data: bytes, decode):
    """Each source frame of an AVI as FFMPEG decodes it: ``decode(chunk)``
    (one decoder over the chunks in file order, so that a cut chunk keeps
    the frame before's pixels) of its chunk, None where it does not
    decode."""
    out = []
    for c in chunks(data):
        try:
            out.append(decode(c))
        except ValueError:
            out.append(None)
    return out


def ident(img, sources, exact: bool = False) -> int:
    """The index of the source frame nearest ``img`` by mean |difference|,
    1.3 times nearer than the next; with ``exact``, of the one frame of
    ``sources`` (decoded frames) equal to ``img``."""
    if exact:
        hits = [i for i, s in enumerate(sources) if s is not None and np.array_equal(img, s)]
        if len(hits) != 1:
            raise ValueError(f"a frame equals sources {hits}")
        return hits[0]
    d = sorted((float(np.abs(img.astype(np.int32) - s).mean()), i)
               for i, s in enumerate(sources))
    if not d[1][0] > 1.3 * d[0][0]:
        raise ValueError(f"a frame is as near source {d[1][1]} as {d[0][1]}: {d[:2]}")
    return d[0][1]


def observe(runner, path, sources, seek_to, exact: bool = False, ui: bool = True):
    """What ``runner.frame_source`` (the JAX package's or the port's runner
    module) gives for ``path`` in PINNED's form: the source ids of the frames
    read from the start, of READ_AFTER_SEEK frames after each start_frame k,
    and of READ_AFTER_SEEK frames after a ui seek to k made once 2 frames
    were read; the frame numbers it yields are checked to count on from 0
    or k.  ``exact``: ``sources`` are the decoded frames (:func:`decoded`)
    and each frame must equal one of them; without ``ui``, no ui seeks (a
    source of one frame)."""
    def ids(first, start=0, ui_seek=None, limit=READ_AFTER_SEEK):
        ui = runner.UIState() if ui_seek is not None else None
        src = runner.frame_source(runner.PipelineConfig(video=path, start_frame=start,
                                                        no_frame_drops=True), ui)
        if ui_seek is not None:
            if sum(1 for _ in itertools.islice(src, 2)) != 2:
                raise ValueError(f"{path}: fewer than 2 frames before the ui seek")
            ui.current_frame, ui.seek_to_frame = ui_seek, True
        got = list(itertools.islice(src, limit))
        if [i for i, _, _ in got] != list(range(first, first + len(got))):
            raise ValueError(f"{path}: frame numbers {[i for i, _, _ in got]} from {first}")
        return tuple(ident(img, sources, exact) for _, img, _ in got)

    out = dict(order=ids(0, limit=None), start={k: ids(k, start=k) for k in seek_to})
    if ui:
        out["ui"] = {k: ids(k, ui_seek=k) for k in seek_to}
    return out


# What the JAX package's reader gives for each case (frame ids index the
# case's source frames): frame_count and fps as cv2.VideoCapture reports
# them, the frames a read from the start gives, the frames READ_AFTER_SEEK
# reads give after start_frame k and after a ui seek to k made once 2 frames
# were read, and the sha256 of the JAX reader's frames in the read's order
# (FFMPEG's decode, which the port's equals bit for bit).
PINNED = {
    "cv2": {'count': 8,
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
     'sha256': 'bfd28d2e99ed9b1036ffc223a51e1def12fb5dcadc59a5b966b72168a24247da'},
    "ffmpeg": {'count': 8,
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
     'sha256': 'bfd28d2e99ed9b1036ffc223a51e1def12fb5dcadc59a5b966b72168a24247da'},
    "idx1_absolute": {'count': 8,
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
     'sha256': 'bfd28d2e99ed9b1036ffc223a51e1def12fb5dcadc59a5b966b72168a24247da'},
    "no_idx1": {'count': 8,
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
     'sha256': 'bfd28d2e99ed9b1036ffc223a51e1def12fb5dcadc59a5b966b72168a24247da'},
    "odd_chunk": {'count': 8,
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
     'sha256': 'bfd28d2e99ed9b1036ffc223a51e1def12fb5dcadc59a5b966b72168a24247da'},
    "zero_length": {'count': 9,
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
     'sha256': 'bfd28d2e99ed9b1036ffc223a51e1def12fb5dcadc59a5b966b72168a24247da'},
    "zero_first": {'count': 9,
     'fps': 25.0,
     'order': (0, 1, 2, 3, 4, 5, 6, 7),
     'start': {0: (0, 1, 2),
               1: (2, 3, 4),
               2: (2, 3, 4),
               3: (3, 4, 5),
               5: (5, 6, 7),
               7: (7,),
               8: (),
               9: (),
               100: ()},
     'ui': {0: (2, 3, 4),
            1: (3, 4, 5),
            2: (3, 4, 5),
            3: (3, 4, 5),
            5: (5, 6, 7),
            7: (7,),
            8: (),
            9: (),
            100: ()},
     'sha256': 'bfd28d2e99ed9b1036ffc223a51e1def12fb5dcadc59a5b966b72168a24247da'},
    "ntsc": {'count': 8,
     'fps': 29.97002997002997,
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
     'sha256': 'bfd28d2e99ed9b1036ffc223a51e1def12fb5dcadc59a5b966b72168a24247da'},
    "odml": {'count': 8,
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
     'sha256': 'bfd28d2e99ed9b1036ffc223a51e1def12fb5dcadc59a5b966b72168a24247da'},
    "long": {'count': 40,
     'fps': 25.0,
     'order': (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21,
               22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39),
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
     'sha256': '3cb335e117ddc7d99c707540a41a6d9f13fb7c5401c5511c303e7a50e9888adb'},
    "zero_long": {'count': 42,
     'fps': 25.0,
     'order': (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21,
               22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39),
     'start': {0: (0, 1, 2),
               15: (15, 16, 17),
               17: (17, 18, 19),
               20: (20, 21, 22),
               30: (29, 30, 31),
               38: (37, 38, 39),
               39: (38, 39),
               40: (39,)},
     'ui': {0: (0, 1, 2),
            15: (15, 16, 17),
            17: (17, 18, 19),
            20: (20, 21, 22),
            30: (29, 30, 31),
            38: (37, 38, 39),
            39: (38, 39),
            40: (39,)},
     'sha256': '3cb335e117ddc7d99c707540a41a6d9f13fb7c5401c5511c303e7a50e9888adb'},
    "truncated": {'count': 8,
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
     'sha256': '2e33a75148299416f06a5b813cacb565d0ea69b2d3668863852dfa585f65f920'},
    "corrupt": {'count': 8,
     'fps': 25.0,
     'order': (0, 1, 2, 3, 4),
     'start': {0: (0, 1, 2),
               1: (1, 2, 3),
               2: (2, 3, 4),
               3: (3, 4),
               5: (),
               7: (6, 7),
               8: (6, 7),
               9: (6, 7),
               100: (6, 7)},
     'ui': {0: (0, 1, 2),
            1: (1, 2, 3),
            2: (2, 3, 4),
            3: (3, 4),
            5: (),
            7: (6, 7),
            8: (6, 7),
            9: (6, 7),
            100: (6, 7)},
     'sha256': '6f9379aa1627d9a9c5fc37592f21348520a3ed1e319014c4fc777c105d29b964'},
}
