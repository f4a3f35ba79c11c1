"""Matroska (MKV) and WebM files for the port's Matroska demuxer
(``caffe_rtpose_tpu_torch/pipeline/matroska.py`` behind
``video.MkvReader``) and the results pinned for them (numpy, ``struct``
and ``zlib`` only, so that ``chip_smoke.py`` can load this module on a
machine without OpenCV).

* An EBML writer (:func:`write_mkv`), independent of the port's reader,
  that wraps the packets of streams the repo already has: the H.264
  streams of ``h264_cases`` (CAVLC, CABAC, B pyramid, High profile, a
  stream that starts on a non-IDR I picture), the MPEG-4 Part 2 samples of
  ``tests/data/mp4v.mp4`` and the Motion-JPEG samples of
  ``tests/data/mjpeg.mov``.  Its knobs: ``SimpleBlock`` or ``BlockGroup``
  (with ``ReferenceBlock`` on the frames that are not key frames, and
  ``BlockDuration``), the three lacings, ``Cues`` on every key frame, on
  some or none, before or after the clusters, unknown-size Segment and
  Clusters, header stripping and zlib, ``V_MS/VFW/FOURCC``, TimestampScale
  1 ms and 100 us, 30000/1001 and 24000/1001 timestamps, no
  ``DefaultDuration``, no ``Duration``, an audio track first, ``EBMLVoid``
  and ``CRC-32`` elements, the invisible flag, a block of an undeclared
  track, ``PixelCrop*``, and a file cut inside its last cluster.
* CLIPS: files cv2 5.0's FFMPEG writer wrote into ``.mkv`` (``MJPG`` and
  ``mp4v``, 100x74, committed under ``tests/data``); :func:`write_clips`
  rewrites them (it needs cv2).
* CASES, REFUSED and PINNED: what the JAX package's reader
  (``cv2.VideoCapture`` in ``caffe_rtpose_tpu.pipeline.runner``) gives for
  each file, in ``avi_cases.observe``'s form.

``tests/test_torch_mkv.py`` holds PINNED against the JAX reader and the
port; ``chip_smoke.py``'s video phase holds the port on the card's host to
them, and its cli phase remuxes ``tests/data/h264_high_720p.mp4``
(:func:`remux_mp4`).
"""

import os
import struct
import zlib

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CLIP_SIZE = (74, 100)  # (h, w)
SEEKS = (0, 1, 3, 11, 12, 13, 20, 25, 26, 40)
READ_AFTER_SEEK = 3

# ------------------------------------------------------------------ EBML

EBML, DOC_TYPE = 0x1A45DFA3, 0x4282
SEGMENT, SEEK_HEAD, SEEK, SEEK_ID, SEEK_POSITION = 0x18538067, 0x114D9B74, 0x4DBB, 0x53AB, 0x53AC
INFO, TIMESTAMP_SCALE, DURATION = 0x1549A966, 0x2AD7B1, 0x4489
TRACKS, TRACK_ENTRY, TRACK_NUMBER, TRACK_UID, TRACK_TYPE = 0x1654AE6B, 0xAE, 0xD7, 0x73C5, 0x83
CODEC_ID, CODEC_PRIVATE, DEFAULT_DURATION, TRACK_TIMESTAMP_SCALE = 0x86, 0x63A2, 0x23E383, 0x23314F
VIDEO, PIXEL_WIDTH, PIXEL_HEIGHT = 0xE0, 0xB0, 0xBA
PIXEL_CROP = dict(bottom=0x54AA, top=0x54BB, left=0x54CC, right=0x54DD)
AUDIO, SAMPLING_FREQUENCY, CHANNELS, BIT_DEPTH = 0xE1, 0xB5, 0x9F, 0x6264
CONTENT_ENCODINGS, CONTENT_ENCODING, CONTENT_ENCODING_SCOPE = 0x6D80, 0x6240, 0x5032
CONTENT_ENCODING_TYPE, CONTENT_COMPRESSION, CONTENT_COMP_ALGO = 0x5033, 0x5034, 0x4254
CONTENT_COMP_SETTINGS, CONTENT_ENCRYPTION, CONTENT_ENC_ALGO = 0x4255, 0x5035, 0x47E1
CLUSTER, TIMESTAMP, SIMPLE_BLOCK, BLOCK_GROUP, BLOCK = 0x1F43B675, 0xE7, 0xA3, 0xA0, 0xA1
BLOCK_DURATION, REFERENCE_BLOCK = 0x9B, 0xFB
CUES, CUE_POINT, CUE_TIME, CUE_TRACK_POSITIONS = 0x1C53BB6B, 0xBB, 0xB3, 0xB7
CUE_TRACK, CUE_CLUSTER_POSITION, CUE_RELATIVE_POSITION = 0xF7, 0xF1, 0xF0
VOID, CRC32 = 0xEC, 0xBF
UNKNOWN = -1  # an element size of all ones


def ebml_id(i: int) -> bytes:
    return i.to_bytes((i.bit_length() + 7) // 8, "big")


def vint(n: int, length: int = 0) -> bytes:
    """An element size: ``n`` in the shortest length (or ``length``
    bytes), or the unknown size (:data:`UNKNOWN`, 8 bytes)."""
    if n == UNKNOWN:
        return b"\x01" + b"\xff" * 7
    if not length:
        length = 1
        while n >= (1 << (7 * length)) - 1:
            length += 1
    return ((1 << (7 * length)) | n).to_bytes(length, "big")


def el(i: int, body: bytes, size_len: int = 0) -> bytes:
    return ebml_id(i) + vint(len(body), size_len) + body


def uint(i: int, v: int, width: int = 0) -> bytes:
    width = width or max(1, (v.bit_length() + 7) // 8)
    return el(i, v.to_bytes(width, "big"))


def sint(i: int, v: int) -> bytes:
    width = 1
    while not -(1 << (8 * width - 1)) <= v < (1 << (8 * width - 1)):
        width += 1
    return el(i, v.to_bytes(width, "big", signed=True))


def flt(i: int, v: float) -> bytes:
    return el(i, struct.pack(">d", v))


def text(i: int, s: str) -> bytes:
    return el(i, s.encode())


def crc(body: bytes) -> bytes:
    """A CRC-32 element over ``body`` (the master element's other children)."""
    return el(CRC32, struct.pack("<I", zlib.crc32(body)))


def ebml_header(doc_type: str = "matroska", max_id: int = 4, max_size: int = 8) -> bytes:
    return el(EBML, uint(0x4286, 1) + uint(0x42F7, 1) + uint(0x42F2, max_id)
              + uint(0x42F3, max_size) + text(DOC_TYPE, doc_type) + uint(0x4287, 4)
              + uint(0x4285, 2))


def _lace(frames, kind: str) -> bytes:
    """The lace header and the frames of one laced block."""
    head = bytes([len(frames) - 1])
    if kind == "xiph":
        for f in frames[:-1]:
            n = len(f)
            head += b"\xff" * (n // 255) + bytes([n % 255])
    elif kind == "ebml":
        head += vint(len(frames[0]))
        for a, b in zip(frames, frames[1:-1]):
            d = len(b) - len(a)
            length = 1
            while not abs(d) < (1 << (7 * length - 1)) - 1:
                length += 1
            head += vint(d + (1 << (7 * length - 1)) - 1, length)
    elif kind == "fixed":
        if len({len(f) for f in frames}) != 1:
            raise ValueError("fixed-size lacing needs frames of one size")
    else:
        raise ValueError(kind)
    return head + b"".join(frames)


_LACE_FLAG = {"xiph": 0x02, "fixed": 0x04, "ebml": 0x06}


def bitmapinfo(fourcc: bytes, w: int, h: int, extradata: bytes = b"") -> bytes:
    """A BITMAPINFOHEADER and its extradata (``V_MS/VFW/FOURCC``'s CodecPrivate)."""
    return struct.pack("<IiiHH4sIiiII", 40 + len(extradata), w, h, 1, 24, fourcc, w * h * 3,
                       0, 0, 0, 0) + extradata


def write_mkv(packets, w, h, codec_id="V_MPEG4/ISO/ASP", private=b"", keys=None, pts=None,
              scale=1_000_000, default_duration=40_000_000, duration=True, block="simple",
              lacing=None, cues="all", cues_first=False, unknown_sizes=False,
              compression=None, audio_first=False, void=False, crc32=False, cut=0,
              cluster_frames=12, doc_type="matroska", track_number=1, invisible=(),
              stray_track=None, crop=None, track_scale=None, encrypted=False,
              max_id=4, max_size=8, seek_head=True, key_flags=True,
              block_duration=None) -> bytes:
    """A Matroska file of one video track around ``packets`` (one frame
    each, in decode order).  ``pts``: each packet's timestamp in
    TimestampScale units (``scale`` ns; default a frame each 40 ms);
    ``keys``: the key frames' indices (default all); ``default_duration``
    in ns (None: no DefaultDuration); ``duration`` True writes Info's
    Duration as the end of the last frame, a number writes that, None none;
    ``block`` "simple" or "group" (BlockGroup: ReferenceBlock on every
    frame not in ``keys``, BlockDuration of one frame, or ``block_duration``
    ticks);
    ``lacing`` ("xiph", "fixed", "ebml", n): n frames a block;
    ``cues`` "all", "some" (every other key frame), None;
    ``cues_first``: Cues before the clusters; ``unknown_sizes``: the
    Segment and every Cluster of unknown size; ``compression`` ("strip",
    prefix) or ("zlib", scope) or ("algo", n); ``audio_first``: an
    ``A_PCM/INT/LIT`` track (number 1) before the video track (number 2),
    with a block of it after each video block; ``void``/``crc32``: EBMLVoid
    elements and CRC-32 first in each master element of level 1 and each
    Cluster; ``cut``: bytes cut from the end; ``cluster_frames``: frames a
    Cluster; ``invisible``: frames flagged invisible; ``stray_track``: the
    index of a frame before which a block of undeclared track 9 is
    written; ``crop`` a dict of PixelCrop* values; ``track_scale``:
    TrackTimestampScale; ``encrypted``: a ContentEncryption encoding;
    ``seek_head`` False: no SeekHead; ``key_flags`` False: SimpleBlocks
    without the key frame flag."""
    n = len(packets)
    keys = set(range(n)) if keys is None else {k for k in keys if 0 <= k < n}
    if pts is None:
        pts = [round(i * 40_000_000 / scale) for i in range(n)]
    frame_ticks = block_duration or round((default_duration or 40_000_000) / scale)
    vnum = 2 if audio_first else track_number
    stored = list(packets)
    encodings = b""
    if compression is not None:
        kind, arg = compression
        if kind == "strip":
            if not all(p.startswith(arg) for p in packets):
                raise ValueError("a packet does not start with the stripped bytes")
            stored = [p[len(arg):] for p in packets]
            comp = uint(CONTENT_COMP_ALGO, 3) + el(CONTENT_COMP_SETTINGS, arg)
            scope = 1
        elif kind == "zlib":
            stored = [zlib.compress(p, 9) for p in packets]
            comp = uint(CONTENT_COMP_ALGO, 0)
            scope = arg
            if scope & 2:
                private = zlib.compress(private, 9)
        else:
            comp = uint(CONTENT_COMP_ALGO, arg)
            scope = 1
        encodings = el(CONTENT_ENCODINGS, el(CONTENT_ENCODING, uint(CONTENT_ENCODING_SCOPE, scope)
                                             + el(CONTENT_COMPRESSION, comp)))
    if encrypted:
        encodings = el(CONTENT_ENCODINGS, el(CONTENT_ENCODING, uint(CONTENT_ENCODING_TYPE, 1)
                                             + el(CONTENT_ENCRYPTION,
                                                  uint(CONTENT_ENC_ALGO, 5)
                                                  + el(0x47E2, b"0123456789abcdef"))))
    video = uint(PIXEL_WIDTH, w) + uint(PIXEL_HEIGHT, h)
    for side, v in (crop or {}).items():
        video += uint(PIXEL_CROP[side], v)
    entry = (uint(TRACK_NUMBER, vnum) + uint(TRACK_UID, 1000 + vnum) + uint(TRACK_TYPE, 1)
             + text(CODEC_ID, codec_id))
    if default_duration:
        entry += uint(DEFAULT_DURATION, default_duration)
    if track_scale is not None:
        entry += flt(TRACK_TIMESTAMP_SCALE, track_scale)
    if private:
        entry += el(CODEC_PRIVATE, private)
    entry += el(VIDEO, video) + encodings
    tracks_body = el(TRACK_ENTRY, entry)
    audio_block = b""
    if audio_first:
        tracks_body = el(TRACK_ENTRY, uint(TRACK_NUMBER, 1) + uint(TRACK_UID, 1001)
                         + uint(TRACK_TYPE, 2) + text(CODEC_ID, "A_PCM/INT/LIT")
                         + el(AUDIO, flt(SAMPLING_FREQUENCY, 8000.0) + uint(CHANNELS, 1)
                              + uint(BIT_DEPTH, 16))) + tracks_body
        audio_block = bytes(640)  # 40 ms of 8 kHz 16-bit mono silence

    def master(i, body, unknown=False):
        if crc32:
            body = crc(body) + body
        if void:
            body = el(VOID, bytes(5)) + body
        return ebml_id(i) + (vint(UNKNOWN) if unknown else vint(len(body))) + body

    if lacing is None:
        groups = [[i] for i in range(n)]
    else:
        kind, per = lacing
        groups, i = [], 0
        while i < n:
            # a lace starts on a key frame and holds no other
            j = i + 1
            while j < n and j - i < per and j not in keys:
                j += 1
            groups.append(list(range(i, j)))
            i = j
    clusters, at = [], 0  # (first group, groups)
    while at < len(groups):
        take, frames = [], 0
        while at < len(groups) and (frames < cluster_frames or not take):
            take.append(groups[at])
            frames += len(groups[at])
            at += 1
        clusters.append(take)

    def block_bytes(g, base):
        rel = pts[g[0]] - base
        if not -32768 <= rel < 32768:
            raise ValueError("a block's relative timestamp outside 16 bits")
        flags = 0x08 if g[0] in invisible else 0
        if lacing is not None and len(g) > 1:
            flags |= _LACE_FLAG[lacing[0]]
            payload = _lace([stored[i] for i in g], lacing[0])
        else:
            payload = stored[g[0]]
        head = vint(vnum) + struct.pack(">hB", rel, flags | (
            0x80 if block == "simple" and key_flags and g[0] in keys else 0))
        if block == "simple":
            return el(SIMPLE_BLOCK, head + payload)
        body = el(BLOCK, head + payload) + uint(BLOCK_DURATION, frame_ticks * len(g))
        if g[0] not in keys:
            body += sint(REFERENCE_BLOCK, -frame_ticks)
        return el(BLOCK_GROUP, body)

    def cluster_bytes(groups_):
        base = pts[groups_[0][0]]
        body = uint(TIMESTAMP, base)
        offs = []  # (frame, offset of its block in the body)
        for g in groups_:
            if stray_track is not None and g[0] == stray_track:
                body += el(SIMPLE_BLOCK, vint(9) + struct.pack(">hB", 0, 0x80) + b"stray")
            offs.append((g[0], len(body)))
            body += block_bytes(g, base)
            if audio_first:
                body += el(SIMPLE_BLOCK, vint(1) + struct.pack(">hB", pts[g[0]] - base, 0x80)
                           + audio_block)
        pre = (len(crc(body)) if crc32 else 0) + (len(el(VOID, bytes(5))) if void else 0)
        return master(CLUSTER, body, unknown_sizes), [(f, o + pre) for f, o in offs]

    info = uint(TIMESTAMP_SCALE, scale) + text(0x4D80, "mkv_cases") + text(0x5741, "mkv_cases")
    if duration is True:
        last = max(range(n), key=lambda i: pts[i])
        info += flt(DURATION, float(pts[last] + frame_ticks))
    elif duration is not None:
        info += flt(DURATION, float(duration))
    info_el, tracks_el = master(INFO, info), master(TRACKS, tracks_body)
    built = [cluster_bytes(c) for c in clusters]
    cue_keys = sorted(keys)
    if cues == "some":
        cue_keys = cue_keys[::2]

    def cues_el(cluster_pos):
        body = b""
        for k in cue_keys if cues else ():
            c = next(ci for ci, cl in enumerate(clusters) if any(k in g for g in cl))
            rel = dict(built[c][1])[k]  # a key frame starts its lace
            body += el(CUE_POINT, uint(CUE_TIME, pts[k]) + el(CUE_TRACK_POSITIONS, uint(
                CUE_TRACK, vnum) + uint(CUE_CLUSTER_POSITION, cluster_pos[c], 8)
                + uint(CUE_RELATIVE_POSITION, rel, 4)))
        return master(CUES, body) if cues else b""

    def seek_head_el(pos):
        body = b"".join(el(SEEK, el(SEEK_ID, ebml_id(i)) + uint(SEEK_POSITION, p, 8))
                        for i, p in pos)
        return el(SEEK_HEAD, body)

    # two passes: the sizes of SeekHead and Cues do not depend on positions
    cluster_pos = [0] * len(built)
    for _ in range(2):
        cues_b = cues_el(cluster_pos)
        head_items = [(INFO, 0), (TRACKS, 0)] + ([(CUES, 0)] if cues else [])
        sh = seek_head_el(head_items) if seek_head else b""
        pos = len(sh) + (len(el(VOID, bytes(20))) if void else 0)
        info_at = pos
        pos += len(info_el)
        tracks_at = pos
        pos += len(tracks_el)
        cues_at = pos if cues_first else None
        if cues_first:
            pos += len(cues_b)
        for ci, (cb, _) in enumerate(built):
            cluster_pos[ci] = pos
            pos += len(cb)
        if not cues_first:
            cues_at = pos
    items = [(INFO, info_at), (TRACKS, tracks_at)] + ([(CUES, cues_at)] if cues else [])
    segment = (seek_head_el(items) if seek_head else b"") + (el(VOID, bytes(20)) if void else b"")
    segment += info_el + tracks_el + (cues_b if cues_first else b"")
    segment += b"".join(cb for cb, _ in built) + (b"" if cues_first else cues_b)
    out = (ebml_header(doc_type, max_id, max_size) + ebml_id(SEGMENT)
           + (vint(UNKNOWN) if unknown_sizes else vint(len(segment), 8)) + segment)
    return out[:len(out) - cut] if cut else out


# ---------------------------------------------------------------- sources

def _mp4_track(path: str):
    """(packets, CodecPrivate, keys, pts in ms) of the first track of an MP4
    the repo holds: esds's VOL headers or the avcC record, stss, and each
    sample's time from stts, ctts and the edit's media_time (a plain reading,
    independent of the port's bmff.py)."""
    import mp4_cases

    with open(path, "rb") as f:
        data = f.read()
    packets, extra, timescale, delta = mp4_cases.samples(data)
    boxes = {}
    mp4_cases._walk(data, 0, len(data), boxes)
    stbl = (b"moov", b"trak", b"mdia", b"minf", b"stbl")

    def body(*p):
        a, b = boxes[p]
        return data[a:b]

    stsd = body(*stbl, b"stsd")
    j = stsd.find(b"avcC")
    if j >= 0:
        extra = stsd[j + 4:j - 4 + struct.unpack_from(">I", stsd, j - 4)[0]]
    n = len(packets)
    keys = list(range(n))
    if (*stbl, b"stss") in boxes:
        stss = body(*stbl, b"stss")
        keys = [k - 1 for k in struct.unpack_from(f">{struct.unpack_from('>I', stss, 4)[0]}I",
                                                  stss, 8)]
    offsets = [0] * n
    if (*stbl, b"ctts") in boxes:
        ctts = body(*stbl, b"ctts")
        runs = struct.unpack_from(f">{2 * struct.unpack_from('>I', ctts, 4)[0]}i", ctts, 8)
        offsets = [off for count, off in zip(runs[::2], runs[1::2]) for _ in range(count)]
    shift = 0
    if (b"moov", b"trak", b"edts", b"elst") in boxes:
        shift = struct.unpack_from(">i", body(b"moov", b"trak", b"edts", b"elst"), 12)[0]
    pts = [(i * delta + offsets[i] - shift) * 1000 // timescale for i in range(n)]
    return packets, extra, keys, pts


def remux_mp4(path: str, **kw) -> bytes:
    """An MP4 of the repo (MPEG-4 Part 2 or H.264) remuxed to Matroska, as
    mkvmerge or ``ffmpeg -c copy`` would: the same packets, each block
    timestamped with its sample's presentation time (ctts) in ms."""
    packets, extra, keys, pts = _mp4_track(path)
    codec = "V_MPEG4/ISO/AVC" if extra[:1] == b"\x01" else "V_MPEG4/ISO/ASP"
    with open(path, "rb") as f:
        head = f.read()
    j = head.find(b"avc1" if codec.endswith("AVC") else b"mp4v")
    w, h = struct.unpack_from(">HH", head, j + 4 + 24)
    return write_mkv(packets, w, h, codec_id=codec, private=extra, keys=keys, pts=pts, **kw)


def mp4v_sources():
    """(packets, VOL headers, key frames) of tests/data/mp4v.mp4."""
    packets, extra, keys, _ = _mp4_track(os.path.join(DATA, "mp4v.mp4"))
    return packets, extra, keys


def mjpeg_packets():
    """The Motion-JPEG frames of tests/data/mjpeg.mov."""
    return _mp4_track(os.path.join(DATA, "mjpeg.mov"))[0]


def xvid_packets():
    """The chunks of tests/data/xvid.avi (the VOL headers in the first)."""
    import avi_cases

    with open(os.path.join(DATA, "xvid.avi"), "rb") as f:
        return avi_cases.chunks(f.read())


def h264_stream(name: str):
    """(packets with 4-byte lengths, Annex B packets, the avcC record, the
    Annex B parameter sets, keys, pts in ms, (h, w)) of an h264_cases
    stream: blocks in decode order, each at its display time."""
    import h264_cases

    p, units, sps, pps = h264_cases.stream(name)
    order = p["order"] or list(range(len(units)))
    keys = [k - p["cut"] for k in (p["idr"] if p["keys"] is None else p["keys"])
            if k >= p["cut"]]
    if p["order"]:
        keys = [order.index(k) for k in keys]
    return ([h264_cases.prefixed(u, 4) for u in units], [h264_cases.annexb(u) for u in units],
            h264_cases.avcc(sps, pps, 4), h264_cases.annexb([sps, pps]), keys,
            [o * 40 for o in order], p["size"])


NTSC = [round(i * 1001 / 30) for i in range(26)]  # 30000/1001 in ms: 33/34 ms steps
FILM = [round(i * 1001 / 24) for i in range(26)]  # 24000/1001 in ms

# name -> (source, write_mkv keywords).  Sources: "mp4v" (tests/data/mp4v.mp4's
# samples and VOL headers; "mp4v*2" them twice), "mjpeg" (tests/data/mjpeg.mov's frames), "xvid"
# (tests/data/xvid.avi's chunks in V_MS/VFW/FOURCC), "h264:<case>" (an
# h264_cases stream in V_MPEG4/ISO/AVC) and "vfw:<case>" (the same in
# V_MS/VFW/FOURCC, fourcc H264, Annex B, blocks at decode times).
CASES = {
    "mp4v_simple": ("mp4v", {}),
    "mp4v_group": ("mp4v", dict(block="group")),
    "mp4v_cues_first": ("mp4v", dict(cues_first=True, cues="some")),
    "mp4v_no_cues": ("mp4v", dict(cues=None, seek_head=False)),
    "mp4v_unknown": ("mp4v", dict(unknown_sizes=True)),
    "mp4v_void_crc": ("mp4v", dict(void=True, crc32=True)),
    "mp4v_strip": ("mp4v", dict(compression=("strip", b"\x00\x00\x01"))),
    "mp4v_zlib": ("mp4v", dict(compression=("zlib", 3))),
    # laces of 3 at 30000/1001: libavformat splits the block's 100 ticks 33, 33, 34
    "mp4v_xiph": ("mp4v", dict(lacing=("xiph", 3), pts=NTSC, default_duration=33366667)),
    "mp4v_ebml": ("mp4v", dict(lacing=("ebml", 4), block="group")),
    "mp4v_audio": ("mp4v", dict(audio_first=True)),
    # Duration 1017.6834 ms: 30.500002 frames at 30000/1001, 30 once
    # libavformat has truncated it to whole microseconds
    "mp4v_ntsc": ("mp4v", dict(pts=NTSC, default_duration=33366667, duration=1017.6834)),
    "mp4v_film": ("mp4v", dict(pts=FILM, default_duration=41708333)),
    # no DefaultDuration: the VOL's 25 fps wins over the 30000/1001 steps
    "mp4v_no_dd": ("mp4v", dict(pts=NTSC, default_duration=None)),
    # and with BlockDurations of 33 ms (30.3 fps): the VOL's rate makes the
    # time base reliable, so the stream probe reads no durations
    "mp4v_no_dd_group": ("mp4v", dict(pts=NTSC, default_duration=None, block="group",
                                      block_duration=33)),
    "mp4v_100us": ("mp4v", dict(scale=100_000)),
    "mp4v_stray": ("mp4v", dict(stray_track=5)),
    "mp4v_invisible": ("mp4v", dict(invisible=(3, 12, 15))),
    "mp4v_crop": ("mp4v", dict(crop=dict(left=2, top=4, right=6))),
    "mp4v_cut": ("mp4v", dict(cut=100)),
    "mp4v_webm": ("mp4v", dict(doc_type="webm")),
    # Clusters of 10 frames (key frames inside them), no Cues
    "mp4v_clusters": ("mp4v", dict(cluster_frames=10, cues=None, seek_head=False)),
    # the 26 frames twice (52, key frames 0, 12, 24, 26, 38, 50): seeks step
    # back 16 frames by timestamp
    "mp4v_long": ("mp4v*2", {}),
    "xvid_vfw": ("xvid", dict(codec_id="V_MS/VFW/FOURCC")),
    "mjpeg_simple": ("mjpeg", dict(codec_id="V_MJPEG")),
    "mjpeg_vfw": ("mjpeg", dict(codec_id="V_MS/VFW/FOURCC")),
    # laced: a block of 5 frames, the first a key frame
    "mjpeg_fixed": ("mjpeg", dict(codec_id="V_MJPEG", lacing=("fixed", 5), keys=range(0, 26, 5))),
    # no DefaultDuration and no codec rate: the rate from the timestamps
    "mjpeg_no_dd": ("mjpeg", dict(codec_id="V_MJPEG", pts=NTSC, default_duration=None)),
    "mjpeg_no_duration": ("mjpeg", dict(codec_id="V_MJPEG", duration=None)),
    "mjpeg_unknown_cut": ("mjpeg", dict(codec_id="V_MJPEG", unknown_sizes=True, cues=None,
                                        cut=700)),
    "h264_cavlc": ("h264:inter", {}),
    "h264_cabac": ("h264:cabac_slices", dict(cues="some")),
    "h264_b_pyramid": ("h264:cabac_b_pyramid", dict(compression=("strip", b"\x00\x00"))),
    "h264_high": ("h264:high_b", dict(block="group", cues_first=True)),
    "h264_open_gop": ("h264:cabac_b_open_gop", {}),
    # C10's starts: an I picture and a recovery point SEI at 0 (no IDR
    # picture); a stream cut at a P picture whose SEI names a later one, its
    # only key frame a non-IDR I picture (PPS of one reference) at 7: every
    # seek lands there, and FFmpeg shows it
    "h264_c10": ("h264:c10_b3_mp4", {}),
    "h264_c10_cut": ("h264:c10_c1_mp4", {}),
    "h264_no_dd": ("h264:full_range", dict(pts=NTSC, default_duration=None)),
    # and with BlockDurations of 33 ms: they give 30.3 fps, the VUI's 25
    # notwithstanding (Matroska prefers no codec rate)
    "h264_no_dd_group": ("h264:full_range", dict(pts=NTSC, default_duration=None, block="group",
                                                 block_duration=33)),
    "h264_vfw": ("vfw:pcm_skip", {}),
}


def _source(spec: str):
    """(packets, w, h, write_mkv keywords) of a CASES source."""
    h, w = CLIP_SIZE
    if spec in ("mp4v", "mp4v*2"):
        packets, extra, keys = mp4v_sources()
        if spec == "mp4v*2":
            keys = keys + [len(packets) + k for k in keys]
            packets = packets * 2
        return packets, w, h, dict(private=extra, keys=keys)
    if spec == "mjpeg":
        return mjpeg_packets(), w, h, dict(private=bitmapinfo(b"MJPG", w, h))
    if spec == "xvid":
        import mp4_cases

        packets = xvid_packets()
        keys = [i for i, p in enumerate(packets) if mp4_cases._is_intra(p)]
        return packets, w, h, dict(private=bitmapinfo(b"XVID", w, h), keys=keys)
    kind, name = spec.split(":")
    avc, annexb, record, params, keys, pts, (h, w) = h264_stream(name)
    if kind == "h264":
        return avc, w, h, dict(codec_id="V_MPEG4/ISO/AVC", private=record, keys=keys, pts=pts)
    return annexb, w, h, dict(codec_id="V_MS/VFW/FOURCC", private=bitmapinfo(b"H264", w, h, params),
                              keys=keys, pts=[i * 40 for i in range(len(annexb))])


def build(name: str) -> bytes:
    """The bytes of CASES / REFUSED ``name``."""
    spec, kw = CASES[name] if name in CASES else REFUSED[name][:2]
    packets, w, h, base = _source(spec)
    if base.get("private", b"")[:4] == struct.pack("<I", 40) and not kw.get(
            "codec_id", "").startswith("V_MS/VFW"):
        base.pop("private")  # a BITMAPINFOHEADER only for V_MS/VFW/FOURCC
    base.update(kw)
    if base.get("lacing", ("",))[0] == "fixed":  # fixed-size laces: pad (after the JPEG's EOI)
        top = max(len(p) for p in packets)
        packets = [p + bytes(top - len(p)) for p in packets]
    return write_mkv(packets, w, h, **base)


def codec_id(name: str) -> str:
    """The CodecID of CASES / REFUSED ``name``'s video track."""
    spec, kw = CASES[name] if name in CASES else REFUSED[name][:2]
    default = {"mp4v": "V_MPEG4/ISO/ASP", "mp4v*2": "V_MPEG4/ISO/ASP", "mjpeg": "V_MJPEG",
               "xvid": "V_MS/VFW/FOURCC",
               "h264": "V_MPEG4/ISO/AVC", "vfw": "V_MS/VFW/FOURCC"}[spec.split(":")[0]]
    return kw.get("codec_id", default)


# name -> (source, write_mkv keywords, the words the refusal names)
REFUSED = {
    "vp8": ("mp4v", dict(codec_id="V_VP8", doc_type="webm"), "V_VP8"),
    "hevc": ("mp4v", dict(codec_id="V_MPEGH/ISO/HEVC"), "V_MPEGH/ISO/HEVC"),
    "vp9": ("mp4v", dict(codec_id="V_VP9"), "V_VP9"),
    "av1": ("mp4v", dict(codec_id="V_AV1"), "V_AV1"),
    "ffv1": ("mp4v", dict(codec_id="V_FFV1"), "V_FFV1"),
    "theora": ("mp4v", dict(codec_id="V_THEORA"), "V_THEORA"),
    "mpeg1": ("mp4v", dict(codec_id="V_MPEG1"), "V_MPEG1"),
    "mpeg2": ("mp4v", dict(codec_id="V_MPEG2"), "V_MPEG2"),
    "prores": ("mp4v", dict(codec_id="V_PRORES"), "V_PRORES"),
    "uncompressed": ("mp4v", dict(codec_id="V_UNCOMPRESSED"), "V_UNCOMPRESSED"),
    "real": ("mp4v", dict(codec_id="V_REAL/RV40"), "V_REAL/RV40"),
    "quicktime": ("mp4v", dict(codec_id="V_QUICKTIME"), "V_QUICKTIME"),
    "unknown_codec": ("mp4v", dict(codec_id="V_NONSUCH"), "V_NONSUCH"),
    "vfw_div3": ("mjpeg", dict(codec_id="V_MS/VFW/FOURCC", private=bitmapinfo(b"DIV3", 100, 74)),
                 "DIV3"),
    "vfw_h264_b": ("vfw:cabac_b_pyramid", {}, "B pictures"),
    "bzlib": ("mp4v", dict(compression=("algo", 1)), "bzlib"),
    "lzo": ("mp4v", dict(compression=("algo", 2)), "LZO"),
    "encrypted": ("mp4v", dict(encrypted=True), "ContentEncryption"),
    "track_scale": ("mp4v", dict(track_scale=2.0), "TrackTimestampScale"),
    "doc_type": ("mp4v", dict(doc_type="mkvfoo"), "DocType"),
    "laced_no_duration": ("mjpeg", dict(codec_id="V_MJPEG", lacing=("ebml", 4), keys=(0, 12, 24),
                                        default_duration=None), "BlockDuration"),
}

# files cv2 5.0's FFMPEG writer wrote (tests/data), from mp4_cases'
# drift frames at 25 fps: name -> (file, fourcc)
CLIPS = {"mjpeg_mkv": ("mjpeg.mkv", "MJPG"), "mp4v_mkv": ("mp4v.mkv", "mp4v")}

# What CAP_PROP_FRAME_COUNT and CAP_PROP_FPS are without DefaultDuration,
# for Motion-JPEG (no rate of its own) blocks at these timestamps (ms; one
# at 100 us ticks): ff_rfps_calculate's standard rates, its rate from the
# steps' greatest common divisor past 15 steps, the 5 s analysis limit and
# the 40 steps it reads at 1 ms ticks.  name -> (timestamps,
# TimestampScale, count, fps)
RATES = {
    "gap_end": ([i * 40 for i in range(10)] + [760], 1_000_000, 20, 25.0),
    "steps_37": ([i * 37 for i in range(12)], 1_000_000, 12, 27.0),
    "steps_37_long": ([i * 37 for i in range(45)], 1_000_000, 45, 27.027027027027028),
    "steps_22": ([i * 22 for i in range(30)], 1_000_000, 31, 45.45454545454545),
    "steps_22_5": ([round(i * 22.5) for i in range(30)], 1_000_000, 30, 44.0),
    "steps_20_40": ([0, 40, 80, 100, 140, 180, 200, 240, 280, 300, 340], 1_000_000, 19, 50.0),
    "gap_mid": ([i * 40 for i in range(20)] + [1200 + i * 40 for i in range(20)], 1_000_000, 50,
                25.0),
    "steps_1s": ([i * 1000 for i in range(12)], 1_000_000, 11, 1.0),
    "steps_250": ([i * 250 for i in range(40)], 1_000_000, 39, 4.0),
    "ntsc_100us": ([round(i * 10010 / 30) for i in range(40)], 100_000, 40, 29.97002997002997),
    # 40 ms steps, then 20 ms from the 23rd frame: the read goes on to 40 steps
    "steps_change": ([i * 40 for i in range(22)] + [840 + 20 * j for j in range(1, 25)],
                     1_000_000, 68, 50.0),
}


def build_rate(name: str) -> bytes:
    pts, scale, _, _ = RATES[name]
    frames = mjpeg_packets()
    h, w = CLIP_SIZE
    return write_mkv([frames[i % len(frames)] for i in range(len(pts))], w, h, codec_id="V_MJPEG",
                     pts=pts, scale=scale, default_duration=None)


def clip_path(name: str) -> str:
    return os.path.join(DATA, CLIPS[name][0])


def write_clips(cv2) -> None:
    """Rewrites tests/data's Matroska clips with cv2's FFMPEG writer."""
    import mp4_cases

    frames = mp4_cases.sources("mp4v_mp4")
    h, w = frames[0].shape[:2]
    for fname, fourcc in CLIPS.values():
        wr = cv2.VideoWriter(os.path.join(DATA, fname), cv2.CAP_FFMPEG,
                             cv2.VideoWriter_fourcc(*fourcc), 25, (w, h))
        for f in frames:
            wr.write(f)
        wr.release()


def exact(name: str) -> bool:
    """Whether PINNED's frame ids of ``name`` index the frames a read from
    the start gives (H.264), rather than mp4_cases' drift frames."""
    return name in CASES and CASES[name][0].startswith(("h264", "vfw"))


def _reads(ids, count=None):
    """The reads PINNED holds for a file that shows frames ``ids`` in turn:
    every start_frame and ui seek to k (made once 2 frames were read) reads
    on from the k-th, k clamped to CAP_PROP_FRAME_COUNT ``count``."""
    ids = tuple(ids)
    after = {k: ids[min(k, len(ids) if count is None else count):][:READ_AFTER_SEEK]
             for k in SEEKS}
    return dict(order=ids, start=after, ui=dict(after))


def _open_gop_reads(n):
    """h264_cases' open-GOP reads, as FFmpeg gives them in Matroska too: a
    seek's step back lands on an I picture whose leading B picture is not
    shown, so the frames counted from there run one ahead."""
    out = _reads(range(n))
    for k in ("start", "ui"):
        out[k].update({20: (21, 22, 23), 25: (), 26: (), 40: ()})
    return out


def _cut_reads(n):
    """The reads of h264_cases' C10 case (c) in Matroska (``n`` frames
    shown from the recovery point, id 0 its frame 3): every seek to a time
    before frame 7, the I picture that is its only key frame, lands there
    and shows it (id 4) first, so a start_frame or ui seek to 1 or 3 reads
    on from id 5 and a ui seek to 0 from id 4; later targets are counted
    from the first frame shown at open, as in MP4."""
    out = _reads(range(n))
    out["start"].update({1: (5, 6, 7), 3: (5, 6, 7)})
    out["ui"].update({0: (4, 5, 6), 1: (5, 6, 7), 3: (5, 6, 7)})
    return out


def _unseekable(n):
    """The reads of a file without Duration: its frame count is negative,
    so OpenCV's seek neither grabs nor seeks (it flushes the decoder): a
    start_frame reads from the start, a ui seek on from where it is."""
    return dict(order=tuple(range(n)), start={k: (0, 1, 2) for k in SEEKS},
                ui={k: (2, 3, 4) for k in SEEKS})


# What the JAX package's reader gives for each file: frame_count and fps as
# cv2.VideoCapture reports them, the reads (avi_cases.observe: frame ids of
# mp4_cases' drift frames, or for H.264 of the frames a read from the start
# gives) and the sha256 of the frames a read from the start gives, in order
# (FFmpeg's decode and swscale's conversion, which the port's equal bit for
# bit).
PINNED = {
    "mp4v_simple": dict(count=26, fps=25.0, **_reads(range(26)),
        sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "mp4v_group": dict(count=26, fps=25.0, **_reads(range(26)),
        sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "mp4v_cues_first": dict(count=26, fps=25.0, **_reads(range(26)),
        sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "mp4v_no_cues": dict(count=26, fps=25.0, **_reads(range(26)),
        sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "mp4v_unknown": dict(count=26, fps=25.0, **_reads(range(26)),
        sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "mp4v_void_crc": dict(count=26, fps=25.0, **_reads(range(26)),
        sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "mp4v_strip": dict(count=26, fps=25.0, **_reads(range(26)),
        sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "mp4v_zlib": dict(count=26, fps=25.0, **_reads(range(26)),
        sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "mp4v_xiph": dict(count=26, fps=29.97002997002997, **_reads(range(26)),
        sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "mp4v_ebml": dict(count=26, fps=25.0, **_reads(range(26)),
        sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "mp4v_audio": dict(count=26, fps=25.0, **_reads(range(26)),
        sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "mp4v_ntsc": dict(count=30, fps=29.97002997002997, **_reads(range(26)),
        sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "mp4v_film": dict(count=26, fps=23.976023976023978, **_reads(range(26)),
        sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "mp4v_no_dd": dict(count=22, fps=25.0, **_reads(range(26), count=22),
        sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "mp4v_no_dd_group": dict(count=22, fps=25.0, **_reads(range(26), count=22),
        sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "mp4v_100us": dict(count=26, fps=25.0, **_reads(range(26)),
        sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    # frames 5-11 go with the rest of the stray block's Cluster
    "mp4v_stray": dict(count=26, fps=25.0, **_reads([*range(5), *range(12, 26)]),
        sha256="90d020513dc2037a85ad72683f9fe2f3f4085d898b64bdfea72128553954d804"),
    "mp4v_invisible": dict(count=26, fps=25.0, **_reads(range(26)),
        sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "mp4v_crop": dict(count=26, fps=25.0, **_reads(range(26)),
        sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "mp4v_cut": dict(count=26, fps=25.0, **_reads(range(25)),
        sha256="36369bd016240b408fec901e7e12549523b923bbdd719dcfa8c03be860a32cd2"),
    "mp4v_webm": dict(count=26, fps=25.0, **_reads(range(26)),
        sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "mp4v_clusters": dict(count=26, fps=25.0, **_reads(range(26)),
        sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "mp4v_long": dict(count=52, fps=25.0, **_reads([*range(26)] * 2),  # the drift frames twice
        sha256="211e3b15f25e9a1a816fc2f4ce39684f2ca77ea198e0e8c90776bc73500fb9e8"),
    "xvid_vfw": dict(count=26, fps=25.0, **_reads(range(26)),
        sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
    "mjpeg_simple": dict(count=26, fps=25.0, **_reads(range(26)),
        sha256="07e2010779f808db0b33bfb02bc68b46a951616766a89c60f0a76eb9b4978e11"),
    "mjpeg_vfw": dict(count=26, fps=25.0, **_reads(range(26)),
        sha256="07e2010779f808db0b33bfb02bc68b46a951616766a89c60f0a76eb9b4978e11"),
    "mjpeg_fixed": dict(count=26, fps=25.0, **_reads(range(26)),
        sha256="07e2010779f808db0b33bfb02bc68b46a951616766a89c60f0a76eb9b4978e11"),
    "mjpeg_no_dd": dict(count=26, fps=29.97002997002997, **_reads(range(26)),
        sha256="07e2010779f808db0b33bfb02bc68b46a951616766a89c60f0a76eb9b4978e11"),
    "mjpeg_no_duration": dict(count=-230584300921369408, fps=25.0, **_unseekable(26),
        sha256="07e2010779f808db0b33bfb02bc68b46a951616766a89c60f0a76eb9b4978e11"),
    "mjpeg_unknown_cut": dict(count=26, fps=25.0, **_reads(range(25)),
        sha256="1d5623102c19565d4eb17beb9485c228733240ee581b815cbccf4ce02d43ebc3"),
    "h264_cavlc": dict(count=26, fps=25.0, **_reads(range(26)),
        sha256="2a3ffdfd2abac89106463dc2bc993b65dbdffefb96d4cd62ec07f2e9bda803b8"),
    "h264_cabac": dict(count=12, fps=25.0, **_reads(range(12)),
        sha256="4d52bbac1505ffd7cb5126e4ef27f69c79f60ba4ae4f64c7bd003de74de5c6f3"),
    "h264_b_pyramid": dict(count=26, fps=25.0, **_reads(range(26)),
        sha256="643f8775018068d1d666b51615210434d180f690e1d3dd9d1d5a7d97d6b5d914"),
    "h264_high": dict(count=26, fps=25.0, **_reads(range(26)),
        sha256="c48530ff79c9162d8abc0d0a18efed0e5556728094af2e9c9855f4e4e3e85e76"),
    "h264_open_gop": dict(count=26, fps=25.0, **_open_gop_reads(26),
        sha256="27f158b1900ab759a43a92a97b50d2177c1817bfb0930fec2eef2c166d0fce36"),
    "h264_c10": dict(count=26, fps=25.0, **_reads(range(26)),
        sha256="4aa147ef93788ba97f07c01eba9d54090cd33f0eb33828cbc8cf330c1610d049"),
    "h264_c10_cut": dict(count=26, fps=25.0, **_cut_reads(23),
        sha256="15f05c7ce2089689ee4d1e84d7c09ad0d598b69f2363ec8d2130f7ae07a10377"),
    "h264_no_dd": dict(count=22, fps=25.0, **_reads(range(26), count=22),
        sha256="e8bf901f89dce1d4b21bd5656f91f914ad333dbc8b745977e3061f348b3449eb"),
    "h264_no_dd_group": dict(count=26, fps=30.303030303030305, **_reads(range(26)),
        sha256="e8bf901f89dce1d4b21bd5656f91f914ad333dbc8b745977e3061f348b3449eb"),
    "h264_vfw": dict(count=26, fps=25.0, **_reads(range(26)),
        sha256="4683312305719ed663ec5e2f017ec10cfd713d95b6ec84e387b7e5eecf701c1c"),}
PINNED.update({
    "mjpeg_mkv": dict(count=26, fps=25.0, **_reads(range(26)),  # mp4_cases' mjpeg_mov frames
                      sha256="07e2010779f808db0b33bfb02bc68b46a951616766a89c60f0a76eb9b4978e11"),
    "mp4v_mkv": dict(count=26, fps=25.0, **_reads(range(26)),  # mp4_cases' mp4v_mp4 frames
                     sha256="84741607830889986b4ec76bfbff2d56b6a7543d399887204eda2d4fe8a38ad6"),
})
