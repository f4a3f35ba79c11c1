"""Crafted BMP and PNM files and images to encode, for the port's image
formats (``caffe_rtpose_tpu_torch/pipeline/image_io.py``), and the results
pinned for them (numpy and ``struct`` only, so that ``chip_smoke.py`` can
load this module on a machine without OpenCV).

* DECODE: BMP layouts OpenCV's BmpDecoder reads (1-, 4- and 8-bit
  palettes, bottom-up, top-down and OS/2 headers, RLE8 and RLE4 with ends
  of line, deltas and an early end of bitmap, 16-bit 555 and 565, 32-bit
  BI_BITFIELDS with the masks after a 40-byte header and inside a V5 one)
  and PNM files (P1-P6, ASCII and binary, maxval 1 to 65535, comments).
  ``tests/test_torch_image_io.py`` pins the sha256 of ``cv2.imread``'s
  IMREAD_COLOR and IMREAD_GRAYSCALE arrays of each; ``chip_smoke.py``'s
  formats phase holds the port's reads to them.
* ENCODE: gray and colour images written as ``.bmp``, ``.pbm``, ``.pgm``,
  ``.ppm`` and ``.pnm``: the sha256 of ``cv2.imencode``'s bytes and of
  ``cv2.imdecode``'s array of them.
"""

import hashlib
import struct

import numpy as np

SIZE = (13, 21)  # (h, w) of the crafted files


def sha256(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(a if isinstance(a, bytes) else np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


# ------------------------------------------------------------------- BMP

def bmp(w, h, bpp, pixels, comp=0, palette=None, masks=None, top_down=False, core=False,
        v5_masks=None):
    """A BMP around ``pixels`` (rows as stored): BITMAPINFOHEADER, or OS/2's
    12-byte header with ``core``, or a 124-byte V5 header holding
    ``v5_masks`` (R, G, B, A); ``masks`` (R, G, B) follow a 40-byte one."""
    pal = b""
    if palette is not None:
        pal = b"".join(bytes(c) + (b"" if core else b"\0") for c in palette)
    extra = b"" if masks is None else struct.pack("<3I", *masks)
    if core:
        info = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        n = len(palette) if palette is not None else 0
        size = 40 if v5_masks is None else 124
        info = struct.pack("<IiiHHIIiiII", size, w, -h if top_down else h, 1, bpp, comp,
                           len(pixels), 2835, 2835, n, 0)
        if v5_masks is not None:
            info += struct.pack("<4I", *v5_masks) + bytes(124 - 56)
    off = 14 + len(info) + len(extra) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off) + info + extra + pal + pixels


def _packed_rows(idx, bpp):
    """Palette indices (rows as stored) packed at ``bpp``, rows padded to 4 bytes."""
    h, w = idx.shape
    pitch = ((w * bpp + 7) // 8 + 3) & ~3
    bits = np.unpackbits(idx.astype(np.uint8)[..., None], axis=-1)[..., 8 - bpp:].reshape(h, -1)
    rows = np.packbits(bits, axis=1)
    return np.pad(rows, ((0, 0), (0, pitch - rows.shape[1]))).tobytes()


def _rle8(idx):
    """RLE8: runs of three or more as encoded runs, the rest in absolute runs
    of up to 7 (or single encoded pixels), an end of line after each row and
    an end of bitmap."""
    out = bytearray()
    for r in idx.tolist():
        x, w = 0, len(r)
        while x < w:
            n = 1
            while x + n < w and r[x + n] == r[x] and n < 255:
                n += 1
            if n >= 3 or w - x < 3:
                out += bytes([n, r[x]])
                x += n
                continue
            m = min(w - x, 7)
            out += bytes([0, m] + r[x:x + m] + [0] * (m & 1))
            x += m
        out += b"\0\0"
    return bytes(out + b"\0\1")


def _rle4(idx):
    """RLE4: runs of alternating pairs of four or more encoded, the rest in
    absolute runs of up to 6, an end of line after each row, end of bitmap."""
    out = bytearray()
    for r in idx.tolist():
        x, w = 0, len(r)
        while x < w:
            n = 1
            if x + 1 < w:
                n = 2
                while x + n < w and r[x + n] == r[x + (n & 1)] and n < 255:
                    n += 1
            if n >= 4 or w - x < 4:
                out += bytes([n, (r[x] << 4) | (r[x + 1] if x + 1 < w else 0)])
                x += n
                continue
            m = min(w - x, 6)
            nib = r[x:x + m] + [0] * (m & 1)
            data = bytes((nib[i] << 4) | nib[i + 1] for i in range(0, len(nib), 2))
            out += bytes([0, m]) + data + bytes((((m + 1) >> 1) + 1 & ~1) - len(data))
            x += m
        out += b"\0\0"
    return bytes(out + b"\0\1")


def bmp_files():
    """name -> BMP bytes, each layout of DECODE's BMP part."""
    rs = np.random.RandomState(1)
    h, w = SIZE
    out = {}
    for bpp in (1, 4, 8):
        pal = rs.randint(0, 256, (1 << bpp, 3)).tolist()
        idx = rs.randint(0, 1 << bpp, (h, w))
        out[f"pal{bpp}"] = bmp(w, h, bpp, _packed_rows(idx[::-1], bpp), palette=pal)
        out[f"pal{bpp}_top_down"] = bmp(w, h, bpp, _packed_rows(idx, bpp), palette=pal,
                                        top_down=True)
        out[f"pal{bpp}_os2"] = bmp(w, h, bpp, _packed_rows(idx[::-1], bpp), palette=pal,
                                   core=True)
    out["pal8_short_palette"] = bmp(w, h, 8, _packed_rows(rs.randint(0, 120, (h, w)), 8),
                                    palette=rs.randint(0, 256, (100, 3)).tolist())
    idx = np.repeat(rs.randint(0, 16, (h, 5)), 5, axis=1)[:, :w]
    idx[::3, 2:9] = rs.randint(0, 16, (len(idx[::3]), 7))
    pal16, pal256 = rs.randint(0, 256, (16, 3)).tolist(), rs.randint(0, 256, (256, 3)).tolist()
    out["rle8"] = bmp(w, h, 8, _rle8(idx[::-1]), comp=1, palette=pal256)
    out["rle8_early_end"] = bmp(w, h, 8, _rle8(idx[::-1][:5]), comp=1, palette=pal256)
    out["rle4"] = bmp(w, h, 4, _rle4(idx[::-1]), comp=2, palette=pal16)
    # RLE4's end of bitmap fills only its line: the data ends first
    out["rle4_early_end"] = bmp(w, h, 4, _rle4(idx[::-1][:5]), comp=2, palette=pal16)
    # a full row, a delta of (3, 2), 5 pixels, runs that end their lines,
    # an absolute run, a run, the end of the bitmap: RLE8 fills what the
    # delta skips with index 0; RLE4 skips only the delta's columns
    hd, wd = 9, 12
    out["rle8_delta"] = bmp(wd, hd, 8, bytes([12, 7, 0, 0, 0, 2, 3, 2, 5, 9, 0, 0, 12, 4, 0, 0,
                                              0, 4, 1, 2, 3, 4, 6, 200, 0, 0, 0, 1]),
                            comp=1, palette=pal256)
    out["rle4_delta"] = bmp(wd, hd, 4, bytes([12, 0x7A, 0, 0, 0, 2, 3, 2, 9, 0x9C, 0, 0]
                                             + [12, 0x41, 0, 0] * 8 + [0, 1]),
                            comp=2, palette=pal16)
    t = rs.randint(0, 1 << 16, (h, w)).astype("<u2")
    raw = np.pad(t[::-1].view(np.uint8).reshape(h, 2 * w), ((0, 0), (0, 2))).tobytes()
    out["555"] = bmp(w, h, 16, raw)
    out["555_bitfields"] = bmp(w, h, 16, raw, comp=3, masks=(0x7C00, 0x3E0, 0x1F))
    out["565_bitfields"] = bmp(w, h, 16, raw, comp=3, masks=(0xF800, 0x7E0, 0x1F))
    px = rs.randint(0, 256, (h, w, 4)).astype(np.uint8)
    out["32_bitfields"] = bmp(w, h, 32, px[::-1].tobytes(), comp=3,
                              masks=(0xFF0000, 0xFF00, 0xFF))
    out["32_v5_rgba"] = bmp(w, h, 32, px[::-1].tobytes(), comp=3,
                            v5_masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000))
    out["24_os2"] = bmp(w, h, 24, np.pad(px[::-1, :, :3].reshape(h, 3 * w),
                                         ((0, 0), (0, 1))).tobytes(), core=True)
    return out


# ------------------------------------------------------------------- PNM

def pnm(kind, w, h, maxval, vals, comment=False):
    """P``kind`` bytes of the samples ``vals``: ASCII rows (digits packed
    without spaces for P1 with a comment), or binary (16-bit big-endian
    above maxval 255)."""
    head = b"P%d\n" % kind + (b"# a comment 12 34\n" if comment else b"") + b"%d %d\n" % (w, h)
    if kind not in (1, 4):
        head += b"%d\n" % maxval
    vals = np.asarray(vals)
    if kind == 1 and comment:
        body = b"".join(b"%d" % v for v in vals.ravel())
    elif kind in (1, 2, 3):
        body = b"\n".join(b" ".join(b"%d" % v for v in row) for row in vals.reshape(h, -1)) + b"\n"
    elif kind == 4:
        body = np.packbits(vals.reshape(h, w).astype(np.uint8), axis=1).tobytes()
    else:
        body = vals.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    return head + body


def pnm_files():
    """name -> PNM bytes: each kind at each maxval, ASCII samples up to a
    quarter over maxval (clipped), binary ones anywhere in their bytes."""
    rs = np.random.RandomState(2)
    h, w = SIZE
    out = {}
    for kind in range(1, 7):
        cn = 3 if kind in (3, 6) else 1
        for maxval in ((1,) if kind in (1, 4) else (15, 255, 1000, 65535)):
            for comment in (False, True):
                top = maxval + 1 + (maxval // 4 if kind in (2, 3) else 0)
                if kind in (5, 6) and maxval <= 255:
                    top = 256
                vals = rs.randint(0, top, h * w * cn)
                out[f"p{kind}_{maxval}{'_comment' if comment else ''}"] = pnm(
                    kind, w, h, maxval, vals, comment)
    return out


def decode_files():
    return {**{f"bmp_{k}": v for k, v in bmp_files().items()},
            **{f"pnm_{k}": v for k, v in pnm_files().items()}}


# ---------------------------------------------------------------- encode

ENCODE_EXTS = (".bmp", ".pbm", ".pgm", ".ppm", ".pnm")


def encode_images():
    """name -> an image to encode (gray, one-channel, colour; odd widths;
    zeros for PBM's black)."""
    rs = np.random.RandomState(3)
    out = {}
    for name, shape in (("gray", (7, 11)), ("gray_c1", (9, 13, 1)), ("gray_w16", (5, 16)),
                        ("bgr", (7, 11, 3)), ("bgr_w4", (6, 4, 3))):
        img = rs.randint(0, 256, shape).astype(np.uint8)
        img.reshape(-1)[::3] = 0
        out[name] = img
    return out


def encode_cases():
    """(image name, extension) pairs cv2.imencode writes: BMP of any image,
    PBM and PGM of one channel, PPM of three, PNM of either."""
    out = []
    for name, img in encode_images().items():
        gray = img.ndim == 2 or img.shape[2] == 1
        for ext in ENCODE_EXTS:
            if ext in (".pbm", ".pgm") and not gray or ext == ".ppm" and gray:
                continue
            out.append((name, ext))
    return out


# What cv2 gives: for each DECODE file the sha256 of cv2.imread's
# IMREAD_COLOR and IMREAD_GRAYSCALE arrays (None where it reads nothing);
# for each ENCODE case the sha256 of cv2.imencode's bytes and of
# cv2.imdecode's array of them (IMREAD_GRAYSCALE for one channel).
PINNED = {
    'bmp_pal1': (
        'c86aedb87e2f66dc863bbaa330c1119ebdc3bd86ba980effb24111543d9cf5c0',
        'ce1248103d10e22810d36c43bb40b806347873464a3209814184dfa834ed4737'),
    'bmp_pal1_top_down': (
        'c86aedb87e2f66dc863bbaa330c1119ebdc3bd86ba980effb24111543d9cf5c0',
        'ce1248103d10e22810d36c43bb40b806347873464a3209814184dfa834ed4737'),
    'bmp_pal1_os2': (
        'c86aedb87e2f66dc863bbaa330c1119ebdc3bd86ba980effb24111543d9cf5c0',
        'ce1248103d10e22810d36c43bb40b806347873464a3209814184dfa834ed4737'),
    'bmp_pal4': (
        'c98366885ce221f597387217acc58facf911820a974b40edc596b66e53dd7f65',
        '71848294a656a4d89ca3c6e375a3c3b80fa6884a22901b775f94aea6985b0e62'),
    'bmp_pal4_top_down': (
        'c98366885ce221f597387217acc58facf911820a974b40edc596b66e53dd7f65',
        '71848294a656a4d89ca3c6e375a3c3b80fa6884a22901b775f94aea6985b0e62'),
    'bmp_pal4_os2': (
        'c98366885ce221f597387217acc58facf911820a974b40edc596b66e53dd7f65',
        '71848294a656a4d89ca3c6e375a3c3b80fa6884a22901b775f94aea6985b0e62'),
    'bmp_pal8': (
        'bcca8bd4889eab89283a56549e6338f450b753302f4c5bd6958e4cdd33cdd019',
        'd7dc87439a9bc9b789502eb969c1c84a98cf1a7ec52e3dfbf7fdcfd3e5876714'),
    'bmp_pal8_top_down': (
        'bcca8bd4889eab89283a56549e6338f450b753302f4c5bd6958e4cdd33cdd019',
        'd7dc87439a9bc9b789502eb969c1c84a98cf1a7ec52e3dfbf7fdcfd3e5876714'),
    'bmp_pal8_os2': (
        'bcca8bd4889eab89283a56549e6338f450b753302f4c5bd6958e4cdd33cdd019',
        'd7dc87439a9bc9b789502eb969c1c84a98cf1a7ec52e3dfbf7fdcfd3e5876714'),
    'bmp_pal8_short_palette': (
        '6b2edf0af052fde848c82e8b5ca50fafc7a6b818ec075a2b61e17edbbb09c7c1',
        '4885ff7ca2e602e544593d41caceae123e4cb53fbd233e34148fe70005da879f'),
    'bmp_rle8': (
        '9e088fc8911b5b03c23464bdcfcd527c8b5bb08d1f226a635d39a789bcb2e5d1',
        '58beb2718232c89531ee32b7362ec594d21101604d18f80cf4f7e140669a2f55'),
    'bmp_rle8_early_end': (
        'b5f192eea0ae9d25c58cd91d37c5e87b1e22009ee34d5adc2d8ba700656f59d1',
        'bade180b00dcb861cc0e2a75c81784a80cdb6cc0729d3ec33072bcb3c0f39e03'),
    'bmp_rle4': (
        'ee5040293744019c79a35a003e0603fb1bb5fe5684816a37488ad2bbd28b0ed7',
        '81afce449e5233e673f1c4263aa3ea77a3473b4adc611f5a51e03988d3ce4a31'),
    'bmp_rle4_early_end': (
        None,
        None),
    'bmp_rle8_delta': (
        'd63dc84bcda854ad8dfb783069a3272dc7b2f2bf90a9bc9e3a59562fa8290330',
        '52804a0fd85d3473dad9473795770dec36b112907c0cd284e4948758c02a0bcc'),
    'bmp_rle4_delta': (
        '73bd65ed32ee9916ecce71fd47131a6c23722c8421bd97c422140b1251938962',
        '5d9c1ccfdd98628a359f6a8241d93a486ce69592eafe15907fdaff44ce9cba05'),
    'bmp_555': (
        '775e8eaea0416457f5b162b737d0dbfe915e33b4b8df935e148304ac364ee74c',
        '212dfe205b97779931e28c1e9b77383226dc19a06f8e89fe2da631bdfa501917'),
    'bmp_555_bitfields': (
        '775e8eaea0416457f5b162b737d0dbfe915e33b4b8df935e148304ac364ee74c',
        '212dfe205b97779931e28c1e9b77383226dc19a06f8e89fe2da631bdfa501917'),
    'bmp_565_bitfields': (
        '0ffaab6e5cd556400ac441d6ac0c0f6bce9f45ab1f5439d50ee3f9c04012a8bb',
        '3e82c79cf15c2f742cd177f061175e813b84819c23c0939425d03e089abcceca'),
    'bmp_32_bitfields': (
        'd8a80839d4f73717e4b2b69684d2208601a90af165f36d94a4ae8303f2d5d89b',
        'b5e24aec911d32769601301c2c1989585063e8249d09116d74d3fb0be4d2ebe4'),
    'bmp_32_v5_rgba': (
        '24d819b90f6c8097b150789fd34493e61454477fb913e6f344360c9280162661',
        '12f7dcab8edcd7bd7b20c398bedd735be066490078eda3022283df83496de626'),
    'bmp_24_os2': (
        'd8a80839d4f73717e4b2b69684d2208601a90af165f36d94a4ae8303f2d5d89b',
        'b5e24aec911d32769601301c2c1989585063e8249d09116d74d3fb0be4d2ebe4'),
    'pnm_p1_1': (
        'ef480e305322ebe92519de8d709ab37f5ea04966f9ad519aa00144727b9c5440',
        '33a8fb81da76a2ba6f5503f57a16369691f116b434cd246bb09cc56f543a1e35'),
    'pnm_p1_1_comment': (
        '744298a544f377162c025021dbf6eb232ee7798f05963c67fb904224acb737eb',
        '48c7ea692b2a73b8b11630dc971cd867620a30cd280624dbe94b6b310a139442'),
    'pnm_p2_15': (
        '7ba5597cc0c08fc8c65712a60c18fb7396658e2cb0aad857bcf3a361473ce984',
        '172dcbaa82cc2207d7f6195159594036fbb058cfaea74ae03f25ef155ee57cf4'),
    'pnm_p2_15_comment': (
        '2b01b30681b578c13bcd57aa64118a72255b11fef92785077ed18951efb7fb1a',
        'c35efd9e88fe0fc3cb226d3150ac6584a5790afb463e924e4d49d06d10d2e5c1'),
    'pnm_p2_255': (
        '83c998181d67e1dcdfafcc9519ba5a5af7635c2b2fcdd5f41b26d17aeea87500',
        '0e62ff14a394951c4dd3f5414624661969f906b7ce3b500f0c1c339fa7abbc58'),
    'pnm_p2_255_comment': (
        '5fc7766e73a9a66435ddad02b2db6ddba4ca143da5d1a9003f3c548eff23f486',
        '06901c8427aefa64b2f86f98f9bf1e341e780fc0078da76e1fcbf02443acc58c'),
    'pnm_p2_1000': (
        'cc40f46115885cfbd8a5f038e5656b4add61318d92d7d9e491d09e6c3892a7c9',
        'b2ba88743c7ebf08984fad6d2c283bd5a42d16f5c74d993589f7861b23aa411c'),
    'pnm_p2_1000_comment': (
        '09481a6f5c6da59fba6e5d3d32fa06281e1bfb6a82ac4a551a20682bafc698b1',
        'd038180130c91f0948bea7567487622c57ece615a12ed5e876fe07d1df948a45'),
    'pnm_p2_65535': (
        'f701bf0fcdf08fc073096f14b6c7b45fc808d3d111b21d79bb258e347317a7d1',
        '90bac2ffe3b1d5066a86b3a4bdeb56bdef5507eb986908f2c95bb9fa47f6b61a'),
    'pnm_p2_65535_comment': (
        '8fc0a2773ea79ee14998a737f21df7e19843789a42bcd65c5b0a012efdbbc024',
        '7c14b2acfb03c0d1fabf66a4e3932219f3dfb61826f5011e4250e79a6464a182'),
    'pnm_p3_15': (
        '7d37704e5dcb869e2b9000b9bdf54aa68f44e3489bf67472a3d0e309e26e9e7f',
        '5ce59d6866b4f06f33d3b76eb408b4068e4e2f27a4fdd25fb62f329494602643'),
    'pnm_p3_15_comment': (
        'b775514e6e8d35d0cd5781c788ee196d569d857e994d40a4bfc0c59c8fb484b3',
        '71f546ae923c532a945e01fe56698bfda8c1d99b400e3785a685a5b197258c19'),
    'pnm_p3_255': (
        'f1d018df105d34dfdb4ec40a93dfad787ee8b43024e87acd84075fca45e78a7b',
        '6545612c6c16b2b66631681446c256628b4c61a8123cba4bbf3aaa04d1727750'),
    'pnm_p3_255_comment': (
        '22f5c3fee1e9c24fa257de2fc5f1e61cbee781734d6a5154ab34084c0b06a331',
        '491745a6fb6361f94ace00f791cc423babe2f7b1c266deb3dfcdfb291a55e768'),
    'pnm_p3_1000': (
        '163046521247011e3d0aea9bb36eba6b00e0bddcfd1cc1a1b5ce946ccc389aaf',
        'fa5d5b90604b7d53cb3fc96a01bda8eea1c7885292159e4fcc163a565561ed99'),
    'pnm_p3_1000_comment': (
        'd799870fbb6d0eb2931f307c34ec203f22c635bbc58758422800e87b7982d77a',
        '3de6c65ee542619a3dab5d0a7f5192e4000ed89381e7825638f936b56a6ff053'),
    'pnm_p3_65535': (
        'a4429bd02beee604b8ee8f179084def85cd6a6157ee486da867e24ac48d84203',
        'c27bf98d2ab953c72d093f71779f3b5d7ab7569a092472adf60fe6e14dc45391'),
    'pnm_p3_65535_comment': (
        'c5d568c7d992974c13dd5b168149227fb9211085a6adf0641541a77ef0789a3e',
        '4384aa754851a5632613be7b74b9603395f2c4f7e23ef219e42bcd562e3dabe1'),
    'pnm_p4_1': (
        'e01876bfc66d9e78481fc92f0ae1cc30285cd098f535f5779f3bb4acb84c8797',
        'baf104b40fc6063e8959447127f9ae5c81de0406c1a2af2172057c78d86ef3a5'),
    'pnm_p4_1_comment': (
        'cb3178ee7e6061fc7925ed4e032de1e999270047b28d7fc314642f72d9ed0885',
        'f2a0d6a1ed0f7ab35c15020886fcb17173363673d97bf05d2ad3ae07a53987fb'),
    'pnm_p5_15': (
        '2e7d0ea99d0177fc7981e7a1c595b7701a1ff0b03cfd91c03b7f62772c777805',
        'd039500db1053db7e0e13f1d1149e87913cf97586bca7d08dfb277663da37999'),
    'pnm_p5_15_comment': (
        'cac5df7a62d37d9346ceb000d3643243e724f33e7338d1cb0fed8575b9f16c77',
        '78b958ae0843b787ad3911e55e35be10a408f54d3229db3ab9a739ff9b475e23'),
    'pnm_p5_255': (
        '229c9bbffb1af3f69a7a5ad2d45cbdc45cdb78f4eaab96dcdd4324db3a27a3bc',
        '904b3e6ea574a1d02b1ad6f315bc0e90107ef67b2a2f9828b7ee9b8f9a70c3ab'),
    'pnm_p5_255_comment': (
        '27b907293a922e61a24eb8e3960ddf122b3e4c396927b569756212700bc81659',
        '0f58e6a9798d737c49519c4d3412f88dda150d8ad564adff03dabbd89d95eb5e'),
    'pnm_p5_1000': (
        '099fc8a3b0661b9d775cbc1f9e348a8b10fab5ab5f4bbc2bd3f6dd86e60de169',
        '0a5ae2dc94338f387c547969890588164cf5e440151955ab3f8af73709bbf037'),
    'pnm_p5_1000_comment': (
        'c1a5bc24d6f51e0475a7cf99e3c4ccf370409f523fb00e64af0da8cf4b2ce5ab',
        'a01dfbbdcf9643af5ecac74911c5307bb3b478485c6c58c42f36c0b22c0063a0'),
    'pnm_p5_65535': (
        '89351c052addb93cdbc3c2f3d334bcd692ec210c5e22d2544d432e1f8814cd13',
        '3e7c1b20aafc96daeaefa8bbaee24a6fb3c9a4d4e407bd2c10c7f548b1f013e4'),
    'pnm_p5_65535_comment': (
        'ea14c3ad8c91d861eb2496e0ff36db0601781825f51b6e3789d5cedc1e1e97aa',
        'a52b8591424ba460d9e6da1e727ffd12d14d5d4c304e7c02132b934e7ca1bb7c'),
    'pnm_p6_15': (
        '1e1110caa0e09fd19decb998e4c56ff4cf295aa780ede72892ac83dee35aad1d',
        '6b29672b0f1946446b0668db4aaa8f11c0bd80046772d1d88fb2a8e0a6d77045'),
    'pnm_p6_15_comment': (
        'f384fe75f15de7119f0a0b99fab5a9cde0f47563be5930fd22ae0d7f67c09622',
        'bcfb0b392d8bdd4538fc74d5e88c64a8abed74d3bc0a1e928285c958079ca3d6'),
    'pnm_p6_255': (
        '440809b152c80a75ad6ebd5939f627294c02d920b942c5ade628497e05ec50de',
        'd5dd83608dace8cf64c49ca01320c8a77929ed3280283968a8be8801478fca6f'),
    'pnm_p6_255_comment': (
        '86d07ddc84d294c5cc68d4f16ff4643996b3081c386071a81b1943567d0273da',
        '0a800e4408b4c98251e9f24d9c04c98a58a46e84e0d4036ba0020c5ff712a2c1'),
    'pnm_p6_1000': (
        '403e769395b30540fd96ef5fb2e3825a99b6dcdfbd86a73977cb0481ea24f31c',
        'd6c40ad088bbc8fa1a21f53318b1738a7f853af0b5eee57b325fe0b6233cf2ec'),
    'pnm_p6_1000_comment': (
        '3d36f6eef6f8e6aef80cca490dc1aabb3eaf3a0ef58920d6e2a9de6c27070b4c',
        '4473ab46ec14a498b2a1045e99989505d15259152c86a5fd165fa1c2f51271c0'),
    'pnm_p6_65535': (
        '7bb1b0f5ab4dee1ada2a6ef0bab9e004880013407e49fa445b595722ad359d49',
        '2909360d3129882065c880aec13189ce1251ad21d844b74010e01447b50aceb1'),
    'pnm_p6_65535_comment': (
        '1446d9ac24a3d3193cf9af61018a630a2073318269bc157392abfa11352e12db',
        '4d1d222f5a47e667007f365347780319d6660af168304aa9c10a29444801cd07'),
    'gray.bmp': (
        '325c320859f573053be2ee46c6b4507446a0bb23f852955d5630f74e6f9b81e6',
        '1bf00b583e796d598980c22e07488e80e45d059b5b5ac8a9364f2155a15d2e16'),
    'gray.pbm': (
        '3f3f05c18f2cdf90c45f9c998edbe5171f302989816b1aa6d9c10c403efa471a',
        'a9221eb15108fb39aeae043afcb4c35c5f531c7b10e194d8c4cce6f788605bc5'),
    'gray.pgm': (
        '84f0caeabb17efe361da2332dd0dcf63e976ccf145b965f87f110c338bfcd64e',
        '1bf00b583e796d598980c22e07488e80e45d059b5b5ac8a9364f2155a15d2e16'),
    'gray.pnm': (
        '84f0caeabb17efe361da2332dd0dcf63e976ccf145b965f87f110c338bfcd64e',
        '1bf00b583e796d598980c22e07488e80e45d059b5b5ac8a9364f2155a15d2e16'),
    'gray_c1.bmp': (
        '9caeb4df654b4bd3dd4245505616d43f422fc88790ce50ef16cc1cd648ada2da',
        'b934622e7634d8d889ed27335cfda37bf724afc10c62620a17d15b9f908815e0'),
    'gray_c1.pbm': (
        '5d8a3e1dac533e46bda2c355ecdef0f1aef46b2617f73c21f7633fdf1960bf7f',
        'ec86836f531f3b594f5be19cbd257befcd29c1f3534a0fbb81692bce0c995b67'),
    'gray_c1.pgm': (
        'e6b805a55a874d6937673c19481f6b3e033c00c2cff2927019f79ee0d6eaba75',
        'b934622e7634d8d889ed27335cfda37bf724afc10c62620a17d15b9f908815e0'),
    'gray_c1.pnm': (
        'e6b805a55a874d6937673c19481f6b3e033c00c2cff2927019f79ee0d6eaba75',
        'b934622e7634d8d889ed27335cfda37bf724afc10c62620a17d15b9f908815e0'),
    'gray_w16.bmp': (
        'a6ab89d822c21e390a89aa05fb1b9196fd6da73e56078543f954deca3fd9e5db',
        'eea349aeba52b6b32dc524ac80a86a8b15a91b140aaeae149059a0148111b4c5'),
    'gray_w16.pbm': (
        'e6b29016f2d2c8ce7c74abb74254d481a3e737781374b7541e171d987b86e951',
        '21297e9a113e20eb1dffe5fe2ff7a4ab55a949e3227738a160e8d93895683e7b'),
    'gray_w16.pgm': (
        '0ec4f40760b0fd56e02fc22eb47b2b71cbda11732cd15cacf009872388abbd40',
        'eea349aeba52b6b32dc524ac80a86a8b15a91b140aaeae149059a0148111b4c5'),
    'gray_w16.pnm': (
        '0ec4f40760b0fd56e02fc22eb47b2b71cbda11732cd15cacf009872388abbd40',
        'eea349aeba52b6b32dc524ac80a86a8b15a91b140aaeae149059a0148111b4c5'),
    'bgr.bmp': (
        'ddd42c32245cdfbe0af5ec046fd930ed147ff67309f32d43e4c1a7e2c0ba16c9',
        '85ab9bb9032c679465529aeb76b64c3bd485344d433ef6f0f2f3bee0e049f0ad'),
    'bgr.ppm': (
        '38cbf47beafa99e72dd2f0718fc653e268bf532fc45136cd4d0685f0f57e3e1f',
        '85ab9bb9032c679465529aeb76b64c3bd485344d433ef6f0f2f3bee0e049f0ad'),
    'bgr.pnm': (
        '38cbf47beafa99e72dd2f0718fc653e268bf532fc45136cd4d0685f0f57e3e1f',
        '85ab9bb9032c679465529aeb76b64c3bd485344d433ef6f0f2f3bee0e049f0ad'),
    'bgr_w4.bmp': (
        '79b02e7d6afb2f036965ec63915186eeb7d03617d9773094f422dce12239068e',
        'ac49106be0d4ad1438277eb6c237b54e5ab83799675977b622d606a93c9f5f98'),
    'bgr_w4.ppm': (
        'c6496e303fb6ce071f4113c935975f97bf4cd1493bc9cfdcc7ced84f38deb6e6',
        'ac49106be0d4ad1438277eb6c237b54e5ab83799675977b622d606a93c9f5f98'),
    'bgr_w4.pnm': (
        'c6496e303fb6ce071f4113c935975f97bf4cd1493bc9cfdcc7ced84f38deb6e6',
        'ac49106be0d4ad1438277eb6c237b54e5ab83799675977b622d606a93c9f5f98'),
}
