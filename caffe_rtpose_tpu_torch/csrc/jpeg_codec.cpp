// Host JPEG codec: decodes and encodes with libjpeg-turbo's integer
// arithmetic, as OpenCV's imread/imdecode/imencode call it.
//
// Decoder: baseline, extended-Huffman and progressive 8-bit files, restart
// intervals, any integral sampling ratio; jpeg_idct_islow, the fancy
// (triangle) upsamplers with their biases and edge replication, jdcolor's
// fixed-point tables, written as BGR (OpenCV's JCS_EXT_BGR) or as the gray
// plane OpenCV's IMREAD_GRAYSCALE asks for.  4-component files come out as
// libjpeg's CMYK and are converted as OpenCV converts them.  The EXIF
// orientation is parsed here and applied by the caller.  A progressive
// file whose low AC coefficients are not all known exactly (a truncated
// file, read as imread reads it) is smoothed as jdcoefct.c smooths it.
// Where a corrupt table sends coefficients out of 16 bits, the pixels are
// libjpeg-turbo's C code's; its SIMD IDCT, which OpenCV runs, wraps there.
//
// Motion-JPEG mode (crt_mjpeg_*): the same parse and entropy decode, then
// what FFmpeg's mjpeg decoder and swscale do for OpenCV's VideoCapture: the
// DC predictor dequantized and started at the level shift (4 << 8), DC
// clipped to int16, each restart interval read from its own data, FFmpeg's
// simple IDCT into planes that outlive the frame (a cut scan leaves the
// frame before's pixels), and swscale's YUV -> BGR24 (ffmpeg_dsp.h) for
// 4:2:0 and 4:2:2 of even height, 4:4:4 and gray; other layouts take the
// libjpeg arithmetic above.
//
// Encoder: what jpeg_set_defaults + jpeg_set_quality(q, TRUE) write for a
// BGR (4:2:0) or gray image: JFIF APP0, the Annex K quantization and
// Huffman tables, jccolor, h2v2_downsample, jpeg_fdct_islow and the
// reciprocal quantizer.
//
// The C interface (crt_jpeg_*) returns 0 on success, else writes a message
// into `err`.  Built with g++ -O2 -std=c++17 -shared -fPIC; no dependency
// beyond the C++ standard library.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

#include "ffmpeg_dsp.h"

namespace {

struct JpegError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError(msg); }

// Zigzag position -> natural (row-major) index, with 16 guard entries for a
// run that overshoots the block, as jpeg_natural_order has.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------- tables

// jdcolor.c / jccolor.c fixed point (SCALEBITS 16).
constexpr int kScaleBits = 16;
constexpr int64_t kOneHalf = int64_t(1) << (kScaleBits - 1);
constexpr int64_t fix(double x) { return int64_t(x * (1L << kScaleBits) + 0.5); }

struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  int64_t rgb_y[3 * 256];    // jdcolor build_rgb_y_table
  int64_t rgb_ycc[8 * 256];  // jccolor rgb_ycc_start
  ColorTables() {
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = int((fix(1.40200) * x + kOneHalf) >> kScaleBits);
      cb_b[i] = int((fix(1.77200) * x + kOneHalf) >> kScaleBits);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kOneHalf;
    }
    for (int i = 0; i < 256; i++) {
      rgb_y[i] = fix(0.29900) * i;
      rgb_y[i + 256] = fix(0.58700) * i;
      rgb_y[i + 512] = fix(0.11400) * i + kOneHalf;
      const int64_t cbcr_offset = int64_t(128) << kScaleBits;
      rgb_ycc[i] = fix(0.29900) * i;
      rgb_ycc[i + 256] = fix(0.58700) * i;
      rgb_ycc[i + 2 * 256] = fix(0.11400) * i + kOneHalf;
      rgb_ycc[i + 3 * 256] = -fix(0.16874) * i;
      rgb_ycc[i + 4 * 256] = -fix(0.33126) * i;
      rgb_ycc[i + 5 * 256] = fix(0.50000) * i + cbcr_offset + kOneHalf - 1;  // B->Cb, R->Cr
      rgb_ycc[i + 6 * 256] = -fix(0.41869) * i;
      rgb_ycc[i + 7 * 256] = -fix(0.08131) * i;
    }
  }
};

const ColorTables& tables() {
  static const ColorTables t;
  return t;
}

inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

// jdmaster.c prepare_range_limit_table, the post-IDCT part: index
// (x & 1023) of a centered sample x.
struct IdctRangeLimit {
  uint8_t t[1024];
  IdctRangeLimit() {
    for (int i = 0; i < 1024; i++) {
      if (i < 128) t[i] = uint8_t(i + 128);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = uint8_t(i - 896);
    }
  }
};

const IdctRangeLimit& idct_limit() {
  static const IdctRangeLimit t;
  return t;
}

// jstdhuff.c
const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// ---------------------------------------------------------------- IDCT

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// jidctint.c jpeg_idct_islow: one dequantized block -> 8x8 samples.
void idct_islow(const int16_t* coef, const int16_t* quant, uint8_t* out, int stride) {
  const uint8_t* limit = idct_limit().t;
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const int16_t* q = quant + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 && in[48] == 0 &&
        in[56] == 0) {
      int dc = int(int64_t(int(in[0]) * int(q[0])) * (1 << kPass1Bits));
      for (int r = 0; r < 8; r++) ws[r * 8 + c] = dc;
      continue;
    }
    int64_t z2 = int64_t(in[16]) * q[16], z3 = int64_t(in[48]) * q[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(in[0]) * q[0];
    z3 = int64_t(in[32]) * q[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(in[56]) * q[56];
    tmp1 = int64_t(in[40]) * q[40];
    tmp2 = int64_t(in[24]) * q[24];
    tmp3 = int64_t(in[8]) * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    ws[0 * 8 + c] = int(descale(tmp10 + tmp3, sh));
    ws[7 * 8 + c] = int(descale(tmp10 - tmp3, sh));
    ws[1 * 8 + c] = int(descale(tmp11 + tmp2, sh));
    ws[6 * 8 + c] = int(descale(tmp11 - tmp2, sh));
    ws[2 * 8 + c] = int(descale(tmp12 + tmp1, sh));
    ws[5 * 8 + c] = int(descale(tmp12 - tmp1, sh));
    ws[3 * 8 + c] = int(descale(tmp13 + tmp0, sh));
    ws[4 * 8 + c] = int(descale(tmp13 - tmp0, sh));
  }
  for (int r = 0; r < 8; r++) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 && w[7] == 0) {
      uint8_t v = limit[int(descale(w[0], kPass1Bits + 3)) & 1023];
      for (int i = 0; i < 8; i++) o[i] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits + kPass1Bits + 3;
    o[0] = limit[int(descale(tmp10 + tmp3, sh)) & 1023];
    o[7] = limit[int(descale(tmp10 - tmp3, sh)) & 1023];
    o[1] = limit[int(descale(tmp11 + tmp2, sh)) & 1023];
    o[6] = limit[int(descale(tmp11 - tmp2, sh)) & 1023];
    o[2] = limit[int(descale(tmp12 + tmp1, sh)) & 1023];
    o[5] = limit[int(descale(tmp12 - tmp1, sh)) & 1023];
    o[3] = limit[int(descale(tmp13 + tmp0, sh)) & 1023];
    o[4] = limit[int(descale(tmp13 - tmp0, sh)) & 1023];
  }
}

// ---------------------------------------------------------------- Huffman decode

struct HuffTable {
  bool defined = false;
  bool dc_ok = false;  // every symbol a DC size (0-15), as jdhuff.c demands of a DC table
  uint8_t look_len[256];  // 0: the code is longer than 8 bits
  uint8_t look_sym[256];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
};

// jdhuff.c jpeg_make_d_derived_tbl.
void build_huff(HuffTable& t, const uint8_t bits[17], const uint8_t* vals, int nvals) {
  int huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < bits[l]; i++) huffsize[p++] = l;
  huffsize[p] = 0;
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (uint32_t(1) << si)) fail("bad Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (bits[l]) {
      t.valoffset[l] = p - int32_t(huffcode[p]);
      p += bits[l];
      t.maxcode[l] = int32_t(huffcode[p - 1]);
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.valoffset[17] = 0;
  t.maxcode[17] = 0xFFFFF;
  std::memset(t.look_len, 0, sizeof t.look_len);
  std::memset(t.look_sym, 0, sizeof t.look_sym);
  p = 0;
  for (int l = 1; l <= 8; l++) {
    for (int i = 1; i <= bits[l]; i++, p++) {
      int look = int(huffcode[p]) << (8 - l);
      for (int c = 1 << (8 - l); c > 0; c--, look++) {
        t.look_len[look] = uint8_t(l);
        t.look_sym[look] = vals[p];
      }
    }
  }
  std::memset(t.vals, 0, sizeof t.vals);
  std::memcpy(t.vals, vals, size_t(nvals));
  t.dc_ok = std::all_of(vals, vals + nvals, [](uint8_t v) { return v <= 15; });
  t.defined = true;
}

// Entropy-coded data: FF00 is a data FF, FF fill bytes are skipped, any
// other marker (or the end of the data) stops the reader, and zero bits
// follow.  `short_data` is libjpeg's insufficient_data: a bit past the
// stop was consumed.
struct BitReader {
  const uint8_t* d;
  size_t n, pos;
  uint64_t acc = 0;
  int cnt = 0, zeros = 0;
  bool stopped = false, at_end = false, short_data = false;
  bool ff_tail = false;  // FFmpeg's unescaping: FF bytes that end the data are one data byte
  int marker = 0;

  BitReader(const uint8_t* data, size_t size, size_t start) : d(data), n(size), pos(start) {}

  void fill() {
    while (cnt <= 56) {
      if (stopped) {
        acc <<= 8;
        cnt += 8;
        zeros += 8;
        continue;
      }
      if (pos >= n) {
        stopped = at_end = true;
        continue;
      }
      uint8_t b = d[pos];
      if (b == 0xFF) {
        size_t q = pos + 1;
        while (q < n && d[q] == 0xFF) q++;
        if (q >= n) {
          pos = n;
          if (ff_tail) {
            acc = (acc << 8) | b;
            cnt += 8;
          }
          stopped = at_end = true;
          continue;
        }
        if (d[q] != 0) {
          marker = d[q];
          pos = q + 1;
          stopped = true;
          continue;
        }
        pos = q + 1;
      } else {
        pos++;
      }
      acc = (acc << 8) | b;
      cnt += 8;
    }
  }
  inline int peek(int k) {
    if (cnt < k) fill();
    return int((acc >> (cnt - k)) & ((uint64_t(1) << k) - 1));
  }
  inline void skip(int k) {
    cnt -= k;
    if (cnt < zeros) {
      short_data = true;
      zeros = cnt;
    }
  }
  inline int get(int k) {
    if (k == 0) return 0;
    int v = peek(k);
    skip(k);
    return v;
  }
  // The next marker after the entropy data: the one that stopped the
  // reader, else the first one at or after `pos` (garbage skipped).
  // Returns -1 at the end of the data; `pos` ends after the marker code.
  int take_marker() {
    acc = 0;
    cnt = zeros = 0;
    if (stopped) {
      stopped = false;
      if (at_end) return -1;
      return marker;
    }
    while (pos < n) {
      if (d[pos] != 0xFF) {
        pos++;
        continue;
      }
      size_t q = pos + 1;
      while (q < n && d[q] == 0xFF) q++;
      if (q >= n) break;
      if (d[q] == 0) {
        pos = q + 1;
        continue;
      }
      pos = q + 1;
      return d[q];
    }
    pos = n;
    return -1;
  }
};

inline int decode_huff(BitReader& br, const HuffTable& t) {
  int look = br.peek(8);
  int l = t.look_len[look];
  if (l) {
    br.skip(l);
    return t.look_sym[look];
  }
  // jdhuff.c jpeg_huff_decode from 9 bits on
  int code = br.get(9);
  l = 9;
  while (code > t.maxcode[l]) {
    code = (code << 1) | br.get(1);
    l++;
  }
  if (l > 16) return 0;  // a corrupt code: libjpeg warns and returns 0
  return t.vals[(code + t.valoffset[l]) & 0xFF];
}

inline int extend(int x, int s) { return x < (1 << (s - 1)) ? x + (-(1 << s) + 1) : x; }

// ---------------------------------------------------------------- decoder

enum ColorSpace { CS_GRAY, CS_YCBCR, CS_RGB, CS_CMYK, CS_YCCK };

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int16_t quant[64];
  bool quant_latched = false;
  int width = 0, height = 0;    // downsampled size (libjpeg's downsampled_width/height)
  int wblocks = 0, hblocks = 0;  // width/height_in_blocks
  int bw = 0, bh = 0;            // allocated block grid (padded to whole MCUs)
  std::vector<int16_t> coef;     // bh * bw blocks of 64, natural order
  std::vector<uint8_t> done;     // FFmpeg's mode: a block (its DC, when progressive) was decoded
  int16_t* block(int by, int bx) { return coef.data() + (size_t(by) * bw + bx) * 64; }
  // progressive status (jdphuff.c coef_bits): the Al each coefficient was
  // last coded at, -1 before any scan; and its value before the last scan
  int bits[64], prev_bits[64];
  Component() {
    std::fill(bits, bits + 64, -1);
    std::fill(prev_bits, prev_bits + 64, 0);
  }
};

struct Decoder {
  const uint8_t* d;
  size_t n;

  int width = 0, height = 0, precision = 8;
  bool progressive = false, have_frame = false;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  int orientation = 1;
  bool saw_app1 = false;
  int scans = 0;
  int last_good_row = 0;  // jdmaster.h last_good_iMCU_row: last begun with data left
  std::vector<uint8_t> with_eoi;
  // FFmpeg's mjpeg decoder (crt_mjpeg_decode, for ffmpeg_layout()'s layouts)
  bool ff = false, ff_ended = false, cs_itu601 = false;

  // `file`: read as imread's stdio source does, else as imdecode's buffer
  // (whose end is an error)
  Decoder(const uint8_t* data, size_t size, bool file) : d(data), n(size) {
    if (file) {
      // jdatasrc.c fill_input_buffer: past the end of a file libjpeg reads
      // a fake EOI, FF D9, again and again; enough of them for any one
      // segment (at most 65535 bytes) to end inside them
      with_eoi.assign(data, data + size);
      for (int i = 0; i < 32770; i++) {
        with_eoi.push_back(0xFF);
        with_eoi.push_back(0xD9);
      }
      d = with_eoi.data();
      n = with_eoi.size();
    }
  }

  uint16_t u16(size_t p) const { return uint16_t((d[p] << 8) | d[p + 1]); }

  void truncated_error() const {
    fail("premature end of the JPEG data");
  }

  // The segment that starts at `p` (after its marker): its payload range.
  size_t segment(size_t p, size_t* payload) const {
    if (p + 2 > n) truncated_error();
    size_t len = u16(p);
    if (len < 2) fail("bad JPEG marker length");
    if (p + len > n) truncated_error();
    *payload = p + 2;
    return p + len;
  }

  void parse_exif(const uint8_t* s, size_t len) {
    // OpenCV's ExifReader: the TIFF header 6 bytes into the first APP1.
    if (len <= 6) return;
    s += 6;
    len -= 6;
    if (len < 8) return;
    bool le;
    if (s[0] == 'I' && s[1] == 'I') le = true;
    else if (s[0] == 'M' && s[1] == 'M') le = false;
    else return;
    auto r16 = [&](size_t o) -> uint32_t {
      return le ? uint32_t(s[o] | (s[o + 1] << 8)) : uint32_t((s[o] << 8) | s[o + 1]);
    };
    auto r32 = [&](size_t o) -> uint32_t {
      return le ? (uint32_t(s[o]) | (uint32_t(s[o + 1]) << 8) | (uint32_t(s[o + 2]) << 16) |
                   (uint32_t(s[o + 3]) << 24))
                : ((uint32_t(s[o]) << 24) | (uint32_t(s[o + 1]) << 16) |
                   (uint32_t(s[o + 2]) << 8) | uint32_t(s[o + 3]));
    };
    size_t ifd = r32(4);
    if (ifd + 2 > len) return;
    size_t count = r16(ifd);
    for (size_t i = 0; i < count; i++) {
      size_t e = ifd + 2 + 12 * i;
      if (e + 12 > len) return;
      if (r16(e) == 0x0112) {
        orientation = int(r16(e + 8));
        return;
      }
    }
  }

  void read_sof(size_t p, size_t end, int marker) {
    if (have_frame) fail("more than one frame header");
    if (end - p < 6) fail("bad SOF marker");
    precision = d[p];
    height = u16(p + 1);
    width = u16(p + 3);
    int nc = d[p + 5];
    if (precision != 8) fail("JPEG of " + std::to_string(precision) + "-bit samples; 8-bit is supported");
    if (width <= 0 || height <= 0) fail("JPEG of empty size (or a DNL marker)");
    // OpenCV's validateInputImageSize (CV_IO_MAX_IMAGE_PIXELS) refuses these
    if (int64_t(width) * height > (int64_t(1) << 30)) fail("JPEG of more than 2^30 pixels");
    if (nc != 1 && nc != 3 && nc != 4) fail("JPEG of " + std::to_string(nc) + " components");
    if (end - p != size_t(6 + 3 * nc)) fail("bad SOF marker");
    progressive = marker == 0xC2;
    comps.resize(nc);
    for (int i = 0; i < nc; i++) {
      Component& c = comps[i];
      c.id = d[p + 6 + 3 * i];
      c.h = d[p + 7 + 3 * i] >> 4;
      c.v = d[p + 7 + 3 * i] & 15;
      c.tq = d[p + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail("bad component in SOF");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (Component& c : comps) {
      c.width = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.height = int((int64_t(height) * c.v + vmax - 1) / vmax);
      c.wblocks = (c.width + 7) / 8;
      c.hblocks = (c.height + 7) / 8;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
    }
    have_frame = true;
  }

  void read_dqt(size_t p, size_t end) {
    while (p < end) {
      int pq = d[p] >> 4, tq = d[p] & 15;
      p++;
      if (tq > 3 || pq > 1) fail("bad DQT marker");
      if (p + (pq ? 128 : 64) > end) fail("bad DQT marker");
      for (int i = 0; i < 64; i++) {
        qt[tq][kNatural[i]] = pq ? u16(p + 2 * i) : d[p + i];
      }
      p += pq ? 128 : 64;
      qt_defined[tq] = true;
    }
  }

  void read_dht(size_t p, size_t end) {
    while (p < end) {
      if (p + 17 > end) fail("bad DHT marker");
      int tc = d[p] >> 4, th = d[p] & 15;
      if (tc > 1 || th > 3) fail("bad DHT marker");
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int i = 1; i <= 16; i++) {
        bits[i] = d[p + i];
        count += bits[i];
      }
      p += 17;
      if (count > 256 || p + count > end) fail("bad DHT marker");
      build_huff(tc ? ac[th] : dc[th], bits, d + p, count);
      p += count;
    }
  }

  ColorSpace color_space() const {
    // jdapimin.c default_decompress_parms
    if (comps.size() == 1) return CS_GRAY;
    if (comps.size() == 3) {
      if (saw_jfif) return CS_YCBCR;
      if (saw_adobe) return adobe_transform == 0 ? CS_RGB : CS_YCBCR;
      if (comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66) return CS_RGB;
      return CS_YCBCR;
    }
    if (saw_adobe) return adobe_transform == 0 ? CS_CMYK : CS_YCCK;
    return CS_CMYK;
  }

  // Reads markers up to the first SOS (header only), or the whole file.
  void run(bool header_only) {
    // OpenCV picks its JPEG decoder by the signature FF D8 FF
    if (n < 3 || d[0] != 0xFF || d[1] != 0xD8 || d[2] != 0xFF) fail("not a JPEG file (no SOI marker)");
    size_t p = 2;
    for (;;) {
      // next_marker: skip garbage, then FF fill bytes
      while (p < n && d[p] != 0xFF) p++;
      while (p < n && d[p] == 0xFF) p++;
      if (p >= n) truncated_error();
      int m = d[p++];
      if (m == 0) continue;  // a stuffed zero: still garbage (jdmarker.c next_marker)
      if (m == 0xD9) {
        if (scans == 0) fail("JPEG without image data");
        return;
      }
      if (m == 0xD8) fail("two SOI markers");
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      // jdmarker.c read_markers: any marker it does not name is an error
      if (m < 0xC0 || (m > 0xDD && m < 0xE0) || (m > 0xEF && m != 0xFE))
        fail("unknown JPEG marker " + std::to_string(m));
      // APPn, COM and DNL skip what their length covers, nothing when it
      // is under 2; every other segment's length must hold
      bool skipped = (m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC;
      size_t pay, end;
      if (skipped && p + 2 <= n && u16(p) < 2) {
        pay = end = p + 2;
      } else {
        end = segment(p, &pay);
      }
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2:
          read_sof(pay, end, m);
          break;
        case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xC8:
          fail("lossless or hierarchical JPEG is not supported");
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          fail("arithmetic-coded JPEG is not supported");
        case 0xC4:
          read_dht(pay, end);
          break;
        case 0xDB:
          read_dqt(pay, end);
          break;
        case 0xDD:
          if (end - pay != 2) fail("bad DRI marker");
          restart_interval = u16(pay);
          break;
        case 0xE0:
          if (end - pay >= 14 && std::memcmp(d + pay, "JFIF\0", 5) == 0) saw_jfif = true;
          break;
        case 0xE1:
          if (!saw_app1) {
            saw_app1 = true;
            parse_exif(d + pay, end - pay);
          }
          break;
        case 0xFE:
          // mjpegdec.c mjpeg_decode_com: this comment marks limited range
          if (end - pay == 9 && std::memcmp(d + pay, "CS=ITU601", 9) == 0) cs_itu601 = true;
          break;
        case 0xEE:
          if (end - pay >= 12 && std::memcmp(d + pay, "Adobe", 5) == 0) {
            saw_adobe = true;
            adobe_transform = d[pay + 11];
          }
          break;
        case 0xDA: {
          if (!have_frame) fail("SOS before the frame header");
          if (header_only) return;
          if (scans == 0) {
            for (Component& c : comps) {
              c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
              if (ff) c.done.assign(size_t(c.bw) * c.bh, 0);
            }
          }
          p = scan(pay, end);
          scans++;
          if (ff_ended) return;
          // jdinput.c: a sequential first scan of every component is the
          // whole image, and OpenCV keeps it whatever follows (libjpeg's
          // errors on the way to EOI come after its last row)
          if (scans == 1 && !progressive && d[pay] == int(comps.size())) return;
          continue;
        }
        default:
          break;  // APPn, COM, DNL and the rest are skipped
      }
      p = end;
    }
  }

  // One scan; returns the position of the marker that ends it (its FF).
  size_t scan(size_t p, size_t end) {
    if (end - p < 1) fail("bad SOS marker");
    int ns = d[p];
    if (ns < 1 || ns > 4 || end - p != size_t(4 + 2 * ns)) fail("bad SOS marker");
    std::vector<int> sc(ns), td(ns), ta(ns);
    for (int i = 0; i < ns; i++) {
      // jdmarker.c get_sos: the first frame component of that id whose
      // index is no scan slot filled before this one; libjpeg-turbo also
      // refuses a component named twice
      int id = d[p + 1 + 2 * i];
      int k = -1;
      for (int c = i; c < int(comps.size()) && k < 0; c++)
        if (comps[c].id == id) k = c;
      if (k < 0 || std::find(sc.begin(), sc.begin() + i, k) != sc.begin() + i)
        fail("SOS names an unknown component");
      sc[i] = k;
      td[i] = d[p + 2 + 2 * i] >> 4;
      ta[i] = d[p + 2 + 2 * i] & 15;
    }
    int ss = d[p + 1 + 2 * ns], se = d[p + 2 + 2 * ns];
    int ah = d[p + 3 + 2 * ns] >> 4, al = d[p + 3 + 2 * ns] & 15;
    if (!progressive) {
      ss = 0;
      se = 63;
      ah = al = 0;
    } else {
      // jdphuff.c start_pass_phuff_decoder
      bool dc_scan = ss == 0;
      if (dc_scan ? se != 0 : (se < ss || se > 63 || ns != 1)) fail("bad progressive scan");
      if ((ah != 0 && al != ah - 1) || al > 13) fail("bad progressive scan");
    }
    if (progressive) {
      // jdphuff.c start_pass_phuff_decoder: the progression status
      for (int i = 0; i < ns; i++) {
        Component& c = comps[sc[i]];
        for (int k = std::min(ss, 1); k <= std::max(se, 9); k++)
          c.prev_bits[k] = scans > 0 ? c.bits[k] : 0;
        for (int k = ss; k <= se; k++) c.bits[k] = al;
      }
    }
    // jdinput.c latch_quant_tables: a component's table as of its first scan
    for (int i = 0; i < ns; i++) {
      Component& c = comps[sc[i]];
      if (c.quant_latched) continue;
      if (!qt_defined[c.tq]) fail("JPEG quantization table missing");
      for (int k = 0; k < 64; k++) c.quant[k] = int16_t(qt[c.tq][k]);
      c.quant_latched = true;
    }
    bool refine = ah != 0;
    for (int i = 0; i < ns; i++) {
      bool need_dc = ss == 0 && !refine, need_ac = se > 0;
      // a table number is checked only where the scan uses it (jdphuff.c)
      if ((need_dc && td[i] > 3) || (need_ac && ta[i] > 3)) fail("JPEG Huffman table missing");
      // jdhuff.c jinit_huff_decoder: in a sequential file a missing table 0
      // or 1 is the standard one (Motion-JPEG); jdphuff.c has no such rule
      if (!progressive && td[i] < 2 && !dc[td[i]].defined)
        build_huff(dc[td[i]], td[i] ? kDcChromBits : kDcLumBits, kDcVals, 12);
      if (!progressive && ta[i] < 2 && !ac[ta[i]].defined)
        build_huff(ac[ta[i]], ta[i] ? kAcChromBits : kAcLumBits, ta[i] ? kAcChromVals : kAcLumVals, 162);
      if ((need_dc && !dc[td[i]].defined) || (need_ac && !ac[ta[i]].defined))
        fail("JPEG Huffman table missing");
      if (need_dc && !dc[td[i]].dc_ok) fail("bad Huffman table (a DC symbol over 15)");
    }

    BitReader br(d, n, end);
    br.ff_tail = ff;
    // FFmpeg's sequential DC predictor is dequantized and starts at the
    // level shift, 4 << 8, at each scan and restart
    const int dc0 = ff && !progressive ? 1024 : 0;
    int pred[4] = {dc0, dc0, dc0, dc0};
    int eobrun = 0;
    int next_rst = 0;
    // the scan's MCUs: one block of one component, or every component's h x v
    int mcus_x, mcus_y;
    if (ns == 1) {
      mcus_x = comps[sc[0]].wblocks;
      mcus_y = comps[sc[0]].hblocks;
    } else {
      mcus_x = mcux;
      mcus_y = mcuy;
    }
    int64_t total = int64_t(mcus_x) * mcus_y;
    // the iMCU row of an MCU row: v block rows of a lone component
    auto imcu_row = [&](int64_t m) { return int(m / mcus_x) / (ns == 1 ? comps[sc[0]].v : 1); };
    for (int64_t m = 0; m < total; m++) {
      // jdcoefct.c: an iMCU row begun with no data missing is good
      if ((m == 0 || imcu_row(m) != imcu_row(m - 1)) && !br.short_data) last_good_row = imcu_row(m);
      if (restart_interval && m > 0 && m % restart_interval == 0 && ff) {
        // mjpegdec.c reads each restart interval from the data up to the
        // next marker, any RSTn, and past the end of the data from an empty
        // buffer: its first MCU decodes from zero bits
        int mk = br.take_marker();
        if (mk < 0xD0 || mk > 0xD7) {
          br.stopped = true;
          br.at_end = mk < 0;
          br.marker = mk;
        }
        br.short_data = false;
        pred[0] = pred[1] = pred[2] = pred[3] = dc0;
        eobrun = 0;
      }
      if (restart_interval && m > 0 && m % restart_interval == 0 && !ff) {
        // jdhuff.c process_restart, jdmarker.c read_restart_marker
        int mk = br.take_marker();
        const int want = 0xD0 + next_rst;
        auto rst = [&](int k) { return 0xD0 + ((next_rst + k) & 7); };
        // jdmarker.c jpeg_resync_to_restart, when it is not the RSTn expected
        while (mk >= 0 && mk != want) {
          if (mk < 0xC0 || mk == rst(-1) || mk == rst(-2)) {
            mk = br.take_marker();  // skipped: on to the next marker
          } else if (mk < 0xD0 || mk > 0xD7 || mk == rst(1) || mk == rst(2)) {
            break;  // left for later: zero bits follow
          } else {
            mk = want;  // a restart too far away: discarded, reading resumes
          }
        }
        if (mk == want) {
          br.short_data = false;
        } else {
          br.stopped = true;
          br.at_end = mk < 0;
          br.marker = mk;
        }
        next_rst = (next_rst + 1) & 7;
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
        eobrun = 0;
      }
      // mjpegdec.c: an MCU begun past the end of the data ends the scan,
      // and the blocks not reached keep what the frame buffer held
      if (ff && br.short_data) {
        ff_ended = true;
        break;
      }
      if (br.short_data) {
        if (br.at_end) truncated_error();
        continue;  // libjpeg leaves the rest of the segment's blocks as they are
      }
      int my = int(m / mcus_x), mx = int(m % mcus_x);
      for (int i = 0; i < ns; i++) {
        Component& c = comps[sc[i]];
        int bh = ns == 1 ? 1 : c.v, bwid = ns == 1 ? 1 : c.h;
        for (int yy = 0; yy < bh; yy++) {
          for (int xx = 0; xx < bwid; xx++) {
            int by = ns == 1 ? my : my * c.v + yy;
            int bx = ns == 1 ? mx : mx * c.h + xx;
            int16_t* blk = c.block(by, bx);
            if (ff) c.done[size_t(by) * c.bw + bx] |= !progressive || (ss == 0 && !refine);
            if (!progressive) {
              decode_block(br, blk, dc[td[i]], ac[ta[i]], pred[i], ff ? c.quant[0] : 0);
            } else if (ss == 0) {
              if (!refine) {
                int s = decode_huff(br, dc[td[i]]);
                if (s) s = extend(br.get(s), s);
                pred[i] += s;
                blk[0] = int16_t(uint32_t(pred[i]) << al);
              } else if (br.get(1)) {
                blk[0] = int16_t(blk[0] | (1 << al));
              }
            } else if (!refine) {
              ac_first(br, blk, ac[ta[i]], ss, se, al, eobrun);
            } else {
              ac_refine(br, blk, ac[ta[i]], ss, se, al, eobrun);
            }
          }
        }
      }
    }
    if (ff && (ff_ended || br.short_data || br.take_marker() < 0)) {
      ff_ended = true;  // no marker follows: FFmpeg emulates the EOI
      return n;
    }
    if (ff) return br.pos - 2;
    if (br.short_data && br.at_end) truncated_error();
    // back up to the marker that ends the scan
    if (br.take_marker() < 0) truncated_error();
    return br.pos - 2;
  }

  // ff_q0: 0 for libjpeg's quantized DC; else FFmpeg's, dequantized by
  // this DC quantizer and clipped to int16 (mjpegdec.c decode_block)
  static void decode_block(BitReader& br, int16_t* blk, const HuffTable& dct, const HuffTable& act,
                           int& pred, int ff_q0) {
    int s = decode_huff(br, dct);
    if (s) s = extend(br.get(s), s);
    pred = ff_q0 ? std::min(std::max(pred + s * ff_q0, -32768), 32767) : pred + s;
    blk[0] = int16_t(pred);
    for (int k = 1; k < 64; k++) {
      int rs = decode_huff(br, act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  static void ac_first(BitReader& br, int16_t* blk, const HuffTable& t, int ss, int se, int al,
                       int& eobrun) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    for (int k = ss; k <= se; k++) {
      int rs = decode_huff(br, t);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(uint32_t(extend(br.get(s), s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        eobrun--;
        break;
      }
    }
  }

  // jdphuff.c decode_mcu_AC_refine
  static void ac_refine(BitReader& br, int16_t* blk, const HuffTable& t, int ss, int se, int al,
                        int& eobrun) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = decode_huff(br, t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br.get(1)) {
              if ((*coef & p1) == 0) *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
            }
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) {
          if (br.get(1)) {
            if ((*coef & p1) == 0) *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
          }
        }
      }
      eobrun--;
    }
  }

  // IDCT of one component into a (bh*8) x (bw*8) plane.
  std::vector<uint8_t> plane(Component& c) {
    if (!c.quant_latched) {
      // a component no scan named: libjpeg never latched its table; its
      // blocks are zero and dequantize to the flat mid-gray
      for (int k = 0; k < 64; k++) c.quant[k] = int16_t(qt_defined[c.tq] ? qt[c.tq][k] : 1);
    }
    int stride = c.bw * 8;
    std::vector<uint8_t> out(size_t(stride) * c.bh * 8);
    const bool smooth = smoothing_ok();
    int16_t ws[64];
    for (int by = 0; by < c.hblocks; by++)
      for (int bx = 0; bx < c.wblocks; bx++) {
        const int16_t* blk = c.block(by, bx);
        if (smooth) {
          std::memcpy(ws, blk, sizeof ws);
          smooth_block(c, by, bx, ws);
          blk = ws;
        }
        idct_islow(blk, c.quant, out.data() + size_t(by) * 8 * stride + bx * 8, stride);
      }
    return out;
  }

  // jdcoefct.c smoothing_ok: a progressive file whose every component has
  // its table latched, nonzero at the smoothed positions, and some DC data,
  // and some of whose first nine AC coefficients are not known exactly
  bool smoothing_ok() const {
    if (!progressive) return false;
    bool useful = false;
    for (const Component& c : comps) {
      if (!c.quant_latched) return false;
      for (int pos : {0, 1, 8, 16, 9, 2, 3, 10, 17, 24})
        if (c.quant[pos] == 0) return false;
      if (c.bits[0] < 0) return false;
      for (int k = 1; k < 10; k++) useful = useful || c.bits[k] != 0;
    }
    return useful;
  }

  // jdcoefct.c decompress_smooth_data for one block: the first nine AC
  // coefficients that are still zero and not known exactly are estimated
  // from the DC values of the block and its 24 neighbours, and with no AC
  // data at all the DC too.
  void smooth_block(Component& c, int by, int bx, int16_t* ws) const {
    // the status latched at output; past the last good iMCU row, the one
    // before the last scan
    const int r = by / c.v;
    int bits[10];
    for (int k = 0; k < 10; k++)
      bits[k] = r <= last_good_row ? c.bits[k] : scans > 1 ? c.prev_bits[k] : -1;
    // the neighbouring block rows, as libjpeg picks them
    int block_rows = c.v;
    if (r == mcuy - 1) {
      block_rows = c.hblocks % c.v;
      if (block_rows == 0) block_rows = c.v;
    }
    const int ibr = r * block_rows + by % c.v, ibrs = block_rows * mcuy;
    const int prev = ibr > 0 ? by - 1 : by, next = ibr < ibrs - 1 ? by + 1 : by;
    const int rows[5] = {ibr > 1 ? by - 2 : prev, prev, by, next, ibr < ibrs - 2 ? by + 2 : next};
    int64_t DC[26];
    for (int i = 0; i < 5; i++)
      for (int j = 0; j < 5; j++)
        DC[1 + 5 * i + j] = c.block(rows[i], std::min(std::max(bx + j - 2, 0), c.wblocks - 1))[0];
    bool change_dc = true;
    for (int k = 1; k < 10; k++) change_dc = change_dc && bits[k] == -1;
    const int64_t Q00 = c.quant[0];
    auto put = [&](int pos, int al, int64_t num) {
      const int64_t q = c.quant[pos];
      int pred = int(((q << 7) + (num >= 0 ? num : -num)) / (q << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      ws[pos] = int16_t(num >= 0 ? pred : -pred);
    };
    if (bits[1] != 0 && ws[1] == 0)  // AC01
      put(1, bits[1], Q00 * (change_dc ?
          (-DC[1] - DC[2] + DC[4] + DC[5] - 3 * DC[6] + 13 * DC[7] - 13 * DC[9] + 3 * DC[10] -
           3 * DC[11] + 38 * DC[12] - 38 * DC[14] + 3 * DC[15] - 3 * DC[16] + 13 * DC[17] -
           13 * DC[19] + 3 * DC[20] - DC[21] - DC[22] + DC[24] + DC[25]) :
          (-7 * DC[11] + 50 * DC[12] - 50 * DC[14] + 7 * DC[15])));
    if (bits[2] != 0 && ws[8] == 0)  // AC10
      put(8, bits[2], Q00 * (change_dc ?
          (-DC[1] - 3 * DC[2] - 3 * DC[3] - 3 * DC[4] - DC[5] - DC[6] + 13 * DC[7] + 38 * DC[8] +
           13 * DC[9] - DC[10] + DC[16] - 13 * DC[17] - 38 * DC[18] - 13 * DC[19] + DC[20] +
           DC[21] + 3 * DC[22] + 3 * DC[23] + 3 * DC[24] + DC[25]) :
          (-7 * DC[3] + 50 * DC[8] - 50 * DC[18] + 7 * DC[23])));
    if (bits[3] != 0 && ws[16] == 0)  // AC20
      put(16, bits[3], Q00 * (change_dc ?
          (DC[3] + 2 * DC[7] + 7 * DC[8] + 2 * DC[9] - 5 * DC[12] - 14 * DC[13] - 5 * DC[14] +
           2 * DC[17] + 7 * DC[18] + 2 * DC[19] + DC[23]) :
          (-DC[3] + 13 * DC[8] - 24 * DC[13] + 13 * DC[18] - DC[23])));
    if (bits[4] != 0 && ws[9] == 0)  // AC11
      put(9, bits[4], Q00 * (change_dc ?
          (-DC[1] + DC[5] + 9 * DC[7] - 9 * DC[9] - 9 * DC[17] + 9 * DC[19] + DC[21] - DC[25]) :
          (DC[10] + DC[16] - 10 * DC[17] + 10 * DC[19] - DC[2] - DC[20] + DC[22] - DC[24] +
           DC[4] - DC[6] + 10 * DC[7] - 10 * DC[9])));
    if (bits[5] != 0 && ws[2] == 0)  // AC02
      put(2, bits[5], Q00 * (change_dc ?
          (2 * DC[7] - 5 * DC[8] + 2 * DC[9] + DC[11] + 7 * DC[12] - 14 * DC[13] + 7 * DC[14] +
           DC[15] + 2 * DC[17] - 5 * DC[18] + 2 * DC[19]) :
          (-DC[11] + 13 * DC[12] - 24 * DC[13] + 13 * DC[14] - DC[15])));
    if (!change_dc) return;
    if (bits[6] != 0 && ws[3] == 0)  // AC03
      put(3, bits[6], Q00 * (DC[7] - DC[9] + 2 * DC[12] - 2 * DC[14] + DC[17] - DC[19]));
    if (bits[7] != 0 && ws[10] == 0)  // AC12
      put(10, bits[7], Q00 * (DC[7] - 3 * DC[8] + DC[9] - DC[17] + 3 * DC[18] - DC[19]));
    if (bits[8] != 0 && ws[17] == 0)  // AC21
      put(17, bits[8], Q00 * (DC[7] - DC[9] - 3 * DC[12] + 3 * DC[14] + DC[17] - DC[19]));
    if (bits[9] != 0 && ws[24] == 0)  // AC30
      put(24, bits[9], Q00 * (DC[7] + 2 * DC[8] + DC[9] - DC[17] - 2 * DC[18] - DC[19]));
    // the DC itself, a weighted mean of the 25 (weights summing to 256)
    put(0, 0, Q00 * (-2 * DC[1] - 6 * DC[2] - 8 * DC[3] - 6 * DC[4] - 2 * DC[5] - 6 * DC[6] +
                     6 * DC[7] + 42 * DC[8] + 6 * DC[9] - 6 * DC[10] - 8 * DC[11] +
                     42 * DC[12] + 152 * DC[13] + 42 * DC[14] - 8 * DC[15] - 6 * DC[16] +
                     6 * DC[17] + 42 * DC[18] + 6 * DC[19] - 6 * DC[20] - 2 * DC[21] -
                     6 * DC[22] - 8 * DC[23] - 6 * DC[24] - 2 * DC[25]));
  }

  // jdsample.c: the component at full size (width x height).
  std::vector<uint8_t> upsample(Component& c) {
    std::vector<uint8_t> src = plane(c);
    const int stride = c.bw * 8, dw = c.width, dh = c.height;
    std::vector<uint8_t> out(size_t(width) * height);
    auto in = [&](int y, int x) { return int(src[size_t(y) * stride + x]); };
    if (hmax % c.h || vmax % c.v) fail("fractional JPEG sampling ratios are not supported");
    const int he = hmax / c.h, ve = vmax / c.v;
    std::vector<uint8_t> row(size_t(2 * dw + 2));
    if (he == 1 && ve == 1) {
      for (int y = 0; y < height; y++) std::memcpy(&out[size_t(y) * width], &src[size_t(y) * stride], width);
    } else if (he == 2 && ve == 1 && dw > 2) {
      for (int y = 0; y < height; y++) {
        uint8_t* o = row.data();
        const uint8_t* ip = &src[size_t(y) * stride];
        int v = ip[0];
        o[0] = uint8_t(v);
        o[1] = uint8_t((v * 3 + ip[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; x++) {
          v = ip[x] * 3;
          o[2 * x] = uint8_t((v + ip[x - 1] + 1) >> 2);
          o[2 * x + 1] = uint8_t((v + ip[x + 1] + 2) >> 2);
        }
        v = ip[dw - 1];
        o[2 * dw - 2] = uint8_t((v * 3 + ip[dw - 2] + 1) >> 2);
        o[2 * dw - 1] = uint8_t(v);
        std::memcpy(&out[size_t(y) * width], o, width);
      }
    } else if (he == 1 && ve == 2) {
      for (int y = 0; y < height; y++) {
        int iy = y >> 1, ny = (y & 1) ? std::min(iy + 1, dh - 1) : std::max(iy - 1, 0);
        int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < width; x++)
          out[size_t(y) * width + x] = uint8_t((in(iy, x) * 3 + in(ny, x) + bias) >> 2);
      }
    } else if (he == 2 && ve == 2 && dw > 2) {
      std::vector<int> cs(dw);
      for (int y = 0; y < height; y++) {
        int iy = y >> 1, ny = (y & 1) ? std::min(iy + 1, dh - 1) : std::max(iy - 1, 0);
        for (int x = 0; x < dw; x++) cs[x] = in(iy, x) * 3 + in(ny, x);
        uint8_t* o = row.data();
        o[0] = uint8_t((cs[0] * 4 + 8) >> 4);
        o[1] = uint8_t((cs[0] * 3 + cs[1] + 7) >> 4);
        for (int x = 1; x < dw - 1; x++) {
          o[2 * x] = uint8_t((cs[x] * 3 + cs[x - 1] + 8) >> 4);
          o[2 * x + 1] = uint8_t((cs[x] * 3 + cs[x + 1] + 7) >> 4);
        }
        o[2 * dw - 2] = uint8_t((cs[dw - 1] * 3 + cs[dw - 2] + 8) >> 4);
        o[2 * dw - 1] = uint8_t((cs[dw - 1] * 4 + 7) >> 4);
        std::memcpy(&out[size_t(y) * width], o, width);
      }
    } else {
      // h2v1_upsample, h2v2_upsample, int_upsample: box replication
      for (int y = 0; y < height; y++)
        for (int x = 0; x < width; x++) out[size_t(y) * width + x] = uint8_t(in(y / ve, x / he));
    }
    return out;
  }

  // The layouts FFmpeg's arithmetic is followed for: what its mjpeg
  // decoder gives swscale as yuvj420p or yuvj422p (yuv420p/yuv422p under a
  // "CS=ITU601" comment) of even height, which swscale converts on its
  // unscaled path (YCbCr with Y sampled 2x2 or 2x1, chroma 1x1); and
  // yuvj444p and gray8 (every component 1x1), which its scaler converts
  // with full chroma at 1:1.
  bool ffmpeg_layout() const {
    const Component& y = comps[0];
    if (comps.size() == 1) return y.h == 1 && y.v == 1;
    if (comps.size() != 3 || color_space() != CS_YCBCR) return false;
    const Component &cb = comps[1], &cr = comps[2];
    if (cb.h != 1 || cb.v != 1 || cr.h != 1 || cr.v != 1) return false;
    if (y.h == 1 && y.v == 1) return !cs_itu601;
    return y.h == 2 && (y.v == 1 || y.v == 2) && !(height & 1);
  }

  // FFmpeg's mode: each decoded block through the simple IDCT into the
  // frame's planes (`planes`, kept from the frame before: blocks a cut scan
  // did not reach keep their pixels), then swscale's conversion to BGR24.
  // A progressive file's blocks are all transformed at its end, as
  // mjpegdec.c does; their DC holds the level shift where a DC scan reached
  // them.
  void ff_output(uint8_t* out, std::vector<uint8_t> (&planes)[3]) {
    int16_t ws[64];
    for (size_t ci = 0; ci < comps.size(); ci++) {
      Component& c = comps[ci];
      const int stride = c.bw * 8;
      const size_t size = size_t(stride) * c.bh * 8;
      if (planes[ci].size() != size) planes[ci].assign(size, 0);  // a new, zeroed buffer
      for (int by = 0; by < c.hblocks; by++)
        for (int bx = 0; bx < c.wblocks; bx++) {
          const bool done = c.done[size_t(by) * c.bw + bx] != 0;
          if (!done && !progressive) continue;
          const int16_t* blk = c.block(by, bx);
          for (int k = 0; k < 64; k++) ws[k] = int16_t(blk[k] * c.quant[k]);
          ws[0] = int16_t(progressive ? (done ? 1024 : 0) + blk[0] * c.quant[0] : blk[0]);
          ffdsp::idct_put(planes[ci].data() + size_t(by) * 8 * stride + bx * 8, stride, ws);
        }
    }
    const int stride = comps[0].bw * 8;
    if (comps.size() == 1) {
      ffdsp::yuv444_bgr24_full(planes[0].data(), nullptr, nullptr, stride, width, height, out);
    } else if (comps[0].h == 1) {
      ffdsp::yuv444_bgr24_full(planes[0].data(), planes[1].data(), planes[2].data(), stride, width,
                               height, out);
    } else {
      ffdsp::yuv2bgr24(planes[0].data(), stride, planes[1].data(), planes[2].data(),
                       comps[1].bw * 8, width, height, comps[0].v == 2 ? 1 : 0, !cs_itu601, out);
    }
  }

  // The decoded image: (height, width, 3) BGR, or (height, width) gray.
  void output(uint8_t* out, bool gray) {
    const ColorTables& t = tables();
    const size_t np = size_t(width) * height;
    ColorSpace cs = color_space();
    if (cs == CS_GRAY || (gray && cs == CS_YCBCR)) {
      std::vector<uint8_t> y = upsample(comps[0]);
      if (gray) {
        std::memcpy(out, y.data(), np);
      } else {
        for (size_t i = 0; i < np; i++) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
      }
      return;
    }
    std::vector<std::vector<uint8_t>> pl;
    for (Component& c : comps) pl.push_back(upsample(c));
    if (cs == CS_YCBCR) {
      for (size_t i = 0; i < np; i++) {
        int y = pl[0][i], cb = pl[1][i], cr = pl[2][i];
        out[3 * i + 2] = clamp255(y + t.cr_r[cr]);
        out[3 * i + 1] = clamp255(y + int((t.cb_g[cb] + t.cr_g[cr]) >> kScaleBits));
        out[3 * i + 0] = clamp255(y + t.cb_b[cb]);
      }
      return;
    }
    if (cs == CS_RGB) {
      for (size_t i = 0; i < np; i++) {
        int r = pl[0][i], g = pl[1][i], b = pl[2][i];
        if (gray) {
          out[i] = uint8_t((t.rgb_y[r] + t.rgb_y[g + 256] + t.rgb_y[b + 512]) >> kScaleBits);
        } else {
          out[3 * i] = uint8_t(b);
          out[3 * i + 1] = uint8_t(g);
          out[3 * i + 2] = uint8_t(r);
        }
      }
      return;
    }
    // CMYK (YCCK converted by jdcolor's ycck_cmyk_convert), then OpenCV's
    // icvCvt_CMYK2BGR_8u_C4C3R / icvCvt_CMYK2Gray_8u_C4C1R
    for (size_t i = 0; i < np; i++) {
      int c = pl[0][i], m = pl[1][i], y = pl[2][i], k = pl[3][i];
      if (cs == CS_YCCK) {
        int yy = c, cb = m, cr = y;
        c = 255 - clamp255(yy + t.cr_r[cr]);
        m = 255 - clamp255(yy + int((t.cb_g[cb] + t.cr_g[cr]) >> kScaleBits));
        y = 255 - clamp255(yy + t.cb_b[cb]);
      }
      c = k - (((255 - c) * k) >> 8);
      m = k - (((255 - m) * k) >> 8);
      y = k - (((255 - y) * k) >> 8);
      if (gray) {
        const int sh = 14, cr_ = 4899, cg_ = 9617, cb_ = 1868;
        out[i] = uint8_t((y * cb_ + m * cg_ + c * cr_ + (1 << (sh - 1))) >> sh);
      } else {
        out[3 * i] = uint8_t(y);
        out[3 * i + 1] = uint8_t(m);
        out[3 * i + 2] = uint8_t(c);
      }
    }
  }
};

// ---------------------------------------------------------------- encoder

const uint8_t kStdLumQ[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                              14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                              18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                              49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromQ[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                                24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                                99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                                99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

struct HuffCodes {
  uint32_t code[256];
  uint8_t size[256];
  HuffCodes(const uint8_t bits[17], const uint8_t* vals) {
    std::memset(size, 0, sizeof size);
    std::memset(code, 0, sizeof code);
    uint32_t c = 0;
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      for (int i = 0; i < bits[l]; i++, p++) {
        code[vals[p]] = c++;
        size[vals[p]] = uint8_t(l);
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int cnt = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t bits, int n) {
    if (n == 0) return;
    acc = (acc << n) | (bits & ((uint32_t(1) << n) - 1));
    cnt += n;
    while (cnt >= 8) {
      cnt -= 8;
      uint8_t b = uint8_t(acc >> cnt);
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
    }
  }
  void flush() {  // jchuff.c flush_bits: pad the last byte with ones
    if (cnt) put(0x7F, 8 - cnt);
  }
};

// jfdctint.c jpeg_fdct_islow on centered samples, in 16-bit DCTELEMs.
void fdct_islow(int16_t* data) {
  for (int pass = 0; pass < 2; pass++) {
    const int step = pass == 0 ? 1 : 8, adv = pass == 0 ? 8 : 1;
    for (int ctr = 0; ctr < 8; ctr++) {
      int16_t* p = data + ctr * adv;
      int64_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int64_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int64_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      int64_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        p[0] = int16_t((tmp10 + tmp11) * (1 << kPass1Bits));
        p[4 * step] = int16_t((tmp10 - tmp11) * (1 << kPass1Bits));
      } else {
        p[0] = int16_t(descale(tmp10 + tmp11, kPass1Bits));
        p[4 * step] = int16_t(descale(tmp10 - tmp11, kPass1Bits));
      }
      const int sh = pass == 0 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
      int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
      p[2 * step] = int16_t(descale(z1 + tmp13 * FIX_0_765366865, sh));
      p[6 * step] = int16_t(descale(z1 + tmp12 * -FIX_1_847759065, sh));
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp4 *= FIX_0_298631336;
      tmp5 *= FIX_2_053119869;
      tmp6 *= FIX_3_072711026;
      tmp7 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      p[7 * step] = int16_t(descale(tmp4 + z1 + z3, sh));
      p[5 * step] = int16_t(descale(tmp5 + z2 + z4, sh));
      p[3 * step] = int16_t(descale(tmp6 + z2 + z3, sh));
      p[1 * step] = int16_t(descale(tmp7 + z1 + z4, sh));
    }
  }
}

// jcdctmgr.c compute_reciprocal, for a 16-bit DCTELEM.
struct Divisor {
  uint32_t recip, corr;
  int shift;  // total right shift of the product
};

Divisor reciprocal(uint16_t divisor) {
  Divisor dv;
  if (divisor == 1) {
    dv.recip = 1;
    dv.corr = 0;
    dv.shift = 0;
    return dv;
  }
  int b = 31 - __builtin_clz(divisor);  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (uint32_t(1) << r) / divisor, fr = (uint32_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2u) {
    c++;
  } else {
    fq++;
  }
  dv.recip = fq & 0xFFFF;
  dv.corr = c & 0xFFFF;
  dv.shift = r;
  return dv;
}

void quant_table(int quality, const uint8_t* basic, uint16_t* out) {
  // jcparam.c jpeg_quality_scaling + jpeg_add_quant_table(force_baseline)
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; i++) {
    long t = (long(basic[i]) * scale + 50L) / 100L;
    if (t <= 0) t = 1;
    if (t > 32767) t = 32767;
    if (t > 255) t = 255;
    out[i] = uint16_t(t);
  }
}

struct EncComponent {
  int id, h, v, tq, tbl;
  int wblocks, hblocks, stride, rows;
  std::vector<uint8_t> plane;  // stride x rows, padded as libjpeg's prep/downsample pad
};

std::vector<uint8_t> encode(const uint8_t* img, int w, int h, int channels, int quality) {
  if (w <= 0 || h <= 0 || w > 65535 || h > 65535) fail("JPEG image size out of range");
  if (channels != 1 && channels != 3) fail("JPEG encode takes 1 (gray) or 3 (BGR) channels");
  const ColorTables& t = tables();
  uint16_t qtab[2][64];
  quant_table(quality, kStdLumQ, qtab[0]);
  quant_table(quality, kStdChromQ, qtab[1]);
  Divisor div[2][64];
  for (int q = 0; q < 2; q++)
    for (int i = 0; i < 64; i++) div[q][i] = reciprocal(uint16_t(qtab[q][i] << 3));

  const bool color = channels == 3;
  const int hmax = color ? 2 : 1, vmax = color ? 2 : 1;
  std::vector<EncComponent> comps;
  if (color) {
    comps.push_back({1, 2, 2, 0, 0, 0, 0, 0, 0, {}});
    comps.push_back({2, 1, 1, 1, 1, 0, 0, 0, 0, {}});
    comps.push_back({3, 1, 1, 1, 1, 0, 0, 0, 0, {}});
  } else {
    comps.push_back({1, 1, 1, 0, 0, 0, 0, 0, 0, {}});
  }
  const int mcux = (w + 8 * hmax - 1) / (8 * hmax), mcuy = (h + 8 * vmax - 1) / (8 * vmax);
  const int groups = (h + vmax - 1) / vmax;  // row groups of max_v_samp rows
  const int hp = groups * vmax;              // rows after jcprepct's bottom replication

  // color-converted full-size planes, hp rows of w
  std::vector<std::vector<uint8_t>> full(comps.size(), std::vector<uint8_t>(size_t(w) * hp));
  for (int y = 0; y < hp; y++) {
    const uint8_t* src = img + size_t(std::min(y, h - 1)) * w * channels;
    for (int x = 0; x < w; x++) {
      size_t o = size_t(y) * w + x;
      if (!color) {
        full[0][o] = src[x];
        continue;
      }
      int b = src[3 * x], g = src[3 * x + 1], r = src[3 * x + 2];
      full[0][o] = uint8_t((t.rgb_ycc[r] + t.rgb_ycc[g + 256] + t.rgb_ycc[b + 512]) >> kScaleBits);
      full[1][o] = uint8_t((t.rgb_ycc[r + 768] + t.rgb_ycc[g + 1024] + t.rgb_ycc[b + 1280]) >> kScaleBits);
      full[2][o] = uint8_t((t.rgb_ycc[r + 1280] + t.rgb_ycc[g + 1536] + t.rgb_ycc[b + 1792]) >> kScaleBits);
    }
  }
  for (size_t ci = 0; ci < comps.size(); ci++) {
    EncComponent& c = comps[ci];
    int cw = int((int64_t(w) * c.h + hmax - 1) / hmax), ch = int((int64_t(h) * c.v + vmax - 1) / vmax);
    c.wblocks = (cw + 7) / 8;
    c.hblocks = (ch + 7) / 8;
    c.stride = c.wblocks * 8;
    c.rows = mcuy * c.v * 8;
    c.plane.assign(size_t(c.stride) * c.rows, 0);
    const int he = hmax / c.h, ve = vmax / c.v;
    const int in_w = c.stride * he;  // expand_right_edge target
    const int out_rows = groups * c.v;
    std::vector<uint8_t> row0(in_w), row1(in_w);
    for (int oy = 0; oy < out_rows; oy++) {
      uint8_t* o = &c.plane[size_t(oy) * c.stride];
      auto expand = [&](int y, std::vector<uint8_t>& r) {
        std::memcpy(r.data(), &full[ci][size_t(y) * w], w);
        for (int x = w; x < in_w; x++) r[x] = r[w - 1];
      };
      if (he == 1 && ve == 1) {
        expand(oy, row0);
        std::memcpy(o, row0.data(), c.stride);
      } else {  // h2v2_downsample
        expand(2 * oy, row0);
        expand(2 * oy + 1, row1);
        int bias = 1;
        for (int x = 0; x < c.stride; x++) {
          o[x] = uint8_t((row0[2 * x] + row0[2 * x + 1] + row1[2 * x] + row1[2 * x + 1] + bias) >> 2);
          bias ^= 3;
        }
      }
    }
    for (int oy = out_rows; oy < c.rows; oy++)
      std::memcpy(&c.plane[size_t(oy) * c.stride], &c.plane[size_t(out_rows - 1) * c.stride], c.stride);
  }

  std::vector<uint8_t> out;
  out.reserve(size_t(w) * h * channels / 4 + 1024);
  auto put16 = [&](int v) {
    out.push_back(uint8_t(v >> 8));
    out.push_back(uint8_t(v & 0xFF));
  };
  auto marker = [&](int m) {
    out.push_back(0xFF);
    out.push_back(uint8_t(m));
  };
  marker(0xD8);
  marker(0xE0);  // JFIF 1.01, no units, 1:1 density, no thumbnail
  put16(16);
  for (char ch : {'J', 'F', 'I', 'F', '\0'}) out.push_back(uint8_t(ch));
  for (int b : {1, 1, 0, 0, 1, 0, 1, 0, 0}) out.push_back(uint8_t(b));
  const int ntables = color ? 2 : 1;
  for (int q = 0; q < ntables; q++) {
    marker(0xDB);
    put16(67);
    out.push_back(uint8_t(q));
    for (int i = 0; i < 64; i++) out.push_back(uint8_t(qtab[q][kNatural[i]]));
  }
  marker(0xC0);
  put16(8 + 3 * int(comps.size()));
  out.push_back(8);
  put16(h);
  put16(w);
  out.push_back(uint8_t(comps.size()));
  for (auto& c : comps) {
    out.push_back(uint8_t(c.id));
    out.push_back(uint8_t((c.h << 4) | c.v));
    out.push_back(uint8_t(c.tq));
  }
  const uint8_t* dc_bits[2] = {kDcLumBits, kDcChromBits};
  const uint8_t* ac_bits[2] = {kAcLumBits, kAcChromBits};
  const uint8_t* ac_vals[2] = {kAcLumVals, kAcChromVals};
  for (int tb = 0; tb < ntables; tb++) {
    for (int cls = 0; cls < 2; cls++) {
      const uint8_t* bits = cls ? ac_bits[tb] : dc_bits[tb];
      const uint8_t* vals = cls ? ac_vals[tb] : kDcVals;
      int count = 0;
      for (int i = 1; i <= 16; i++) count += bits[i];
      marker(0xC4);
      put16(2 + 1 + 16 + count);
      out.push_back(uint8_t((cls << 4) | tb));
      for (int i = 1; i <= 16; i++) out.push_back(bits[i]);
      for (int i = 0; i < count; i++) out.push_back(vals[i]);
    }
  }
  marker(0xDA);
  put16(6 + 2 * int(comps.size()));
  out.push_back(uint8_t(comps.size()));
  for (auto& c : comps) {
    out.push_back(uint8_t(c.id));
    out.push_back(uint8_t((c.tbl << 4) | c.tbl));
  }
  out.push_back(0);
  out.push_back(63);
  out.push_back(0);

  const HuffCodes dcc[2] = {HuffCodes(kDcLumBits, kDcVals), HuffCodes(kDcChromBits, kDcVals)};
  const HuffCodes acc[2] = {HuffCodes(kAcLumBits, kAcLumVals), HuffCodes(kAcChromBits, kAcChromVals)};
  BitWriter bw(out);
  int last_dc[3] = {0, 0, 0};

  auto fdct_quant = [&](const EncComponent& c, int by, int bx, int16_t* blk) {
    int16_t ws[64];
    for (int r = 0; r < 8; r++) {
      const uint8_t* s = &c.plane[size_t(by * 8 + r) * c.stride + bx * 8];
      for (int i = 0; i < 8; i++) ws[r * 8 + i] = int16_t(s[i] - 128);
    }
    fdct_islow(ws);
    const Divisor* dv = div[c.tq];
    for (int i = 0; i < 64; i++) {
      int tmp = ws[i];
      bool neg = tmp < 0;
      uint32_t a = uint32_t(neg ? -tmp : tmp);
      int16_t q = int16_t(((a + dv[i].corr) * dv[i].recip) >> dv[i].shift);
      blk[i] = neg ? int16_t(-q) : q;
    }
  };
  auto emit_block = [&](const int16_t* blk, int ci, int tb) {
    int temp = blk[0] - last_dc[ci], temp2 = temp;
    last_dc[ci] = blk[0];
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    int nbits = temp ? 32 - __builtin_clz(uint32_t(temp)) : 0;
    if (nbits > 11) fail("DC coefficient out of range");
    bw.put(dcc[tb].code[nbits], dcc[tb].size[nbits]);
    bw.put(uint32_t(temp2), nbits);
    int r = 0;
    for (int k = 1; k < 64; k++) {
      int v = blk[kNatural[k]];
      if (v == 0) {
        r++;
        continue;
      }
      while (r > 15) {
        bw.put(acc[tb].code[0xF0], acc[tb].size[0xF0]);
        r -= 16;
      }
      int a = v, a2 = v;
      if (a < 0) {
        a = -a;
        a2--;
      }
      nbits = 32 - __builtin_clz(uint32_t(a));
      if (nbits > 10) fail("AC coefficient out of range");
      int sym = (r << 4) + nbits;
      bw.put(acc[tb].code[sym], acc[tb].size[sym]);
      bw.put(uint32_t(a2), nbits);
      r = 0;
    }
    if (r > 0) bw.put(acc[tb].code[0], acc[tb].size[0]);
  };

  std::vector<int16_t> mcu(10 * 64);
  if (!color) {
    const EncComponent& c = comps[0];
    for (int by = 0; by < c.hblocks; by++)
      for (int bx = 0; bx < c.wblocks; bx++) {
        fdct_quant(c, by, bx, mcu.data());
        emit_block(mcu.data(), 0, 0);
      }
  } else {
    for (int my = 0; my < mcuy; my++) {
      for (int mx = 0; mx < mcux; mx++) {
        // jccoefct.c compress_data, dummy blocks included
        int blkn = 0;
        for (const EncComponent& c : comps) {
          int last_col = c.wblocks % c.h ? c.wblocks % c.h : c.h;
          int last_row = c.hblocks % c.v ? c.hblocks % c.v : c.v;
          int blockcnt = mx < mcux - 1 ? c.h : last_col;
          for (int yi = 0; yi < c.v; yi++) {
            int16_t* b = &mcu[size_t(blkn) * 64];
            if (my < mcuy - 1 || yi < last_row) {
              for (int bi = 0; bi < blockcnt; bi++) fdct_quant(c, my * c.v + yi, mx * c.h + bi, b + bi * 64);
              for (int bi = blockcnt; bi < c.h; bi++) {
                std::memset(b + bi * 64, 0, 64 * sizeof(int16_t));
                b[bi * 64] = b[(bi - 1) * 64];
              }
            } else {
              for (int bi = 0; bi < c.h; bi++) {
                std::memset(b + bi * 64, 0, 64 * sizeof(int16_t));
                b[bi * 64] = b[bi * 64 - 64];
              }
            }
            blkn += c.h;
          }
        }
        blkn = 0;
        for (size_t ci = 0; ci < comps.size(); ci++) {
          for (int k = 0; k < comps[ci].h * comps[ci].v; k++, blkn++)
            emit_block(&mcu[size_t(blkn) * 64], int(ci), comps[ci].tbl);
        }
      }
    }
  }
  bw.flush();
  marker(0xD9);
  return out;
}

void set_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", msg);
}

// A Motion-JPEG stream decoded frame by frame as FFmpeg decodes it: the
// planes outlive a frame, as the decoder's frame buffer does.
struct MjpegStream {
  std::vector<uint8_t> planes[3];
};

}  // namespace

extern "C" {

// info = {width, height, EXIF orientation}: the stored size, before the
// orientation is applied.  `file_mode` as for crt_jpeg_decode.
int crt_jpeg_header(const uint8_t* data, long n, int file_mode, int* info, char* err, int errlen) {
  try {
    Decoder dec(data, size_t(n), file_mode != 0);
    dec.run(true);
    info[0] = dec.width;
    info[1] = dec.height;
    info[2] = dec.orientation;
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

// Decodes into `out`: (height, width, 3) BGR, or (height, width) with
// `gray`.  `file_mode` reads as imread does (libjpeg's file source reads
// fake EOI markers past the end of the file, so a truncated scan leaves its
// missing blocks as they are); otherwise as imdecode (truncation is an
// error).
int crt_jpeg_decode(const uint8_t* data, long n, int gray, int file_mode, uint8_t* out,
                    long out_size, char* err, int errlen) {
  try {
    Decoder dec(data, size_t(n), file_mode != 0);
    dec.run(false);
    if (long(dec.width) * dec.height * (gray ? 1 : 3) != out_size) fail("output buffer size mismatch");
    dec.output(out, gray != 0);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

// Encodes a (h, w) gray or (h, w, 3) BGR u8 image; *out is malloc'ed (free
// it with crt_jpeg_free).
int crt_jpeg_encode(const uint8_t* img, int w, int h, int channels, int quality, uint8_t** out,
                    long* out_n, char* err, int errlen) {
  try {
    std::vector<uint8_t> bytes = encode(img, w, h, channels, quality);
    *out = static_cast<uint8_t*>(std::malloc(bytes.size()));
    if (!*out) fail("out of memory");
    std::memcpy(*out, bytes.data(), bytes.size());
    *out_n = long(bytes.size());
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

void crt_jpeg_free(uint8_t* p) { std::free(p); }

void* crt_mjpeg_create() { return new MjpegStream(); }

void crt_mjpeg_destroy(void* h) { delete static_cast<MjpegStream*>(h); }

// One frame of a Motion-JPEG stream as (height, width, 3) BGR, as FFmpeg's
// mjpeg decoder and swscale give it to OpenCV: *arith is 1 where the
// layout is one ffmpeg_layout() takes (FFmpeg's arithmetic; where the data
// ends inside a scan, the blocks not reached keep the previous frame's
// pixels), else 0: libjpeg's arithmetic, the data read as imread reads a
// file (the EXIF orientation is not applied in either).
int crt_mjpeg_decode(void* h, const uint8_t* data, long n, uint8_t* out, long out_size,
                     int* arith, char* err, int errlen) {
  MjpegStream* st = static_cast<MjpegStream*>(h);
  bool ff_layout = false;
  try {
    Decoder probe(data, size_t(n), false);
    probe.run(true);
    ff_layout = probe.ffmpeg_layout();
  } catch (const std::exception&) {
  }
  Decoder dec(data, size_t(n), !ff_layout);
  dec.ff = ff_layout;
  try {
    dec.run(false);
  } catch (const std::exception& e) {
    // past its first scan FFmpeg keeps the frame and ignores the error
    if (!dec.ff || dec.comps.empty() || dec.comps[0].coef.empty()) {
      set_error(err, errlen, e.what());
      return 1;
    }
  }
  try {
    if (long(dec.width) * dec.height * 3 != out_size) fail("output buffer size mismatch");
    *arith = dec.ff ? 1 : 0;
    if (dec.ff) {
      dec.ff_output(out, st->planes);
    } else {
      dec.output(out, false);
    }
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

}  // extern "C"
