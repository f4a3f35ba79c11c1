// MPEG-4 Part 2 video (ISO/IEC 14496-2, Simple Profile) decoded on the host,
// as FFmpeg's `mpeg4` decoder decodes it for OpenCV's VideoCapture, and the
// decoded 4:2:0 picture converted to BGR24 as swscale's unscaled
// YUV420P -> BGR24 path converts it.
//
// What is decoded: rectangular, progressive, 8-bit VOLs with H.263
// quantisation (quant_type 0); I- and P-VOPs; intra DC and AC prediction;
// one motion vector a macroblock with half-pel interpolation under the
// VOP's rounding type; unrestricted vectors (reads outside the coded frame
// take the edge pixel); FFmpeg's "simple" integer IDCT.  Everything else
// (B- and S-VOPs, quarter-pel, interlace, quant_type 1, data partitioning,
// reversible VLC, resync markers, inter4v macroblocks, short video header,
// scalability, newpred, reduced resolution, bit depths other than 8) is
// refused by name.
//
// C interface (ctypes): crt_mpeg4_create, crt_mpeg4_config (the headers
// carried outside the packets), crt_mpeg4_decode (one packet), crt_mpeg4_bgr
// (the last picture as BGR24), crt_mpeg4_flush, crt_mpeg4_destroy.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

#include "ffmpeg_dsp.h"

namespace {

struct Corrupt : std::runtime_error {
    using std::runtime_error::runtime_error;
};
struct Refused : std::runtime_error {
    using std::runtime_error::runtime_error;
};

// ------------------------------------------------------------------ bits

struct Bits {
    const uint8_t* buf;  // padded with 8 zero bytes past `bytes`
    size_t bytes;
    size_t pos = 0;  // in bits

    uint32_t show(int n) const {  // 0 < n <= 32
        uint64_t v;
        size_t b = pos >> 3;
        if (b + 8 <= bytes + 8) {
            std::memcpy(&v, buf + b, 8);
            v = __builtin_bswap64(v);
        } else {
            v = 0;
        }
        v <<= (pos & 7);
        return (uint32_t)(v >> (64 - n));
    }
    void skip(int n) { pos += n; }
    uint32_t get(int n) {
        if (n == 0) return 0;
        uint32_t v = show(n);
        pos += n;
        return v;
    }
    int get1() { return (int)get(1); }
    int sbits(int n) {  // two's complement
        int v = (int)get(n);
        return v >= (1 << (n - 1)) ? v - (1 << n) : v;
    }
    long left() const { return (long)(bytes * 8) - (long)pos; }
    void check() const {
        if (left() < 0) throw Corrupt("the data ends inside a VOP");
    }
    void marker(const char* what) {
        if (!get1()) throw Corrupt(std::string("marker bit missing ") + what);
    }
};

// ------------------------------------------------------------------- VLC

struct Vlc {
    int bits = 0;
    std::vector<int16_t> sym;
    std::vector<uint8_t> len;

    // codes[i] = {code, length} of symbol i
    void init(const uint16_t (*codes)[2], int n) {
        bits = 0;
        for (int i = 0; i < n; i++) bits = std::max(bits, (int)codes[i][1]);
        sym.assign(size_t(1) << bits, -1);
        len.assign(size_t(1) << bits, 0);
        for (int i = 0; i < n; i++) {
            int l = codes[i][1];
            if (!l) continue;
            uint32_t first = (uint32_t)codes[i][0] << (bits - l);
            for (uint32_t k = 0; k < (1u << (bits - l)); k++) {
                sym[first + k] = (int16_t)i;
                len[first + k] = (uint8_t)l;
            }
        }
    }
    int get(Bits& b, const char* what) const {
        uint32_t v = b.show(bits);
        int s = sym[v];
        if (s < 0) throw Corrupt(std::string("invalid ") + what + " code");
        b.skip(len[v]);
        return s;
    }
};

// Table B-16 (intra) and B-17 (inter) TCOEF codes, escape last; the
// (last, run, level) of each follow from max_levels below.
const uint16_t kIntraCodes[103][2] = {
    {2, 2}, {6, 3}, {15, 4}, {13, 5}, {12, 5}, {21, 6}, {19, 6}, {18, 6}, {23, 7}, {31, 8},
    {30, 8}, {29, 8}, {37, 9}, {36, 9}, {35, 9}, {33, 9}, {33, 10}, {32, 10}, {15, 10},
    {14, 10}, {7, 11}, {6, 11}, {32, 11}, {33, 11}, {80, 12}, {81, 12}, {82, 12}, {14, 4},
    {20, 6}, {22, 7}, {28, 8}, {32, 9}, {31, 9}, {13, 10}, {34, 11}, {83, 12}, {85, 12},
    {11, 5}, {21, 7}, {30, 9}, {12, 10}, {86, 12}, {17, 6}, {27, 8}, {29, 9}, {11, 10},
    {16, 6}, {34, 9}, {10, 10}, {13, 6}, {28, 9}, {8, 10}, {18, 7}, {27, 9}, {84, 12},
    {20, 7}, {26, 9}, {87, 12}, {25, 8}, {9, 10}, {24, 8}, {35, 11}, {23, 8}, {25, 9},
    {24, 9}, {7, 10}, {88, 12}, {7, 4}, {12, 6}, {22, 8}, {23, 9}, {6, 10}, {5, 11}, {4, 11},
    {89, 12}, {15, 6}, {22, 9}, {5, 10}, {14, 6}, {4, 10}, {17, 7}, {36, 11}, {16, 7},
    {37, 11}, {19, 7}, {90, 12}, {21, 8}, {91, 12}, {20, 8}, {19, 8}, {26, 8}, {21, 9},
    {20, 9}, {19, 9}, {18, 9}, {17, 9}, {38, 11}, {39, 11}, {92, 12}, {93, 12}, {94, 12},
    {95, 12}, {3, 7}};
const uint16_t kInterCodes[103][2] = {
    {2, 2}, {15, 4}, {21, 6}, {23, 7}, {31, 8}, {37, 9}, {36, 9}, {33, 10}, {32, 10}, {7, 11},
    {6, 11}, {32, 11}, {6, 3}, {20, 6}, {30, 8}, {15, 10}, {33, 11}, {80, 12}, {14, 4},
    {29, 8}, {14, 10}, {81, 12}, {13, 5}, {35, 9}, {13, 10}, {12, 5}, {34, 9}, {82, 12},
    {11, 5}, {12, 10}, {83, 12}, {19, 6}, {11, 10}, {84, 12}, {18, 6}, {10, 10}, {17, 6},
    {9, 10}, {16, 6}, {8, 10}, {22, 7}, {85, 12}, {21, 7}, {20, 7}, {28, 8}, {27, 8}, {33, 9},
    {32, 9}, {31, 9}, {30, 9}, {29, 9}, {28, 9}, {27, 9}, {26, 9}, {34, 11}, {35, 11},
    {86, 12}, {87, 12}, {7, 4}, {25, 9}, {5, 11}, {15, 6}, {4, 11}, {14, 6}, {13, 6}, {12, 6},
    {19, 7}, {18, 7}, {17, 7}, {16, 7}, {26, 8}, {25, 8}, {24, 8}, {23, 8}, {22, 8}, {21, 8},
    {20, 8}, {19, 8}, {24, 9}, {23, 9}, {22, 9}, {21, 9}, {20, 9}, {19, 9}, {18, 9}, {17, 9},
    {7, 10}, {6, 10}, {5, 10}, {4, 10}, {36, 11}, {37, 11}, {38, 11}, {39, 11}, {88, 12},
    {89, 12}, {90, 12}, {91, 12}, {92, 12}, {93, 12}, {94, 12}, {95, 12}, {3, 7}};
// the largest level of each run, for last = 0 and last = 1
const int kIntraMaxLevel0[] = {27, 10, 5, 4, 3, 3, 3, 3, 2, 2, 1, 1, 1, 1, 1};
const int kIntraMaxLevel1[] = {8, 3, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
const int kInterMaxLevel0[] = {12, 6, 4, 3, 3, 3, 3, 2, 2, 2, 2, 1, 1, 1, 1,
                               1,  1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
const int kInterMaxLevel1[] = {3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};

const uint16_t kIntraMcbpc[9][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4},
                                    {1, 6}, {2, 6}, {3, 6}, {1, 9}};
const uint16_t kInterMcbpc[28][2] = {
    {1, 1}, {3, 4}, {2, 4}, {5, 6},  {3, 5}, {4, 8},  {3, 8},  {3, 7},  {3, 3},  {7, 7},
    {6, 7}, {5, 9}, {4, 6}, {4, 9},  {3, 9}, {2, 9},  {2, 3},  {5, 7},  {4, 7},  {5, 8},
    {1, 9}, {0, 0}, {0, 0}, {0, 0},  {2, 11}, {12, 13}, {14, 13}, {15, 13}};
const uint16_t kCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4}, {2, 6}, {11, 4},
                               {2, 5}, {3, 6}, {5, 4}, {10, 4}, {4, 4}, {8, 4}, {6, 4}, {3, 2}};
const uint16_t kMv[33][2] = {
    {1, 1},  {1, 2},  {1, 3},  {1, 4},  {3, 6},  {5, 7},  {4, 7},  {3, 7},  {11, 9},
    {10, 9}, {9, 9},  {17, 10}, {16, 10}, {15, 10}, {14, 10}, {13, 10}, {12, 10}, {11, 10},
    {10, 10}, {9, 10}, {8, 10}, {7, 10}, {6, 10}, {5, 10}, {4, 10}, {7, 11}, {6, 11},
    {5, 11}, {4, 11}, {3, 11}, {2, 11}, {3, 12}, {2, 12}};
const uint16_t kDcLum[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3}, {1, 4}, {1, 5},
                                {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
const uint16_t kDcChrom[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4},  {1, 5}, {1, 6},
                                  {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};

const uint8_t kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                             12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                             35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                             58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const uint8_t kAltH[64] = {0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14,
                           13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
                           30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
                           46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
const uint8_t kAltV[64] = {0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49,
                           41, 33, 26, 18, 3,  11, 4,  12, 19, 27, 34, 42, 50, 58, 35, 43,
                           51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44, 52, 60, 37, 45,
                           53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};
const int kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};
const int kDquant[4] = {-1, -2, 1, 2};

int y_dc_scale(int q) { return q < 5 ? 8 : q < 9 ? 2 * q : q < 25 ? q + 8 : 2 * q - 16; }
int c_dc_scale(int q) { return q < 5 ? 8 : q < 25 ? (q + 13) / 2 : q - 6; }

struct RunLevel {
    Vlc vlc;
    int8_t run[102], level[102], last[102];
    int8_t max_level[2][64];
    int8_t max_run[2][64];

    void init(const uint16_t (*codes)[2], const int* ml0, int n0, const int* ml1, int n1) {
        vlc.init(codes, 103);
        std::memset(max_level, 0, sizeof(max_level));
        std::memset(max_run, 0, sizeof(max_run));
        int k = 0;
        for (int l = 0; l < 2; l++) {
            const int* ml = l ? ml1 : ml0;
            for (int r = 0; r < (l ? n1 : n0); r++) {
                max_level[l][r] = (int8_t)ml[r];
                for (int v = 1; v <= ml[r]; v++, k++) {
                    run[k] = (int8_t)r;
                    level[k] = (int8_t)v;
                    last[k] = (int8_t)l;
                    max_run[l][v] = (int8_t)std::max<int>(max_run[l][v], r);
                }
            }
        }
    }
};

struct Tables {
    RunLevel intra, inter;
    Vlc intra_mcbpc, inter_mcbpc, cbpy, mv, dc_lum, dc_chrom;
    Tables() {
        intra.init(kIntraCodes, kIntraMaxLevel0, 15, kIntraMaxLevel1, 21);
        inter.init(kInterCodes, kInterMaxLevel0, 27, kInterMaxLevel1, 41);
        intra_mcbpc.init(kIntraMcbpc, 9);
        inter_mcbpc.init(kInterMcbpc, 28);
        cbpy.init(kCbpy, 16);
        mv.init(kMv, 33);
        dc_lum.init(kDcLum, 13);
        dc_chrom.init(kDcChrom, 13);
    }
};

const Tables& tables() {
    static const Tables t;
    return t;
}

// FFmpeg's simple IDCT and swscale's converter: ffmpeg_dsp.h

using ffdsp::clip_u8;
using ffdsp::idct_add;
using ffdsp::idct_put;

// ------------------------------------------------------ half-pel copies
// src points at a block with one more row and column than it reads when
// its half-pel flag is set.  no_rnd (vop_rounding_type 1): averages round
// down; otherwise up.

void hpel(uint8_t* dst, int dls, const uint8_t* src, int sls, int w, int h, int dxy, int no_rnd) {
    for (int y = 0; y < h; y++) {
        const uint8_t* s0 = src + y * sls;
        const uint8_t* s1 = s0 + sls;
        uint8_t* d = dst + y * dls;
        switch (dxy) {
        case 0:
            std::memcpy(d, s0, w);
            break;
        case 1:
            for (int x = 0; x < w; x++) d[x] = (uint8_t)((s0[x] + s0[x + 1] + 1 - no_rnd) >> 1);
            break;
        case 2:
            for (int x = 0; x < w; x++) d[x] = (uint8_t)((s0[x] + s1[x] + 1 - no_rnd) >> 1);
            break;
        default:
            for (int x = 0; x < w; x++)
                d[x] = (uint8_t)((s0[x] + s0[x + 1] + s1[x] + s1[x + 1] + 2 - no_rnd) >> 2);
        }
    }
}

// ------------------------------------------------------------- decoder

struct Plane {
    std::vector<uint8_t> px;
    int w = 0, h = 0;  // coded size (whole macroblocks)
    uint8_t* at(int x, int y) { return px.data() + (size_t)y * w + x; }
};

struct Decoder {
    // VOL
    bool have_vol = false;
    int width = 0, height = 0, mb_w = 0, mb_h = 0;
    int time_inc_bits = 1;
    int quant_precision = 5;
    std::string tag;                   // the container's codec tag
    bool tag_needs_user_data = false;  // a tag FFmpeg reads as Xvid/DivX without Lavc user data
    bool lavc = false;                 // user data names libavcodec

    // pictures: cur is decoded into, ref is the last I/P picture
    Plane cur[3], ref[3];
    bool have_ref = false, have_picture = false;

    // prediction state; borders hold the "outside" values (1024, 0, 0)
    int ys = 0, cs = 0;  // strides of the luma-block and macroblock grids
    std::vector<int16_t> dc[3];
    std::vector<int16_t> ac[3];  // 16 a block: [1..7] first column, [9..15] first row
    std::vector<int8_t> qtab;    // qscale of each macroblock of this VOP
    std::vector<int16_t> mvs;    // (x, y) of each macroblock, half-pel

    // VOP
    int pict_type = 0, no_rounding = 0, f_code = 1, qscale = 1, dc_thr = 0;
    alignas(16) int16_t block[6][64];
    int last_index[6];
    std::vector<uint8_t> emu;
    std::vector<uint8_t> pad;  // the packet with 8 zero bytes after it

    // -------------------------------------------------------- headers

    void set_size(int w, int h) {
        if (w == width && h == height && have_vol) return;
        width = w;
        height = h;
        mb_w = (w + 15) / 16;
        mb_h = (h + 15) / 16;
        for (int p = 0; p < 3; p++) {
            int s = p ? 8 : 16;
            for (Plane* pl : {&cur[p], &ref[p]}) {
                pl->w = mb_w * s;
                pl->h = mb_h * s;
                pl->px.assign((size_t)pl->w * pl->h, 128);
            }
        }
        have_ref = false;
        ys = 2 * mb_w + 2;
        cs = mb_w + 2;
        dc[0].assign((size_t)ys * (2 * mb_h + 1), 1024);
        ac[0].assign((size_t)ys * (2 * mb_h + 1) * 16, 0);
        for (int p = 1; p < 3; p++) {
            dc[p].assign((size_t)cs * (mb_h + 1), 1024);
            ac[p].assign((size_t)cs * (mb_h + 1) * 16, 0);
        }
        qtab.assign((size_t)mb_w * mb_h, 0);
        mvs.assign((size_t)cs * (mb_h + 1) * 2, 0);
    }

    void parse_vol(Bits& b) {
        b.skip(1);                 // random_accessible_vol
        int vo_type = b.get(8);
        if (vo_type == 14 || vo_type == 15) throw Refused("studio profile");
        int ver_id = 1;
        if (b.get1()) {  // is_object_layer_identifier
            ver_id = b.get(4);
            b.skip(3);
        }
        if (b.get(4) == 15) b.skip(16);  // aspect ratio, extended PAR
        int low_delay;
        if (b.get1()) {  // vol_control_parameters
            if (b.get(2) != 1) throw Refused("chroma format other than 4:2:0");
            low_delay = b.get1();
            if (b.get1()) {  // vbv parameters
                b.skip(15); b.marker("in vbv"); b.skip(15); b.marker("in vbv");
                b.skip(15); b.marker("in vbv"); b.skip(3); b.skip(11);
                b.marker("in vbv"); b.skip(15); b.marker("in vbv");
            }
        } else {
            low_delay = vo_type == 1 || vo_type == 17;  // Simple, Advanced Simple
        }
        int shape = b.get(2);
        if (shape) throw Refused("non-rectangular (shape-coded) VOL");
        b.marker("before vop_time_increment_resolution");
        int res = b.get(16);
        if (!res) throw Corrupt("vop_time_increment_resolution 0");
        time_inc_bits = res > 1 ? 32 - __builtin_clz((unsigned)(res - 1)) : 1;
        b.marker("before fixed_vop_rate");
        if (b.get1()) b.skip(time_inc_bits);
        b.marker("before width");
        int w = b.get(13);
        b.marker("before height");
        int h = b.get(13);
        b.marker("after height");
        if (b.get1()) throw Refused("interlaced video");
        b.skip(1);  // obmc_disable: FFmpeg decodes as if it were set
        int sprite = ver_id == 1 ? b.get1() : (int)b.get(2);
        if (sprite) throw Refused("sprites and global motion compensation (S-VOPs)");
        if (b.get1()) {  // not_8_bit
            int qp = b.get(4), bpp = b.get(4);
            if (bpp != 8) throw Refused("bit depth other than 8");
            if (qp != 5) throw Refused("quant_precision other than 5");
        }
        if (b.get1()) throw Refused("quant_type 1 (MPEG quantisation matrices)");
        if (ver_id != 1 && b.get1()) throw Refused("quarter-pel motion");
        if (!b.get1()) throw Refused("complexity estimation headers");
        if (!b.get1()) throw Refused("resync markers (video packets)");
        if (b.get1()) throw Refused("data partitioning and reversible VLC");
        if (ver_id != 1) {
            if (b.get1()) throw Refused("newpred");
            if (b.get1()) throw Refused("reduced resolution VOPs");
        }
        if (b.get1()) throw Refused("scalability");
        if (!low_delay) throw Refused("low_delay 0 (B-VOP reordering)");
        if (!w || !h) throw Corrupt("VOL of size 0");
        b.check();
        set_size(w, h);
        have_vol = true;
    }

    void parse_user_data(const uint8_t* p, size_t n) {
        std::string s((const char*)p, std::min<size_t>(n, 256));
        if (s.compare(0, 4, "Lavc") == 0 || s.compare(0, 5, "FFmpe") == 0) lavc = true;
        for (const char* tag : {"XviD", "DivX", "3IV", "RMP4"}) {
            if (s.compare(0, std::strlen(tag), tag) == 0)
                throw Refused(std::string("a stream written by ") + tag +
                              " (FFmpeg decodes it with that encoder's IDCT and bug workarounds)");
        }
    }

    // Walks the start codes of `data` (VOS, VO, VOL, user data, GOV) up to
    // the first VOP; returns the bit position of the VOP header after its
    // start code, or -1 when the data holds no VOP.
    long headers(const uint8_t* data, size_t n) {
        if (n >= 3 && data[0] == 0 && data[1] == 0 && (data[2] & 0xfc) == 0x80)
            throw Refused("short video header (H.263 baseline)");
        size_t i = 0;
        while (true) {
            while (i + 3 < n && !(data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1)) i++;
            if (i + 3 >= n) return -1;
            uint8_t code = data[i + 3];
            size_t body = i + 4;
            size_t next = body;
            while (next + 2 < n && !(data[next] == 0 && data[next + 1] == 0 && data[next + 2] == 1))
                next++;
            if (next + 2 >= n) next = n;
            if (code == 0xb6) return (long)body * 8;
            if (code >= 0x20 && code <= 0x2f) {
                Bits b{data + body, next - body};
                pad.assign(data + body, data + next);
                pad.resize(pad.size() + 8, 0);
                b.buf = pad.data();
                parse_vol(b);
            } else if (code == 0xb2) {
                parse_user_data(data + body, next - body);
            } else if (code == 0xb7 || code == 0xb8) {
                // GOV (0xb3) and VO/VOS are skipped; 0xb7/0xb8 are reserved
            } else if (code >= 0x40 && code <= 0x4f) {
                throw Refused("scalability (FGS) layers");
            }
            i = next;
        }
    }

    // FFmpeg reads a stream with one of these tags and no libavcodec user
    // data as Xvid's or DivX's: their IDCT and bug workarounds
    void check_tag() const {
        if (tag_needs_user_data && !lavc)
            throw Refused("an " + tag + "-tagged stream without FFmpeg's user data (FFmpeg "
                          "decodes it with the Xvid or DivX IDCT and bug workarounds)");
    }

    // ------------------------------------------------------ prediction

    int16_t* dc_at(int n, int mx, int my) {
        if (n < 4) return &dc[0][(size_t)(2 * my + (n >> 1) + 1) * ys + 2 * mx + (n & 1) + 1];
        return &dc[n - 3][(size_t)(my + 1) * cs + mx + 1];
    }
    int16_t* ac_at(int n, int mx, int my) {
        if (n < 4)
            return &ac[0][((size_t)(2 * my + (n >> 1) + 1) * ys + 2 * mx + (n & 1) + 1) * 16];
        return &ac[n - 3][((size_t)(my + 1) * cs + mx + 1) * 16];
    }

    // FFmpeg's ff_mpeg4_pred_dc: the predicted DC added to `level`, the
    // direction (0 left, 1 top), and the block's reconstructed DC stored.
    int pred_dc(int n, int mx, int my, int level, int* dir) {
        int scale = n < 4 ? y_dc_scale(qscale) : c_dc_scale(qscale);
        int wrap = n < 4 ? ys : cs;
        int16_t* d = dc_at(n, mx, my);
        int a = d[-1], b = d[-1 - wrap], c = d[-wrap];
        int pred;
        if (std::abs(a - b) < std::abs(b - c)) {
            pred = c;
            *dir = 1;
        } else {
            pred = a;
            *dir = 0;
        }
        pred = (pred + (scale >> 1)) / scale;
        level += pred;
        int rec = level * scale;
        if (rec & ~2047) rec = rec < 0 ? 0 : 2047;
        d[0] = (int16_t)rec;
        return level;
    }

    void pred_ac(int16_t* blk, int n, int mx, int my, int dir, int ac_pred) {
        int16_t* a = ac_at(n, mx, my);
        if (ac_pred) {
            if (dir == 0) {
                const int16_t* l = a - 16;
                int lq = mx > 0 ? qtab[(size_t)my * mb_w + mx - 1] : qscale;
                if (mx == 0 || lq == qscale || n == 1 || n == 3) {
                    for (int i = 1; i < 8; i++) blk[i << 3] += l[i];
                } else {
                    for (int i = 1; i < 8; i++) blk[i << 3] += rounded_div(l[i] * lq, qscale);
                }
            } else {
                int wrap = n < 4 ? ys : cs;
                const int16_t* t = a - 16 * wrap;
                int tq = my > 0 ? qtab[(size_t)(my - 1) * mb_w + mx] : qscale;
                if (my == 0 || tq == qscale || n == 2 || n == 3) {
                    for (int i = 1; i < 8; i++) blk[i] += t[i + 8];
                } else {
                    for (int i = 1; i < 8; i++) blk[i] += rounded_div(t[i + 8] * tq, qscale);
                }
            }
        }
        for (int i = 1; i < 8; i++) a[i] = blk[i << 3];
        for (int i = 1; i < 8; i++) a[8 + i] = blk[i];
    }

    static int rounded_div(int a, int b) { return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b; }

    void clean_intra(int mx, int my) {
        for (int n = 0; n < 6; n++) {
            *dc_at(n, mx, my) = 1024;
            std::memset(ac_at(n, mx, my), 0, 16 * sizeof(int16_t));
        }
    }

    // ---------------------------------------------------------- blocks

    int intra_dc(Bits& b, int n) {
        const Tables& t = tables();
        int size = (n < 4 ? t.dc_lum : t.dc_chrom).get(b, "intra DC size");
        if (!size) return 0;
        int v = (int)b.get(size);
        if (!(v >> (size - 1))) v -= (1 << size) - 1;
        if (size > 8) b.marker("after intra DC");
        return v;
    }

    // FFmpeg's mpeg4_decode_block for H.263 quantisation: intra levels stay
    // quantised (dequantised later), inter levels are dequantised here.
    void decode_block(Bits& b, int16_t* blk, int n, int coded, int intra, int mx, int my,
                      int ac_pred, int use_dc_vlc) {
        const Tables& t = tables();
        int i, dir = 0, qmul, qadd;
        const uint8_t* scan;
        const RunLevel* rl;
        if (intra) {
            if (use_dc_vlc) {
                blk[0] = (int16_t)pred_dc(n, mx, my, intra_dc(b, n), &dir);
                i = 0;
            } else {
                i = -1;
                pred_dc(n, mx, my, 0, &dir);
            }
            rl = &t.intra;
            scan = ac_pred ? (dir == 0 ? kAltV : kAltH) : kZigzag;
            qmul = 1;
            qadd = 0;
        } else {
            i = -1;
            rl = &t.inter;
            scan = kZigzag;
            qmul = qscale << 1;
            qadd = (qscale - 1) | 1;
        }
        if (coded) {
            while (true) {
                int code = rl->vlc.get(b, "TCOEF");
                int run, level, last;
                if (code == 102) {  // escape
                    if (b.get1() == 0) {  // first escape: level offset
                        code = rl->vlc.get(b, "TCOEF");
                        if (code == 102) throw Corrupt("escape inside an escape");
                        run = rl->run[code];
                        last = rl->last[code];
                        level = (rl->level[code] + rl->max_level[last][run]) * qmul + qadd;
                        if (b.get1()) level = -level;
                    } else if (b.get1() == 0) {  // second escape: run offset
                        code = rl->vlc.get(b, "TCOEF");
                        if (code == 102) throw Corrupt("escape inside an escape");
                        last = rl->last[code];
                        run = rl->run[code] + rl->max_run[last][rl->level[code]] + 1;
                        level = rl->level[code] * qmul + qadd;
                        if (b.get1()) level = -level;
                    } else {  // third escape: fixed-length
                        last = b.get1();
                        run = b.get(6);
                        b.marker("in a third escape");
                        level = b.sbits(12);
                        b.marker("in a third escape");
                        level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
                        if ((unsigned)(level + 2048) > 4095) level = level < 0 ? -2048 : 2047;
                    }
                } else {
                    run = rl->run[code];
                    last = rl->last[code];
                    level = rl->level[code] * qmul + qadd;
                    if (b.get1()) level = -level;
                }
                i += run + 1;
                if (i > 63) throw Corrupt("more than 64 coefficients in a block");
                blk[scan[i]] = (int16_t)level;
                if (last) break;
            }
        }
        if (intra) {
            if (!use_dc_vlc) {
                blk[0] = (int16_t)pred_dc(n, mx, my, blk[0], &dir);
                if (i < 0) i = 0;
            }
            pred_ac(blk, n, mx, my, dir, ac_pred);
            if (ac_pred) i = 63;
        }
        last_index[n] = i;
    }

    // ------------------------------------------------------- pictures

    uint8_t* dest(int p, int mx, int my, int n) {
        if (p == 0) return cur[0].at(mx * 16 + (n & 1) * 8, my * 16 + (n >> 1) * 8);
        return cur[p].at(mx * 8, my * 8);
    }

    void put_intra(int mx, int my) {
        int ysc = y_dc_scale(qscale), csc = c_dc_scale(qscale);
        int qmul = qscale << 1, qadd = (qscale - 1) | 1;
        for (int n = 0; n < 6; n++) {
            int16_t* blk = block[n];
            blk[0] = (int16_t)(blk[0] * (n < 4 ? ysc : csc));
            for (int k = 1; k < 64; k++) {
                int v = blk[k];
                if (v) blk[k] = (int16_t)(v < 0 ? v * qmul - qadd : v * qmul + qadd);
            }
            int p = n < 4 ? 0 : n - 3;
            idct_put(dest(p, mx, my, n), cur[p].w, blk);
        }
    }

    // the reference block at (x, y) of w x h (+1 each way for half-pel),
    // read with coordinates clamped to the coded picture
    const uint8_t* ref_block(int p, int x, int y, int w, int h, int* ls) {
        Plane& r = ref[p];
        if (x >= 0 && y >= 0 && x + w <= r.w && y + h <= r.h) {
            *ls = r.w;
            return r.at(x, y);
        }
        emu.resize((size_t)w * h);
        for (int j = 0; j < h; j++) {
            int yy = std::min(std::max(y + j, 0), r.h - 1);
            for (int i = 0; i < w; i++) {
                int xx = std::min(std::max(x + i, 0), r.w - 1);
                emu[(size_t)j * w + i] = r.px[(size_t)yy * r.w + xx];
            }
        }
        *ls = w;
        return emu.data();
    }

    void motion(int mx, int my, int vx, int vy) {
        int dxy = ((vy & 1) << 1) | (vx & 1);
        int sx = mx * 16 + (vx >> 1), sy = my * 16 + (vy >> 1);
        int ls;
        const uint8_t* s = ref_block(0, sx, sy, 17, 17, &ls);
        hpel(cur[0].at(mx * 16, my * 16), cur[0].w, s, ls, 16, 16, dxy, no_rounding);
        int uvdxy = dxy | (vy & 2) | ((vx & 2) >> 1);
        for (int p = 1; p < 3; p++) {
            s = ref_block(p, sx >> 1, sy >> 1, 9, 9, &ls);
            hpel(cur[p].at(mx * 8, my * 8), cur[p].w, s, ls, 8, 8, uvdxy, no_rounding);
        }
    }

    int decode_mv(Bits& b, int pred) {
        int code = tables().mv.get(b, "motion vector");
        if (!code) return pred;
        int sign = b.get1();
        int shift = f_code - 1, val = code;
        if (shift) {
            val = (val - 1) << shift;
            val |= (int)b.get(shift);
            val++;
        }
        if (sign) val = -val;
        val += pred;
        int bits = 5 + f_code;
        val = (int)((unsigned)val << (32 - bits)) >> (32 - bits);
        return val;
    }

    int16_t* mv_at(int mx, int my) { return &mvs[((size_t)(my + 1) * cs + mx + 1) * 2]; }

    void pred_mv(int mx, int my, int* px, int* py) {
        const int16_t* a = mv_at(mx - 1, my);
        if (my == 0) {
            *px = mx == 0 ? 0 : a[0];
            *py = mx == 0 ? 0 : a[1];
            return;
        }
        const int16_t* bb = mv_at(mx, my - 1);
        const int16_t* c = mv_at(mx + 1, my - 1);
        auto mid = [](int x, int y, int z) {
            return std::max(std::min(x, y), std::min(std::max(x, y), z));
        };
        *px = mid(a[0], bb[0], c[0]);
        *py = mid(a[1], bb[1], c[1]);
    }

    void set_qscale(int q) { qscale = std::min(std::max(q, 1), 31); }

    void decode_mb(Bits& b, int mx, int my) {
        const Tables& t = tables();
        int cbpc, intra = 0, dquant;
        int16_t* mv = mv_at(mx, my);
        if (pict_type == 1) {
            do {
                if (b.get1()) {  // not_coded: the reference copied
                    mv[0] = mv[1] = 0;
                    qtab[(size_t)my * mb_w + mx] = (int8_t)qscale;
                    motion(mx, my, 0, 0);
                    clean_intra(mx, my);
                    return;
                }
                cbpc = t.inter_mcbpc.get(b, "MCBPC");
            } while (cbpc == 20);
            if (cbpc > 20 && cbpc < 24) throw Corrupt("invalid MCBPC code");
            dquant = cbpc & 8;
            intra = (cbpc & 4) != 0;
            if (!intra && (cbpc & 16)) throw Refused("inter4v macroblocks (four motion vectors)");
        } else {
            do {
                cbpc = t.intra_mcbpc.get(b, "MCBPC");
            } while (cbpc == 8);
            dquant = cbpc & 4;
            intra = 1;
        }
        std::memset(block, 0, sizeof(block));
        if (intra) {
            int ac_pred = b.get1();
            int cbpy = t.cbpy.get(b, "CBPY");
            int cbp = (cbpc & 3) | (cbpy << 2);
            int use_dc_vlc = qscale < dc_thr;
            if (dquant) set_qscale(qscale + kDquant[b.get(2)]);
            qtab[(size_t)my * mb_w + mx] = (int8_t)qscale;
            for (int n = 0; n < 6; n++) {
                decode_block(b, block[n], n, cbp & 32, 1, mx, my, ac_pred, use_dc_vlc);
                cbp += cbp;
            }
            mv[0] = mv[1] = 0;
            b.check();
            put_intra(mx, my);
            return;
        }
        int cbpy = t.cbpy.get(b, "CBPY") ^ 0x0f;
        int cbp = (cbpc & 3) | (cbpy << 2);
        if (dquant) set_qscale(qscale + kDquant[b.get(2)]);
        qtab[(size_t)my * mb_w + mx] = (int8_t)qscale;
        int px, py;
        pred_mv(mx, my, &px, &py);
        int vx = decode_mv(b, px);
        int vy = decode_mv(b, py);
        mv[0] = (int16_t)vx;
        mv[1] = (int16_t)vy;
        for (int n = 0; n < 6; n++) {
            decode_block(b, block[n], n, cbp & 32, 0, mx, my, 0, 0);
            cbp += cbp;
        }
        b.check();
        motion(mx, my, vx, vy);
        clean_intra(mx, my);
        for (int n = 0; n < 6; n++) {
            if (last_index[n] < 0) continue;
            int p = n < 4 ? 0 : n - 3;
            idct_add(dest(p, mx, my, n), cur[p].w, block[n]);
        }
    }

    // -------------------------------------------------------------- VOP

    // 1: a picture decoded into cur (and kept as the reference), 0: none
    int decode_vop(Bits& b) {
        int type = b.get(2);
        if (type == 2) throw Refused("B-VOPs (bidirectional prediction)");
        if (type == 3) throw Refused("S-VOPs (sprites and global motion compensation)");
        while (b.get1()) {
        }  // modulo_time_base
        b.marker("before vop_time_increment");
        b.skip(time_inc_bits);
        b.marker("before vop_coded");
        if (!b.get1()) return 0;  // not coded: FFmpeg outputs no picture
        pict_type = type;
        no_rounding = type == 1 ? b.get1() : 0;
        dc_thr = kDcThreshold[b.get(3)];
        qscale = (int)b.get(quant_precision);
        if (!qscale) throw Corrupt("vop_quant 0");
        f_code = 1;
        if (type == 1) {
            f_code = b.get(3);
            if (!f_code) throw Corrupt("vop_fcode_forward 0");
        }
        b.check();
        if (type == 1 && !have_ref) {  // FFmpeg predicts from a grey picture
            for (int p = 0; p < 3; p++) std::fill(ref[p].px.begin(), ref[p].px.end(), 128);
            have_ref = true;
        }
        for (int my = 0; my < mb_h; my++)
            for (int mx = 0; mx < mb_w; mx++) decode_mb(b, mx, my);
        for (int p = 0; p < 3; p++) std::swap(cur[p].px, ref[p].px);
        have_ref = true;
        return 1;
    }

    // the reference picture (just decoded) as BGR24, swscale's unscaled
    // YUV420P -> BGR24 arithmetic at limited range (ffmpeg_dsp.h)
    void to_bgr(uint8_t* out) const {
        ffdsp::yuv2bgr24(ref[0].px.data(), ref[0].w, ref[1].px.data(), ref[2].px.data(),
                         ref[1].w, width, height, 1, false, out);
    }

    int decode(const uint8_t* data, size_t n, int* info) {
        long at = headers(data, n);
        info[0] = width;
        info[1] = height;
        info[2] = -1;
        if (at < 0) return 0;
        if (!have_vol) throw Corrupt("a VOP before any VOL header");
        check_tag();
        size_t start = (size_t)at / 8;
        pad.assign(data + start, data + n);
        pad.resize(pad.size() + 8, 0);
        Bits b{pad.data(), n - start};
        int got = decode_vop(b);
        info[2] = pict_type;
        have_picture = have_picture || got;
        return got;
    }

    void flush() {
        have_ref = false;
        have_picture = false;
    }
};

void set_err(char* err, int errlen, const char* msg) {
    if (err && errlen > 0) std::snprintf(err, (size_t)errlen, "%s", msg);
}

}  // namespace

extern "C" {

void* crt_mpeg4_create() { return new Decoder(); }

// Takes the headers carried outside the packets (an MP4 esds
// DecoderSpecificInfo, or the bytes before an AVI stream's first VOP: VOS,
// VO, VOL, user data; may be empty) and the container's codec tag.
// 0, or -1 / -2 as crt_mpeg4_decode.
int crt_mpeg4_config(void* h, const uint8_t* extra, long n, const char* tag, char* err,
                     int errlen) {
    Decoder* d = static_cast<Decoder*>(h);
    try {
        d->tag = tag ? tag : "";
        std::string t = d->tag;
        for (char& c : t) c = (char)std::toupper((unsigned char)c);
        if (t == "3IV1" || t == "3IV2") throw Refused("3ivx streams (codec tag " + d->tag + ")");
        d->tag_needs_user_data = t == "XVID" || t == "XVIX" || t == "RMP4" || t == "ZMP4" ||
                                 t == "SIPP" || t == "DIVX";
        if (n > 0 && d->headers(extra, (size_t)n) >= 0)
            throw Corrupt("a VOP in the decoder configuration");
        if (d->have_vol) d->check_tag();
        return 0;
    } catch (const Refused& e) {
        set_err(err, errlen, e.what());
        return -2;
    } catch (const std::exception& e) {
        set_err(err, errlen, e.what());
        return -1;
    }
}

// Decodes one packet: 1 a picture (the new reference), 0 none (headers
// only, or a VOP that is not coded), -1 the data does not decode, -2 a
// feature the decoder refuses.  info: width, height, VOP type (0 I, 1 P,
// -1 none).
int crt_mpeg4_decode(void* h, const uint8_t* data, long n, int* info, char* err, int errlen) {
    Decoder* d = static_cast<Decoder*>(h);
    try {
        return d->decode(data, (size_t)n, info);
    } catch (const Refused& e) {
        set_err(err, errlen, e.what());
        return -2;
    } catch (const std::exception& e) {
        set_err(err, errlen, e.what());
        return -1;
    }
}

// The last picture decoded as BGR24 into out (height x width x 3 bytes):
// 0, or -1 when there is none or out has another size.
int crt_mpeg4_bgr(void* h, uint8_t* out, long size) {
    Decoder* d = static_cast<Decoder*>(h);
    if (!d->have_picture || size != (long)d->width * d->height * 3) return -1;
    d->to_bgr(out);
    return 0;
}

// Forgets the reference picture (avcodec_flush_buffers).
void crt_mpeg4_flush(void* h) { static_cast<Decoder*>(h)->flush(); }

void crt_mpeg4_destroy(void* h) { delete static_cast<Decoder*>(h); }

}  // extern "C"
