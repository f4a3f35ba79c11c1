// H.264 (ISO/IEC 14496-10) Main and High profile video decoded on the
// host, as FFmpeg's `h264` decoder decodes it for OpenCV's VideoCapture,
// and each picture, cropped, converted to BGR24 as swscale's unscaled
// YUV420P (or, with video_full_range_flag, YUVJ420P) -> BGR24 path
// converts it.
//
// What is decoded: CAVLC and CABAC, I, P and B slices, 4:2:0 8-bit
// progressive frames; several slices a picture, in order; the 4x4 and 8x8
// transforms with flat, default or transmitted scaling matrices (SPS and
// PPS lists under fall-back rules A and B) and a chroma QP offset for each
// of Cb and Cr; Intra4x4, Intra8x8,
// Intra16x16, I_PCM, the P partitions down to 4x4 and every B mb_type and
// sub_mb_type (B_Skip, B_Direct_16x16 and B_8x8 with direct sub-blocks);
// spatial and temporal direct prediction with direct_8x8_inference_flag 0
// or 1; quarter-pel luma and eighth-pel chroma motion compensation with
// edge clamping; explicit weighted prediction of P slices and default,
// explicit and implicit weighted bi-prediction of B slices; the in-loop
// deblocking filter (bS of blocks with two motions as FFmpeg's check_mv
// compares them); short-term reference pictures, B pictures among them,
// under the sliding window and MMCO 1, with modification of both lists;
// POC types 0 and 2; FFmpeg's output order and delay (has_b_frames, the
// demuxer's video delay to start from, num_reorder_frames and its POC and
// B-picture heuristics) and where it starts to show pictures (an IDR
// picture, a recovery point SEI, or an I picture with few references; a
// stream that starts on a P picture predicts from grey pictures, as
// FFmpeg's frame_num gap concealment makes them); temporal direct maps the
// co-located picture's refIdx through its first slice's lists, as FFmpeg
// under frame threads (OpenCV's) does.  The samples are those the standard
// specifies (H.264 decoding is exact), so any conforming decoder gives the
// same planes.  Everything else (SP and SI slices, field pictures and
// MBAFF, slice groups, arbitrary slice order, redundant pictures,
// monochrome and the other chroma formats, bit depths above 8, lossless
// macroblocks, long-term references in either list, MMCO 2-6, POC type 1,
// frame_num gaps inside a stream, constrained intra prediction, data
// partitioning) is refused by name.  There is no concealment: a slice that
// does not decode raises.
//
// C interface (ctypes): crt_h264_create, crt_h264_config (the parameter
// sets carried outside the packets, and the NAL length size),
// crt_h264_probe (checks a packet's parameter sets and slice headers
// without decoding), crt_h264_set_delay and crt_h264_delay (the output
// delay to start with, and the one reached), crt_h264_decode (one packet),
// crt_h264_drain (the pictures held back, at the end), crt_h264_bgr (the
// last picture given, as BGR24), crt_h264_flush, crt_h264_destroy.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <climits>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

#include "ffmpeg_dsp.h"
#include "h264_cabac_tables.h"

namespace {

struct Corrupt : std::runtime_error {
    using std::runtime_error::runtime_error;
};
struct Refused : std::runtime_error {
    using std::runtime_error::runtime_error;
};

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }
inline uint8_t clip1(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// ------------------------------------------------------------------ tables

// Table 9-5 (coeff_token), by nC class, indexed TotalCoeff * 4 + TrailingOnes
const uint8_t kTokenLen[3][68] = {
    {1, 0, 0, 0, 6, 2, 0, 0, 8, 6, 3, 0, 9, 8, 7, 5, 10, 9, 8, 6, 11, 10, 9, 7, 13, 11, 10, 8,
     13, 13, 11, 9, 13, 13, 13, 10, 14, 14, 13, 11, 14, 14, 14, 13, 15, 15, 14, 14, 15, 15,
     15, 14, 16, 15, 15, 15, 16, 16, 16, 15, 16, 16, 16, 16, 16, 16, 16, 16},
    {2, 0, 0, 0, 6, 2, 0, 0, 6, 5, 3, 0, 7, 6, 6, 4, 8, 6, 6, 4, 8, 7, 7, 5, 9, 8, 8, 6,
     11, 9, 9, 6, 11, 11, 11, 7, 12, 11, 11, 9, 12, 12, 12, 11, 12, 12, 12, 11, 13, 13, 13,
     12, 13, 13, 13, 13, 13, 14, 13, 13, 14, 14, 14, 13, 14, 14, 14, 14},
    {4, 0, 0, 0, 6, 4, 0, 0, 6, 5, 4, 0, 6, 5, 5, 4, 7, 5, 5, 4, 7, 5, 5, 4, 7, 6, 6, 4,
     7, 6, 6, 4, 8, 7, 7, 5, 8, 8, 7, 6, 9, 8, 8, 7, 9, 9, 8, 8, 9, 9, 9, 8, 10, 9, 9, 9,
     10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10}};
const uint8_t kTokenBits[3][68] = {
    {1, 0, 0, 0, 5, 1, 0, 0, 7, 4, 1, 0, 7, 6, 5, 3, 7, 6, 5, 3, 7, 6, 5, 4, 15, 6, 5, 4,
     11, 14, 5, 4, 8, 10, 13, 4, 15, 14, 9, 4, 11, 10, 13, 12, 15, 14, 9, 12, 11, 10, 13, 8,
     15, 1, 9, 12, 11, 14, 13, 8, 7, 10, 9, 12, 4, 6, 5, 8},
    {3, 0, 0, 0, 11, 2, 0, 0, 7, 7, 3, 0, 7, 10, 9, 5, 7, 6, 5, 4, 4, 6, 5, 6, 7, 6, 5, 8,
     15, 6, 5, 4, 11, 14, 13, 4, 15, 10, 9, 4, 11, 14, 13, 12, 8, 10, 9, 8, 15, 14, 13, 12,
     11, 10, 9, 12, 7, 11, 6, 8, 9, 8, 10, 1, 7, 6, 5, 4},
    {15, 0, 0, 0, 15, 14, 0, 0, 11, 15, 13, 0, 8, 12, 14, 12, 15, 10, 11, 11, 11, 8, 9, 10,
     9, 14, 13, 9, 8, 10, 9, 8, 15, 14, 13, 13, 11, 14, 10, 12, 15, 10, 13, 12, 11, 14, 9, 12,
     8, 10, 13, 8, 13, 7, 9, 12, 9, 12, 11, 10, 5, 8, 7, 6, 1, 4, 3, 2}};
const uint8_t kDcTokenLen[20] = {2, 0, 0, 0, 6, 1, 0, 0, 6, 6, 3, 0, 6, 7, 7, 6, 6, 8, 8, 7};
const uint8_t kDcTokenBits[20] = {1, 0, 0, 0, 7, 1, 0, 0, 4, 6, 1, 0, 3, 3, 2, 5, 2, 3, 2, 0};
// Tables 9-7 and 9-8 (total_zeros, 4x4 blocks), by TotalCoeff - 1
const uint8_t kZerosLen[15][16] = {
    {1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9}, {3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6},
    {4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6}, {5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5},
    {4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5}, {6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6},
    {6, 5, 3, 3, 3, 2, 3, 4, 3, 6}, {6, 4, 5, 3, 2, 2, 3, 3, 6}, {6, 6, 4, 2, 2, 3, 2, 5},
    {5, 5, 3, 2, 2, 2, 4}, {4, 4, 3, 3, 1, 3}, {4, 4, 2, 1, 3}, {3, 3, 1, 2}, {2, 2, 1}, {1, 1}};
const uint8_t kZerosBits[15][16] = {
    {1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1}, {7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0},
    {5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0}, {3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0},
    {5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0}, {1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0},
    {1, 1, 5, 4, 3, 3, 2, 1, 1, 0}, {1, 1, 1, 3, 3, 2, 2, 1, 0}, {1, 0, 1, 3, 2, 1, 1, 1},
    {1, 0, 1, 3, 2, 1, 1}, {0, 1, 1, 2, 1, 3}, {0, 1, 1, 1, 1}, {0, 1, 1, 1}, {0, 1, 1}, {0, 1}};
// Table 9-9 (a): total_zeros of chroma DC 2x2
const uint8_t kDcZerosLen[3][4] = {{1, 2, 3, 3}, {1, 2, 2}, {1, 1}};
const uint8_t kDcZerosBits[3][4] = {{1, 1, 1, 0}, {1, 1, 0}, {1, 0}};
// Table 9-10 (run_before), by min(zerosLeft, 7) - 1
const uint8_t kRunLen[7][16] = {{1, 1}, {1, 2, 2}, {2, 2, 2, 2}, {2, 2, 2, 3, 3},
                                {2, 2, 3, 3, 3, 3}, {2, 3, 3, 3, 3, 3, 3},
                                {3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11}};
const uint8_t kRunBits[7][16] = {{1, 0}, {1, 1, 0}, {3, 2, 1, 0}, {3, 2, 1, 1, 0},
                                 {3, 2, 3, 2, 1, 0}, {3, 0, 1, 3, 2, 5, 4},
                                 {7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1}};
// Table 9-4: coded_block_pattern from codeNum (Intra_4x4, Inter)
const uint8_t kIntraCbp[48] = {47, 31, 15, 0,  23, 27, 29, 30, 7,  11, 13, 14, 39, 43, 45, 46,
                               16, 3,  5,  10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1,  2,  4,
                               8,  17, 18, 20, 24, 6,  9,  22, 25, 32, 33, 34, 36, 40, 38, 41};
const uint8_t kInterCbp[48] = {0,  16, 1,  2,  4,  8,  32, 3,  5,  10, 12, 15, 47, 7,  11, 13,
                               14, 6,  9,  31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
                               17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
// the 8x8 frame zigzag scan (8.5.7): scan position -> raster (y * 8 + x)
const uint8_t kZigzag8[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                              12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                              35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                              58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
// normAdjust4x4 (8-315): v[m][0] at (even, even), [1] at (odd, odd), [2] else
const int kNormAdjust[6][3] = {{10, 16, 13}, {11, 18, 14}, {13, 20, 16},
                               {14, 23, 18}, {16, 25, 20}, {18, 29, 23}};
// normAdjust8x8 (8-318): v[m][0..5] by the position class of (x, y)
const int kNormAdjust8[6][6] = {{20, 18, 32, 19, 25, 24}, {22, 19, 35, 21, 28, 26},
                                {26, 23, 42, 24, 33, 31}, {28, 25, 45, 26, 35, 33},
                                {32, 28, 51, 30, 40, 38}, {36, 32, 58, 34, 46, 43}};
// Tables 7-3 and 7-4: Default_4x4_Intra/Inter and Default_8x8_Intra/Inter
// (raster order)
const uint8_t kDefault4[2][16] = {{6, 13, 20, 28, 13, 20, 28, 32, 20, 28, 32, 37, 28, 32, 37, 42},
                                  {10, 14, 20, 24, 14, 20, 24, 27, 20, 24, 27, 30, 24, 27, 30, 34}};
const uint8_t kDefault8[2][64] = {
    {6,  10, 13, 16, 18, 23, 25, 27, 10, 11, 16, 18, 23, 25, 27, 29, 13, 16, 18, 23, 25, 27,
     29, 31, 16, 18, 23, 25, 27, 29, 31, 33, 18, 23, 25, 27, 29, 31, 33, 36, 23, 25, 27, 29,
     31, 33, 36, 38, 25, 27, 29, 31, 33, 36, 38, 40, 27, 29, 31, 33, 36, 38, 40, 42},
    {9,  13, 15, 17, 19, 21, 22, 24, 13, 13, 17, 19, 21, 22, 24, 25, 15, 17, 19, 21, 22, 24,
     25, 27, 17, 19, 21, 22, 24, 25, 27, 28, 19, 21, 22, 24, 25, 27, 28, 30, 21, 22, 24, 25,
     27, 28, 30, 32, 22, 24, 25, 27, 28, 30, 32, 33, 24, 25, 27, 28, 30, 32, 33, 35}};
// Table 9-43 (frame-coded blocks): ctxIdxInc of significant_coeff_flag and
// last_significant_coeff_flag of an 8x8 block, by scan position
const uint8_t kSig8[63] = {0,  1,  2,  3,  4,  5,  5,  4,  4,  3,  3,  4,  4,  4,  5,  5,
                           4,  4,  4,  4,  3,  3,  6,  7,  7,  7,  8,  9,  10, 9,  8,  7,
                           7,  6,  11, 12, 13, 11, 6,  7,  8,  9,  14, 10, 9,  8,  6,  11,
                           12, 13, 11, 6,  9,  14, 10, 9,  11, 12, 13, 11, 14, 10, 12};
const uint8_t kLast8[63] = {0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2,
                            2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 4, 4,
                            4, 4, 4, 4, 4, 4, 5, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7, 8, 8, 8};
// Table 8-15: QPc from qPI 30..51
const uint8_t kChromaQp[22] = {29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36,
                               36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39};
// Table 8-16 (alpha', beta' from indexA/indexB 16..51) and 8-17 (tC0)
const uint8_t kAlpha[52] = {0,  0,  0,  0,  0,  0,  0,  0,  0,   0,   0,   0,   0,
                            0,  0,  0,  4,  4,  5,  6,  7,  8,   9,   10,  12,  13,
                            15, 17, 20, 22, 25, 28, 32, 36, 40,  45,  50,  56,  63,
                            71, 80, 90, 101, 113, 127, 144, 162, 182, 203, 226, 255, 255};
const uint8_t kBeta[52] = {0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,  0,  2,  2,
                           2, 3, 3, 3, 3, 4, 4, 4, 6,  6,  7,  7,  8,  8,  9,  9,  10, 10,
                           11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18};
const uint8_t kTc0[52][3] = {
    {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},    {0, 0, 0},    {0, 0, 0},
    {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},    {0, 0, 0},    {0, 0, 0},
    {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},    {0, 0, 0},    {0, 0, 1},
    {0, 0, 1},   {0, 0, 1},   {0, 0, 1},   {0, 1, 1},    {0, 1, 1},    {1, 1, 1},
    {1, 1, 1},   {1, 1, 1},   {1, 1, 1},   {1, 1, 2},    {1, 1, 2},    {1, 1, 2},
    {1, 1, 2},   {1, 2, 3},   {1, 2, 3},   {2, 2, 3},    {2, 2, 4},    {2, 3, 4},
    {2, 3, 4},   {3, 3, 5},   {3, 4, 6},   {3, 4, 6},    {4, 5, 7},    {4, 5, 8},
    {4, 6, 9},   {5, 7, 10},  {6, 8, 11},  {6, 8, 13},   {7, 10, 14},  {8, 11, 16},
    {9, 12, 18}, {10, 13, 20}, {11, 15, 23}, {13, 17, 25}};

// (x, y) in 4x4 units of luma4x4BlkIdx, and its inverse
const uint8_t kBlkX[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
const uint8_t kBlkY[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};
const uint8_t kBlkIdx[16] = {0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15};  // raster

// A prefix code decoded by a lookup on 16 peeked bits: value, length
struct Vlc {
    std::vector<uint16_t> lut;  // (value << 5) | length; length 0: no code
    int bits = 16;
    void add(int len, int code, int value) {
        if (!len) return;
        const int shift = bits - len;
        for (int i = 0; i < (1 << shift); i++)
            lut[(code << shift) | i] = (uint16_t)(value << 5 | len);
    }
    explicit Vlc(int nbits) : lut((size_t)1 << nbits, 0), bits(nbits) {}
};

struct Tables {
    Vlc token[3] = {Vlc(16), Vlc(16), Vlc(16)};
    Vlc dc_token{8};
    std::vector<Vlc> zeros, dc_zeros, run;
    int chroma_qp[52 + 24];  // QPc of qPI + 12 (qPI -12..63 before clipping)
    Tables() {
        for (int k = 0; k < 3; k++)
            for (int i = 0; i < 68; i++)
                if ((i & 3) <= (i >> 2)) token[k].add(kTokenLen[k][i], kTokenBits[k][i], i);
        for (int i = 0; i < 20; i++)
            if ((i & 3) <= (i >> 2)) dc_token.add(kDcTokenLen[i], kDcTokenBits[i], i);
        for (int t = 0; t < 15; t++) {
            zeros.emplace_back(9);
            for (int z = 0; z < 16 - t; z++) zeros.back().add(kZerosLen[t][z], kZerosBits[t][z], z);
        }
        for (int t = 0; t < 3; t++) {
            dc_zeros.emplace_back(3);
            for (int z = 0; z < 4 - t; z++)
                dc_zeros.back().add(kDcZerosLen[t][z], kDcZerosBits[t][z], z);
        }
        for (int t = 0; t < 7; t++) {
            run.emplace_back(11);
            for (int r = 0; r < (t < 6 ? t + 2 : 15); r++)
                run.back().add(kRunLen[t][r], kRunBits[t][r], r);
        }
        for (int i = 0; i < 52 + 24; i++) {
            int q = clip3(0, 51, i - 12);
            chroma_qp[i] = q < 30 ? q : kChromaQp[q - 30];
        }
    }
};

const Tables& tables() {
    static const Tables t;
    return t;
}

// ------------------------------------------------------------------ bits

struct Bits {
    const uint8_t* buf;  // padded with 8 zero bytes past `bytes`
    size_t bytes;
    size_t pos = 0;   // in bits
    size_t stop = 0;  // the rbsp_stop_one_bit's position (bytes * 8 when none)

    Bits(const uint8_t* b, size_t n) : buf(b), bytes(n) {
        stop = n * 8;
        for (size_t i = n; i-- > 0;)
            if (b[i]) {
                stop = i * 8 + 7 - (size_t)__builtin_ctz(b[i]);
                break;
            }
    }
    uint32_t show(int n) const {  // 0 < n <= 32
        uint64_t v;
        std::memcpy(&v, buf + std::min(pos >> 3, bytes), 8);
        v = __builtin_bswap64(v) << (pos & 7);
        return (uint32_t)(v >> (64 - n));
    }
    void skip(int n) {
        pos += n;
        if (pos > bytes * 8) throw Corrupt("read past the end of a NAL unit");
    }
    uint32_t u(int n) {
        if (!n) return 0;
        uint32_t v = show(n);
        skip(n);
        return v;
    }
    bool u1() { return u(1) != 0; }
    uint32_t ue() {
        int zeros = 0;
        while (!u1()) {
            if (++zeros > 31) throw Corrupt("an Exp-Golomb code longer than 32 bits");
        }
        return zeros ? (uint32_t)(((uint64_t)1 << zeros) - 1 + u(zeros)) : 0;
    }
    int se() {
        uint32_t k = ue();
        return k & 1 ? (int)((k + 1) >> 1) : -(int)(k >> 1);
    }
    int vlc(const Vlc& t) {
        uint32_t e = t.lut[show(t.bits)];
        if (!(e & 31)) throw Corrupt("an invalid variable-length code");
        skip(e & 31);
        return (int)(e >> 5);
    }
    bool more_rbsp_data() const { return pos < stop; }
    void align() { pos = (pos + 7) & ~(size_t)7; }
};

uint32_t ue_max(Bits& b, uint32_t top, const char* what) {
    uint32_t v = b.ue();
    if (v > top) throw Corrupt(std::string(what) + " out of range");
    return v;
}

// ---------------------------------------------------------- parameter sets

struct Sps {
    bool valid = false;
    int profile = 0, level = 0;
    int log2_max_frame_num = 4, poc_type = 0, log2_max_poc_lsb = 4;
    int max_refs = 0;
    bool gaps_allowed = false;
    int mb_w = 0, mb_h = 0;
    int crop_l = 0, crop_r = 0, crop_t = 0, crop_b = 0;  // luma samples
    bool full_range = false, restriction = false;
    bool direct8x8 = true;  // direct_8x8_inference_flag
    int num_reorder_frames = 0;
    // the scaling lists (raster order): 4x4 Intra Y, Cb, Cr, Inter Y, Cb,
    // Cr; 8x8 Intra Y, Inter Y (Flat_16 without seq_scaling_matrix_present_flag)
    bool scaling = false;
    uint8_t scale4[6][16], scale8[2][64];
    // whether FFmpeg reads a PPS's fields past redundant_pic_cnt_present_flag
    // (not under Baseline, Main or Extended with constraint_set0, 1 or 2)
    bool pps_ext = true;
    Sps() {
        std::memset(scale4, 16, sizeof(scale4));
        std::memset(scale8, 16, sizeof(scale8));
    }
};

struct Pps {
    bool valid = false;
    int sps_id = 0;
    bool bottom_field_poc = false;
    bool cabac = false, weighted = false;
    int bipred = 0;  // weighted_bipred_idc: 0 default, 1 explicit, 2 implicit
    int num_ref_idx_default = 1, num_ref_idx_l1_default = 1;
    int init_qp = 26;
    int chroma_offset[2] = {0, 0};  // chroma_qp_index_offset, second_chroma_qp_index_offset
    bool deblocking_control = false;
    bool transform8 = false;  // transform_8x8_mode_flag
    uint8_t scale4[6][16], scale8[2][64];  // the picture's scaling lists, as Sps's
};

// 7.3.2.1.1.1: one scaling list in zigzag order into `out` (raster): its
// delta_scales, or the default list where the first makes nextScale 0
// (useDefaultScalingMatrixFlag), or `fallback` where the list is absent
void scaling_list(Bits& b, uint8_t* out, int n, const uint8_t* fallback, const uint8_t* dflt) {
    if (!b.u1()) {
        std::memcpy(out, fallback, (size_t)n);
        return;
    }
    int last = 8, next = 8;
    for (int i = 0; i < n; i++) {
        if (next) {
            const int delta = b.se();
            if (delta < -128 || delta > 127) throw Corrupt("delta_scale out of range");
            next = (last + delta + 256) % 256;
            if (i == 0 && next == 0) {
                std::memcpy(out, dflt, (size_t)n);
                return;
            }
        }
        last = out[n == 16 ? kZigzag[i] : kZigzag8[i]] = (uint8_t)(next ? next : last);
    }
}

// The lists of an SPS (fall-back rule A: Default_* for the first of each
// kind) or a PPS (rule B where the SPS has lists: the SPS's, else rule A);
// each later list of a kind falls back to the one before.  `n8`: the 8x8
// lists present (0 or 2).
void scaling_lists(Bits& b, uint8_t (*s4)[16], uint8_t (*s8)[64], int n8, const Sps* seq) {
    const bool rule_b = seq && seq->scaling;
    for (int i = 0; i < 6; i++) {
        const uint8_t* fallback = i == 0 || i == 3 ? (rule_b ? seq->scale4[i] : kDefault4[i / 3])
                                                   : s4[i - 1];
        scaling_list(b, s4[i], 16, fallback, kDefault4[i / 3]);
    }
    for (int i = 0; i < n8; i++)
        scaling_list(b, s8[i], 64, rule_b ? seq->scale8[i] : kDefault8[i], kDefault8[i]);
}

void skip_hrd(Bits& b) {
    uint32_t n = ue_max(b, 31, "cpb_cnt_minus1") + 1;
    b.u(8);
    for (uint32_t i = 0; i < n; i++) {
        b.ue();
        b.ue();
        b.u(1);
    }
    b.u(20);
}

Sps parse_sps(Bits& b, int* id_out) {
    Sps s;
    s.profile = (int)b.u(8);
    const int constraints = (int)b.u(8);
    s.level = (int)b.u(8);
    s.pps_ext = !((s.profile == 66 || s.profile == 77 || s.profile == 88) && (constraints & 0xE0));
    int id = (int)ue_max(b, 31, "seq_parameter_set_id");
    int chroma = 1, depth_y = 8, depth_c = 8;
    const int p = s.profile;
    if (p == 100 || p == 110 || p == 122 || p == 244 || p == 44 || p == 83 || p == 86 ||
        p == 118 || p == 128 || p == 138 || p == 139 || p == 134 || p == 135) {
        chroma = (int)ue_max(b, 3, "chroma_format_idc");
        if (chroma == 3) b.u(1);
        depth_y = (int)b.ue() + 8;
        depth_c = (int)b.ue() + 8;
        const bool bypass = b.u1();
        if (chroma == 0)
            throw Refused("monochrome (chroma_format_idc 0; only 4:2:0, chroma_format_idc 1, "
                          "is decoded)");
        if (chroma != 1) throw Refused("chroma_format_idc " + std::to_string(chroma) +
                                       " (only 4:2:0, chroma_format_idc 1, is decoded)");
        if (depth_y != 8 || depth_c != 8)
            throw Refused("bit depth " + std::to_string(depth_y != 8 ? depth_y : depth_c) +
                          " (only 8-bit samples are decoded)");
        if (bypass)
            throw Refused("lossless macroblocks (qpprime_y_zero_transform_bypass_flag)");
        if ((s.scaling = b.u1())) scaling_lists(b, s.scale4, s.scale8, 2, nullptr);
    }
    s.log2_max_frame_num = (int)ue_max(b, 12, "log2_max_frame_num_minus4") + 4;
    s.poc_type = (int)ue_max(b, 2, "pic_order_cnt_type");
    if (s.poc_type == 0)
        s.log2_max_poc_lsb = (int)ue_max(b, 12, "log2_max_pic_order_cnt_lsb_minus4") + 4;
    else if (s.poc_type == 1)
        throw Refused("pic_order_cnt_type 1 (POC types 0 and 2 are decoded)");
    s.max_refs = (int)ue_max(b, 16, "max_num_ref_frames");
    s.gaps_allowed = b.u1();
    s.mb_w = (int)ue_max(b, 1023, "pic_width_in_mbs_minus1") + 1;
    s.mb_h = (int)ue_max(b, 1023, "pic_height_in_map_units_minus1") + 1;
    if (!b.u1()) {
        if (b.u1())
            throw Refused("MBAFF (mb_adaptive_frame_field_flag 1: field and frame macroblock pairs)");
        throw Refused("field pictures (frame_mbs_only_flag 0)");
    }
    s.direct8x8 = b.u1();
    if (b.u1()) {
        s.crop_l = 2 * (int)b.ue();
        s.crop_r = 2 * (int)b.ue();
        s.crop_t = 2 * (int)b.ue();
        s.crop_b = 2 * (int)b.ue();
        if (s.crop_l + s.crop_r >= 16 * s.mb_w || s.crop_t + s.crop_b >= 16 * s.mb_h)
            throw Corrupt("frame cropping removes the whole picture");
    }
    if (b.u1()) {  // VUI
        if (b.u1() && b.u(8) == 255) b.u(32);  // aspect ratio
        if (b.u1()) b.u(1);                     // overscan
        if (b.u1()) {                           // video signal type
            b.u(3);
            s.full_range = b.u1();
            if (b.u1()) b.u(24);
        }
        if (b.u1()) {  // chroma location
            b.ue();
            b.ue();
        }
        if (b.u1()) b.u(32), b.u(32), b.u(1);  // timing
        bool nal_hrd = b.u1();
        if (nal_hrd) skip_hrd(b);
        bool vcl_hrd = b.u1();
        if (vcl_hrd) skip_hrd(b);
        if (nal_hrd || vcl_hrd) b.u(1);
        b.u(1);  // pic_struct_present_flag
        s.restriction = b.u1();
        if (s.restriction) {
            b.u(1);
            for (int i = 0; i < 4; i++) b.ue();
            s.num_reorder_frames = (int)ue_max(b, 16, "max_num_reorder_frames");
            b.ue();
        }
    }
    s.valid = true;
    *id_out = id;
    return s;
}

Pps parse_pps(Bits& b, const Sps* sps_table, int* id_out) {
    Pps p;
    int id = (int)ue_max(b, 255, "pic_parameter_set_id");
    p.sps_id = (int)ue_max(b, 31, "seq_parameter_set_id");
    if (!sps_table[p.sps_id].valid) throw Corrupt("a PPS names an SPS not received");
    p.cabac = b.u1();
    p.bottom_field_poc = b.u1();
    if (b.ue() > 0) throw Refused("slice groups (FMO, num_slice_groups_minus1 > 0)");
    p.num_ref_idx_default = (int)ue_max(b, 31, "num_ref_idx_l0_default_active_minus1") + 1;
    p.num_ref_idx_l1_default = (int)ue_max(b, 31, "num_ref_idx_l1_default_active_minus1") + 1;
    p.weighted = b.u1();
    p.bipred = (int)b.u(2);
    if (p.bipred == 3) throw Corrupt("weighted_bipred_idc 3");
    p.init_qp = 26 + b.se();
    b.se();
    p.chroma_offset[0] = p.chroma_offset[1] = clip3(-12, 12, b.se());
    p.deblocking_control = b.u1();
    if (b.u1()) throw Refused("constrained_intra_pred (constrained_intra_pred_flag 1)");
    if (b.u1()) throw Refused("redundant pictures (redundant_pic_cnt_present_flag 1)");
    const Sps& seq = sps_table[p.sps_id];
    std::memcpy(p.scale4, seq.scale4, sizeof(p.scale4));
    std::memcpy(p.scale8, seq.scale8, sizeof(p.scale8));
    if (seq.pps_ext && b.more_rbsp_data()) {
        p.transform8 = b.u1();
        if (b.u1()) scaling_lists(b, p.scale4, p.scale8, p.transform8 ? 2 : 0, &seq);
        p.chroma_offset[1] = clip3(-12, 12, b.se());
    }
    if (p.init_qp < 0 || p.init_qp > 51) throw Corrupt("pic_init_qp out of range");
    p.valid = true;
    *id_out = id;
    return p;
}

struct SliceHeader {
    int first_mb = 0, type = 0;  // 0 P, 1 B, 2 I
    int pps_id = 0;
    int frame_num = 0, idr_pic_id = 0, poc_lsb = 0, delta_poc_bottom = 0;
    int nref[2] = {1, 1};           // num_ref_idx_l0_active, num_ref_idx_l1_active
    bool direct_spatial = false;    // direct_spatial_mv_pred_flag
    std::vector<std::pair<int, int>> modifications[2];  // (idc, abs_diff_pic_num_minus1) a list
    std::vector<int> mmco1;                          // difference_of_pic_nums_minus1
    bool adaptive = false;
    int qp = 26;
    int deblock_idc = 0, alpha_offset = 0, beta_offset = 0;
    bool idr = false;
    int ref_idc = 0;
    int cabac_init_idc = 0;
    // explicit weighted prediction (pred_weight_table): log2 denominators,
    // and by list and ref_idx the weight and offset of Y, Cb, Cr
    bool weighted = false;
    int log2_wd[2] = {0, 0};
    int weight[2][16][3] = {}, offset[2][16][3] = {};
};

// ---------------------------------------------------------------- pictures

// What direct prediction reads of a co-located macroblock (8.4.1.2.1):
// whether it is intra, refIdxL0/L1 of each 8x8 block (-1 unused) and the
// motion vectors of each 4x4 block (raster)
struct ColMb {
    bool intra = true;
    int8_t ref[2][4] = {{-1, -1, -1, -1}, {-1, -1, -1, -1}};
    int16_t mv[2][16][2] = {};
};

struct Picture {
    int w = 0, h = 0;  // coded luma size
    std::vector<uint8_t> y, u, v;
    int frame_num = 0, poc = 0, id = 0;
    long tag = -1;  // the packet the picture came in
    bool key = false, mmco_reset = false, recovered = false, full_range = false;
    bool b_type = false;  // its first slice is a B slice (FFmpeg's pict_type)
    int crop_l = 0, crop_r = 0, crop_t = 0, crop_b = 0;
    // as a co-located picture: its macroblocks' motion (kept for reference
    // pictures), and the frame_num of each entry of the lists of its first
    // slice, which name the pictures its refIdx refer to (FFmpeg's
    // ref_poc, which under frame threads, as OpenCV runs it, only the first
    // slice of a picture sets)
    std::vector<ColMb> col;
    int ref_fn[2][16] = {}, ref_cnt[2] = {0, 0};
};
using PicPtr = std::shared_ptr<Picture>;

enum MbKind : int8_t { NONE = 0, SKIP, INTER, I4, I16, PCM };

struct Mb {
    int8_t kind = NONE;
    int slice = -1;
    int qp = 0;  // QPY for deblocking (0 for I_PCM)
    // non-zero coefficients of each 4x4 luma block (raster): with the 8x8
    // transform, CAVLC's TotalCoeff of each interleaved 4x4 block (nC reads
    // it) and CABAC's count of the 8x8 block in each of its four
    uint8_t nz[16] = {};
    bool t8 = false;  // transform_size_8x8_flag
    uint8_t nz8 = 0;  // with it, the 8x8 blocks holding coefficients (bS 2 reads it)
    uint8_t nzc[2][4] = {};
    int8_t i4[16] = {};  // Intra4x4PredMode, or Intra8x8PredMode in each 4x4 block of its 8x8
    int8_t ref[2][16] = {};   // refIdxL0 and refIdxL1 a 4x4 block, -1 intra or unused
    int refpic[2][16] = {};   // the reference picture's id, -1 unused
    int16_t mv[2][16][2] = {};
    // what CABAC's context selection reads of a neighbour: coded_block_pattern
    // (luma bits 0-3, chroma 4-5), the coded_block_flags of the DC blocks
    // (bit 0 luma, 1 Cb, 2 Cr), intra_chroma_pred_mode, the 8x8 blocks
    // predicted in direct mode (bits 0-3; bit 4: B_Skip or B_Direct_16x16),
    // and each 4x4 block's absolute mvd of each list (at most 70)
    uint8_t cbp = 0, dc = 0, cmode = 0, direct = 0;
    uint8_t mvd[2][16][2] = {};
};

// The state transitions (Table 9-45) by state byte (pStateIdx << 1 |
// valMPS) after the most probable symbol, and by its complement (255 - byte)
// after the least probable one.
struct StateTable {
    uint8_t v[256];
    StateTable() {
        for (int st = 0; st < 128; st++) {
            const int s = st >> 1, mps = st & 1;
            v[st] = (uint8_t)((s < 62 ? s + 1 : s) << 1 | mps);
            v[255 - st] = (uint8_t)(h264cabac::kTransLps[s] << 1 | (s == 0 ? 1 - mps : mps));
        }
    }
};
const StateTable kNextState;

// The arithmetic decoding engine (9.3.1.2, 9.3.3.2) and the context
// variables, (pStateIdx << 1) | valMPS each.  Bits come from a 64-bit cache
// over the slice's RBSP; `b` keeps the position of the next unread bit
// for I_PCM's samples.
struct Cabac {
    Bits* b = nullptr;
    const uint8_t *p = nullptr, *end = nullptr;
    uint64_t cache = 0;
    int cached = 0;
    uint32_t range = 510, offset = 0;
    uint16_t state[h264cabac::kCtxCount] = {};  // not a char type: stores to it alias nothing else

    void init_contexts(int table, int qp) {
        const int q = clip3(0, 51, qp);
        for (int i = 0; i < h264cabac::kCtxCount; i++) {
            const int8_t* mn = h264cabac::kInit[table][i];
            const int pre = clip3(1, 126, ((mn[0] * q) >> 4) + mn[1]);
            state[i] = (uint16_t)(pre <= 63 ? (63 - pre) << 1 : (pre - 64) << 1 | 1);
        }
    }
    // starts at bits's position (byte aligned); sync() hands it back
    void init_engine(Bits& bits) {
        b = &bits;
        p = bits.buf + (bits.pos >> 3);
        end = bits.buf + bits.bytes;
        cache = 0;
        cached = 0;
        range = 510;
        offset = read(9);
        if (offset >= 510) throw Corrupt("a CABAC codIOffset of 510 or 511");
    }
    void sync() { b->pos = (size_t)(p - b->buf) * 8 - (size_t)cached; }
    __attribute__((always_inline)) uint32_t read(int n) {  // 0 <= n <= 32
        if (cached < n) refill();
        cached -= n;
        return (uint32_t)(cache >> cached) & (uint32_t)((1ull << n) - 1);  // n 0: none
    }
    void refill() {
        if (p + 8 <= end) {  // the whole bytes the cache has room for, at once
            uint64_t v;
            std::memcpy(&v, p, 8);
            v = __builtin_bswap64(v);
            const int take = (64 - cached) >> 3;
            cache = take == 8 ? v : cache << (8 * take) | v >> (64 - 8 * take);
            p += take;
            cached += 8 * take;
            return;
        }
        while (cached <= 56) {
            if (p >= end + 8) throw Corrupt("read past the end of a NAL unit");
            cache = cache << 8 | (p < end ? *p : 0);
            p++;
            cached += 8;
        }
    }
    // Branch-free, as the bins are hard to predict: lps is all ones where
    // codIOffset falls in the least probable symbol's range, and the state
    // byte, or its complement for that symbol, indexes its successor.
    __attribute__((always_inline)) int decision(int ctx) {
        uint16_t& st = state[ctx];
        const uint32_t lps_range = h264cabac::kRangeLps[st >> 1][(range >> 6) & 3];
        range -= lps_range;
        const uint32_t lps = (uint32_t)((int32_t)(range - 1 - offset) >> 31);
        offset -= range & lps;
        range += (lps_range - range) & lps;
        const uint32_t idx = st ^ (lps & 255);
        st = kNextState.v[idx];
        const int n = __builtin_clz(range) - 23;
        range <<= n;
        offset = offset << n | read(n);
        return (int)(idx & 1);
    }
    int bypass() {
        offset = offset << 1 | read(1);
        const uint32_t one = (uint32_t)((int32_t)(range - 1 - offset) >> 31);
        offset -= range & one;
        return (int)(one & 1);
    }
    int terminate() {
        range -= 2;
        if (offset >= range) return 1;
        if (range < 256) {
            range <<= 1;
            offset = offset << 1 | read(1);
        }
        return 0;
    }
};

struct SliceInfo {
    int idc = 0, alpha = 0, beta = 0;
    int chroma_offset[2] = {0, 0};
    bool b = false;  // a B slice: deblocking compares both lists' motion
};

struct Motion {  // a neighbour partition's motion data
    bool avail = false;
    int ref = -1;
    int mv[2] = {0, 0};
};

const int kMaxDelayed = 16;

struct Decoder {
    Sps sps[32];
    Pps pps[256];
    int nal_length = 0;  // bytes of a NAL length prefix; 0 for Annex B
    std::vector<uint8_t> rbsp;

    // current picture
    PicPtr cur;
    const Sps* cs = nullptr;
    const Pps* cp = nullptr;
    int mb_w = 0, mb_h = 0, w = 0, h = 0;
    std::vector<Mb> mbs;
    std::vector<SliceInfo> slices;
    int last_mb = -1;
    SliceHeader first_header;  // of the current picture

    // reference state
    std::vector<PicPtr> refs;  // short-term references
    bool have_prev = false;    // a picture decoded since the last IDR or flush
    int prev_ref_frame_num = 0, prev_frame_num = 0, prev_frame_num_offset = 0;
    int prev_poc_msb = 0, prev_poc_lsb = 0;
    int next_id = 1;
    // where FFmpeg starts to show pictures: frame_recovered's bits (1 an IDR
    // picture, 2 a recovered picture given, 4 an I picture with few
    // references), the frame_num a recovery point SEI names, the SEI of the
    // packet (recovery_frame_cnt, or -1)
    int frame_recovered = 0, recovery_frame = -1, sei_recovery = -1;
    bool valid_recovery_point = false;
    bool has_recovery_point = false;  // a recovery point SEI was ever read (not reset by a flush)
    bool grey_refs = false;  // grey references were made and no I picture came since

    // output (h264_select_output_frame)
    std::vector<PicPtr> delayed;
    int has_b_frames = 0;
    int last_pocs[kMaxDelayed];
    int next_outputed_poc = INT_MIN;
    bool mmco_reset = true;
    std::vector<PicPtr> ready;  // pictures given by the packet, in order
    PicPtr shown;                 // the last picture handed out

    // probing: the last slice's first_mb in the packet, the last reference
    // picture's frame_num
    int probe_last_mb = -1, probe_fn = -1;

    // per-slice state
    SliceHeader sh;
    std::vector<PicPtr> lists[2];  // RefPicList0, RefPicList1
    int slice_num = 0, qp = 0;
    // B slices: implicit bi-prediction weights w0 by (refIdxL0, refIdxL1),
    // or none (FFmpeg's use_weight 0 where the two pictures lie evenly
    // about the current one); temporal direct's DistScaleFactor by refIdxL0
    bool implicit = false;
    int implicit_w[16][16] = {};
    int dist_scale[16] = {};
    bool cabac = false;
    Cabac cb;
    // the dequantisation of the current PPS (8.5.9), by list and QP in scan
    // order: LevelScale4x4 << QP / 6 (lists 0-5) and LevelScale8x8 << QP / 6
    // (0 Intra Y, 1 Inter Y); `dq_of` the PPS they were made for
    int32_t dq4[6][52][16], dq8[2][52][64];
    const Pps* dq_of = nullptr;
    // the mb_qp_delta of the slice's macroblock before (CABAC), and this one's
    int last_dqp = 0, cur_dqp = 0;

    Decoder() {
        reset_pocs();
        restart();
    }
    void reset_pocs() {
        for (int& p : last_pocs) p = INT_MIN;
    }
    // the state a stream starts in, and after a flush (ff_h264_flush_change)
    void restart() {
        refs.clear();
        have_prev = false;
        prev_poc_msb = 1 << 16;
        prev_poc_lsb = -1;
        prev_frame_num = prev_frame_num_offset = 0;
        frame_recovered = 0;
        recovery_frame = -1;
        valid_recovery_point = false;
        grey_refs = false;
        mmco_reset = true;
    }

    // ------------------------------------------------------------ NALs
    template <class F>
    void nal_units(const uint8_t* d, size_t n, F&& fn) {
        if (nal_length) {
            size_t pos = 0;
            while (pos + (size_t)nal_length <= n) {
                size_t len = 0;
                for (int i = 0; i < nal_length; i++) len = len << 8 | d[pos + i];
                pos += nal_length;
                if (len > n - pos) throw Corrupt("a NAL unit runs past its packet");
                if (len) fn(d + pos, len);
                pos += len;
            }
            return;
        }
        size_t i = 0, start = SIZE_MAX;
        while (i + 3 <= n) {
            if (d[i] == 0 && d[i + 1] == 0 && d[i + 2] == 1) {
                if (start != SIZE_MAX) emit(d, start, i, fn);
                i += 3;
                start = i;
            } else {
                i++;
            }
        }
        if (start != SIZE_MAX) emit(d, start, n, fn);
    }
    template <class F>
    static void emit(const uint8_t* d, size_t a, size_t b, F& fn) {
        while (b > a && d[b - 1] == 0) b--;  // trailing_zero_8bits, the next start code's zero
        if (b > a) fn(d + a, b - a);
    }

    Bits unescape(const uint8_t* d, size_t n) {
        rbsp.assign(n + 8, 0);
        size_t o = 0, zeros = 0;
        for (size_t i = 1; i < n; i++) {  // past the header byte
            if (zeros >= 2 && d[i] == 3) {
                zeros = 0;
                continue;
            }
            rbsp[o++] = d[i];
            zeros = d[i] ? 0 : zeros + 1;
        }
        return Bits(rbsp.data(), o);
    }

    void parameter_set(int type, Bits& b) {
        int id;
        if (type == 7) {
            Sps s = parse_sps(b, &id);
            sps[id] = s;
        } else {
            Pps p = parse_pps(b, sps, &id);
            pps[id] = p;
        }
        dq_of = nullptr;  // the dequantisation tables may be of a set just replaced
    }

    // Parses one NAL unit; with `decode` false only headers are checked.
    void nal(const uint8_t* d, size_t n, bool decode) {
        if (d[0] & 0x80) throw Corrupt("forbidden_zero_bit set");
        const int type = d[0] & 31, ref_idc = d[0] >> 5;
        switch (type) {
            case 7:
            case 8: {
                Bits b = unescape(d, n);
                parameter_set(type, b);
                break;
            }
            case 1:
            case 5: {
                Bits b = unescape(d, n);
                SliceHeader h = slice_header(b, type == 5, ref_idc);
                if (decode) slice(b, h);
                else probe_slice(h);
                break;
            }
            case 2:
            case 3:
            case 4:
                throw Refused("data partitioning (NAL unit types 2-4)");
            case 6:
                if (decode) sei(d, n);
                break;
            default:
                break;  // delimiters, fillers, extensions: nothing to decode
        }
    }

    // The recovery point (payload type 6) of an SEI NAL unit, the one
    // message read; a message that does not parse ends the unit, as FFmpeg
    // goes on past SEI errors.
    void sei(const uint8_t* d, size_t n) try {
        Bits b = unescape(d, n);
        while (b.pos + 16 <= b.stop) {
            int type = 0, size = 0, byte;
            do type += byte = (int)b.u(8);
            while (byte == 255 && b.pos + 8 <= b.stop);
            do size += byte = (int)b.u(8);
            while (byte == 255 && b.pos + 8 <= b.stop);
            const size_t end = b.pos + 8 * (size_t)size;
            if (end > b.stop) return;
            if (type == 6) {
                const uint32_t cnt = b.ue();
                if (b.pos > end || cnt > 65535) return;
                sei_recovery = (int)cnt;
                has_recovery_point = true;
            }
            b.pos = end;
        }
    } catch (const Corrupt&) {
    }

    // The refusals a slice header shows beside its own fields: slices out
    // of order within a packet (one access unit), and frame_num gaps.
    void probe_slice(const SliceHeader& s) {
        if (probe_last_mb >= 0 && s.first_mb <= probe_last_mb)
            throw Refused("arbitrary slice order");
        const bool first = probe_last_mb < 0;
        probe_last_mb = s.first_mb;
        if (!first) return;
        if (!s.idr && probe_fn >= 0) check_gap(s, probe_fn);
        if (s.ref_idc) probe_fn = s.frame_num;
    }

    // frame_num must follow the last reference picture's (gaps refused)
    void check_gap(const SliceHeader& s, int prev) const {
        const int max_fn = 1 << sps[pps[s.pps_id].sps_id].log2_max_frame_num;
        if (s.frame_num != prev && s.frame_num != (prev + 1) % max_fn)
            throw Refused("gaps in frame_num (frame_num " + std::to_string(s.frame_num) +
                          " after " + std::to_string(prev) + ")");
    }

    // ----------------------------------------------------- slice header
    SliceHeader slice_header(Bits& b, bool idr, int ref_idc) {
        SliceHeader s;
        s.idr = idr;
        s.ref_idc = ref_idc;
        s.first_mb = (int)b.ue();
        uint32_t t = ue_max(b, 9, "slice_type") % 5;
        if (t == 3 || t == 4) throw Refused("SP and SI slices");
        s.type = (int)t;
        if (idr && t != 2) throw Corrupt("an IDR picture with a P or B slice");
        s.pps_id = (int)ue_max(b, 255, "pic_parameter_set_id");
        if (!pps[s.pps_id].valid) throw Corrupt("a slice names a PPS not received");
        const Pps& p = pps[s.pps_id];
        const Sps& q = sps[p.sps_id];
        if (s.first_mb >= q.mb_w * q.mb_h) throw Corrupt("first_mb_in_slice out of range");
        s.frame_num = (int)b.u(q.log2_max_frame_num);
        if (idr) s.idr_pic_id = (int)b.ue();
        if (q.poc_type == 0) {
            s.poc_lsb = (int)b.u(q.log2_max_poc_lsb);
            if (p.bottom_field_poc) s.delta_poc_bottom = b.se();
        }
        if (s.type == 1) s.direct_spatial = b.u1();
        s.nref[0] = p.num_ref_idx_default;
        s.nref[1] = p.num_ref_idx_l1_default;
        const int lists = s.type == 1 ? 2 : s.type == 0 ? 1 : 0;
        if (lists) {
            if (b.u1()) {
                s.nref[0] = (int)ue_max(b, 15, "num_ref_idx_l0_active_minus1") + 1;
                if (lists == 2) s.nref[1] = (int)ue_max(b, 15, "num_ref_idx_l1_active_minus1") + 1;
            }
            for (int l = 0; l < lists; l++)
                if (s.nref[l] > 16) throw Corrupt("num_ref_idx_active out of range");
            for (int l = 0; l < lists; l++) {
                if (!b.u1()) continue;  // ref_pic_list_modification_flag_lX
                for (;;) {
                    uint32_t idc = b.ue();
                    if (idc == 3) break;
                    if (idc == 2)
                        throw Refused("long-term reference pictures "
                                      "(modification_of_pic_nums_idc 2)");
                    if (idc > 3 || s.modifications[l].size() > 32)
                        throw Corrupt("a bad ref_pic_list_modification");
                    s.modifications[l].emplace_back((int)idc, (int)b.ue());
                }
            }
            if ((p.weighted && s.type == 0) || (p.bipred == 1 && s.type == 1))
                pred_weight_table(b, s, lists);
        }
        if (ref_idc) {
            if (idr) {
                b.u(1);
                if (b.u1())
                    throw Refused("long-term reference pictures (long_term_reference_flag)");
            } else if ((s.adaptive = b.u1())) {
                for (;;) {
                    uint32_t op = b.ue();
                    if (op == 0) break;
                    if (op == 1) {
                        s.mmco1.push_back((int)b.ue());
                    } else if (op == 5) {
                        throw Refused("memory_management_control_operation 5");
                    } else if (op <= 6) {
                        throw Refused("long-term reference pictures "
                                      "(memory_management_control_operation " +
                                      std::to_string(op) + ")");
                    } else {
                        throw Corrupt("a bad memory_management_control_operation");
                    }
                    if (s.mmco1.size() > 66) throw Corrupt("too many MMCOs");
                }
            }
        }
        if (p.cabac && s.type != 2) s.cabac_init_idc = (int)ue_max(b, 2, "cabac_init_idc");
        s.qp = p.init_qp + b.se();
        if (s.qp < 0 || s.qp > 51) throw Corrupt("slice QP out of range");
        if (p.deblocking_control) {
            s.deblock_idc = (int)ue_max(b, 2, "disable_deblocking_filter_idc");
            if (s.deblock_idc != 1) {
                s.alpha_offset = 2 * b.se();
                s.beta_offset = 2 * b.se();
                if (std::abs(s.alpha_offset) > 12 || std::abs(s.beta_offset) > 12)
                    throw Corrupt("slice deblocking offsets out of range");
            }
        }
        return s;
    }

    // 7.3.3.2: the weights and offsets of each list's ref_idx (the default
    // where its flag is 0: 2^denominator and 0)
    static void pred_weight_table(Bits& b, SliceHeader& s, int lists) {
        s.weighted = true;
        s.log2_wd[0] = (int)ue_max(b, 7, "luma_log2_weight_denom");
        s.log2_wd[1] = (int)ue_max(b, 7, "chroma_log2_weight_denom");
        auto value = [&](const char* what) {
            const int v = b.se();
            if (v < -128 || v > 127) throw Corrupt(std::string(what) + " out of range");
            return v;
        };
        for (int l = 0; l < lists; l++)
            for (int i = 0; i < s.nref[l]; i++) {
                for (int c = 0; c < 3; c++) {
                    s.weight[l][i][c] = 1 << s.log2_wd[c ? 1 : 0];
                    s.offset[l][i][c] = 0;
                }
                if (b.u1()) {
                    s.weight[l][i][0] = value("luma_weight");
                    s.offset[l][i][0] = value("luma_offset");
                }
                if (b.u1())
                    for (int c = 1; c < 3; c++) {
                        s.weight[l][i][c] = value("chroma_weight");
                        s.offset[l][i][c] = value("chroma_offset");
                    }
            }
    }

    // ------------------------------------------------------------ slices
    void slice(Bits& b, const SliceHeader& s) {
        if (s.first_mb == 0 || !cur) {
            if (cur) finish_picture();
            start_picture(s);
        } else if (s.first_mb <= last_mb) {
            throw Refused("arbitrary slice order");
        } else if (s.frame_num != first_header.frame_num || s.idr != first_header.idr) {
            throw Corrupt("a slice of another picture before the first macroblock");
        }
        if (s.first_mb != last_mb + 1) throw Corrupt("missing macroblocks before a slice");
        sh = s;
        cp = &pps[s.pps_id];
        if (&sps[cp->sps_id] != cs) throw Corrupt("slices of a picture name different SPSs");
        SliceInfo si;
        si.idc = s.deblock_idc;
        si.alpha = s.alpha_offset;
        si.beta = s.beta_offset;
        si.chroma_offset[0] = cp->chroma_offset[0];
        si.chroma_offset[1] = cp->chroma_offset[1];
        si.b = s.type == 1;
        slice_num = (int)slices.size();
        slices.push_back(si);
        if (cp != dq_of) make_dequant();
        if (s.type != 2) build_lists(s);
        if (s.type == 1) b_tables();
        qp = s.qp;
        cabac = cp->cabac;
        slice_data(b);
    }

    PicPtr new_picture(uint8_t fill) const {
        PicPtr p = std::make_shared<Picture>();
        p->w = w;
        p->h = h;
        p->y.assign((size_t)w * h, fill);
        p->u.assign((size_t)w * h / 4, fill);
        p->v.assign((size_t)w * h / 4, fill);
        return p;
    }

    void start_picture(const SliceHeader& s) {
        const Pps& p = pps[s.pps_id];
        cs = &sps[p.sps_id];
        first_header = s;
        mb_w = cs->mb_w;
        mb_h = cs->mb_h;
        w = mb_w * 16;
        h = mb_h * 16;
        if (s.idr) {
            refs.clear();
            grey_refs = false;
            have_prev = false;
            prev_poc_msb = prev_poc_lsb = 0;
            prev_frame_num_offset = 0;
            prev_ref_frame_num = 0;
            reset_pocs();
        } else if (have_prev) {
            check_gap(s, prev_ref_frame_num);
        } else {
            grey_references(s);
        }
        cur = new_picture(0);
        cur->frame_num = s.frame_num;
        cur->id = next_id++;
        cur->b_type = s.type == 1;
        cur->key = s.idr || sei_recovery >= 0;
        cur->full_range = cs->full_range;
        cur->crop_l = cs->crop_l;
        cur->crop_r = cs->crop_r;
        cur->crop_t = cs->crop_t;
        cur->crop_b = cs->crop_b;
        cur->mmco_reset = mmco_reset;
        mmco_reset = false;
        // h264_field_start: the recovery point SEI, and what is recovered
        const int max_fn = 1 << cs->log2_max_frame_num;
        if (sei_recovery >= 0) {
            if (s.frame_num != sei_recovery || s.type != 2) valid_recovery_point = true;
            if (recovery_frame < 0 || ((recovery_frame - s.frame_num) & (max_fn - 1)) > sei_recovery)
                recovery_frame = valid_recovery_point ? (s.frame_num + sei_recovery) & (max_fn - 1)
                                                      : s.frame_num;
        }
        if (s.idr || (recovery_frame == s.frame_num && s.ref_idc)) {
            recovery_frame = -1;
            cur->recovered = true;
        }
        if (s.idr) frame_recovered |= 1;
        if (frame_recovered) cur->recovered = true;
        // POC (8.2.1)
        if (cs->poc_type == 0) {
            const int max_lsb = 1 << cs->log2_max_poc_lsb;
            int msb = prev_poc_msb;
            if (s.poc_lsb < prev_poc_lsb && prev_poc_lsb - s.poc_lsb >= max_lsb / 2)
                msb = prev_poc_msb + max_lsb;
            else if (s.poc_lsb > prev_poc_lsb && s.poc_lsb - prev_poc_lsb > max_lsb / 2)
                msb = prev_poc_msb - max_lsb;
            int top = msb + s.poc_lsb;
            cur->poc = std::min(top, top + s.delta_poc_bottom);
            if (s.ref_idc) {
                prev_poc_msb = msb;
                prev_poc_lsb = s.poc_lsb;
            }
        } else {
            const int max_fn = 1 << cs->log2_max_frame_num;
            int offset = 0;
            if (!s.idr)
                offset = prev_frame_num_offset + (prev_frame_num > s.frame_num ? max_fn : 0);
            int abs_fn = offset + s.frame_num;
            cur->poc = s.idr ? 0 : s.ref_idc ? 2 * abs_fn : 2 * abs_fn - 1;
            prev_frame_num_offset = offset;
        }
        prev_frame_num = s.frame_num;
        mbs.assign((size_t)mb_w * mb_h, Mb());
        slices.clear();
        last_mb = -1;
    }

    // A stream that starts (or, after a seek, goes on) on a non-IDR picture:
    // FFmpeg's frame_num gap concealment from prev_frame_num -1 makes up to
    // max_num_ref_frames grey reference pictures with the frame_nums before
    // it, each marked by the sliding window.  They share one buffer (each a
    // copy of the one before), so deblocking sees one reference picture.
    // Each takes the slice's type (h264_frame_start), and its marking applies
    // the I picture heuristic to it: before an I picture whose PPS takes one
    // reference, what follows counts as recovered, a recovery point SEI read
    // before notwithstanding (measured against FFmpeg: a Matroska seek onto
    // such a picture in a stream cut at a recovery point shows it).
    void grey_references(const SliceHeader& s) {
        const int frame_num = s.frame_num;
        const Pps& p = pps[s.pps_id];
        const int max_fn = 1 << cs->log2_max_frame_num;
        int prev = -1;
        if (frame_num - prev > cs->max_refs) {
            prev = frame_num - cs->max_refs - 1;
            if (prev < 0) prev += max_fn;
        }
        PicPtr grey;
        while (frame_num != prev && frame_num != (prev + 1) % max_fn) {
            prev = (prev + 1) % max_fn;
            if (!grey) {
                grey = new_picture(128);
                grey->id = next_id++;
            }
            PicPtr g = std::make_shared<Picture>(*grey);
            g->frame_num = prev;
            if ((int)refs.size() >= std::max(cs->max_refs, 1)) {
                auto older = [&](const PicPtr& a, const PicPtr& b) {
                    return pic_num(*a, *g) < pic_num(*b, *g);
                };
                refs.erase(std::min_element(refs.begin(), refs.end(), older));
            }
            refs.push_back(g);
            grey_refs = true;
            if (!cs->gaps_allowed) reset_pocs();
            if (s.type == 2 && p.num_ref_idx_default <= 1 && !has_b_frames &&
                ((int)refs.size() <= 2 || p.num_ref_idx_l1_default <= 1))
                frame_recovered |= 4;
        }
    }

    // PicNum (FrameNumWrap) of reference picture p while picture c decodes
    int pic_num(const Picture& p, const Picture& c) const {
        const int max_fn = 1 << cs->log2_max_frame_num;
        return p.frame_num > c.frame_num ? p.frame_num - max_fn : p.frame_num;
    }
    int pic_num(const Picture& p) const { return pic_num(p, *cur); }

    // The initial lists (8.2.4.2.1, 8.2.4.2.3): P by descending PicNum; B
    // by POC, list 0 the pictures before the current one (descending),
    // then those after (ascending), list 1 the other way round, its first
    // two entries switched where it would equal list 0.  Then each list's
    // modifications, and FFmpeg's default for an entry with no picture.
    void build_lists(const SliceHeader& s) {
        const int nl = s.type == 1 ? 2 : 1;
        std::vector<PicPtr> init[2];
        if (s.type == 0) {
            init[0] = refs;
            std::sort(init[0].begin(), init[0].end(), [&](const PicPtr& a, const PicPtr& b) {
                return pic_num(*a) > pic_num(*b);
            });
        } else {
            std::vector<PicPtr> before, after;
            for (auto& r : refs)
                if (r->poc < cur->poc) before.push_back(r);
                else if (r->poc > cur->poc) after.push_back(r);
            std::sort(before.begin(), before.end(),
                      [](const PicPtr& a, const PicPtr& b) { return a->poc > b->poc; });
            std::sort(after.begin(), after.end(),
                      [](const PicPtr& a, const PicPtr& b) { return a->poc < b->poc; });
            init[0] = before;
            init[0].insert(init[0].end(), after.begin(), after.end());
            init[1] = after;
            init[1].insert(init[1].end(), before.begin(), before.end());
            bool same = init[1].size() > 1;  // compared by picture (grey pictures are one)
            for (size_t i = 0; same && i < init[0].size(); i++) same = init[0][i]->id == init[1][i]->id;
            if (same) std::swap(init[1][0], init[1][1]);
        }
        for (int l = 0; l < nl; l++) {
            auto& list = lists[l];
            const int n = s.nref[l];
            list.assign((size_t)n + 1, nullptr);
            for (int i = 0; i < n && i < (int)init[l].size(); i++) list[i] = init[l][i];
            const int max_pic = 1 << cs->log2_max_frame_num, curr = cur->frame_num;
            int pred = curr, idx = 0;
            for (auto [idc, diff] : s.modifications[l]) {
                if (idx >= n) throw Corrupt("more reference list modifications than entries");
                if (diff >= max_pic) throw Corrupt("abs_diff_pic_num_minus1 out of range");
                int no_wrap = idc == 0 ? pred - (diff + 1) : pred + (diff + 1);
                if (no_wrap < 0) no_wrap += max_pic;
                if (no_wrap >= max_pic) no_wrap -= max_pic;
                pred = no_wrap;
                const int num = no_wrap > curr ? no_wrap - max_pic : no_wrap;
                PicPtr pic;
                for (auto& r : refs)
                    if (pic_num(*r) == num) pic = r;
                if (!pic) throw Corrupt("a reference list modification names no reference picture");
                for (int c = n; c > idx; c--) list[c] = list[c - 1];
                list[idx++] = pic;
                int k = idx;
                for (int c = idx; c <= n; c++)
                    if (!list[c] || pic_num(*list[c]) != num) list[k++] = list[c];
                for (; k <= n; k++) list[k] = nullptr;
            }
            list.resize(n);
        }
        // ff_h264_build_ref_list: an entry with no picture takes the first
        // of its initial list ("Missing reference picture, default is ...")
        for (int l = 0; l < nl; l++)
            for (auto& r : lists[l])
                if (!r) {
                    if (init[l].empty()) throw Corrupt("an inter slice without reference pictures");
                    r = init[l][0];
                    reset_pocs();
                }
        for (int l = 0; l < nl && slice_num == 0; l++) {  // ff_h264_direct_ref_list_init
            cur->ref_cnt[l] = s.nref[l];
            for (int i = 0; i < s.nref[l]; i++) cur->ref_fn[l][i] = lists[l][i]->frame_num;
        }
    }

    // A B slice's implicit weights (8.4.2.3.1, as FFmpeg's
    // implicit_weight_table) and temporal direct's DistScaleFactors
    // (8.4.1.2.3).
    void b_tables() {
        auto clip8 = [](int v) { return clip3(-128, 127, v); };
        const int poc = cur->poc;
        implicit = false;
        if (cp->bipred == 2 &&
            !(sh.nref[0] == 1 && sh.nref[1] == 1 &&
              (int64_t)lists[0][0]->poc + lists[1][0]->poc == 2LL * poc)) {
            implicit = true;
            for (int i = 0; i < sh.nref[0]; i++)
                for (int j = 0; j < sh.nref[1]; j++) {
                    int wt = 32;
                    const int td = clip8(lists[1][j]->poc - lists[0][i]->poc);
                    if (td) {
                        const int tb = clip8(poc - lists[0][i]->poc);
                        const int tx = (16384 + (std::abs(td) >> 1)) / td;
                        const int dsf = (tb * tx + 32) >> 8;
                        if (dsf >= -64 && dsf <= 128) wt = 64 - dsf;
                    }
                    implicit_w[i][j] = wt;
                }
        }
        if (sh.direct_spatial) return;
        const Picture& col = *lists[1][0];
        for (int i = 0; i < sh.nref[0]; i++) {
            const int td = clip8(col.poc - lists[0][i]->poc);
            if (!td) {
                dist_scale[i] = 256;
                continue;
            }
            const int tb = clip8(poc - lists[0][i]->poc);
            const int tx = (16384 + (std::abs(td) >> 1)) / td;
            dist_scale[i] = clip3(-1024, 1023, (tb * tx + 32) >> 6);
        }
    }

    // ---------------------------------------------------- neighbours
    int mb_addr(int mb, int dx, int dy) const {  // an available neighbour, or -1
        int x = mb % mb_w + dx, y = mb / mb_w + dy;
        if (x < 0 || x >= mb_w || y < 0) return -1;
        int n = y * mb_w + x;
        return n < mb && mbs[n].slice == slice_num ? n : -1;
    }

    int nc_luma(int mb, int x, int y) const {
        int na = -1, nb = -1;
        if (x > 0) {
            na = mbs[mb].nz[y * 4 + x - 1];
        } else {
            int a = mb_addr(mb, -1, 0);
            if (a >= 0) na = mbs[a].nz[y * 4 + 3];
        }
        if (y > 0) {
            nb = mbs[mb].nz[(y - 1) * 4 + x];
        } else {
            int c = mb_addr(mb, 0, -1);
            if (c >= 0) nb = mbs[c].nz[12 + x];
        }
        return nc_of(na, nb);
    }
    int nc_chroma(int mb, int c, int x, int y) const {
        int na = -1, nb = -1;
        if (x > 0) {
            na = mbs[mb].nzc[c][y * 2];
        } else {
            int a = mb_addr(mb, -1, 0);
            if (a >= 0) na = mbs[a].nzc[c][y * 2 + 1];
        }
        if (y > 0) {
            nb = mbs[mb].nzc[c][x];
        } else {
            int t = mb_addr(mb, 0, -1);
            if (t >= 0) nb = mbs[t].nzc[c][2 + x];
        }
        return nc_of(na, nb);
    }
    static int nc_of(int na, int nb) {
        if (na >= 0 && nb >= 0) return (na + nb + 1) >> 1;
        return na >= 0 ? na : nb >= 0 ? nb : 0;
    }

    // ------------------------------------------------------ residuals
    // One CAVLC block into coeff[0..maxnum) (scan order); TotalCoeff.
    int residual(Bits& b, int* coeff, int maxnum, int nc) {
        const Tables& t = tables();
        std::memset(coeff, 0, sizeof(int) * (size_t)maxnum);
        int token;
        if (nc == -1) {
            token = b.vlc(t.dc_token);
        } else if (nc >= 8) {
            uint32_t v = b.u(6);
            if (v == 3) token = 0;
            else if ((v & 3) > (v >> 2) + 1) throw Corrupt("a bad coeff_token");
            else token = (int)(((v >> 2) + 1) * 4 + (v & 3));
        } else {
            token = b.vlc(t.token[nc < 2 ? 0 : nc < 4 ? 1 : 2]);
        }
        const int tc = token >> 2, t1 = token & 3;
        if (!tc) return 0;
        if (tc > maxnum) throw Corrupt("more coefficients than a block holds");
        int level[16], run[16];
        int suffix = tc > 10 && t1 < 3 ? 1 : 0;
        for (int i = 0; i < tc; i++) {
            if (i < t1) {
                level[i] = b.u1() ? -1 : 1;
                continue;
            }
            int prefix = 0;
            while (!b.u1())
                if (++prefix > 31) throw Corrupt("a level_prefix too long");
            int code = (std::min(15, prefix) << suffix);
            if (suffix > 0 || prefix >= 14) {
                int size = prefix == 14 && suffix == 0 ? 4 : prefix >= 15 ? prefix - 3 : suffix;
                if (size > 0) code += (int)b.u(size);
            }
            if (prefix >= 15 && suffix == 0) code += 15;
            if (prefix >= 16) code += (1 << (prefix - 3)) - 4096;
            if (i == t1 && t1 < 3) code += 2;
            level[i] = code % 2 == 0 ? (code + 2) >> 1 : (-code - 1) >> 1;
            if (suffix == 0) suffix = 1;
            if (std::abs(level[i]) > (3 << (suffix - 1)) && suffix < 6) suffix++;
        }
        int zeros = 0;
        if (tc < maxnum) zeros = b.vlc(maxnum == 4 ? t.dc_zeros[tc - 1] : t.zeros[tc - 1]);
        if (zeros + tc > maxnum) throw Corrupt("total_zeros out of range");
        for (int i = 0; i < tc - 1; i++) {
            run[i] = zeros > 0 ? b.vlc(t.run[std::min(zeros, 7) - 1]) : 0;
            zeros -= run[i];
            if (zeros < 0) throw Corrupt("run_before out of range");
        }
        run[tc - 1] = zeros;
        int k = -1;
        for (int i = tc - 1; i >= 0; i--) {
            k += run[i] + 1;
            coeff[k] = level[i];
        }
        return tc;
    }

    // ------------------------------------------------- macroblocks
    void slice_data(Bits& b) {
        const int nmb = mb_w * mb_h;
        int mb = sh.first_mb;
        if (cabac) {  // 7.3.4 with entropy_coding_mode_flag 1
            b.align();    // cabac_alignment_one_bit
            cb.init_contexts(sh.type == 2 ? 0 : 1 + sh.cabac_init_idc, sh.qp);
            cb.init_engine(b);
            last_dqp = 0;
            do {
                if (mb >= nmb) throw Corrupt("slice data past the last macroblock");
                cur_dqp = 0;
                if (sh.type != 2 && cb.decision((sh.type == 1 ? 24 : 11) + skip_ctx(mb)))
                    skip_mb(mb);
                else macroblock(b, mb);
                last_dqp = cur_dqp;
                mb++;
            } while (!cb.terminate());  // end_of_slice_flag
            last_mb = mb - 1;
            return;
        }
        for (;;) {
            if (mb >= nmb) throw Corrupt("slice data past the last macroblock");
            if (sh.type != 2) {
                uint32_t run = b.ue();
                if (run > (uint32_t)(nmb - mb)) throw Corrupt("mb_skip_run past the picture");
                for (uint32_t i = 0; i < run; i++) skip_mb(mb++);
                if (run > 0 && !b.more_rbsp_data()) break;
                if (mb >= nmb) throw Corrupt("slice data past the last macroblock");
            }
            macroblock(b, mb++);
            if (!b.more_rbsp_data()) break;
        }
        last_mb = mb - 1;
    }

    // ---------------------------------------- CABAC syntax elements (9.3)
    // ctxIdxInc of mb_skip_flag: the neighbours that are not skipped
    int skip_ctx(int mb) const {
        const int a = mb_addr(mb, -1, 0), t = mb_addr(mb, 0, -1);
        return (a >= 0 && mbs[a].kind != SKIP) + (t >= 0 && mbs[t].kind != SKIP);
    }

    // mb_type (Table 9-36, 9-37): I slices 0-25; P slices 0-3, intra 5-30;
    // B slices 0-22, intra 23-48 (B: FFmpeg's decode_cabac_mb_type_b)
    int cabac_mb_type(int mb) {
        if (sh.type == 2) return cabac_intra_type(mb, 3, true);
        if (sh.type == 1) {
            const int a = mb_addr(mb, -1, 0), t = mb_addr(mb, 0, -1);
            const int ctx = (a >= 0 && !(mbs[a].direct & 16)) + (t >= 0 && !(mbs[t].direct & 16));
            if (!cb.decision(27 + ctx)) return 0;                   // B_Direct_16x16
            if (!cb.decision(30)) return 1 + cb.decision(32);       // B_L0_16x16, B_L1_16x16
            int bits = cb.decision(31) << 3;
            bits |= cb.decision(32) << 2;
            bits |= cb.decision(32) << 1;
            bits |= cb.decision(32);
            if (bits < 8) return bits + 3;                           // B_Bi_16x16 .. B_L1_L0_16x8
            if (bits == 13) return 23 + cabac_intra_type(mb, 32, false);
            if (bits == 14) return 11;                               // B_L1_L0_8x16
            if (bits == 15) return 22;                               // B_8x8
            return ((bits << 1) | cb.decision(32)) - 4;             // B_L0_Bi_16x8 .. B_Bi_Bi_8x16
        }
        if (cb.decision(14)) return 5 + cabac_intra_type(mb, 17, false);
        if (!cb.decision(15)) return cb.decision(16) ? 3 : 0;
        return cb.decision(17) ? 1 : 2;
    }
    // the I mb_types from ctxIdxOffset base (3 in I slices, 17 the suffix in P)
    int cabac_intra_type(int mb, int base, bool islice) {
        int ctx = base;
        if (islice) {
            const int a = mb_addr(mb, -1, 0), t = mb_addr(mb, 0, -1);
            ctx += (a >= 0 && mbs[a].kind != I4) + (t >= 0 && mbs[t].kind != I4);
        }
        if (!cb.decision(ctx)) return 0;  // I_NxN
        if (cb.terminate()) return 25;    // I_PCM
        const int k = islice ? base + 3 : base + 1, i = islice;
        int t = 1 + 12 * cb.decision(k);  // coded luma
        if (cb.decision(k + 1)) t += cb.decision(k + 1 + i) ? 8 : 4;  // chroma 1 or 2
        t += 2 * cb.decision(k + 2 + i);
        t += cb.decision(k + 2 + 2 * i);
        return t;
    }

    int cabac_sub_type() {
        if (sh.type == 1) {  // Table 9-38's B sub_mb_types (decode_cabac_b_mb_sub_type)
            if (!cb.decision(36)) return 0;
            if (!cb.decision(37)) return 1 + cb.decision(39);
            int t = 3;
            if (cb.decision(38)) {
                if (cb.decision(39)) return 11 + cb.decision(39);
                t += 4;
            }
            t += 2 * cb.decision(39);
            return t + cb.decision(39);
        }
        if (cb.decision(21)) return 0;
        if (!cb.decision(22)) return 1;
        return cb.decision(23) ? 2 : 3;
    }

    int cabac_chroma_mode(int mb) {
        auto term = [&](int n) {
            return n >= 0 && (mbs[n].kind == I4 || mbs[n].kind == I16) && mbs[n].cmode != 0;
        };
        if (!cb.decision(64 + term(mb_addr(mb, -1, 0)) + term(mb_addr(mb, 0, -1)))) return 0;
        if (!cb.decision(67)) return 1;
        return cb.decision(67) ? 3 : 2;
    }

    // coded_block_pattern: the luma prefix by 8x8 block from its neighbours
    // A and B, the chroma suffix from theirs
    int cabac_cbp(int mb) {
        const int a = mb_addr(mb, -1, 0), t = mb_addr(mb, 0, -1);
        auto luma = [&](int n, int b8) -> int {  // condTermFlagN
            if (n < 0 || mbs[n].kind == PCM) return 0;
            return mbs[n].kind == SKIP || !(mbs[n].cbp >> b8 & 1);
        };
        int cbp = 0;
        cbp |= cb.decision(73 + luma(a, 1) + 2 * luma(t, 2));
        cbp |= cb.decision(73 + !(cbp & 1) + 2 * luma(t, 3)) << 1;
        cbp |= cb.decision(73 + luma(a, 3) + 2 * !(cbp & 1)) << 2;
        cbp |= cb.decision(73 + !(cbp >> 2 & 1) + 2 * !(cbp >> 1 & 1)) << 3;
        auto chroma = [&](int n, int bin) -> int {
            if (n < 0 || mbs[n].kind == SKIP) return 0;
            if (mbs[n].kind == PCM) return 1;
            const int c = mbs[n].cbp >> 4;
            return bin ? c == 2 : c != 0;
        };
        if (cb.decision(77 + chroma(a, 0) + 2 * chroma(t, 0)))
            cbp |= (cb.decision(81 + chroma(a, 1) + 2 * chroma(t, 1)) ? 2 : 1) << 4;
        return cbp;
    }

    // ref_idx_lX of the partition at (x, y) (samples in the macroblock);
    // pref: list X's reference indices of the partitions read before, by
    // 4x4 block (0 where none was read); a neighbour predicted in direct
    // mode counts as 0
    int cabac_ref(int mb, int x, int y, const int8_t* pref, int list) {
        auto ref = [&](int xx, int yy) -> int {
            if (xx >= 0 && yy >= 0) return pref[(yy >> 2) * 4 + (xx >> 2)];
            const int n = mb_addr(mb, xx < 0 ? -1 : 0, yy < 0 ? -1 : 0);
            if (n < 0 || mbs[n].kind != INTER) return 0;
            const int bx = ((xx + 16) & 15) >> 2, by = ((yy + 16) & 15) >> 2;
            if (mbs[n].direct >> ((by >> 1) * 2 + (bx >> 1)) & 1) return 0;
            return mbs[n].ref[list][by * 4 + bx];
        };
        int ctx = (ref(x - 1, y) > 0) + 2 * (ref(x, y - 1) > 0), r = 0;
        while (cb.decision(54 + ctx)) {
            if (++r > 31) throw Corrupt("ref_idx_l0 out of range");
            ctx = r == 1 ? 4 : 5;
        }
        return r;
    }

    // one mvd_l0 component (UEG3, uCoff 9) from ctxIdxOffset base, whose
    // neighbours' absolute mvds sum to `sum`
    int cabac_mvd(int base, int sum) {
        if (!cb.decision(base + (sum < 3 ? 0 : sum <= 32 ? 1 : 2))) return 0;
        int v = 1, ctx = base + 3;
        while (v < 9 && cb.decision(ctx)) {
            if (v < 4) ctx++;
            v++;
        }
        if (v >= 9) {
            int k = 3;
            while (cb.bypass()) {
                v += 1 << k;
                if (++k > 24) throw Corrupt("an mvd_l0 too long");
            }
            while (k--) v += cb.bypass() << k;
        }
        return cb.bypass() ? -v : v;
    }

    // ctxIdxInc of coded_block_flag for block (x, y) (4x4 units; c the
    // chroma component) of ctxBlockCat cat: neighbours A and B's transBlocks
    int cbf_inc(int mb, int cat, int x, int y, int c) const {
        static const int kOffset[5] = {0, 4, 8, 12, 16};
        const bool intra_mb = intra(mbs[mb]);
        auto term = [&](int n, int bx, int by) -> int {
            if (n < 0) return intra_mb;
            const Mb& m = mbs[n];
            if (m.kind == PCM) return 1;
            if (m.kind == SKIP) return 0;
            switch (cat) {
                case 0: return m.kind == I16 && (m.dc & 1);
                case 3: return (m.cbp >> 4) != 0 && (m.dc >> (1 + c) & 1);
                case 4: return (m.cbp >> 4) == 2 && m.nzc[c][by * 2 + bx] != 0;
                default: return (m.cbp >> (by / 2 * 2 + bx / 2) & 1) && m.nz[by * 4 + bx] != 0;
            }
        };
        if (cat == 0 || cat == 3)
            return kOffset[cat] + term(mb_addr(mb, -1, 0), 0, 0) + 2 * term(mb_addr(mb, 0, -1), 0, 0);
        const int size = cat == 4 ? 2 : 4;
        const int a = x > 0 ? term(mb, x - 1, y) : term(mb_addr(mb, -1, 0), size - 1, y);
        const int t = y > 0 ? term(mb, x, y - 1) : term(mb_addr(mb, 0, -1), x, size - 1);
        return kOffset[cat] + a + 2 * t;
    }

    // One CABAC residual block (7.3.5.3.3) into coeff[0..maxnum) (scan
    // order) given coded_block_flag's ctxIdxInc; the coefficients not zero.
    // ctxBlockCat 5 (an 8x8 luma block, EIGHT) has no coded_block_flag
    // (4:2:0), Table 9-43's significance contexts and ctxIdxOffsets of its
    // own.
    template <bool EIGHT = false>
    int residual_cabac(int* coeff, int maxnum, int cat, int cbf_ctx) {
        static const int kSig[5] = {0, 15, 29, 44, 47}, kAbs[5] = {0, 10, 20, 30, 39};
        std::memset(coeff, 0, sizeof(int) * (size_t)maxnum);
        if (!EIGHT && !cb.decision(85 + cbf_ctx)) return 0;
        int pos[EIGHT ? 64 : 16], n = 0, i = 0;
        for (; i < maxnum - 1; i++) {
            if (EIGHT) {
                if (cb.decision(402 + kSig8[i])) {
                    pos[n++] = i;
                    if (cb.decision(417 + kLast8[i])) break;
                }
                continue;
            }
            const int inc = cat == 3 ? std::min(i, 2) : i;
            if (cb.decision(105 + kSig[cat] + inc)) {
                pos[n++] = i;
                if (cb.decision(166 + kSig[cat] + inc)) break;
            }
        }
        if (i == maxnum - 1) pos[n++] = i;
        int gt1 = 0, eq1 = 0;
        const int base = EIGHT ? 426 : 227 + kAbs[cat];
        for (int k = n - 1; k >= 0; k--) {
            int v = 0;  // coeff_abs_level_minus1: TU prefix (cMax 14), EG0 suffix
            if (cb.decision(base + (gt1 ? 0 : std::min(4, 1 + eq1)))) {
                const int ctx = base + 5 + std::min(4 - (cat == 3), gt1);
                v = 1;
                while (v < 14 && cb.decision(ctx)) v++;
                if (v == 14) {
                    int e = 0;
                    while (cb.bypass()) {
                        v += 1 << e;
                        if (++e > 24) throw Corrupt("a coeff_abs_level_minus1 too long");
                    }
                    while (e--) v += cb.bypass() << e;
                }
            }
            if (v) gt1++;
            else eq1++;
            coeff[pos[k]] = cb.bypass() ? -(v + 1) : v + 1;
        }
        return n;
    }

    // One residual block of macroblock mb: block (x, y) in 4x4 units of
    // ctxBlockCat cat (0 Intra16x16 DC, 1 its AC, 2 luma 4x4, 3 chroma DC,
    // 4 chroma AC of component c); the coefficients not zero.
    int block(Bits& b, int* coeff, int maxnum, int cat, int mb, int x, int y, int c) {
        if (cabac) return residual_cabac(coeff, maxnum, cat, cbf_inc(mb, cat, x, y, c));
        const int nc = cat == 3 ? -1 : cat == 4 ? nc_chroma(mb, c, x, y) : nc_luma(mb, x, y);
        return residual(b, coeff, maxnum, nc);
    }

    void begin_mb(int mb, MbKind kind) {
        Mb& m = mbs[mb];
        m = Mb();
        m.kind = kind;
        m.slice = slice_num;
        m.qp = qp;
        std::memset(m.ref, -1, sizeof(m.ref));
        std::memset(m.refpic, -1, sizeof(m.refpic));
    }

    void skip_mb(int mb) {
        if (lists[0].empty() || !lists[0][0])
            throw Corrupt("a skipped macroblock without a reference picture");
        begin_mb(mb, SKIP);
        if (sh.type == 1) return direct_mb(mb);  // B_Skip
        Mb& m = mbs[mb];
        int mv[2] = {0, 0};
        Motion a = motion(mb, -1, 0, nullptr, 0), b = motion(mb, 0, -1, nullptr, 0);
        if (!(!a.avail || !b.avail || (a.ref == 0 && !a.mv[0] && !a.mv[1]) ||
              (b.ref == 0 && !b.mv[0] && !b.mv[1])))
            mvp(mb, 0, 0, 16, 0, 0, nullptr, 0, mv);
        set_motion(m, 0, 0, 16, 16, 0, 0, mv);
        const int ref[2] = {0, -1}, mvs[2][2] = {{mv[0], mv[1]}, {0, 0}};
        predict(mb, 0, 0, 16, 16, ref, mvs);
    }

    void macroblock(Bits& b, int mb) {
        uint32_t t = cabac ? (uint32_t)cabac_mb_type(mb) : b.ue();
        if (sh.type == 0) {
            if (t < 5) return inter_mb(b, mb, (int)t);
            t -= 5;
        } else if (sh.type == 1) {
            if (t < 23) return b_mb(b, mb, (int)t);
            t -= 23;
        }
        if (t > 25) throw Corrupt("mb_type out of range");
        if (t == 25) return pcm_mb(b, mb);
        intra_mb(b, mb, (int)t);
    }

    void pcm_mb(Bits& b, int mb) {
        if (cabac) cb.sync();
        begin_mb(mb, PCM);
        Mb& m = mbs[mb];
        m.qp = 0;
        std::memset(m.nz, 16, sizeof(m.nz));
        std::memset(m.nzc, 16, sizeof(m.nzc));
        b.align();
        const int x0 = mb % mb_w * 16, y0 = mb / mb_w * 16;
        for (int y = 0; y < 16; y++)
            for (int x = 0; x < 16; x++) cur->y[(size_t)(y0 + y) * w + x0 + x] = (uint8_t)b.u(8);
        for (int c = 0; c < 2; c++) {
            auto& plane = c ? cur->v : cur->u;
            for (int y = 0; y < 8; y++)
                for (int x = 0; x < 8; x++)
                    plane[(size_t)(y0 / 2 + y) * (w / 2) + x0 / 2 + x] = (uint8_t)b.u(8);
        }
        if (cabac) cb.init_engine(b);  // 9.3.1.2, after the samples
    }

    void qp_delta(Bits& b) {
        int d;
        if (!cabac) {
            d = b.se();
        } else if (!cb.decision(60 + (last_dqp != 0))) {
            d = 0;
        } else {  // U binarization of the se(v) mapping
            int v = 1, ctx = 62;
            while (cb.decision(ctx)) {
                ctx = 63;
                if (++v > 52) throw Corrupt("mb_qp_delta out of range");
            }
            d = v & 1 ? (v + 1) >> 1 : -(v >> 1);
        }
        if (d < -26 || d > 25) throw Corrupt("mb_qp_delta out of range");
        cur_dqp = d;
        qp = (qp + d + 52) % 52;
    }

    // the luma residual blocks of I_NxN and inter macroblocks (raster order
    // of their 4x4 blocks into lev[16][16], scan order within each)
    void luma_residual(Bits& b, int mb, int cbp, int (*lev)[16]) {
        Mb& m = mbs[mb];
        for (int blk = 0; blk < 16; blk++) {
            const int x = kBlkX[blk], y = kBlkY[blk];
            if (cbp >> (blk >> 2) & 1)
                m.nz[y * 4 + x] = (uint8_t)block(b, lev[y * 4 + x], 16, 2, mb, x, y, 0);
            else
                std::memset(lev[y * 4 + x], 0, sizeof(int) * 16);
        }
    }

    // The same with transform_size_8x8_flag: each 8x8 block into lev8[i8x8]
    // (scan order).  CAVLC codes it as four interleaved 4x4 blocks
    // (coefficient k of the i-th at 4k + i), each with its own nC and
    // TotalCoeff; CABAC as one block of ctxBlockCat 5, whose
    // coded_block_flag is inferred to be 1.
    void luma_residual8(Bits& b, int mb, int cbp, int (*lev8)[64]) {
        Mb& m = mbs[mb];
        for (int i8 = 0; i8 < 4; i8++) {
            int* lev = lev8[i8];
            std::memset(lev, 0, sizeof(int) * 64);
            if (!(cbp >> i8 & 1)) continue;
            int n = 0;
            if (cabac) {
                n = residual_cabac<true>(lev, 64, 5, 0);
                for (int k = 4 * i8; k < 4 * i8 + 4; k++) m.nz[kBlkY[k] * 4 + kBlkX[k]] = (uint8_t)n;
            } else {
                for (int i4 = 0; i4 < 4; i4++) {
                    const int x = kBlkX[4 * i8 + i4], y = kBlkY[4 * i8 + i4];
                    int c[16];
                    const int tc = residual(b, c, 16, nc_luma(mb, x, y));
                    m.nz[y * 4 + x] = (uint8_t)tc;
                    for (int k = 0; k < 16; k++) lev[4 * k + i4] = c[k];
                    n += tc;
                }
            }
            if (n) m.nz8 |= (uint8_t)(1 << i8);
        }
    }

    // transform_size_8x8_flag (CABAC: ctxIdx 399 + the neighbours A and B
    // that have it)
    bool transform_flag(Bits& b, int mb) {
        if (!cabac) return b.u1();
        const int a = mb_addr(mb, -1, 0), t = mb_addr(mb, 0, -1);
        return cb.decision(399 + (a >= 0 && mbs[a].t8) + (t >= 0 && mbs[t].t8));
    }

    // the first sample of 8x8 block i8 of macroblock mb's luma
    uint8_t* luma_block8(int mb, int i8) { return luma_block(mb, 8 * (i8 >> 1) + 2 * (i8 & 1)); }

    void chroma_residual(Bits& b, int mb, int cbp_c, int (*dc)[4], int (*ac)[4][16]) {
        Mb& m = mbs[mb];
        for (int c = 0; c < 2; c++) {
            if (!cbp_c) std::memset(dc[c], 0, sizeof(int) * 4);
            else if (block(b, dc[c], 4, 3, mb, 0, 0, c)) m.dc |= (uint8_t)(2 << c);
        }
        for (int c = 0; c < 2; c++)
            for (int k = 0; k < 4; k++) {
                std::memset(ac[c][k], 0, sizeof(int) * 16);
                if (cbp_c == 2)
                    m.nzc[c][k] = (uint8_t)block(b, ac[c][k] + 1, 15, 4, mb, k & 1, k >> 1, c);
            }
    }

    void intra_mb(Bits& b, int mb, int t) {
        begin_mb(mb, t == 0 ? I4 : I16);
        Mb& m = mbs[mb];
        int modes[16];
        if (t == 0) {
            if (cp->transform8) m.t8 = transform_flag(b, mb);
            // Intra4x4PredMode of 16 4x4 blocks, or Intra8x8PredMode of 4 8x8
            // blocks (predicted from the top-left 4x4 block's neighbours,
            // 8.3.2.1, and kept in each of its 4x4 blocks)
            for (int blk = 0; blk < (m.t8 ? 4 : 16); blk++) {
                const int x = kBlkX[m.t8 ? 4 * blk : blk], y = kBlkY[m.t8 ? 4 * blk : blk];
                int pred = i4_pred_mode(mb, x, y);
                int mode = pred;
                if (cabac ? !cb.decision(68) : !b.u1()) {  // prev_intra{4x4,8x8}_pred_mode_flag
                    int rem;
                    if (cabac) {  // three bins, the least significant first
                        rem = cb.decision(69);
                        rem |= cb.decision(69) << 1;
                        rem |= cb.decision(69) << 2;
                    } else {
                        rem = (int)b.u(3);
                    }
                    mode = rem < pred ? rem : rem + 1;
                }
                for (int k = 0; k < (m.t8 ? 4 : 1); k++)
                    m.i4[(y + (k >> 1)) * 4 + x + (k & 1)] = (int8_t)mode;
                modes[blk] = mode;
            }
        }
        const int cmode = cabac ? cabac_chroma_mode(mb) : (int)ue_max(b, 3, "intra_chroma_pred_mode");
        m.cmode = (uint8_t)cmode;
        int cbp_l, cbp_c, mode16 = 0;
        if (t == 0) {
            int cbp = cabac ? cabac_cbp(mb) : kIntraCbp[ue_max(b, 47, "coded_block_pattern")];
            cbp_l = cbp & 15;
            cbp_c = cbp >> 4;
            m.cbp = (uint8_t)cbp;
            if (cbp) qp_delta(b);
        } else {
            mode16 = (t - 1) % 4;
            cbp_c = (t - 1) / 4 % 3;
            cbp_l = t >= 13 ? 15 : 0;
            m.cbp = (uint8_t)(cbp_l | cbp_c << 4);
            qp_delta(b);
        }
        if (cbp_c > 2) throw Corrupt("coded_block_pattern out of range");
        m.qp = qp;
        int lev[16][16], lev8[4][64], dcl[16], dc[2][4], ac[2][4][16];
        if (t == 0 && m.t8) {
            luma_residual8(b, mb, cbp_l, lev8);
        } else if (t == 0) {
            luma_residual(b, mb, cbp_l, lev);
        } else {
            if (block(b, dcl, 16, 0, mb, 0, 0, 0)) m.dc |= 1;
            for (int blk = 0; blk < 16; blk++) {
                const int x = kBlkX[blk], y = kBlkY[blk];
                std::memset(lev[y * 4 + x], 0, sizeof(int) * 16);
                if (cbp_l)
                    m.nz[y * 4 + x] = (uint8_t)block(b, lev[y * 4 + x] + 1, 15, 1, mb, x, y, 0);
            }
        }
        chroma_residual(b, mb, cbp_c, dc, ac);
        // reconstruction (lists 0 and 6: intra Y)
        if (t == 0 && m.t8) {
            for (int i8 = 0; i8 < 4; i8++) {
                pred8x8(mb, i8, modes[i8]);
                add_block8(luma_block8(mb, i8), w, lev8[i8], dq8[0][qp]);
            }
        } else if (t == 0) {
            for (int blk = 0; blk < 16; blk++) {
                const int x = kBlkX[blk], y = kBlkY[blk];
                pred4x4(mb, x, y, modes[blk]);
                add_block(luma_block(mb, y * 4 + x), w, lev[y * 4 + x], dq4[0][qp], nullptr);
            }
        } else {
            pred16x16(mb, mode16);
            int dcy[16];
            luma_dc(dcl, dq4[0][qp][0], dcy);
            for (int r = 0; r < 16; r++) add_block(luma_block(mb, r), w, lev[r], dq4[0][qp], &dcy[r]);
        }
        predchroma(mb, cmode);
        chroma_add(mb, dc, ac, true);
    }

    // the first sample of raster 4x4 block r of macroblock mb's luma
    uint8_t* luma_block(int mb, int r) {
        return cur->y.data() + (size_t)(mb / mb_w * 16 + 4 * (r >> 2)) * w + mb % mb_w * 16 +
               4 * (r & 3);
    }

    int i4_pred_mode(int mb, int x, int y) const {
        int a, b;
        if (x > 0) {
            a = mbs[mb].i4[y * 4 + x - 1];
        } else {
            int n = mb_addr(mb, -1, 0);
            if (n < 0) return 2;
            a = mbs[n].kind == I4 ? mbs[n].i4[y * 4 + 3] : 2;
        }
        if (y > 0) {
            b = mbs[mb].i4[(y - 1) * 4 + x];
        } else {
            int n = mb_addr(mb, 0, -1);
            if (n < 0) return 2;
            b = mbs[n].kind == I4 ? mbs[n].i4[12 + x] : 2;
        }
        return std::min(a, b);
    }

    // ------------------------------------------------ transforms
    // The dequantisation tables of the current PPS (dq4, dq8)
    void make_dequant() {
        // normAdjust8x8's position class by (y % 4, x % 4)
        static const uint8_t kClass8[4][4] = {{0, 3, 4, 3}, {3, 1, 5, 1}, {4, 5, 2, 5}, {3, 1, 5, 1}};
        dq_of = cp;
        for (int q = 0; q < 52; q++) {
            const int m = q % 6, sh = q / 6;
            for (int l = 0; l < 6; l++)
                for (int i = 0; i < 16; i++) {
                    const int r = kZigzag[i], x = r & 3, y = r >> 2;
                    const int k = !(x & 1) && !(y & 1) ? 0 : (x & 1) && (y & 1) ? 1 : 2;
                    dq4[l][q][i] = (cp->scale4[l][r] * kNormAdjust[m][k]) << sh;
                }
            for (int l = 0; l < 2; l++)
                for (int i = 0; i < 64; i++) {
                    const int r = kZigzag8[i];
                    dq8[l][q][i] = (cp->scale8[l][r] * kNormAdjust8[m][kClass8[(r >> 3) & 3][r & 3]])
                                   << sh;
                }
        }
    }

    // Dequantises a 4x4 block (raster coefficients from scan order; 8.5.12.1:
    // (c * LevelScale4x4 << QP / 6 + 8) >> 4 is the standard's two cases) and
    // adds its inverse transform to dst; dq: dq4[list][QP]; dc: the already
    // scaled DC
    static void add_block(uint8_t* dst, int stride, const int* scan, const int32_t* dq,
                          const int* dc) {
        int any = dc ? *dc : 0;
        for (int i = dc ? 1 : 0; i < 16; i++) any |= scan[i];
        if (!any) return;
        int d[16];
        for (int i = 0; i < 16; i++) d[kZigzag[i]] = (int)(((int64_t)scan[i] * dq[i] + 8) >> 4);
        if (dc) d[0] = *dc;
        idct_add(dst, stride, d);
    }

    // The same for an 8x8 block (8.5.13): (c * LevelScale8x8 << QP / 6 + 32)
    // >> 6, then the 8x8 inverse transform
    static void add_block8(uint8_t* dst, int stride, const int* scan, const int32_t* dq) {
        int any = 0;
        for (int i = 0; i < 64; i++) any |= scan[i];
        if (!any) return;
        int d[64];
        for (int i = 0; i < 64; i++) d[kZigzag8[i]] = (int)(((int64_t)scan[i] * dq[i] + 32) >> 6);
        idct8_add(dst, stride, d);
    }

    // one 1-D pass of the 8x8 inverse transform over v[0], v[s], .. v[7s]
    static void idct8_1d(int* v, int s) {
        const int d0 = v[0], d1 = v[s], d2 = v[2 * s], d3 = v[3 * s];
        const int d4 = v[4 * s], d5 = v[5 * s], d6 = v[6 * s], d7 = v[7 * s];
        const int a0 = d0 + d4, a4 = d0 - d4, a2 = (d2 >> 1) - d6, a6 = d2 + (d6 >> 1);
        const int b0 = a0 + a6, b2 = a4 + a2, b4 = a4 - a2, b6 = a0 - a6;
        const int a1 = -d3 + d5 - d7 - (d7 >> 1), a3 = d1 + d7 - d3 - (d3 >> 1);
        const int a5 = -d1 + d7 + d5 + (d5 >> 1), a7 = d3 + d5 + d1 + (d1 >> 1);
        const int b1 = a1 + (a7 >> 2), b7 = a7 - (a1 >> 2), b3 = a3 + (a5 >> 2), b5 = (a3 >> 2) - a5;
        v[0] = b0 + b7;
        v[s] = b2 + b5;
        v[2 * s] = b4 + b3;
        v[3 * s] = b6 + b1;
        v[4 * s] = b6 - b1;
        v[5 * s] = b4 - b3;
        v[6 * s] = b2 - b5;
        v[7 * s] = b0 - b7;
    }

    static void idct8_add(uint8_t* dst, int stride, int* d) {
        for (int y = 0; y < 8; y++) idct8_1d(d + 8 * y, 1);  // rows
        for (int x = 0; x < 8; x++) idct8_1d(d + x, 8);      // columns
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++) {
                uint8_t& p = dst[(size_t)y * stride + x];
                p = clip1(p + ((d[8 * y + x] + 32) >> 6));
            }
    }

    static void idct_add(uint8_t* dst, int stride, int* d) {
        for (int y = 0; y < 4; y++) {  // rows
            int* r = d + 4 * y;
            const int e0 = r[0] + r[2], e1 = r[0] - r[2];
            const int e2 = (r[1] >> 1) - r[3], e3 = r[1] + (r[3] >> 1);
            r[0] = e0 + e3;
            r[1] = e1 + e2;
            r[2] = e1 - e2;
            r[3] = e0 - e3;
        }
        for (int x = 0; x < 4; x++) {  // columns
            int g0 = d[x] + d[8 + x], g1 = d[x] - d[8 + x];
            int g2 = (d[4 + x] >> 1) - d[12 + x], g3 = d[4 + x] + (d[12 + x] >> 1);
            int out[4] = {g0 + g3, g1 + g2, g1 - g2, g0 - g3};
            for (int y = 0; y < 4; y++) {
                uint8_t& p = dst[(size_t)y * stride + x];
                p = clip1(p + ((out[y] + 32) >> 6));
            }
        }
    }

    // Intra16x16 DC: inverse Hadamard and scaling (8.5.10: (f * LevelScale4x4(0, 0)
    // << QP / 6 + 32) >> 6, the standard's two cases); ls: dq4[0][QP][0]; out raster
    static void luma_dc(const int* scan, int ls, int* out) {
        int c[16], f[16];
        for (int i = 0; i < 16; i++) c[kZigzag[i]] = scan[i];
        for (int y = 0; y < 4; y++) {
            const int* r = c + 4 * y;
            int a = r[0] + r[1], b = r[0] - r[1], e = r[2] - r[3], g = r[2] + r[3];
            f[4 * y] = a + g;
            f[4 * y + 1] = a - g;
            f[4 * y + 2] = b - e;
            f[4 * y + 3] = b + e;
        }
        for (int x = 0; x < 4; x++) {
            const int a = f[x] + f[4 + x], b = f[x] - f[4 + x];
            const int e = f[8 + x] - f[12 + x], g = f[8 + x] + f[12 + x];
            int col[4] = {a + g, a - g, b - e, b + e};
            for (int y = 0; y < 4; y++) out[4 * y + x] = (int)(((int64_t)col[y] * ls + 32) >> 6);
        }
    }

    // the chroma residual of macroblock mb (8.5.11; dcC = (f * LevelScale4x4(0, 0)
    // << QPc / 6) >> 5), with the lists of intra (1, 2) or inter (4, 5) blocks
    void chroma_add(int mb, int (*dc)[4], int (*ac)[4][16], bool intra_mb) {
        const int x0 = mb % mb_w * 8, y0 = mb / mb_w * 8, cw = w / 2;
        const Tables& t = tables();
        for (int c = 0; c < 2; c++) {
            const int qc = t.chroma_qp[clip3(0, 51, qp + slices[slice_num].chroma_offset[c]) + 12];
            const int32_t* dq = dq4[(intra_mb ? 1 : 4) + c][qc];
            const int* v = dc[c];
            const int f[4] = {v[0] + v[1] + v[2] + v[3], v[0] - v[1] + v[2] - v[3],
                              v[0] + v[1] - v[2] - v[3], v[0] - v[1] - v[2] + v[3]};
            auto& plane = c ? cur->v : cur->u;
            for (int k = 0; k < 4; k++) {
                int dcc = (int)(((int64_t)f[k] * dq[0]) >> 5);
                add_block(plane.data() + (size_t)(y0 + 4 * (k >> 1)) * cw + x0 + 4 * (k & 1), cw,
                          ac[c][k], dq, &dcc);
            }
        }
    }

    // ---------------------------------------------------- intra prediction
    // The nine Intra4x4 (8.3.1.2) or Intra8x8 (8.3.2.2) modes of an NxN
    // block into dst from its (for 8x8, filtered) references: T[0] = L[0] =
    // p[-1, -1], T[1 + x] = p[x, -1] (x < 2N), L[1 + y] = p[-1, y]
    template <int N>
    static void intra_nxn(const int* T, const int* L, int mode, bool top, bool left, bool tl,
                          uint8_t* dst, int stride) {
        auto P = [&](int x, int y) -> int {  // p[x, y] with x or y = -1
            return y < 0 ? T[x + 1] : L[y + 1];
        };
        auto F2 = [](int a, int b) { return (a + b + 1) >> 1; };
        auto F3 = [](int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; };
        const char* need = mode == 0 || mode == 3 || mode == 7 ? "B" : mode == 1 || mode == 8 ? "A"
                          : mode >= 4 && mode <= 6 ? "ABD" : "";
        for (const char* n = need; *n; n++)
            if ((*n == 'A' && !left) || (*n == 'B' && !top) || (*n == 'D' && !tl))
                throw Corrupt("an intra NxN mode whose neighbours are not available");
        if (mode < 0 || mode > 8) throw Corrupt("an intra NxN mode out of range");
        const int shift = N == 4 ? 2 : 3;
        int dc = 128;
        if (mode == 2) {
            int st = 0, sl = 0;
            for (int i = 0; i < N; i++) st += P(i, -1), sl += P(-1, i);
            dc = top && left ? (st + sl + N) >> (shift + 1) : left ? (sl + N / 2) >> shift
                 : top ? (st + N / 2) >> shift : 128;
        }
        for (int y = 0; y < N; y++)
            for (int x = 0; x < N; x++) {
                int v = 0;
                switch (mode) {
                    case 0: v = P(x, -1); break;
                    case 1: v = P(-1, y); break;
                    case 2: v = dc; break;
                    case 3:
                        v = x == N - 1 && y == N - 1
                                ? (P(2 * N - 2, -1) + 3 * P(2 * N - 1, -1) + 2) >> 2
                                : F3(P(x + y, -1), P(x + y + 1, -1), P(x + y + 2, -1));
                        break;
                    case 4:
                        if (x > y) v = F3(P(x - y - 2, -1), P(x - y - 1, -1), P(x - y, -1));
                        else if (x < y) v = F3(P(-1, y - x - 2), P(-1, y - x - 1), P(-1, y - x));
                        else v = F3(P(0, -1), P(-1, -1), P(-1, 0));
                        break;
                    case 5: {
                        const int z = 2 * x - y, k = x - (y >> 1);
                        if (z >= 0 && !(z & 1)) v = F2(P(k - 1, -1), P(k, -1));
                        else if (z >= 0) v = F3(P(k - 2, -1), P(k - 1, -1), P(k, -1));
                        else if (z == -1) v = F3(P(-1, 0), P(-1, -1), P(0, -1));
                        else v = F3(P(-1, y - 2 * x - 1), P(-1, y - 2 * x - 2), P(-1, y - 2 * x - 3));
                        break;
                    }
                    case 6: {
                        const int z = 2 * y - x, k = y - (x >> 1);
                        if (z >= 0 && !(z & 1)) v = F2(P(-1, k - 1), P(-1, k));
                        else if (z >= 0) v = F3(P(-1, k - 2), P(-1, k - 1), P(-1, k));
                        else if (z == -1) v = F3(P(-1, 0), P(-1, -1), P(0, -1));
                        else v = F3(P(x - 2 * y - 1, -1), P(x - 2 * y - 2, -1), P(x - 2 * y - 3, -1));
                        break;
                    }
                    case 7: {
                        const int k = x + (y >> 1);
                        v = !(y & 1) ? F2(P(k, -1), P(k + 1, -1))
                                     : F3(P(k, -1), P(k + 1, -1), P(k + 2, -1));
                        break;
                    }
                    default: {
                        const int z = x + 2 * y, k = y + (x >> 1);
                        if (z < 2 * N - 3 && !(z & 1)) v = F2(P(-1, k), P(-1, k + 1));
                        else if (z < 2 * N - 3) v = F3(P(-1, k), P(-1, k + 1), P(-1, k + 2));
                        else if (z == 2 * N - 3) v = (P(-1, N - 2) + 3 * P(-1, N - 1) + 2) >> 2;
                        else v = P(-1, N - 1);
                        break;
                    }
                }
                dst[(size_t)y * stride + x] = (uint8_t)v;
            }
    }

    void pred4x4(int mb, int bx, int by, int mode) {
        const int x0 = mb % mb_w * 16 + 4 * bx, y0 = mb / mb_w * 16 + 4 * by;
        const bool mbA = mb_addr(mb, -1, 0) >= 0, mbB = mb_addr(mb, 0, -1) >= 0;
        const bool left = bx > 0 || mbA, top = by > 0 || mbB;
        bool tl, tr;
        if (bx > 0 && by > 0) tl = true;
        else if (bx == 0 && by > 0) tl = mbA;
        else if (by == 0 && bx > 0) tl = mbB;
        else tl = mb_addr(mb, -1, -1) >= 0;
        if (by == 0) tr = bx < 3 ? mbB : mb_addr(mb, 1, -1) >= 0;
        else tr = bx < 3 && kBlkIdx[(by - 1) * 4 + bx + 1] < kBlkIdx[by * 4 + bx];
        uint8_t* dst = cur->y.data() + (size_t)y0 * w + x0;
        int T[9], L[5];
        T[0] = L[0] = tl ? dst[-w - 1] : 0;
        for (int i = 0; i < 8; i++)
            T[1 + i] = !top ? 0 : i < 4 || tr ? dst[-w + i] : dst[-w + 3];
        for (int i = 0; i < 4; i++) L[1 + i] = left ? dst[(size_t)i * w - 1] : 0;
        intra_nxn<4>(T, L, mode, top, left, tl, dst, w);
    }

    // Intra8x8 block i8 of macroblock mb: the reference samples (p[8..15, -1]
    // from the macroblock above for block 0, above right for block 1, block
    // 1 for block 2; none for block 3, which repeats p[7, -1]), filtered
    // (8.3.2.2.1), then the mode
    void pred8x8(int mb, int i8, int mode) {
        const int bx = i8 & 1, by = i8 >> 1;
        const int x0 = mb % mb_w * 16 + 8 * bx, y0 = mb / mb_w * 16 + 8 * by;
        const bool mbA = mb_addr(mb, -1, 0) >= 0, mbB = mb_addr(mb, 0, -1) >= 0;
        const bool left = bx || mbA, top = by || mbB;
        const bool tl = bx && by ? true : bx ? mbB : by ? mbA : mb_addr(mb, -1, -1) >= 0;
        const bool tr = i8 == 0 ? mbB : i8 == 1 ? mb_addr(mb, 1, -1) >= 0 : i8 == 2;
        uint8_t* dst = cur->y.data() + (size_t)y0 * w + x0;
        int t[16] = {}, l[8] = {};
        const int c = tl ? dst[-w - 1] : 0;
        for (int i = 0; i < 16 && top; i++) t[i] = dst[-w + (i < 8 || tr ? i : 7)];
        for (int i = 0; i < 8 && left; i++) l[i] = dst[(size_t)i * w - 1];
        int T[17] = {}, L[9] = {};
        if (top) {
            T[1] = ((tl ? c : t[0]) + 2 * t[0] + t[1] + 2) >> 2;
            for (int x = 1; x < 15; x++) T[1 + x] = (t[x - 1] + 2 * t[x] + t[x + 1] + 2) >> 2;
            T[16] = (t[14] + 3 * t[15] + 2) >> 2;
        }
        if (tl)
            T[0] = top && left ? (t[0] + 2 * c + l[0] + 2) >> 2
                   : top       ? (3 * c + t[0] + 2) >> 2
                   : left      ? (3 * c + l[0] + 2) >> 2
                               : c;
        L[0] = T[0];
        if (left) {
            L[1] = ((tl ? c : l[0]) + 2 * l[0] + l[1] + 2) >> 2;
            for (int y = 1; y < 7; y++) L[1 + y] = (l[y - 1] + 2 * l[y] + l[y + 1] + 2) >> 2;
            L[8] = (l[6] + 3 * l[7] + 2) >> 2;
        }
        intra_nxn<8>(T, L, mode, top, left, tl, dst, w);
    }

    // 16x16 luma (mode 0 V, 1 H, 2 DC, 3 plane) or 8x8 chroma (0 DC, 1 H,
    // 2 V, 3 plane) prediction into plane at the macroblock
    void pred_block(int mb, uint8_t* plane, int stride, int n, int mode, bool chroma) {
        const int x0 = mb % mb_w * n, y0 = mb / mb_w * n;
        const bool A = mb_addr(mb, -1, 0) >= 0, B = mb_addr(mb, 0, -1) >= 0;
        const bool D = mb_addr(mb, -1, -1) >= 0;
        uint8_t* dst = plane + (size_t)y0 * stride + x0;
        int top[16], left[16];
        for (int i = 0; i < n; i++) {
            top[i] = B ? dst[-stride + i] : 0;
            left[i] = A ? dst[(size_t)i * stride - 1] : 0;
        }
        const int corner = D ? dst[-stride - 1] : 0;
        // the luma numbering: 0 V, 1 H, 2 DC, 3 plane
        const int kind = chroma ? (mode == 0 ? 2 : mode == 1 ? 1 : mode == 2 ? 0 : 3) : mode;
        if ((kind == 0 && !B) || (kind == 1 && !A) || (kind == 3 && !(A && B && D)))
            throw Corrupt("an intra mode whose neighbours are not available");
        int out[16][16];
        if (kind == 0 || kind == 1) {
            for (int y = 0; y < n; y++)
                for (int x = 0; x < n; x++) out[y][x] = kind == 0 ? top[x] : left[y];
        } else if (kind == 2 && !chroma) {
            int st = 0, sl = 0;
            for (int i = 0; i < 16; i++) st += top[i], sl += left[i];
            int v = A && B ? (st + sl + 16) >> 5 : A ? (sl + 8) >> 4 : B ? (st + 8) >> 4 : 128;
            for (int y = 0; y < 16; y++)
                for (int x = 0; x < 16; x++) out[y][x] = v;
        } else if (kind == 2) {  // chroma DC, each 4x4 block (8.3.4.1-3)
            for (int by = 0; by < 2; by++)
                for (int bx = 0; bx < 2; bx++) {
                    int st = 0, sl = 0;
                    for (int i = 0; i < 4; i++) st += top[4 * bx + i], sl += left[4 * by + i];
                    int v;
                    if ((bx == 0 && by == 0) || (bx && by))
                        v = A && B ? (st + sl + 4) >> 3
                            : A    ? (sl + 2) >> 2
                            : B    ? (st + 2) >> 2
                                   : 128;
                    else if (bx)
                        v = B ? (st + 2) >> 2 : A ? (sl + 2) >> 2 : 128;
                    else
                        v = A ? (sl + 2) >> 2 : B ? (st + 2) >> 2 : 128;
                    for (int y = 0; y < 4; y++)
                        for (int x = 0; x < 4; x++) out[4 * by + y][4 * bx + x] = v;
                }
        } else {  // plane
            const int half = n / 2;
            auto T = [&](int i) { return i < 0 ? corner : top[i]; };
            auto L = [&](int i) { return i < 0 ? corner : left[i]; };
            int H = 0, V = 0;
            for (int i = 0; i < half; i++) {
                H += (i + 1) * (T(half + i) - T(half - 2 - i));
                V += (i + 1) * (L(half + i) - L(half - 2 - i));
            }
            const int a = 16 * (left[n - 1] + top[n - 1]);
            const int b = chroma ? (34 * H + 32) >> 6 : (5 * H + 32) >> 6;
            const int c = chroma ? (34 * V + 32) >> 6 : (5 * V + 32) >> 6;
            for (int y = 0; y < n; y++)
                for (int x = 0; x < n; x++)
                    out[y][x] = clip1((a + b * (x - (half - 1)) + c * (y - (half - 1)) + 16) >> 5);
        }
        for (int y = 0; y < n; y++)
            for (int x = 0; x < n; x++) dst[(size_t)y * stride + x] = (uint8_t)out[y][x];
    }
    void pred16x16(int mb, int mode) { pred_block(mb, cur->y.data(), w, 16, mode, false); }
    void predchroma(int mb, int mode) {
        pred_block(mb, cur->u.data(), w / 2, 8, mode, true);
        pred_block(mb, cur->v.data(), w / 2, 8, mode, true);
    }

    // ------------------------------------------------------- inter
    // Motion data of list `list` of the partition covering (x, y) relative
    // to macroblock mb (x, y may be -1 or 16); within the macroblock only
    // blocks in `done` count.
    Motion motion(int mb, int x, int y, const bool* done, int list) const {
        Motion r;
        int n;
        if (x >= 0 && x < 16 && y >= 0 && y < 16) {
            if (!done || !done[(y >> 2) * 4 + (x >> 2)]) return r;
            n = mb;
        } else if (x > 15 && y >= 0) {
            return r;
        } else {
            n = mb_addr(mb, x < 0 ? -1 : x > 15 ? 1 : 0, y < 0 ? -1 : 0);
            if (n < 0) return r;
        }
        r.avail = true;
        const Mb& m = mbs[n];
        if (m.kind != INTER && m.kind != SKIP) return r;
        const int b = (((y + 16) & 15) >> 2) * 4 + (((x + 16) & 15) >> 2);
        r.ref = m.ref[list][b];
        r.mv[0] = m.mv[list][b][0];
        r.mv[1] = m.mv[list][b][1];
        return r;
    }

    static int median(int a, int b, int c) {
        return std::max(std::min(a, b), std::min(std::max(a, b), c));
    }

    // 8.4.1.3: the motion vector prediction of list `list` of the partition
    // at (x, y), pw wide, with reference index ref; shape 1: 16x8, 2: 8x16,
    // 0 else
    void mvp(int mb, int x, int y, int pw, int ref, int shape, const bool* done, int list,
             int* out) const {
        Motion A = motion(mb, x - 1, y, done, list), B = motion(mb, x, y - 1, done, list);
        Motion C = motion(mb, x + pw, y - 1, done, list);
        if (!C.avail) C = motion(mb, x - 1, y - 1, done, list);
        if (shape == 1) {
            if (y == 0 && B.ref == ref) return copy(B, out);
            if (y == 8 && A.ref == ref) return copy(A, out);
        } else if (shape == 2) {
            if (x == 0 && A.ref == ref) return copy(A, out);
            if (x == 8 && C.ref == ref) return copy(C, out);
        }
        if (!B.avail && !C.avail && A.avail) {
            B = A;
            C = A;
        }
        const int matches = (A.ref == ref) + (B.ref == ref) + (C.ref == ref);
        if (matches == 1) {
            return copy(A.ref == ref ? A : B.ref == ref ? B : C, out);
        }
        out[0] = median(A.mv[0], B.mv[0], C.mv[0]);
        out[1] = median(A.mv[1], B.mv[1], C.mv[1]);
    }
    static void copy(const Motion& m, int* out) {
        out[0] = m.mv[0];
        out[1] = m.mv[1];
    }

    // list `list`'s motion of the blocks of a partition (ref -1: unused)
    void set_motion(Mb& m, int x, int y, int pw, int ph, int list, int ref, const int* mv) {
        for (int j = y >> 2; j < (y + ph) >> 2; j++)
            for (int i = x >> 2; i < (x + pw) >> 2; i++) {
                m.ref[list][j * 4 + i] = (int8_t)ref;
                m.refpic[list][j * 4 + i] = ref >= 0 ? lists[list][ref]->id : -1;
                m.mv[list][j * 4 + i][0] = (int16_t)(ref >= 0 ? mv[0] : 0);
                m.mv[list][j * 4 + i][1] = (int16_t)(ref >= 0 ? mv[1] : 0);
            }
    }

    // A partition of an inter macroblock: its place, prediction mode (bit 0
    // list 0, bit 1 list 1), shape for the prediction (1 16x8, 2 8x16, 0
    // else), its sub-macroblock (-1 none), reference indices and mvds
    struct Part {
        int x, y, w, h, mode, shape, sub;
        int ref[2], mvd[2][2];
    };

    // ref_idx_lX of a partition: 0 where the list has one entry, else te(v)
    // or CABAC; pref keeps list X's indices read, by 4x4 block
    int read_ref(Bits& b, int mb, int list, int x, int y, int pw, int ph, int8_t* pref) {
        const int n = sh.nref[list];
        int r = 0;
        if (n > 1) r = cabac ? cabac_ref(mb, x, y, pref, list) : n == 2 ? !b.u1() : (int)b.ue();
        if (r >= n) throw Corrupt("ref_idx out of range");
        for (int j = y >> 2; j < (y + ph) >> 2; j++)
            for (int i = x >> 2; i < (x + pw) >> 2; i++) pref[j * 4 + i] = (int8_t)r;
        return r;
    }

    // mvd_l0 then mvd_l1 of the partitions that use each list, in order
    void read_mvds(Bits& b, int mb, Part* parts, int np) {
        Mb& m = mbs[mb];
        for (int l = 0; l < 2; l++)
            for (int k = 0; k < np; k++) {
                Part& p = parts[k];
                if (p.ref[l] < 0) continue;
                for (int c = 0; c < 2; c++) {
                    if (!cabac) {
                        p.mvd[l][c] = b.se();
                        continue;
                    }
                    const int sum = abs_mvd(mb, p.x - 1, p.y, c, l) + abs_mvd(mb, p.x, p.y - 1, c, l);
                    p.mvd[l][c] = cabac_mvd(c ? 47 : 40, sum);
                    for (int j = p.y >> 2; j < (p.y + p.h) >> 2; j++)
                        for (int i = p.x >> 2; i < (p.x + p.w) >> 2; i++)
                            m.mvd[l][j * 4 + i][c] = (uint8_t)std::min(std::abs(p.mvd[l][c]), 70);
                }
            }
    }

    // the motion vectors of a partition (prediction plus mvd), its motion
    // data, and its prediction
    void inter_part(int mb, const Part& p, bool* done) {
        Mb& m = mbs[mb];
        int mv[2][2] = {{0, 0}, {0, 0}};
        for (int l = 0; l < 2; l++) {
            if (p.ref[l] < 0) continue;
            if (p.ref[l] >= (int)lists[l].size() || !lists[l][p.ref[l]])
                throw Corrupt("a partition names a missing reference picture");
            mvp(mb, p.x, p.y, p.w, p.ref[l], p.shape, done, l, mv[l]);
            for (int c = 0; c < 2; c++) {
                mv[l][c] += p.mvd[l][c];
                if (mv[l][c] < -32768 || mv[l][c] > 32767) throw Corrupt("a motion vector out of range");
            }
        }
        for (int l = 0; l < 2; l++) set_motion(m, p.x, p.y, p.w, p.h, l, p.ref[l], mv[l]);
        for (int j = p.y >> 2; j < (p.y + p.h) >> 2; j++)
            for (int i = p.x >> 2; i < (p.x + p.w) >> 2; i++) done[j * 4 + i] = true;
        predict(mb, p.x, p.y, p.w, p.h, p.ref, mv);
    }

    // P mb_types 0-4 (P_L0_16x16, P_L0_L0_16x8, P_L0_L0_8x16, P_8x8, P_8x8ref0)
    void inter_mb(Bits& b, int mb, int t) {
        begin_mb(mb, INTER);
        Part parts[16];
        int np = 0;
        int8_t pref[16] = {};
        if (t < 3) {
            for (int i = 0; i < (t == 0 ? 1 : 2); i++) {
                if (t == 0) parts[np++] = {0, 0, 16, 16, 1, 0, -1, {0, -1}, {}};
                else if (t == 1) parts[np++] = {0, 8 * i, 16, 8, 1, 1, -1, {0, -1}, {}};
                else parts[np++] = {8 * i, 0, 8, 16, 1, 2, -1, {0, -1}, {}};
            }
            for (int k = 0; k < np; k++)
                parts[k].ref[0] = read_ref(b, mb, 0, parts[k].x, parts[k].y, parts[k].w, parts[k].h, pref);
        } else {
            int sub[4], refs[4] = {0, 0, 0, 0};
            for (int& st : sub) st = cabac ? cabac_sub_type() : (int)ue_max(b, 3, "sub_mb_type");
            if (t == 3)
                for (int i = 0; i < 4; i++) refs[i] = read_ref(b, mb, 0, 8 * (i & 1), 8 * (i >> 1), 8, 8, pref);
            for (int i = 0; i < 4; i++) {
                const int sx = 8 * (i & 1), sy = 8 * (i >> 1);
                const int pw = sub[i] < 2 ? 8 : 4, ph = sub[i] == 0 || sub[i] == 2 ? 8 : 4;
                for (int k = 0; k < 64 / (pw * ph); k++) {
                    Part p{sx, sy, pw, ph, 1, 0, i, {refs[i], -1}, {}};
                    if (sub[i] == 1) p.y += 4 * k;
                    else if (sub[i] == 2) p.x += 4 * k;
                    else if (sub[i] == 3) p.x += 4 * (k & 1), p.y += 4 * (k >> 1);
                    parts[np++] = p;
                }
            }
        }
        read_mvds(b, mb, parts, np);
        bool done[16] = {};
        for (int k = 0; k < np; k++) inter_part(mb, parts[k], done);
        inter_residual(b, mb, t < 3 || np == 4);  // P_8x8: every sub-macroblock 8x8
    }

    // Table 7-14: the prediction modes (bit 0 list 0, bit 1 list 1) of the
    // two partitions of B mb_types 4-21, by (mb_type - 4) / 2
    static constexpr uint8_t kBModes[9][2] = {{1, 1}, {2, 2}, {1, 2}, {2, 1}, {1, 3},
                                             {2, 3}, {3, 1}, {3, 2}, {3, 3}};
    // Table 7-18: a B sub_mb_type's prediction mode (0 direct) and shape (0
    // 8x8, 1 8x4, 2 4x8, 3 4x4)
    static constexpr uint8_t kBSub[13][2] = {{0, 0}, {1, 0}, {2, 0}, {3, 0}, {1, 1}, {1, 2}, {2, 1},
                                            {2, 2}, {3, 1}, {3, 2}, {1, 3}, {2, 3}, {3, 3}};

    // B mb_types 0-22 (Table 7-14)
    void b_mb(Bits& b, int mb, int t) {
        begin_mb(mb, INTER);
        Mb& m = mbs[mb];
        if (t == 0) {  // B_Direct_16x16
            direct_mb(mb);
            return inter_residual(b, mb, cs->direct8x8);
        }
        Part parts[16];
        int np = 0;
        int sub[4] = {-1, -1, -1, -1};
        if (t <= 3) {
            parts[np++] = {0, 0, 16, 16, t, 0, -1, {-1, -1}, {}};
        } else if (t < 22) {
            const int k = t - 4;
            for (int i = 0; i < 2; i++)
                parts[np++] = k & 1 ? Part{8 * i, 0, 8, 16, kBModes[k / 2][i], 2, -1, {-1, -1}, {}}
                                    : Part{0, 8 * i, 16, 8, kBModes[k / 2][i], 1, -1, {-1, -1}, {}};
        } else {  // B_8x8
            for (int& st : sub) st = cabac ? cabac_sub_type() : (int)ue_max(b, 12, "sub_mb_type");
            for (int i = 0; i < 4; i++) {
                const int mode = kBSub[sub[i]][0], shape = kBSub[sub[i]][1];
                if (!mode) {
                    m.direct |= (uint8_t)(1 << i);
                    continue;
                }
                const int pw = shape == 0 || shape == 1 ? 8 : 4, ph = shape == 0 || shape == 2 ? 8 : 4;
                for (int k = 0; k < 64 / (pw * ph); k++)
                    parts[np++] = {8 * (i & 1) + (k * pw) % 8, 8 * (i >> 1) + (k * pw) / 8 * ph, pw, ph,
                                   mode, 0, i, {-1, -1}, {}};
            }
        }
        int8_t pref[2][16] = {};
        for (int l = 0; l < 2; l++) {
            if (t < 22) {
                for (int k = 0; k < np; k++)
                    if (parts[k].mode >> l & 1)
                        parts[k].ref[l] = read_ref(b, mb, l, parts[k].x, parts[k].y, parts[k].w,
                                                   parts[k].h, pref[l]);
                continue;
            }
            for (int i = 0; i < 4; i++) {
                if (!(kBSub[sub[i]][0] >> l & 1)) continue;
                const int r = read_ref(b, mb, l, 8 * (i & 1), 8 * (i >> 1), 8, 8, pref[l]);
                for (int k = 0; k < np; k++)
                    if (parts[k].sub == i) parts[k].ref[l] = r;
            }
        }
        read_mvds(b, mb, parts, np);
        bool done[16] = {};
        if (t < 22) {
            for (int k = 0; k < np; k++) inter_part(mb, parts[k], done);
        } else {
            int dref[2] = {0, 0}, dmv[2][2] = {};
            if (m.direct && sh.direct_spatial) spatial_direct(mb, dref, dmv);
            for (int i = 0; i < 4; i++) {
                if (m.direct >> i & 1) {
                    direct8(mb, i, dref, dmv);
                    for (int k = 0; k < 4; k++) done[(2 * (i >> 1) + (k >> 1)) * 4 + 2 * (i & 1) + (k & 1)] = true;
                    predict_direct(mb, 1 << i);
                    continue;
                }
                for (int k = 0; k < np; k++)
                    if (parts[k].sub == i) inter_part(mb, parts[k], done);
            }
        }
        bool allow8 = true;  // B_8x8: each sub-macroblock 8x8, or direct with direct_8x8_inference_flag
        for (int i = 0; i < 4 && t == 22; i++)
            allow8 &= kBSub[sub[i]][0] ? kBSub[sub[i]][1] == 0 : cs->direct8x8;
        inter_residual(b, mb, allow8);
    }

    // coded_block_pattern, transform_size_8x8_flag (where the PPS allows it,
    // luma is coded and `allow8`: no partition below 8x8, a direct 8x8 block
    // only with direct_8x8_inference_flag), mb_qp_delta and the residual of
    // an inter macroblock (lists 3 and 7: inter Y)
    void inter_residual(Bits& b, int mb, bool allow8) {
        Mb& m = mbs[mb];
        int cbp = cabac ? cabac_cbp(mb) : kInterCbp[ue_max(b, 47, "coded_block_pattern")];
        m.cbp = (uint8_t)cbp;
        if ((cbp & 15) && allow8 && cp->transform8) m.t8 = transform_flag(b, mb);
        if (cbp) qp_delta(b);
        m.qp = qp;
        int lev[16][16], lev8[4][64], dc[2][4], ac[2][4][16];
        if (m.t8) luma_residual8(b, mb, cbp & 15, lev8);
        else luma_residual(b, mb, cbp & 15, lev);
        chroma_residual(b, mb, cbp >> 4, dc, ac);
        if (m.t8)
            for (int i8 = 0; i8 < 4; i8++) add_block8(luma_block8(mb, i8), w, lev8[i8], dq8[1][qp]);
        else
            for (int r = 0; r < 16; r++) add_block(luma_block(mb, r), w, lev[r], dq4[3][qp], nullptr);
        chroma_add(mb, dc, ac, false);
    }

    // B_Skip and B_Direct_16x16: every 8x8 block in direct mode
    void direct_mb(int mb) {
        mbs[mb].direct = 31;
        int dref[2] = {0, 0}, dmv[2][2] = {};
        if (sh.direct_spatial) spatial_direct(mb, dref, dmv);
        for (int i = 0; i < 4; i++) direct8(mb, i, dref, dmv);
        predict_direct(mb, 15);
    }

    // 8.4.1.2.2: spatial direct's reference indices (MinPositive of the
    // neighbours A, B and C of the whole macroblock) and motion vectors
    void spatial_direct(int mb, int* ref, int (*mv)[2]) const {
        auto min_positive = [](int a, int b) { return a >= 0 && b >= 0 ? std::min(a, b) : std::max(a, b); };
        for (int l = 0; l < 2; l++) {
            const Motion A = motion(mb, -1, 0, nullptr, l), B = motion(mb, 0, -1, nullptr, l);
            Motion C = motion(mb, 16, -1, nullptr, l);
            if (!C.avail) C = motion(mb, -1, -1, nullptr, l);
            ref[l] = min_positive(A.ref, min_positive(B.ref, C.ref));
            mv[l][0] = mv[l][1] = 0;
            if (ref[l] >= 0) mvp(mb, 0, 0, 16, ref[l], 0, nullptr, l, mv[l]);
        }
        if (ref[0] < 0 && ref[1] < 0) ref[0] = ref[1] = 0;
    }

    // The motion of 8x8 block i8 in direct mode (8.4.1.2): spatial from the
    // macroblock's (ref, mv) with colZeroFlag, or temporal; the co-located
    // block is the corner 4x4 block of the 8x8 block with
    // direct_8x8_inference_flag, else the same 4x4 block.
    void direct8(int mb, int i8, const int* dref, const int (*dmv)[2]) {
        Mb& m = mbs[mb];
        const Picture& colp = *lists[1][0];
        const ColMb* col = colp.col.empty() ? nullptr : &colp.col[mb];  // none: grey pictures
        const int x8 = i8 & 1, y8 = i8 >> 1;
        auto small = [](const int16_t* v) { return std::abs(v[0]) <= 1 && std::abs(v[1]) <= 1; };
        for (int k = 0; k < 4; k++) {
            const int bx = 2 * x8 + (k & 1), by = 2 * y8 + (k >> 1);
            const int cb = cs->direct8x8 ? 12 * y8 + 3 * x8 : by * 4 + bx;
            int ref[2], mv[2][2];
            if (sh.direct_spatial) {
                for (int l = 0; l < 2; l++) {
                    ref[l] = dref[l];
                    mv[l][0] = dmv[l][0];
                    mv[l][1] = dmv[l][1];
                }
                if (col && !col->intra &&
                    ((col->ref[0][i8] == 0 && small(col->mv[0][cb])) ||
                     (col->ref[0][i8] < 0 && col->ref[1][i8] == 0 && small(col->mv[1][cb]))))
                    for (int l = 0; l < 2; l++)
                        if (ref[l] == 0) mv[l][0] = mv[l][1] = 0;
            } else {
                ref[0] = ref[1] = 0;
                mv[0][0] = mv[0][1] = mv[1][0] = mv[1][1] = 0;
                if (col && !col->intra) {
                    const int l = col->ref[0][i8] >= 0 ? 0 : 1;
                    // MapColToList0 (FFmpeg's fill_colmap): the first list 0
                    // entry of the frame_num the co-located picture's first
                    // slice names by refIdxCol, else 0
                    const int old = col->ref[l][i8];
                    if (old < colp.ref_cnt[l])
                        for (int j = 0; j < sh.nref[0]; j++)
                            if (lists[0][j]->frame_num == colp.ref_fn[l][old]) {
                                ref[0] = j;
                                break;
                            }
                    const int16_t* mc = col->mv[l][cb];
                    const int sf = dist_scale[ref[0]];
                    for (int c = 0; c < 2; c++) {
                        mv[0][c] = (int16_t)((sf * mc[c] + 128) >> 8);
                        mv[1][c] = mv[0][c] - mc[c];
                    }
                }
            }
            for (int l = 0; l < 2; l++) set_motion(m, 4 * bx, 4 * by, 4, 4, l, ref[l], mv[l]);
        }
    }

    // Predicts the 8x8 blocks of `mask` in direct mode from their motion:
    // the macroblock, an 8x8 block or each 4x4 block at once where they
    // share it (the samples are the same either way)
    void predict_direct(int mb, int mask) {
        const Mb& m = mbs[mb];
        auto same = [&](int a, int b) {
            for (int l = 0; l < 2; l++)
                if (m.ref[l][a] != m.ref[l][b] || m.mv[l][a][0] != m.mv[l][b][0] ||
                    m.mv[l][a][1] != m.mv[l][b][1])
                    return false;
            return true;
        };
        auto part = [&](int blk, int size) {
            const int ref[2] = {m.ref[0][blk], m.ref[1][blk]};
            const int mv[2][2] = {{m.mv[0][blk][0], m.mv[0][blk][1]}, {m.mv[1][blk][0], m.mv[1][blk][1]}};
            predict(mb, 4 * (blk & 3), 4 * (blk >> 2), size, size, ref, mv);
        };
        if (mask == 15) {
            bool all = true;
            for (int b = 1; b < 16 && all; b++) all = same(0, b);
            if (all) return part(0, 16);
        }
        for (int i8 = 0; i8 < 4; i8++) {
            if (!(mask >> i8 & 1)) continue;
            const int b0 = 8 * (i8 >> 1) + 2 * (i8 & 1);
            if (same(b0, b0 + 1) && same(b0, b0 + 4) && same(b0, b0 + 5)) {
                part(b0, 8);
                continue;
            }
            for (int k : {b0, b0 + 1, b0 + 4, b0 + 5}) part(k, 4);
        }
    }

    // the absolute mvd component c of list l (at most 70) of the partition
    // covering (x, y) relative to macroblock mb (x or y may be -1); 0 where
    // there is none
    int abs_mvd(int mb, int x, int y, int c, int l) const {
        if (x >= 0 && y >= 0) return mbs[mb].mvd[l][(y >> 2) * 4 + (x >> 2)][c];
        const int n = mb_addr(mb, x < 0 ? -1 : 0, y < 0 ? -1 : 0);
        return n < 0 ? 0 : mbs[n].mvd[l][(((y + 16) & 15) >> 2) * 4 + (((x + 16) & 15) >> 2)][c];
    }

    // 8.4.2: the prediction of a partition from list 0, list 1 or both
    // (ref -1: the list is unused): one list's samples (weighted where the
    // slice is explicitly weighted), or the two combined: explicitly
    // weighted, implicitly weighted, or averaged
    void predict(int mb, int x, int y, int pw, int ph, const int* ref, const int (*mv)[2]) {
        const int xa = mb % mb_w * 16 + x, ya = mb / mb_w * 16 + y, cw = w / 2;
        uint8_t* dy = cur->y.data() + (size_t)ya * w + xa;
        uint8_t* du = cur->u.data() + (size_t)(ya / 2) * cw + xa / 2;
        uint8_t* dv = cur->v.data() + (size_t)(ya / 2) * cw + xa / 2;
        if (ref[0] < 0 || ref[1] < 0) {
            const int l = ref[0] >= 0 ? 0 : 1;
            mc(*lists[l][ref[l]], xa, ya, pw, ph, mv[l], dy, w, du, dv, cw);
            if (sh.weighted) weight(l, ref[l], dy, du, dv, pw, ph);
            return;
        }
        uint8_t ty[256], tu[64], tv[64];
        mc(*lists[0][ref[0]], xa, ya, pw, ph, mv[0], dy, w, du, dv, cw);
        mc(*lists[1][ref[1]], xa, ya, pw, ph, mv[1], ty, 16, tu, tv, 8);
        const int r0 = ref[0], r1 = ref[1];
        for (int c = 0; c < 3; c++) {
            uint8_t* d = c == 0 ? dy : c == 1 ? du : dv;
            const uint8_t* t = c == 0 ? ty : c == 1 ? tu : tv;
            const int ds = c ? cw : w, ts = c ? 8 : 16, bw = c ? pw / 2 : pw, bh = c ? ph / 2 : ph;
            if (sh.weighted) {  // 8.4.2.3.2, explicit
                const int lwd = sh.log2_wd[c ? 1 : 0];
                const int w0 = sh.weight[0][r0][c], w1 = sh.weight[1][r1][c];
                const int o = (sh.offset[0][r0][c] + sh.offset[1][r1][c] + 1) >> 1;
                for (int j = 0; j < bh; j++)
                    for (int i = 0; i < bw; i++) {
                        uint8_t& p = d[(size_t)j * ds + i];
                        p = clip1(((p * w0 + t[j * ts + i] * w1 + (1 << lwd)) >> (lwd + 1)) + o);
                    }
            } else if (implicit && implicit_w[r0][r1] != 32) {  // implicit: logWD 5, offsets 0
                const int w0 = implicit_w[r0][r1], w1 = 64 - w0;
                for (int j = 0; j < bh; j++)
                    for (int i = 0; i < bw; i++) {
                        uint8_t& p = d[(size_t)j * ds + i];
                        p = clip1((p * w0 + t[j * ts + i] * w1 + 32) >> 6);
                    }
            } else {
                for (int j = 0; j < bh; j++)
                    for (int i = 0; i < bw; i++) {
                        uint8_t& p = d[(size_t)j * ds + i];
                        p = (uint8_t)((p + t[j * ts + i] + 1) >> 1);
                    }
            }
        }
    }

    // 8.4.2.2: one list's prediction of a partition at luma (xa, ya): luma at
    // quarter-sample and chroma at eighth-sample positions, into dy (stride
    // sy) and du, dv (stride sc)
    void mc(const Picture& r, int xa, int ya, int pw, int ph, const int* mv, uint8_t* dy, int sy,
            uint8_t* du, uint8_t* dv, int sc) const {
        const int fx = mv[0] & 3, fy = mv[1] & 3;
        const int ix = xa + (mv[0] >> 2), iy = ya + (mv[1] >> 2);
        if (!fx && !fy && ix >= 0 && iy >= 0 && ix + pw <= w && iy + ph <= h) {  // whole samples
            for (int j = 0; j < ph; j++)
                std::memcpy(dy + (size_t)j * sy, &r.y[(size_t)(iy + j) * w + ix], (size_t)pw);
        } else {
            predict_luma(r, dy, sy, ix, iy, fx, fy, pw, ph);
        }
        predict_chroma(r, xa, ya, pw, ph, mv, du, dv, sc);
    }

    // 8.4.2.3.2: explicit weighted prediction of one list's samples
    void weight(int l, int ref, uint8_t* dy, uint8_t* du, uint8_t* dv, int pw, int ph) {
        for (int c = 0; c < 3; c++) {
            const int log_wd = sh.log2_wd[c ? 1 : 0], wt = sh.weight[l][ref][c], of = sh.offset[l][ref][c];
            if (wt == 1 << log_wd && of == 0) continue;  // the default: the samples as they are
            const int stride = c ? w / 2 : w, s = c ? 1 : 0;
            uint8_t* d = c == 0 ? dy : c == 1 ? du : dv;
            const int round = log_wd ? 1 << (log_wd - 1) : 0;
            for (int j = 0; j < ph >> s; j++)
                for (int i = 0; i < pw >> s; i++) {
                    uint8_t& p = d[(size_t)j * stride + i];
                    p = clip1(((p * wt + round) >> log_wd) + of);
                }
        }
    }

    void predict_luma(const Picture& r, uint8_t* dst, int stride, int ix, int iy, int fx, int fy,
                      int pw, int ph) const {
        // window of (pw + 5) x (ph + 5) samples from (ix - 2, iy - 2), clamped
        int win[21][21];
        for (int j = 0; j < ph + 5; j++) {
            const int yy = clip3(0, h - 1, iy - 2 + j);
            for (int i = 0; i < pw + 5; i++)
                win[j][i] = r.y[(size_t)yy * w + clip3(0, w - 1, ix - 2 + i)];
        }
        auto tap = [](int a, int b, int c, int d, int e, int f) {
            return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
        };
        auto G = [&](int i, int j) { return win[j + 2][i + 2]; };
        auto b1 = [&](int i, int j) {  // horizontal half sample right of (i, j), unscaled
            return tap(G(i - 2, j), G(i - 1, j), G(i, j), G(i + 1, j), G(i + 2, j), G(i + 3, j));
        };
        auto h1 = [&](int i, int j) {
            return tap(G(i, j - 2), G(i, j - 1), G(i, j), G(i, j + 1), G(i, j + 2), G(i, j + 3));
        };
        auto bb = [&](int i, int j) { return clip1((b1(i, j) + 16) >> 5); };
        auto hh = [&](int i, int j) { return clip1((h1(i, j) + 16) >> 5); };
        auto jj = [&](int i, int j) {
            const int v =
                tap(b1(i, j - 2), b1(i, j - 1), b1(i, j), b1(i, j + 1), b1(i, j + 2), b1(i, j + 3));
            return clip1((v + 512) >> 10);
        };
        for (int j = 0; j < ph; j++)
            for (int i = 0; i < pw; i++) {
                int v;
                switch (fy * 4 + fx) {
                    case 0: v = G(i, j); break;
                    case 1: v = (G(i, j) + bb(i, j) + 1) >> 1; break;          // a
                    case 2: v = bb(i, j); break;                                // b
                    case 3: v = (G(i + 1, j) + bb(i, j) + 1) >> 1; break;      // c
                    case 4: v = (G(i, j) + hh(i, j) + 1) >> 1; break;          // d
                    case 5: v = (bb(i, j) + hh(i, j) + 1) >> 1; break;         // e
                    case 6: v = (bb(i, j) + jj(i, j) + 1) >> 1; break;         // f
                    case 7: v = (bb(i, j) + hh(i + 1, j) + 1) >> 1; break;     // g
                    case 8: v = hh(i, j); break;                                // h
                    case 9: v = (hh(i, j) + jj(i, j) + 1) >> 1; break;         // i
                    case 10: v = jj(i, j); break;                               // j
                    case 11: v = (jj(i, j) + hh(i + 1, j) + 1) >> 1; break;    // k
                    case 12: v = (G(i, j + 1) + hh(i, j) + 1) >> 1; break;     // n
                    case 13: v = (hh(i, j) + bb(i, j + 1) + 1) >> 1; break;    // p
                    case 14: v = (jj(i, j) + bb(i, j + 1) + 1) >> 1; break;    // q
                    default: v = (hh(i + 1, j) + bb(i, j + 1) + 1) >> 1; break;  // r
                }
                dst[(size_t)j * stride + i] = (uint8_t)v;
            }
    }

    void predict_chroma(const Picture& r, int xa, int ya, int pw, int ph, const int* mv, uint8_t* du,
                        uint8_t* dv, int stride) const {
        const int cw = w / 2, chh = h / 2;
        const int cx = xa / 2 + (mv[0] >> 3), cy = ya / 2 + (mv[1] >> 3);
        const int ex = mv[0] & 7, ey = mv[1] & 7;
        for (int c = 0; c < 2; c++) {
            const auto& src = c ? r.v : r.u;
            uint8_t* d = c ? dv : du;
            for (int j = 0; j < ph / 2; j++) {
                const int y0 = clip3(0, chh - 1, cy + j), y1 = clip3(0, chh - 1, cy + j + 1);
                for (int i = 0; i < pw / 2; i++) {
                    const int x0 = clip3(0, cw - 1, cx + i), x1 = clip3(0, cw - 1, cx + i + 1);
                    const int A = src[(size_t)y0 * cw + x0], B = src[(size_t)y0 * cw + x1];
                    const int C = src[(size_t)y1 * cw + x0], D = src[(size_t)y1 * cw + x1];
                    d[(size_t)j * stride + i] = (uint8_t)(((8 - ex) * (8 - ey) * A + ex * (8 - ey) * B +
                                                       (8 - ex) * ey * C + ex * ey * D + 32) >> 6);
                }
            }
        }
    }

    // --------------------------------------------------- deblocking
    static bool intra(const Mb& m) { return m.kind == I4 || m.kind == I16 || m.kind == PCM; }
    // whether the transform block of 4x4 block b (raster) holds coefficients:
    // with the 8x8 transform, its 8x8 block's (FFmpeg's cbp_table bits 12-15
    // under CAVLC, where a 4x4 block's TotalCoeff is nC's)
    static bool coded(const Mb& m, int b) {
        return m.t8 ? m.nz8 >> ((b >> 3) * 2 + ((b & 3) >> 1)) & 1 : m.nz[b] != 0;
    }

    // bS (8.7.2.1) of the edge between 4x4 blocks bp of p and bq of q, as
    // FFmpeg's check_mv compares motion: the pictures each list refers to
    // (-1 unused, mv 0), and in a B slice (q's) both lists, straight and
    // crossed where the two blocks refer to the same pictures
    int strength(const Mb& p, int bp, const Mb& q, int bq, bool mb_edge, bool two) const {
        if (intra(p) || intra(q)) return mb_edge ? 4 : 3;
        if (coded(p, bp) || coded(q, bq)) return 2;
        auto far = [](const int16_t* a, const int16_t* b) {
            return std::abs(a[0] - b[0]) >= 4 || std::abs(a[1] - b[1]) >= 4;
        };
        bool v = p.refpic[0][bp] != q.refpic[0][bq];
        if (!v && p.refpic[0][bp] != -1) v = far(p.mv[0][bp], q.mv[0][bq]);
        if (!two) return v;
        if (!v) v = p.refpic[1][bp] != q.refpic[1][bq] || far(p.mv[1][bp], q.mv[1][bq]);
        if (!v) return 0;
        if (p.refpic[0][bp] != q.refpic[1][bq] || p.refpic[1][bp] != q.refpic[0][bq]) return 1;
        return far(p.mv[0][bp], q.mv[1][bq]) || far(p.mv[1][bp], q.mv[0][bq]);
    }

    // Filters the samples across one edge: `pix` the first q0 sample, `step`
    // from q0 to q1, `along` from one line to the next, `n` lines, bS[line * 4 / n]
    static void filter_edge(uint8_t* pix, int step, int along, int n, const int* bs, int qpav,
                            int alpha_off, int beta_off, bool chroma) {
        const int ia = clip3(0, 51, qpav + alpha_off), ib = clip3(0, 51, qpav + beta_off);
        const int alpha = kAlpha[ia], beta = kBeta[ib];
        if (!alpha || !beta || !(bs[0] | bs[1] | bs[2] | bs[3])) return;
        for (int k = 0; k < n; k++) {
            const int s = bs[k * 4 / n];
            if (!s) continue;
            uint8_t* q = pix + (ptrdiff_t)k * along;
            const int p0 = q[-step], p1 = q[-2 * step], q0 = q[0], q1 = q[step];
            if (std::abs(p0 - q0) >= alpha || std::abs(p1 - p0) >= beta ||
                std::abs(q1 - q0) >= beta)
                continue;
            if (chroma) {
                if (s < 4) {
                    const int tc = kTc0[ia][s - 1] + 1;
                    const int d = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
                    q[-step] = clip1(p0 + d);
                    q[0] = clip1(q0 - d);
                } else {
                    q[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
                    q[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
                }
                continue;
            }
            const int p2 = q[-3 * step], q2 = q[2 * step];
            const int ap = std::abs(p2 - p0), aq = std::abs(q2 - q0);
            if (s < 4) {
                const int tc0 = kTc0[ia][s - 1];
                const int tc = tc0 + (ap < beta) + (aq < beta);
                const int d = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
                q[-step] = clip1(p0 + d);
                q[0] = clip1(q0 - d);
                const int avg = (p0 + q0 + 1) >> 1;
                if (ap < beta)
                    q[-2 * step] = (uint8_t)(p1 + clip3(-tc0, tc0, (p2 + avg - (p1 << 1)) >> 1));
                if (aq < beta)
                    q[step] = (uint8_t)(q1 + clip3(-tc0, tc0, (q2 + avg - (q1 << 1)) >> 1));
            } else {
                const int p3 = q[-4 * step], q3 = q[3 * step];
                const bool small = std::abs(p0 - q0) < ((alpha >> 2) + 2);
                if (ap < beta && small) {
                    q[-step] = (uint8_t)((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
                    q[-2 * step] = (uint8_t)((p2 + p1 + p0 + q0 + 2) >> 2);
                    q[-3 * step] = (uint8_t)((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
                } else {
                    q[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
                }
                if (aq < beta && small) {
                    q[0] = (uint8_t)((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
                    q[step] = (uint8_t)((p0 + q0 + q1 + q2 + 2) >> 2);
                    q[2 * step] = (uint8_t)((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
                } else {
                    q[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
                }
            }
        }
    }

    void deblock() {
        const Tables& t = tables();
        const int cw = w / 2;
        for (int mb = 0; mb < mb_w * mb_h; mb++) {
            const Mb& q = mbs[mb];
            const SliceInfo& s = slices[q.slice];
            if (s.idc == 1) continue;
            const int mx = mb % mb_w, my = mb / mb_w;
            const bool left = mx > 0 && !(s.idc == 2 && mbs[mb - 1].slice != q.slice);
            const bool top = my > 0 && !(s.idc == 2 && mbs[mb - mb_w].slice != q.slice);
            int bs[2][4][4];  // [vertical/horizontal][edge][segment]
            for (int e = 0; e < 4; e++)
                for (int k = 0; k < 4; k++) {
                    bs[0][e][k] = e ? strength(q, k * 4 + e - 1, q, k * 4 + e, false, s.b)
                                    : left ? strength(mbs[mb - 1], k * 4 + 3, q, k * 4, true, s.b) : 0;
                    bs[1][e][k] = e ? strength(q, (e - 1) * 4 + k, q, e * 4 + k, false, s.b)
                                    : top ? strength(mbs[mb - mb_w], 12 + k, q, k, true, s.b) : 0;
                }
            uint8_t* py = cur->y.data() + (size_t)my * 16 * w + mx * 16;
            for (int dir = 0; dir < 2; dir++) {
                for (int e = 0; e < 4; e++) {
                    if (e == 0 && !(dir ? top : left)) continue;
                    if ((e & 1) && q.t8) continue;  // inside an 8x8 transform block
                    const Mb& p = e ? q : mbs[dir ? mb - mb_w : mb - 1];
                    const int qpav = (p.qp + q.qp + 1) >> 1;
                    if (dir == 0)
                        filter_edge(py + 4 * e, 1, w, 16, bs[0][e], qpav, s.alpha, s.beta, false);
                    else
                        filter_edge(py + (size_t)4 * e * w, w, 1, 16, bs[1][e], qpav, s.alpha,
                                    s.beta, false);
                }
            }
            for (int c = 0; c < 2; c++) {
                uint8_t* pc = (c ? cur->v : cur->u).data() + (size_t)my * 8 * cw + mx * 8;
                auto qpc = [&](const Mb& m) {
                    return t.chroma_qp[clip3(0, 51, m.qp + s.chroma_offset[c]) + 12];
                };
                for (int dir = 0; dir < 2; dir++) {
                    for (int e = 0; e < 4; e += 2) {
                        if (e == 0 && !(dir ? top : left)) continue;
                        const Mb& p = e ? q : mbs[dir ? mb - mb_w : mb - 1];
                        const int qpav = (qpc(p) + qpc(q) + 1) >> 1;
                        if (dir == 0)
                            filter_edge(pc + 2 * e, 1, cw, 8, bs[0][e], qpav, s.alpha, s.beta,
                                        true);
                        else
                            filter_edge(pc + (size_t)2 * e * cw, cw, 1, 8, bs[1][e], qpav, s.alpha,
                                        s.beta, true);
                    }
                }
            }
        }
    }

    // ------------------------------------------------- picture end
    void finish_picture() {
        if (last_mb != mb_w * mb_h - 1) throw Corrupt("a picture with missing macroblocks");
        deblock();
        PicPtr pic = cur;
        cur = nullptr;
        const SliceHeader& s = first_header;
        if (s.ref_idc) {  // what a later B slice's direct prediction reads
            pic->col.resize(mbs.size());
            for (size_t i = 0; i < mbs.size(); i++) {
                const Mb& m = mbs[i];
                ColMb& c = pic->col[i];
                c.intra = intra(m);
                for (int l = 0; l < 2; l++) {
                    for (int k = 0; k < 4; k++) c.ref[l][k] = m.ref[l][8 * (k >> 1) + 2 * (k & 1)];
                    std::memcpy(c.mv[l], m.mv[l], sizeof(c.mv[l]));
                }
            }
            if (s.idr) {
                refs.clear();
            } else if (s.adaptive) {
                for (int d : s.mmco1) {  // unmark the picture of PicNum CurrPicNum - (d + 1)
                    auto it = std::find_if(refs.begin(), refs.end(), [&](const PicPtr& r) {
                        return pic_num(*r, *pic) == pic->frame_num - (d + 1);
                    });
                    if (it != refs.end()) refs.erase(it);
                }
            } else if ((int)refs.size() >= std::max(cs->max_refs, 1)) {  // the sliding window
                auto older = [&](const PicPtr& a, const PicPtr& b) {
                    return pic_num(*a, *pic) < pic_num(*b, *pic);
                };
                refs.erase(std::min_element(refs.begin(), refs.end(), older));
            }
            if ((int)refs.size() >= std::max(cs->max_refs, 1) && !s.idr)
                throw Corrupt("more reference pictures than max_num_ref_frames");
            refs.push_back(pic);
            prev_ref_frame_num = pic->frame_num;
        }
        have_prev = true;
        select_output(pic);
        // ff_h264_execute_ref_pic_marking, after the output was chosen: an I
        // picture with few references counts as recovered, in a stream
        // without recovery point SEIs (measured against FFmpeg)
        const Pps& p = pps[s.pps_id];
        if (s.ref_idc && s.type == 2 && !has_recovery_point &&
            ((int)refs.size() <= 2 || (p.num_ref_idx_default <= 1 && p.num_ref_idx_l1_default <= 1))) {
            pic->recovered = true;
            if (!has_b_frames) frame_recovered |= 4;
        }
        // measured against FFmpeg: the first reference I picture after grey
        // references is then the only reference left
        if (s.ref_idc && s.type == 2) {
            if (grey_refs) refs.assign(1, pic);
            grey_refs = false;
        }
    }

    // FFmpeg's h264_select_output_frame
    void select_output(const PicPtr& cur_pic) {
        if (cs->restriction) has_b_frames = std::max(has_b_frames, cs->num_reorder_frames);
        int i = 0;
        for (;; i++) {
            if (i == kMaxDelayed || cur_pic->poc < last_pocs[i]) {
                if (i) last_pocs[i - 1] = cur_pic->poc;
                break;
            } else if (i) {
                last_pocs[i - 1] = last_pocs[i];
            }
        }
        int out_of_order = kMaxDelayed - i;
        if (cur_pic->b_type || (last_pocs[kMaxDelayed - 2] > INT_MIN &&
                                (int64_t)last_pocs[kMaxDelayed - 1] - last_pocs[kMaxDelayed - 2] > 2))
            out_of_order = std::max(out_of_order, 1);
        if (out_of_order == kMaxDelayed) {
            for (int k = 1; k < kMaxDelayed; k++) last_pocs[k] = INT_MIN;
            last_pocs[0] = cur_pic->poc;
            cur_pic->mmco_reset = true;
        } else if (has_b_frames < out_of_order && !cs->restriction) {
            has_b_frames = out_of_order;
        }
        delayed.push_back(cur_pic);
        const int pics = (int)delayed.size();
        const size_t out_idx = next_out();
        PicPtr out = delayed[out_idx];
        if (has_b_frames == 0 && (delayed[0]->key || delayed[0]->mmco_reset))
            next_outputed_poc = INT_MIN;
        const bool ooo = out->poc < next_outputed_poc;
        if (ooo || pics > has_b_frames) delayed.erase(delayed.begin() + (long)out_idx);
        if (!ooo && pics > has_b_frames) {
            if (out_idx == 0 && !delayed.empty() && (delayed[0]->key || delayed[0]->mmco_reset))
                next_outputed_poc = INT_MIN;
            else
                next_outputed_poc = out->poc;
            if (out->recovered) {
                frame_recovered |= 2;
                ready.push_back(out);
            }
        }
    }

    // The held picture to give next: the least POC up to the next key or
    // reset picture.
    size_t next_out() const {
        size_t out = 0;
        for (size_t k = 1; k < delayed.size() && !delayed[k]->key && !delayed[k]->mmco_reset; k++)
            if (delayed[k]->poc < delayed[out]->poc) out = k;
        return out;
    }

    // ---------------------------------------------------------- API
    int decode(const uint8_t* d, size_t n, long tag) {
        ready.clear();
        sei_recovery = -1;
        bool any = false;
        nal_units(d, n, [&](const uint8_t* p, size_t len) {
            const int type = p[0] & 31;
            if (type == 1 || type == 5) {
                if (!any && cur) finish_picture();  // a packet holds one access unit
                any = true;
            }
            nal(p, len, true);
            if (cur && (type == 1 || type == 5)) cur->tag = tag;
        });
        if (cur) finish_picture();
        return take();
    }

    int take() {
        if (ready.empty()) return 0;
        shown = ready.front();
        ready.erase(ready.begin());
        return 1;
    }

    int drain() {
        if (!ready.empty()) return take();
        while (!delayed.empty()) {
            const size_t out_idx = next_out();
            PicPtr out = delayed[out_idx];
            delayed.erase(delayed.begin() + (long)out_idx);
            if (out->recovered) {
                shown = out;
                return 1;
            }
        }
        return 0;
    }

    void flush() {  // h264_decode_flush
        delayed.clear();
        ready.clear();
        cur = nullptr;
        reset_pocs();
        next_outputed_poc = INT_MIN;
        restart();
    }

    // The left crop av_frame_apply_cropping applies: it keeps the data
    // pointers 32-byte aligned, so a crop that would misalign them shrinks
    static int crop_left(const Picture& p) {
        int crop_l = p.crop_l;
        if (crop_l) {
            const int luma = __builtin_ctz((unsigned)crop_l);
            const int half = crop_l >> 1 ? __builtin_ctz((unsigned)(crop_l >> 1)) : 32;
            const int chroma = std::min(luma, half);
            if (chroma < 5) crop_l &= ~((1 << (5 + luma - chroma)) - 1);
        }
        return crop_l;
    }

    void to_bgr(uint8_t* out) const {
        const Picture& p = *shown;
        const int crop_l = crop_left(p);
        const int ow = p.w - crop_l - p.crop_r, oh = p.h - p.crop_t - p.crop_b, cw = p.w / 2;
        ffdsp::yuv2bgr24(p.y.data() + (size_t)p.crop_t * p.w + crop_l, p.w,
                         p.u.data() + (size_t)(p.crop_t / 2) * cw + crop_l / 2,
                         p.v.data() + (size_t)(p.crop_t / 2) * cw + crop_l / 2, cw, ow, oh, 1,
                         p.full_range, out);
    }
    void size(int* wh) const {
        const Picture& p = *shown;
        wh[0] = p.w - crop_left(p) - p.crop_r;
        wh[1] = p.h - p.crop_t - p.crop_b;
    }
};

void set_err(char* err, int errlen, const char* msg) {
    if (err && errlen > 0) std::snprintf(err, (size_t)errlen, "%s", msg);
}

template <class F>
int guarded(char* err, int errlen, F&& fn) {
    try {
        return fn();
    } catch (const Refused& e) {
        set_err(err, errlen, e.what());
        return -2;
    } catch (const std::exception& e) {
        set_err(err, errlen, e.what());
        return -1;
    }
}

void fill_info(const Decoder* d, long* info) {
    int wh[2];
    d->size(wh);
    info[0] = wh[0];
    info[1] = wh[1];
    info[2] = d->shown->tag;
}

}  // namespace

extern "C" {

void* crt_h264_create() { return new Decoder(); }

// Takes the parameter sets carried outside the packets, `extra`: an avcC
// record (MP4's AVCDecoderConfigurationRecord, first byte 1) or Annex B
// units (an AVI strf's extradata), or nothing (n 0: the packets carry
// them); and how packets frame their NAL units: nal_length bytes of length
// before each (1, 2 or 4: MP4), or 0 for Annex B start codes (AVI).
// 0, or -1 / -2 as crt_h264_decode.
int crt_h264_config(void* h, const uint8_t* extra, long n, int nal_length, char* err,
                    int errlen) {
    Decoder* d = static_cast<Decoder*>(h);
    return guarded(err, errlen, [&]() {
        if (nal_length != 0 && nal_length != 1 && nal_length != 2 && nal_length != 4)
            throw Corrupt("a NAL length size other than 1, 2 or 4");
        if (n > 0 && extra[0] != 1) {  // Annex B parameter sets
            d->nal_length = 0;
            d->nal_units(extra, (size_t)n,
                         [&](const uint8_t* p, size_t len) { d->nal(p, len, false); });
        } else if (n > 0) {
            if (n < 7) throw Corrupt("a cut avcC record");
            size_t pos = 5;
            for (int kind = 0; kind < 2; kind++) {
                if (pos >= (size_t)n) throw Corrupt("a cut avcC record");
                int count = kind ? extra[pos] : extra[pos] & 31;
                pos++;
                for (int i = 0; i < count; i++) {
                    if (pos + 2 > (size_t)n) throw Corrupt("a cut avcC record");
                    size_t len = (size_t)extra[pos] << 8 | extra[pos + 1];
                    pos += 2;
                    if (pos + len > (size_t)n || !len) throw Corrupt("a cut avcC record");
                    d->nal(extra + pos, len, false);
                    pos += len;
                }
            }
        }
        d->nal_length = nal_length;
        return 0;
    });
}

// Reads a packet's parameter sets and checks its slice headers (refusals)
// without decoding a picture.  0, or -1 / -2 as decode.
int crt_h264_probe(void* h, const uint8_t* data, long n, char* err, int errlen) {
    Decoder* d = static_cast<Decoder*>(h);
    return guarded(err, errlen, [&]() {
        d->probe_last_mb = -1;
        d->nal_units(data, (size_t)n,
                     [&](const uint8_t* p, size_t len) { d->nal(p, len, false); });
        return 0;
    });
}

// Decodes one packet (an access unit) tagged `tag`: 1 when a picture is
// given (info: width, height, the tag of its packet), 0 none (held
// back for reordering, or not yet recovered), -1 the packet does
// not decode, -2 a feature the decoder refuses.
int crt_h264_decode(void* h, const uint8_t* data, long n, long tag, long* info, char* err,
                    int errlen) {
    Decoder* d = static_cast<Decoder*>(h);
    return guarded(err, errlen, [&]() {
        int got = d->decode(data, (size_t)n, tag);
        if (got) fill_info(d, info);
        return got;
    });
}

// The next picture held back (end of stream): 1 (info as decode) or 0.
int crt_h264_drain(void* h, long* info) {
    Decoder* d = static_cast<Decoder*>(h);
    int got = d->drain();
    if (got) fill_info(d, info);
    return got;
}

// The last picture given as BGR24 into out (height x width x 3 bytes): 0,
// or -1 when there is none or out has another size.
int crt_h264_bgr(void* h, uint8_t* out, long size) {
    Decoder* d = static_cast<Decoder*>(h);
    if (!d->shown) return -1;
    int wh[2];
    d->size(wh);
    if (size != (long)wh[0] * wh[1] * 3) return -1;
    d->to_bgr(out);
    return 0;
}

// The output delay the decoder starts with (FFmpeg's has_b_frames as the
// demuxer's video_delay sets it: libavformat's mov estimates it from the
// composition offsets); it only grows, and a flush keeps it.
void crt_h264_set_delay(void* h, int delay) {
    Decoder* d = static_cast<Decoder*>(h);
    d->has_b_frames = std::max(d->has_b_frames, std::min(std::max(delay, 0), kMaxDelayed - 1));
}

// The output delay reached (has_b_frames).
int crt_h264_delay(void* h) { return static_cast<Decoder*>(h)->has_b_frames; }

// avcodec_flush_buffers: drops the pictures held back and the references;
// what is shown next starts as at the start of a stream.
void crt_h264_flush(void* h) { static_cast<Decoder*>(h)->flush(); }

void crt_h264_destroy(void* h) { delete static_cast<Decoder*>(h); }

}  // extern "C"
