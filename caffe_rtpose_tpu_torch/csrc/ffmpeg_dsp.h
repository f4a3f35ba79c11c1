// What FFmpeg's decoders and swscale do to 8-bit samples, shared by the
// MPEG-4 decoder (mpeg4_video.cpp) and the Motion-JPEG mode of the JPEG
// codec (jpeg_codec.cpp):
//
// * FFmpeg's "simple" IDCT for 8-bit samples (int16 coefficients, rows with
//   ROW_SHIFT 11 then columns with COL_SHIFT 20; a row whose only non-zero
//   coefficient is its first takes that coefficient times 8);
// * swscale's unscaled YUV -> BGR24 path (the x86 yuv2rgb code OpenCV's
//   sws_scale runs for 4:2:0 and 4:2:2 sources of even height): 16-bit
//   fixed point, pmulhw of the samples scaled by 8 against coefficients that
//   ff_yuv2rgb_c_init_tables derives from the BT.601 matrix for limited
//   (MPEG) or full (JPEG) range; one chroma sample for each 2x2 or 2x1
//   block, no filter.

#pragma once

#include <cstdint>
#include <cstring>

namespace ffdsp {

inline uint8_t clip_u8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// ------------------------------------------------------------------ IDCT

constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867,
              W7 = 4520;

inline void idct_row(int16_t* row) {
    uint64_t lo, hi;
    std::memcpy(&lo, row, 8);
    std::memcpy(&hi, row + 4, 8);
    if (!(lo & ~uint64_t(0xffff)) && !hi) {
        uint16_t v = (uint16_t)(row[0] * 8);
        for (int i = 0; i < 8; i++) row[i] = (int16_t)v;
        return;
    }
    unsigned a0 = (unsigned)W4 * row[0] + (1u << 10), a1 = a0, a2 = a0, a3 = a0;
    a0 += (unsigned)W2 * row[2];
    a1 += (unsigned)W6 * row[2];
    a2 -= (unsigned)W6 * row[2];
    a3 -= (unsigned)W2 * row[2];
    unsigned b0 = (unsigned)W1 * row[1] + (unsigned)W3 * row[3];
    unsigned b1 = (unsigned)W3 * row[1] - (unsigned)W7 * row[3];
    unsigned b2 = (unsigned)W5 * row[1] - (unsigned)W1 * row[3];
    unsigned b3 = (unsigned)W7 * row[1] - (unsigned)W5 * row[3];
    if (hi) {
        a0 += (unsigned)W4 * row[4] + (unsigned)W6 * row[6];
        a1 += -(unsigned)W4 * row[4] - (unsigned)W2 * row[6];
        a2 += -(unsigned)W4 * row[4] + (unsigned)W2 * row[6];
        a3 += (unsigned)W4 * row[4] - (unsigned)W6 * row[6];
        b0 += (unsigned)W5 * row[5] + (unsigned)W7 * row[7];
        b1 += -(unsigned)W1 * row[5] - (unsigned)W5 * row[7];
        b2 += (unsigned)W7 * row[5] + (unsigned)W3 * row[7];
        b3 += (unsigned)W3 * row[5] - (unsigned)W1 * row[7];
    }
    row[0] = (int16_t)((int)(a0 + b0) >> 11);
    row[7] = (int16_t)((int)(a0 - b0) >> 11);
    row[1] = (int16_t)((int)(a1 + b1) >> 11);
    row[6] = (int16_t)((int)(a1 - b1) >> 11);
    row[2] = (int16_t)((int)(a2 + b2) >> 11);
    row[5] = (int16_t)((int)(a2 - b2) >> 11);
    row[3] = (int16_t)((int)(a3 + b3) >> 11);
    row[4] = (int16_t)((int)(a3 - b3) >> 11);
}

// the column pass; out[k] for k = 0..7 down the column
inline void idct_col(const int16_t* col, int out[8]) {
    unsigned a0 = (unsigned)W4 * (col[0] + ((1 << 19) / W4)), a1 = a0, a2 = a0, a3 = a0;
    a0 += (unsigned)W2 * col[16];
    a1 += (unsigned)W6 * col[16];
    a2 += -(unsigned)W6 * col[16];
    a3 += -(unsigned)W2 * col[16];
    unsigned b0 = (unsigned)W1 * col[8] + (unsigned)W3 * col[24];
    unsigned b1 = (unsigned)W3 * col[8] - (unsigned)W7 * col[24];
    unsigned b2 = (unsigned)W5 * col[8] - (unsigned)W1 * col[24];
    unsigned b3 = (unsigned)W7 * col[8] - (unsigned)W5 * col[24];
    if (col[32]) {
        a0 += (unsigned)W4 * col[32];
        a1 += -(unsigned)W4 * col[32];
        a2 += -(unsigned)W4 * col[32];
        a3 += (unsigned)W4 * col[32];
    }
    if (col[40]) {
        b0 += (unsigned)W5 * col[40];
        b1 += -(unsigned)W1 * col[40];
        b2 += (unsigned)W7 * col[40];
        b3 += (unsigned)W3 * col[40];
    }
    if (col[48]) {
        a0 += (unsigned)W6 * col[48];
        a1 += -(unsigned)W2 * col[48];
        a2 += (unsigned)W2 * col[48];
        a3 += -(unsigned)W6 * col[48];
    }
    if (col[56]) {
        b0 += (unsigned)W7 * col[56];
        b1 += -(unsigned)W5 * col[56];
        b2 += (unsigned)W3 * col[56];
        b3 += -(unsigned)W1 * col[56];
    }
    out[0] = (int)(a0 + b0) >> 20;
    out[1] = (int)(a1 + b1) >> 20;
    out[2] = (int)(a2 + b2) >> 20;
    out[3] = (int)(a3 + b3) >> 20;
    out[4] = (int)(a3 - b3) >> 20;
    out[5] = (int)(a2 - b2) >> 20;
    out[6] = (int)(a1 - b1) >> 20;
    out[7] = (int)(a0 - b0) >> 20;
}

// blk (64 coefficients, row-major; overwritten) -> an 8x8 block at dst
inline void idct_put(uint8_t* dst, int ls, int16_t* blk) {
    for (int r = 0; r < 8; r++) idct_row(blk + 8 * r);
    int o[8];
    for (int c = 0; c < 8; c++) {
        idct_col(blk + c, o);
        for (int r = 0; r < 8; r++) dst[r * ls + c] = clip_u8(o[r]);
    }
}

inline void idct_add(uint8_t* dst, int ls, int16_t* blk) {
    for (int r = 0; r < 8; r++) idct_row(blk + 8 * r);
    int o[8];
    for (int c = 0; c < 8; c++) {
        idct_col(blk + c, o);
        for (int r = 0; r < 8; r++) dst[r * ls + c] = clip_u8(dst[r * ls + c] + o[r]);
    }
}

// ------------------------------------------------------- YUV -> BGR24

// libswscale's roundToInt16: a 16.16 value rounded to an int16
inline int16_t round_int16(int64_t f) {
    int64_t r = (f + (1 << 15)) >> 16;
    return (int16_t)(r < -0x7FFF ? -0x8000 : r > 0x7FFF ? 0x7FFF : r);
}

// One term a sample value for each coefficient: what pmulhw gives for the
// sample scaled by 8 less the offset (Y: 16 * 8 at limited range, 0 at
// full; chroma: 128 * 8).  The coefficients are ff_yuv2rgb_c_init_tables'
// for the BT.601 matrix (ff_yuv2rgb_coeffs[SWS_CS_ITU601]) at the default
// brightness, contrast and saturation; no sum comes near the 16-bit
// saturation.
struct Yuv2BgrTerms {
    int16_t y[256], b[256], r[256], gu[256], gv[256];

    explicit Yuv2BgrTerms(bool full_range) {
        int64_t crv = 104597, cbu = 132201, cgu = -25675, cgv = -53279;
        int64_t cy = 1 << 16, oy = 0;
        if (!full_range) {
            cy = (cy * 255) / 219;
            oy = int64_t(16) << 16;
        } else {
            crv = (crv * 224) / 255;
            cbu = (cbu * 224) / 255;
            cgu = (cgu * 224) / 255;
            cgv = (cgv * 224) / 255;
        }
        const int yc = round_int16(cy * (1 << 13)), yo = round_int16(oy * (1 << 3));
        const int vr = round_int16(crv * (1 << 13)), ub = round_int16(cbu * (1 << 13));
        const int vg = round_int16(cgv * (1 << 13)), ug = round_int16(cgu * (1 << 13));
        auto mulhi = [](int a, int c) { return (int16_t)((a * c) >> 16); };
        for (int v = 0; v < 256; v++) {
            y[v] = mulhi(v * 8 - yo, yc);
            b[v] = mulhi(v * 8 - 1024, ub);
            r[v] = mulhi(v * 8 - 1024, vr);
            gu[v] = mulhi(v * 8 - 1024, ug);
            gv[v] = mulhi(v * 8 - 1024, vg);
        }
    }
};

inline const Yuv2BgrTerms& yuv2bgr_terms(bool full_range) {
    static const Yuv2BgrTerms limited(false), full(true);
    return full_range ? full : limited;
}

// Planes (Y at full size, U and V at half width and, with vshift 1, half
// height) -> width x height BGR24 rows at out.
inline void yuv2bgr24(const uint8_t* py, int ystride, const uint8_t* pu, const uint8_t* pv,
                      int cstride, int width, int height, int vshift, bool full_range,
                      uint8_t* out) {
    const Yuv2BgrTerms& t = yuv2bgr_terms(full_range);
    for (int y = 0; y < height; y++) {
        const uint8_t* yr = py + (size_t)y * ystride;
        const uint8_t* ur = pu + (size_t)(y >> vshift) * cstride;
        const uint8_t* vr = pv + (size_t)(y >> vshift) * cstride;
        uint8_t* o = out + (size_t)y * width * 3;
        for (int x = 0; x < width; x++) {
            int u = ur[x >> 1], v = vr[x >> 1], yy = t.y[yr[x]];
            o[3 * x] = clip_u8(yy + t.b[u]);
            o[3 * x + 1] = clip_u8(yy + t.gu[u] + t.gv[v]);
            o[3 * x + 2] = clip_u8(yy + t.r[v]);
        }
    }
}

// swscale's scaler at 1:1 with full chroma (what it does for a source
// whose chroma is not subsampled, 4:4:4 or gray): each pixel through
// yuv2rgb_write_full, samples at 9 fractional bits and the same Q13
// coefficients, rounded at bit 22 and clipped to 30 bits.  Full range;
// without pu/pv (gray), chroma is 128.
inline void yuv444_bgr24_full(const uint8_t* py, const uint8_t* pu, const uint8_t* pv,
                              int stride, int width, int height, uint8_t* out) {
    const int vr = round_int16(((int64_t)104597 * 224 / 255) * (1 << 13));
    const int ub = round_int16(((int64_t)132201 * 224 / 255) * (1 << 13));
    const int vg = round_int16(((int64_t)-53279 * 224 / 255) * (1 << 13));
    const int ug = round_int16(((int64_t)-25675 * 224 / 255) * (1 << 13));
    auto put = [](int v) {
        if (v & 0xC0000000) v = v < 0 ? 0 : (1 << 30) - 1;
        return (uint8_t)(v >> 22);
    };
    for (int y = 0; y < height; y++) {
        const uint8_t* yr = py + (size_t)y * stride;
        uint8_t* o = out + (size_t)y * width * 3;
        for (int x = 0; x < width; x++) {
            const int Y = yr[x] * 512 * 8192 + (1 << 21);
            if (!pu) {
                o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = put(Y);
                continue;
            }
            const int U = (pu[(size_t)y * stride + x] - 128) * 512;
            const int V = (pv[(size_t)y * stride + x] - 128) * 512;
            o[3 * x] = put((int)((unsigned)Y + U * (unsigned)ub));
            o[3 * x + 1] = put((int)((unsigned)Y + V * (unsigned)vg + U * (unsigned)ug));
            o[3 * x + 2] = put((int)((unsigned)Y + V * (unsigned)vr));
        }
    }
}

}  // namespace ffdsp
