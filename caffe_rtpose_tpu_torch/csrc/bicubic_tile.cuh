// K1's tile upsample (peak_mask.cu), and the per-pixel tap sum that K1 and
// K3 (upsample_peak_keys.cu, which has its own tiling) share.
//
// One K1 block serves one 32x64 output tile (plus a one-pixel halo) for a
// group of kGroup channels, and computes for each channel c of the group the
// scale-averaged bicubic upsample
//
//     U_c = (1/S) sum_s Ay_s . L_s[:, :, c] . Ax_s^T
//
// from per-output tap tables (index + weight of each output row's and
// column's <= 4 nonzero taps, taken from the same f32 matrices the plain
// PyTorch version multiplies by).
//
// The low-res rows and columns that the tile's taps reach form a small
// source window per scale (about 8 x 12 at COCO's factor 8; the host
// computes it from the tap tables, ops/nms_cuda.py::_windows).  stage_tile
// copies the tile's tap tables (indices made relative to the window) and
// the window of every channel of the group into shared memory once, with
// loads along the NHWC channel axis (16-byte vectors where the strides
// allow).  Then, per channel, upsample_channel runs the vertical pass over
// the window's columns only and the horizontal pass with each thread's
// column taps in registers, the per-scale sums in registers.  The FMA order
// per pixel is tap_sum's (taps k = 0..3 from 0), scales summed in order,
// then x 1/S: the order of the plain per-pixel formulation, and K3's; so
// both kernels see the same U, bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace crt {

constexpr int kTileY = 32;
constexpr int kTileX = 64;  // even, so a horizontal pixel pair never straddles two tiles
constexpr int kExtY = kTileY + 2;  // one-pixel halo above and below
constexpr int kExtX = kTileX + 2;
constexpr int kThreads = 256;
constexpr int kGroup = 4;  // channels a block serves
constexpr int kRowPhases = kThreads / kTileX;  // horizontal pass: 64 columns x 4 row phases
constexpr int kRowsPerThread = (kExtY + kRowPhases - 1) / kRowPhases;  // 9

// One upsampled value from its <= 4 taps: sum_k w_k * v_k, k = 0..3 in order
// from 0, one f32 FMA a step.  Every vertical and horizontal value of K1 and
// K3 is this sum (a zero-weight pad tap adds an exact 0).
__device__ __forceinline__ float tap_sum(float w0, float v0, float w1, float v1, float w2,
                                         float v2, float w3, float v3) {
  float u = fmaf(w0, v0, 0.f);
  u = fmaf(w1, v1, u);
  u = fmaf(w2, v2, u);
  return fmaf(w3, v3, u);
}

// Dynamic shared memory of one block for S scales and a widest source
// window of wh rows x ww columns: the tap tables (index + weight, rows and
// columns), the window of kGroup channels, the vertical pass (kExtY, ww) and
// the upsampled tile (kExtY, kExtX), all 4-byte words.  ops/nms_cuda.py
// computes the same sum (_smem_bytes).
inline long long tile_smem_bytes(int S, int wh, int ww) {
  return 4LL * ((long long)S * (kExtY + kExtX) * 8 + (long long)S * kGroup * wh * ww +
                (long long)kExtY * ww + kExtY * kExtX);
}

struct TileSmem {
  float* ytw;   // (S, kExtY, 4) row tap weights
  int* yti;     // (S, kExtY, 4) row tap indices, relative to the window
  float* xtw;   // (S, kExtX, 4)
  int* xti;     // (S, kExtX, 4)
  float* win;   // (S, kGroup, wh, ww) source window
  float* vrow;  // (kExtY, ww) vertical pass of one scale
  float* acc;   // (kExtY, kExtX) U of one channel over the extended tile
};

__device__ __forceinline__ TileSmem carve_tile_smem(float* smem, int S, int wh, int ww) {
  TileSmem t;
  t.ytw = smem;
  t.yti = reinterpret_cast<int*>(t.ytw + S * kExtY * 4);
  t.xtw = reinterpret_cast<float*>(t.yti + S * kExtY * 4);
  t.xti = reinterpret_cast<int*>(t.xtw + S * kExtX * 4);
  t.win = reinterpret_cast<float*>(t.xti + S * kExtX * 4);
  t.vrow = t.win + S * kGroup * wh * ww;
  t.acc = t.vrow + kExtY * ww;
  return t;
}

// The geometry a block reads: the low-res maps (F, S, h, w, C) by strides in
// elements (F frames that share one geometry; st_f = 0 where F = 1), the
// output size, the tap tables (S, th, 4) / (S, tw, 4) and the windows
// (S, tiles_y, 2) / (S, tiles_x, 2) as [first source index, count].
struct TileArgs {
  const float* low;
  long long st_f, st_s, st_y, st_x, st_c;
  int S, C, th, tw;
  const int* ytap_idx;
  const float* ytap_w;
  const int* xtap_idx;
  const float* xtap_w;
  const int* ywin;
  const int* xwin;
  int wh, ww;  // widest window: the shared-memory layout's pitches
  int vec4;    // 16-byte window loads (channel stride 1, the other strides and the base
              // 16-byte aligned, C % 4 == 0)
  float inv_s;
};

// Copies the tile's tap tables and the window of frame f's channels
// c0 .. c0+kGroup-1 (zeros past C) into shared memory.  Ends with a barrier.
__device__ __forceinline__ void stage_tile(const TileArgs& a, int f, int c0, int ty, int tx,
                                           const TileSmem& sm) {
  const int tid = threadIdx.x;
  const float* low = a.low + f * a.st_f;
  const int tiles_y = gridDim.y, tiles_x = gridDim.x;
  const int y_org = ty * kTileY - 1, x_org = tx * kTileX - 1;
  for (int i = tid; i < a.S * kExtY * 4; i += kThreads) {
    const int s = i / (kExtY * 4), r = (i >> 2) % kExtY;
    const int* wn = a.ywin + (s * tiles_y + ty) * 2;
    const int y = y_org + r;
    int idx = wn[0];
    float w = 0.f;
    if (y >= 0 && y < a.th) {
      idx = a.ytap_idx[(s * a.th + y) * 4 + (i & 3)];
      w = a.ytap_w[(s * a.th + y) * 4 + (i & 3)];
    }
    // a zero-weight pad tap may lie outside the window: any index inside it will do
    sm.yti[i] = min(max(idx - wn[0], 0), wn[1] - 1);
    sm.ytw[i] = w;
  }
  for (int i = tid; i < a.S * kExtX * 4; i += kThreads) {
    const int s = i / (kExtX * 4), q = (i >> 2) % kExtX;
    const int* wn = a.xwin + (s * tiles_x + tx) * 2;
    const int x = x_org + q;
    int idx = wn[0];
    float w = 0.f;
    if (x >= 0 && x < a.tw) {
      idx = a.xtap_idx[(s * a.tw + x) * 4 + (i & 3)];
      w = a.xtap_w[(s * a.tw + x) * 4 + (i & 3)];
    }
    sm.xti[i] = min(max(idx - wn[0], 0), wn[1] - 1);
    sm.xtw[i] = w;
  }
  const int wh = a.wh, ww = a.ww;
  if (a.vec4) {
    for (int i = tid; i < a.S * wh * ww; i += kThreads) {
      const int rx = i % ww, ry = (i / ww) % wh, s = i / (ww * wh);
      const int* wy = a.ywin + (s * tiles_y + ty) * 2;
      const int* wx = a.xwin + (s * tiles_x + tx) * 2;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ry < wy[1] && rx < wx[1])
        v = *reinterpret_cast<const float4*>(low + s * a.st_s + (wy[0] + ry) * a.st_y +
                                             (wx[0] + rx) * a.st_x + c0);
      float* dst = sm.win + ((s * kGroup) * wh + ry) * ww + rx;
      dst[0] = v.x;
      dst[wh * ww] = v.y;
      dst[2 * wh * ww] = v.z;
      dst[3 * wh * ww] = v.w;
    }
  } else {
    // channel fastest: neighbouring threads read neighbouring channels
    for (int i = tid; i < a.S * kGroup * wh * ww; i += kThreads) {
      const int g = i % kGroup, rx = (i / kGroup) % ww, ry = (i / (kGroup * ww)) % wh;
      const int s = i / (kGroup * ww * wh);
      const int* wy = a.ywin + (s * tiles_y + ty) * 2;
      const int* wx = a.xwin + (s * tiles_x + tx) * 2;
      float v = 0.f;
      if (ry < wy[1] && rx < wx[1] && c0 + g < a.C)
        v = low[s * a.st_s + (wy[0] + ry) * a.st_y + (wx[0] + rx) * a.st_x + (c0 + g) * a.st_c];
      sm.win[((s * kGroup + g) * wh + ry) * ww + rx] = v;
    }
  }
  __syncthreads();
}

// Fills sm.acc (kExtY x kExtX, extended-tile origin (ty*kTileY-1,
// tx*kTileX-1)) with U of group channel g; entries outside the map are 0.
// Starts with a barrier (the previous channel's readers of acc are done)
// and ends with one, so every thread may read all of acc afterwards.
__device__ __forceinline__ void upsample_channel(const TileArgs& a, int g, int ty, int tx,
                                                 const TileSmem& sm) {
  const int tid = threadIdx.x;
  const int tiles_x = gridDim.x;
  const int y_org = ty * kTileY - 1, x_org = tx * kTileX - 1;
  const int ww = a.ww;
  // horizontal pass: column q of the extended tile, rows phase, phase+4, ..
  const int q = 1 + tid % kTileX, phase = tid / kTileX;
  // and the halo columns 0 and kExtX-1, one (row, column) per thread
  const bool has_halo = tid < 2 * kExtY;
  const int rh = tid >> 1, qh = (tid & 1) ? kExtX - 1 : 0;
  float sum[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) sum[k] = 0.f;
  float sum_h = 0.f;

  for (int s = 0; s < a.S; ++s) {
    __syncthreads();  // vrow is free (and acc, before the first scale)
    const int wxl = a.xwin[(s * tiles_x + tx) * 2 + 1];
    const float* plane = sm.win + (s * kGroup + g) * a.wh * ww;
    for (int i = tid; i < kExtY * wxl; i += kThreads) {
      const int r = i / wxl, rx = i - r * wxl;
      const int y = y_org + r;
      float v = 0.f;
      if (y >= 0 && y < a.th) {
        const int t = (s * kExtY + r) * 4;
        v = tap_sum(sm.ytw[t], plane[sm.yti[t] * ww + rx], sm.ytw[t + 1],
                    plane[sm.yti[t + 1] * ww + rx], sm.ytw[t + 2], plane[sm.yti[t + 2] * ww + rx],
                    sm.ytw[t + 3], plane[sm.yti[t + 3] * ww + rx]);
      }
      sm.vrow[r * ww + rx] = v;
    }
    __syncthreads();
    if (x_org + q < a.tw) {
      const int t = (s * kExtX + q) * 4;
      float w[4];
      int xi[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        w[k] = sm.xtw[t + k];
        xi[k] = sm.xti[t + k];
      }
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const int r = phase + kRowPhases * j;
        if (r < kExtY) {
          const float* row = sm.vrow + r * ww;
          sum[j] += tap_sum(w[0], row[xi[0]], w[1], row[xi[1]], w[2], row[xi[2]], w[3], row[xi[3]]);
        }
      }
    }
    if (has_halo) {
      const int x = x_org + qh;
      if (x >= 0 && x < a.tw) {
        const int t = (s * kExtX + qh) * 4;
        const float* row = sm.vrow + rh * ww;
        sum_h += tap_sum(sm.xtw[t], row[sm.xti[t]], sm.xtw[t + 1], row[sm.xti[t + 1]],
                         sm.xtw[t + 2], row[sm.xti[t + 2]], sm.xtw[t + 3], row[sm.xti[t + 3]]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int r = phase + kRowPhases * j;
    if (r < kExtY) sm.acc[r * kExtX + q] = sum[j] * a.inv_s;
  }
  if (has_halo) sm.acc[rh * kExtX + qh] = sum_h * a.inv_s;
  __syncthreads();
}

// The reference's strict peak test (nms_layer.cu:15-46) at extended-tile
// coords (r, q), map coords (y, x): interior, U > thr and U > its 8
// neighbours.
__device__ __forceinline__ bool strict_peak(const float* acc, int r, int q, int y, int x,
                                            int th, int tw, float thr) {
  if (y < 1 || y > th - 2 || x < 1 || x > tw - 2) return false;
  const float* a = acc + r * kExtX + q;
  float n8 = a[-kExtX - 1];
  n8 = fmaxf(n8, a[-kExtX]);
  n8 = fmaxf(n8, a[-kExtX + 1]);
  n8 = fmaxf(n8, a[-1]);
  n8 = fmaxf(n8, a[1]);
  n8 = fmaxf(n8, a[kExtX - 1]);
  n8 = fmaxf(n8, a[kExtX]);
  n8 = fmaxf(n8, a[kExtX + 1]);
  return a[0] > thr && a[0] > n8;
}

// Raises a kernel's dynamic shared memory limit where a launch needs more
// than the default 48 KB; remembers the largest size granted, so the
// attribute is set once per size and not on every launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, size_t* granted) {
  if (smem <= 48 * 1024 || smem <= *granted) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) *granted = smem;
  return e;
}

}  // namespace crt
