// The tile upsample shared by peak_mask.cu and upsample_peak_keys.cu.
//
// One block computes, for one channel c and one 32x64 output tile plus a
// one-pixel halo, the scale-averaged bicubic upsample
//
//     U_c = (1/S) sum_s Ay_s . L_s[:, :, c] . Ax_s^T
//
// from per-output tap tables (index + weight of each output row's and
// column's <= 4 nonzero taps, taken from the same f32 matrices the plain
// PyTorch version multiplies by).  Per scale, a vertical pass over the
// extended tile's rows (all source columns) goes to shared memory, then a
// horizontal pass over the extended tile's columns accumulates into a
// second shared array.  Both kernels run this same code, so their U agree
// bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace crt {

constexpr int kTileY = 32;
constexpr int kTileX = 64;  // even, so a horizontal pixel pair never straddles two tiles
constexpr int kExtY = kTileY + 2;  // one-pixel halo above and below
constexpr int kExtX = kTileX + 2;
constexpr int kThreads = 256;

// Dynamic shared memory of one block for a low-res width w: the vertical
// pass (kExtY, w) and the accumulator (kExtY, kExtX), f32.
inline long long tile_smem_bytes(int w) {
  return (long long)(kExtY * w + kExtY * kExtX) * (long long)sizeof(float);
}

// Fills acc (kExtY x kExtX, extended-tile origin y_org, x_org) with U of
// channel c; entries outside the map are 0.  vrow is (kExtY, w) scratch.
// Ends with a barrier, so every thread may read all of acc afterwards.
__device__ __forceinline__ void upsample_tile(
    const float* __restrict__ low, long long st_s, long long st_y, long long st_x,
    long long st_c, int c, int S, int w, int th, int tw,
    const int* __restrict__ ytap_idx, const float* __restrict__ ytap_w,
    const int* __restrict__ xtap_idx, const float* __restrict__ xtap_w,
    float inv_s, int y_org, int x_org, float* vrow, float* acc) {
  const int tid = threadIdx.x;
  for (int i = tid; i < kExtY * kExtX; i += kThreads) acc[i] = 0.f;

  for (int s = 0; s < S; ++s) {
    __syncthreads();  // previous scale's horizontal pass is done with vrow
    const float* plane = low + s * st_s + c * st_c;
    for (int i = tid; i < kExtY * w; i += kThreads) {
      const int r = i / w;
      const int xs = i - r * w;
      const int y = y_org + r;
      float v = 0.f;
      if (y >= 0 && y < th) {
        const int t = (s * th + y) * 4;
        const float* col = plane + xs * st_x;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v = fmaf(ytap_w[t + k], col[ytap_idx[t + k] * st_y], v);
      }
      vrow[i] = v;
    }
    __syncthreads();
    for (int i = tid; i < kExtY * kExtX; i += kThreads) {
      const int r = i / kExtX;
      const int q = i - r * kExtX;
      const int x = x_org + q;
      if (x < 0 || x >= tw) continue;
      const int t = (s * tw + x) * 4;
      const float* row = vrow + r * w;
      float u = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) u = fmaf(xtap_w[t + k], row[xtap_idx[t + k]], u);
      acc[i] += u;  // each thread owns the same entries in every scale
    }
  }
  for (int i = tid; i < kExtY * kExtX; i += kThreads) acc[i] *= inv_s;
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

// Raises the block's dynamic shared memory limit where a launch needs more
// than the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace crt
