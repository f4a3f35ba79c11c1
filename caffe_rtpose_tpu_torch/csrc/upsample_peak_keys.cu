// Fused bicubic upsample + scale average, written out, + strict-peak keys.
//
// Replaces the TPU kernel caffe_rtpose_tpu/ops/nms_pallas.py::_kernel
// (reached through upsample_peak_keys).  For each channel c of the
// low-res map:
//
//     heat_c = U_c = (1/S) sum_s Ay_s . L_s[:, :, c] . Ax_s^T   (th x tw, f32)
//
// and for the first key_channels channels the strict-peak keys of U in the
// horizontal-pair layout of ops/nms.py::block_keys: (key_channels,
// th * (tw / 2)) int32, entry (y, bx) = H*W - pos of the peak among pixels
// (y, 2bx) and (y, 2bx+1), or 0.  Two strict maxima are never horizontal
// neighbours, so the layout is lossless, and its flattened order is raster
// order, which the sort-free compaction (ops/nms.py::compact_keys) needs.
// The TPU kernel's 2x2-per-128-tile block max (pltpu.roll + selector
// matmuls) was a Mosaic workaround and forced a top_k sort downstream.
//
// Design: as peak_mask.cu, one block per (channel, 32x64 output tile), U
// over the tile plus a one-pixel halo in shared memory (bicubic_tile.cuh,
// the same code, so the two kernels' U agree bit for bit).  The block then
// writes the tile's interior U to heat in coalesced 64-float rows and, for
// key channels, applies the strict 8-neighbour test from shared memory and
// writes one key per pixel pair.  What bounds it is the write: at COCO 1
// scale, 57x368x656 f32 heat (55 MB) plus 18x368x328 int32 keys (8.7 MB),
// >= ~20 us at 3.35 TB/s.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "bicubic_tile.cuh"

namespace {

using namespace crt;

__global__ void __launch_bounds__(kThreads)
upsample_peak_keys_kernel(const float* __restrict__ low,  // (S, h, w, C) strided
                          long long st_s, long long st_y, long long st_x, long long st_c,
                          int S, int h, int w, int th, int tw, int key_channels,
                          const int* __restrict__ ytap_idx,    // (S, th, 4)
                          const float* __restrict__ ytap_w,    // (S, th, 4)
                          const int* __restrict__ xtap_idx,    // (S, tw, 4)
                          const float* __restrict__ xtap_w,    // (S, tw, 4)
                          float inv_s, float thr,
                          float* __restrict__ heat,            // (C, th, tw)
                          int32_t* __restrict__ keys) {        // (key_channels, th, tw/2)
  extern __shared__ float smem[];
  float* vrow = smem;               // (kExtY, w): vertical pass of one scale
  float* acc = smem + kExtY * w;    // (kExtY, kExtX): U over the extended tile

  const int c = blockIdx.z;
  const int y_org = blockIdx.y * kTileY - 1;  // extended-tile origin
  const int x_org = blockIdx.x * kTileX - 1;
  upsample_tile(low, st_s, st_y, st_x, st_c, c, S, w, th, tw, ytap_idx, ytap_w,
                xtap_idx, xtap_w, inv_s, y_org, x_org, vrow, acc);

  for (int i = threadIdx.x; i < kTileY * kTileX; i += kThreads) {
    const int r = i / kTileX + 1;  // extended-tile coords of the pixel
    const int q = i - (r - 1) * kTileX + 1;
    const int y = y_org + r;
    const int x = x_org + q;
    if (y >= th || x >= tw) continue;
    heat[((long long)c * th + y) * tw + x] = acc[r * kExtX + q];
  }
  if (c >= key_channels) return;

  const int tw2 = tw / 2;  // an odd last column is border, never a peak
  const int hw = th * tw;
  for (int i = threadIdx.x; i < kTileY * (kTileX / 2); i += kThreads) {
    const int r = i / (kTileX / 2) + 1;
    const int q = 2 * (i - (r - 1) * (kTileX / 2)) + 1;  // left pixel of the pair
    const int y = y_org + r;
    const int x = x_org + q;  // even
    if (y >= th || x + 1 >= tw) continue;
    const int pos = y * tw + x;
    int32_t key = 0;
    if (strict_peak(acc, r, q, y, x, th, tw, thr))
      key = hw - pos;
    else if (strict_peak(acc, r, q + 1, y, x + 1, th, tw, thr))
      key = hw - pos - 1;
    keys[((long long)c * th + y) * tw2 + x / 2] = key;
  }
}

}  // namespace

extern "C" {

int crt_upsample_peak_keys(const float* low, long long st_s, long long st_y, long long st_x,
                           long long st_c, int S, int h, int w, int C, int th, int tw,
                           int key_channels, const int* ytap_idx, const float* ytap_w,
                           const int* xtap_idx, const float* xtap_w, float inv_s, float thr,
                           float* heat, int32_t* keys, void* stream) {
  const size_t smem = (size_t)crt::tile_smem_bytes(w);
  cudaError_t e = crt::allow_smem(upsample_peak_keys_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((tw + crt::kTileX - 1) / crt::kTileX, (th + crt::kTileY - 1) / crt::kTileY, C);
  upsample_peak_keys_kernel<<<grid, crt::kThreads, smem, (cudaStream_t)stream>>>(
      low, st_s, st_y, st_x, st_c, S, h, w, th, tw, key_channels, ytap_idx, ytap_w,
      xtap_idx, xtap_w, inv_s, thr, heat, keys);
  return (int)cudaGetLastError();
}

}  // extern "C"
