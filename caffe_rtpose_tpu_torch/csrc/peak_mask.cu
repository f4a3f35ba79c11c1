// Fused bicubic upsample + scale average + strict 8-neighbour peak mask.
//
// Replaces the TPU kernels caffe_rtpose_tpu/ops/nms_pallas.py::
// _mask_kernel_chan (whole-frame form) and ::_mask_kernel (128x128-tile
// form), which compute the same mask.  For each part channel c:
//
//     U_c = (1/S) sum_s Ay_s . L_s[:, :, c] . Ax_s^T         (th x tw)
//     mask_c(y, x) = interior(y, x) && U > thr && U > max(8 neighbours)
//
// The bicubic operator is separable and each output row/column has at most
// four nonzero taps, so instead of the TPU's dense matmuls this kernel reads
// per-output tap tables and accumulates in plain f32 FMA.
//
// Design: one block per (channel, 32x64 output tile).  The block computes
// U over the tile plus a one-pixel halo in shared memory (bicubic_tile.cuh),
// applies the strict 8-neighbour test from shared memory and writes the i8
// mask.  The full-res U never reaches device memory: what bounds the kernel
// is its 18x368x656 i8 mask write plus the taps' FMAs (recomputed per tile,
// a few tens of MFMA per frame), not HBM.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "bicubic_tile.cuh"

namespace {

using namespace crt;

__global__ void __launch_bounds__(kThreads)
peak_mask_kernel(const float* __restrict__ low,  // (S, h, w, C) strided
                 long long st_s, long long st_y, long long st_x, long long st_c,
                 int S, int h, int w, int th, int tw,
                 const int* __restrict__ ytap_idx,    // (S, th, 4)
                 const float* __restrict__ ytap_w,    // (S, th, 4)
                 const int* __restrict__ xtap_idx,    // (S, tw, 4)
                 const float* __restrict__ xtap_w,    // (S, tw, 4)
                 float inv_s, float thr,
                 int8_t* __restrict__ mask) {         // (C, th, tw)
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
    mask[((long long)c * th + y) * tw + x] = strict_peak(acc, r, q, y, x, th, tw, thr) ? 1 : 0;
  }
}

}  // namespace

extern "C" {

const char* crt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Dynamic shared memory a block of either kernel needs for a low-res width w.
long long crt_tile_smem_bytes(int w) { return crt::tile_smem_bytes(w); }

int crt_peak_mask(const float* low, long long st_s, long long st_y, long long st_x,
                  long long st_c, int S, int h, int w, int C, int th, int tw,
                  const int* ytap_idx, const float* ytap_w,
                  const int* xtap_idx, const float* xtap_w,
                  float inv_s, float thr, int8_t* mask, void* stream) {
  const size_t smem = (size_t)crt::tile_smem_bytes(w);
  cudaError_t e = crt::allow_smem(peak_mask_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((tw + crt::kTileX - 1) / crt::kTileX, (th + crt::kTileY - 1) / crt::kTileY, C);
  peak_mask_kernel<<<grid, crt::kThreads, smem, (cudaStream_t)stream>>>(
      low, st_s, st_y, st_x, st_c, S, h, w, th, tw, ytap_idx, ytap_w, xtap_idx,
      xtap_w, inv_s, thr, mask);
  return (int)cudaGetLastError();
}

}  // extern "C"
