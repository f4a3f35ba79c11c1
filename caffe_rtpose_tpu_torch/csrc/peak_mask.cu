// Fused bicubic upsample + scale average + strict 8-neighbour peak mask.
//
// Replaces the TPU kernels caffe_rtpose_tpu/ops/nms_pallas.py::
// _mask_kernel_chan (whole-frame form) and ::_mask_kernel (128x128-tile
// form), which compute the same mask, and the batched grid that jax.vmap
// makes of them over the frames of a batch.  For each frame f and part
// channel c:
//
//     U_fc = (1/S) sum_s Ay_s . L_fs[:, :, c] . Ax_s^T      (th x tw)
//     mask_fc(y, x) = interior(y, x) && U > thr && U > max(8 neighbours)
//
// thr is read from an f32 scalar in device memory, as the TPU kernel reads
// th_ref, so a captured CUDA graph takes a new threshold without a new
// launch argument.
//
// The bicubic operator is separable and each output row/column has at most
// four nonzero taps, so instead of the TPU's dense matmuls this kernel reads
// per-output tap tables and accumulates in plain f32 FMA.
//
// What bounds it on Hopper: the 18x368x656 bool mask it writes a frame
// (4.35 MB at COCO 1 scale, ~1.3 us at 3.35 TB/s); the low-res read is
// 0.27 MB and the taps' FMAs ~40 MFLOP a frame.  The full-res U never
// reaches device memory.
//
// Design: one block per (32x64 output tile, frame, group of kGroup
// channels); blockIdx.z runs over the frames' channel groups, so one launch
// covers a batch, and every frame shares the tap tables and windows.  The
// block stages the tile's tap tables and its source window (~8 x 12 low-res
// pixels per scale at factor 8) of the group's channels in shared memory
// once, with loads along the NHWC channel axis (bicubic_tile.cuh), then per
// channel computes U over the tile plus a one-pixel halo in shared memory,
// applies the strict 8-neighbour test from registers (each thread 4 columns
// x 2 rows, its 4 x 6 neighbourhood read once) and writes the bool mask
// four pixels per 32-bit store.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "bicubic_tile.cuh"

namespace {

using namespace crt;

__global__ void __launch_bounds__(kThreads)
peak_mask_kernel(TileArgs a, const float* __restrict__ thr_p,  // f32 device scalar
                 uint8_t* __restrict__ mask) {                  // (F, C, th, tw) bool
  const float thr = __ldg(thr_p);
  extern __shared__ float smem[];
  const TileSmem sm = carve_tile_smem(smem, a.S, a.wh, a.ww);
  const int groups = (a.C + kGroup - 1) / kGroup;
  const int tx = blockIdx.x, ty = blockIdx.y;
  const int f = blockIdx.z / groups, c0 = (blockIdx.z - f * groups) * kGroup;
  stage_tile(a, f, c0, ty, tx, sm);

  const int y_org = ty * kTileY - 1, x_org = tx * kTileX - 1;
  const int q0 = 1 + 4 * (threadIdx.x % 16);  // extended-tile coords of this thread's
  const int r0 = 1 + 2 * (threadIdx.x / 16);  // 4 columns x 2 rows
  const int x = x_org + q0;                    // a multiple of 4
  for (int g = 0; g < kGroup && c0 + g < a.C; ++g) {
    upsample_channel(a, g, ty, tx, sm);
    float v[4][6];  // rows r0-1 .. r0+2, columns q0-1 .. q0+4
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j) v[i][j] = sm.acc[(r0 - 1 + i) * kExtX + q0 - 1 + j];
    const int c = c0 + g;
#pragma unroll
    for (int i = 1; i <= 2; ++i) {
      const int y = y_org + r0 + i - 1;
      if (y >= a.th) continue;
      uint32_t word = 0;
#pragma unroll
      for (int j = 1; j <= 4; ++j) {
        const int xj = x + j - 1;
        if (y < 1 || y > a.th - 2 || xj < 1 || xj > a.tw - 2) continue;
        float n8 = v[i - 1][j - 1];  // the order of strict_peak
        n8 = fmaxf(n8, v[i - 1][j]);
        n8 = fmaxf(n8, v[i - 1][j + 1]);
        n8 = fmaxf(n8, v[i][j - 1]);
        n8 = fmaxf(n8, v[i][j + 1]);
        n8 = fmaxf(n8, v[i + 1][j - 1]);
        n8 = fmaxf(n8, v[i + 1][j]);
        n8 = fmaxf(n8, v[i + 1][j + 1]);
        if (v[i][j] > thr && v[i][j] > n8) word |= 1u << (8 * (j - 1));
      }
      const long long at = (((long long)f * a.C + c) * a.th + y) * a.tw + x;
      if (x + 3 < a.tw && (at & 3) == 0) {
        *reinterpret_cast<uint32_t*>(mask + at) = word;
      } else {
        for (int j = 0; j < 4 && x + j < a.tw; ++j) mask[at + j] = (word >> (8 * j)) & 1u;
      }
    }
  }
}

size_t g_mask_smem_granted = 0;

}  // namespace

extern "C" {

const char* crt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Dynamic shared memory a block of either kernel needs for S scales and a
// widest source window of wh x ww low-res pixels.
long long crt_tile_smem_bytes(int S, int wh, int ww) { return crt::tile_smem_bytes(S, wh, ww); }

int crt_peak_mask(const float* low, long long st_f, long long st_s, long long st_y,
                  long long st_x, long long st_c, int F, int S, int C, int th, int tw,
                  const int* ytap_idx, const float* ytap_w,
                  const int* xtap_idx, const float* xtap_w, const int* ywin, const int* xwin,
                  int wh, int ww, int vec4, float inv_s, const float* thr, uint8_t* mask,
                  void* stream) {
  const size_t smem = (size_t)crt::tile_smem_bytes(S, wh, ww);
  cudaError_t e = crt::allow_smem(peak_mask_kernel, smem, &g_mask_smem_granted);
  if (e != cudaSuccess) return (int)e;
  const crt::TileArgs a{low, st_f, st_s, st_y, st_x, st_c, S, C, th, tw, ytap_idx, ytap_w,
                        xtap_idx, xtap_w, ywin, xwin, wh, ww, vec4, inv_s};
  const dim3 grid((tw + crt::kTileX - 1) / crt::kTileX, (th + crt::kTileY - 1) / crt::kTileY,
                  F * ((C + crt::kGroup - 1) / crt::kGroup));
  peak_mask_kernel<<<grid, crt::kThreads, smem, (cudaStream_t)stream>>>(a, thr, mask);
  return (int)cudaGetLastError();
}

}  // extern "C"
