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
// per-output tap tables (index + weight, taken from the same f32 matrices
// the plain PyTorch version multiplies by) and accumulates in plain f32 FMA.
//
// Design: one block per (channel, 32x64 output tile).  Per scale, a
// vertical pass over the tile's rows plus a one-row halo (all source
// columns) goes to shared memory, then a horizontal pass over the tile's
// columns plus a one-column halo accumulates U in shared memory.  After the
// last scale the block applies the strict 8-neighbour test from shared
// memory and writes the i8 mask.  The full-res U never reaches device
// memory: what bounds the kernel is its 18x368x656 i8 mask write plus the
// taps' FMAs (recomputed per tile, a few tens of MFMA per frame), not HBM.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileY = 32;
constexpr int kTileX = 64;
constexpr int kExtY = kTileY + 2;  // one-pixel halo above and below
constexpr int kExtX = kTileX + 2;
constexpr int kThreads = 256;

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
  float* acc = smem + kExtY * w;    // (kExtY, kExtX): U summed over scales

  const int c = blockIdx.z;
  const int y_org = blockIdx.y * kTileY - 1;  // extended-tile origin
  const int x_org = blockIdx.x * kTileX - 1;
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
  __syncthreads();

  for (int i = tid; i < kTileY * kTileX; i += kThreads) {
    const int r = i / kTileX + 1;  // extended-tile coords of the pixel
    const int q = i - (r - 1) * kTileX + 1;
    const int y = y_org + r;
    const int x = x_org + q;
    if (y >= th || x >= tw) continue;
    int8_t m = 0;
    if (y >= 1 && y <= th - 2 && x >= 1 && x <= tw - 2) {
      const float* a = acc + r * kExtX + q;
      const float u = a[0] * inv_s;
      float n8 = a[-kExtX - 1] * inv_s;
      n8 = fmaxf(n8, a[-kExtX] * inv_s);
      n8 = fmaxf(n8, a[-kExtX + 1] * inv_s);
      n8 = fmaxf(n8, a[-1] * inv_s);
      n8 = fmaxf(n8, a[1] * inv_s);
      n8 = fmaxf(n8, a[kExtX - 1] * inv_s);
      n8 = fmaxf(n8, a[kExtX] * inv_s);
      n8 = fmaxf(n8, a[kExtX + 1] * inv_s);
      m = (u > thr && u > n8) ? 1 : 0;
    }
    mask[((long long)c * th + y) * tw + x] = m;
  }
}

}  // namespace

extern "C" {

const char* crt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Dynamic shared memory the kernel needs for a low-res width w.
long long crt_peak_mask_smem_bytes(int w) {
  return (long long)(kExtY * w + kExtY * kExtX) * (long long)sizeof(float);
}

int crt_peak_mask(const float* low, long long st_s, long long st_y, long long st_x,
                  long long st_c, int S, int h, int w, int C, int th, int tw,
                  const int* ytap_idx, const float* ytap_w,
                  const int* xtap_idx, const float* xtap_w,
                  float inv_s, float thr, int8_t* mask, void* stream) {
  const size_t smem = (size_t)crt_peak_mask_smem_bytes(w);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        peak_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((tw + kTileX - 1) / kTileX, (th + kTileY - 1) / kTileY, C);
  peak_mask_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      low, st_s, st_y, st_x, st_c, S, h, w, th, tw, ytap_idx, ytap_w, xtap_idx,
      xtap_w, inv_s, thr, mask);
  return (int)cudaGetLastError();
}

}  // extern "C"
