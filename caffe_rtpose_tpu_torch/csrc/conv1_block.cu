// The VGG trunk's conv1 block in one kernel, bf16 in and out:
//
//     h1  = bf16(ReLU(conv3x3(x, w1) + b1))          3 -> 64, pad 1
//     out = bf16(maxpool2x2(ReLU(conv3x3(h1, w2) + b2)))   64 -> 64, pad 1
//
// Replaces the TPU kernel caffe_rtpose_tpu/ops/conv1_pallas.py::_kernel
// (reached through conv1_block_pallas).  Sums are f32 over bf16 operands,
// biases f32, and h1 is rounded to bf16 exactly once, as there.  ReLU,
// + b2 and the bf16 rounding are monotone, so the 2x2 max is taken on the
// f32 sums before them: the result equals the unfused chain's.
//
// What bounds it on Hopper: per 656x368 canvas conv1_2 is 17.8 GFLOP and
// conv1_1 0.83 GFLOP, against 1.45 MB read and 7.7 MB written.  So it is
// bound by the tensor cores (conv1_2) and the CUDA cores (conv1_1), never
// by device memory: the unfused chain writes and re-reads two 31 MB
// intermediates that this kernel keeps in shared memory.
//
// Design: one block per SM, looping over 16x16 conv-output tiles of all
// images (a persistent loop, so that the 74 KB of conv1_2 weights are
// loaded into shared memory once per block, not once per tile).  Per tile:
//   1. the 20x20x3 input halo tile goes to shared memory as f32 (zeros
//      outside the image);
//   2. conv1_1 on the CUDA cores: each lane owns two output channels with
//      their 27 taps in registers; the 18x18x64 h1 tile (conv1_2's 1-pixel
//      halo included) is stored as bf16, zero outside the image: conv1_2's
//      padding, not conv1_1 of the padding, which would be ReLU(b1);
//   3. conv1_2 as an implicit GEMM on the tensor cores (nvcuda::wmma bf16
//      16x16x16, f32 accumulators): M = the tile's 256 pixels, N = 64,
//      K = 9 taps x 64 channels.  Warp w owns conv rows 2w and 2w+1 (one
//      16-pixel A fragment each) and all four 16-channel N fragments, so its
//      rows are exactly one pooled row: the vertical max is an elementwise
//      max of two accumulator fragments of the same layout;
//   4. the warp stages that max through its own shared-memory slice (the
//      fragment layout is opaque), then takes the horizontal max, adds b2,
//      applies ReLU and stores bf16 pairs: the (8 x 64) pooled row is one
//      1 KB contiguous run of the channels_last output.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kTile = 16;              // conv-output tile, 16 x 16 pixels
constexpr int kH1 = kTile + 2;         // h1 tile with conv1_2's halo
constexpr int kIn = kTile + 4;         // input tile with conv1_1's halo too
constexpr int kC = 64;                 // channels of h1 and of the output
constexpr int kTaps = 9;
constexpr int kK = kTaps * kC;         // conv1_2's GEMM depth, 576
constexpr int kWarps = kTile / 2;      // one pooled row per warp
constexpr int kThreads = kWarps * 32;  // 256
// Row pitches in elements.  wmma wants 32-byte-aligned fragment pointers;
// A fragments start at any pixel, so a pixel's h1 row is 80 bf16 (160 B),
// which also spreads eight consecutive pixels over the banks two-way.  B
// fragments start at multiples of 16 rows, so 72 bf16 rows suffice and
// keep their loads conflict-free.
constexpr int kLdA = 80;
constexpr int kLdB = 72;
constexpr int kLdS = 68;  // f32 staging pitch

constexpr int kW2Bytes = kK * kLdB * 2;                  // 82,944
constexpr int kH1Bytes = kH1 * kH1 * kLdA * 2;           // 51,840
constexpr int kInBytes = kIn * kIn * 3 * 4;              //  4,800
constexpr int kStageBytes = kWarps * kTile * kLdS * 4;   // 34,816
constexpr int kSmemBytes = kW2Bytes + kH1Bytes + kInBytes + kStageBytes;  // 174,400

__global__ void __launch_bounds__(kThreads, 1)
conv1_block_kernel(const __nv_bfloat16* __restrict__ x,  // (B, 3, H, W) strided
                   long long st_b, long long st_c, long long st_y, long long st_x,
                   int B, int H, int W,
                   const float* __restrict__ w1,           // (27, 64): [ky][kx][c] x out, bf16-valued
                   const float* __restrict__ b1,           // (64,)
                   const __nv_bfloat16* __restrict__ w2,   // (576, 64): [ky][kx][cin] x cout
                   const float* __restrict__ b2,           // (64,)
                   __nv_bfloat16* __restrict__ out) {      // (B, H/2, W/2, 64)
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* h1s = reinterpret_cast<__nv_bfloat16*>(smem + kW2Bytes);
  float* xs = reinterpret_cast<float*>(smem + kW2Bytes + kH1Bytes);
  float* stage = reinterpret_cast<float*>(smem + kW2Bytes + kH1Bytes + kInBytes);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // conv1_2's weights, once per block: 16-byte copies into padded rows
  for (int i = tid; i < kK * (kC / 8); i += kThreads) {
    const int row = i / (kC / 8), seg = i - row * (kC / 8);
    reinterpret_cast<uint4*>(w2s + row * kLdB)[seg] =
        reinterpret_cast<const uint4*>(w2 + row * kC)[seg];
  }
  // conv1_1's weights of this lane's two channels, and its biases
  const int n0 = 2 * lane;
  float wa[27], wb[27];
#pragma unroll
  for (int k = 0; k < 27; ++k) {
    wa[k] = w1[k * kC + n0];
    wb[k] = w1[k * kC + n0 + 1];
  }
  const float b1a = b1[n0], b1b = b1[n0 + 1];
  const float b2a = b2[n0], b2b = b2[n0 + 1];

  const int H2 = H >> 1, W2 = W >> 1;
  const int tiles_x = (W + kTile - 1) / kTile;
  const int tiles_y = (H + kTile - 1) / kTile;
  const long long n_tiles = (long long)B * tiles_y * tiles_x;
  float* my_stage = stage + warp * kTile * kLdS;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = (int)(tile / ((long long)tiles_y * tiles_x));
    const int t_yx = (int)(tile - (long long)b * tiles_y * tiles_x);
    const int y0 = (t_yx / tiles_x) * kTile;
    const int x0 = (t_yx % tiles_x) * kTile;
    const __nv_bfloat16* xb = x + b * st_b;

    // 1. input halo tile: image rows y0-2 .. y0+17, cols x0-2 .. x0+17.
    // The barrier also keeps this tile's h1 writes below behind every
    // warp's reads of the previous tile's h1.
    for (int i = tid; i < kIn * kIn * 3; i += kThreads) {
      const int p = i / 3, c = i - p * 3;
      const int r = p / kIn, q = p - r * kIn;
      const int y = y0 - 2 + r, xx = x0 - 2 + q;
      float v = 0.f;
      if (y >= 0 && y < H && xx >= 0 && xx < W)
        v = __bfloat162float(xb[c * st_c + y * st_y + xx * st_x]);
      xs[i] = v;
    }
    __syncthreads();

    // 2. conv1_1 over the 18x18 h1 tile (image rows y0-1 .., cols x0-1 ..)
    for (int p = warp; p < kH1 * kH1; p += kWarps) {
      const int r = p / kH1, q = p - r * kH1;
      const int y = y0 - 1 + r, xx = x0 - 1 + q;
      __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
      if (y >= 0 && y < H && xx >= 0 && xx < W) {
        float sa = 0.f, sb = 0.f;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float xv = xs[((r + ky) * kIn + q + kx) * 3 + c];
              const int k = (ky * 3 + kx) * 3 + c;
              sa = fmaf(xv, wa[k], sa);
              sb = fmaf(xv, wb[k], sb);
            }
        v = __floats2bfloat162_rn(fmaxf(sa + b1a, 0.f), fmaxf(sb + b1b, 0.f));
      }
      reinterpret_cast<__nv_bfloat162*>(h1s + p * kLdA)[lane] = v;
    }
    __syncthreads();

    // 3. conv1_2: rows 2*warp and 2*warp+1 of the tile, all 64 channels
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int t = 0; t < kTaps; ++t) {
      const int ky = t / 3, kx = t - ky * 3;
#pragma unroll
      for (int kc = 0; kc < kC; kc += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], h1s + ((2 * warp + i + ky) * kH1 + kx) * kLdA + kc, kLdA);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
          wmma::load_matrix_sync(bf, w2s + (t * kC + kc) * kLdB + 16 * j, kLdB);
          wmma::mma_sync(acc[0][j], a[0], bf, acc[0][j]);
          wmma::mma_sync(acc[1][j], a[1], bf, acc[1][j]);
        }
      }
    }

    // 4. vertical max in registers, horizontal max through the staging
    // slice, then + b2, ReLU, bf16
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < acc[0][j].num_elements; ++e)
        acc[0][j].x[e] = fmaxf(acc[0][j].x[e], acc[1][j].x[e]);
      wmma::store_matrix_sync(my_stage + 16 * j, acc[0][j], kLdS, wmma::mem_row_major);
    }
    __syncwarp();
    const int oy = (y0 >> 1) + warp;
    if (oy < H2) {
      __nv_bfloat16* orow = out + ((long long)b * H2 + oy) * W2 * kC;
#pragma unroll
      for (int q = 0; q < kTile / 2; ++q) {
        const int ox = (x0 >> 1) + q;
        if (ox >= W2) break;
        const float* s0 = my_stage + (2 * q) * kLdS + n0;
        const float* s1 = s0 + kLdS;
        const float va = fmaxf(fmaxf(s0[0], s1[0]) + b2a, 0.f);
        const float vb = fmaxf(fmaxf(s0[1], s1[1]) + b2b, 0.f);
        reinterpret_cast<__nv_bfloat162*>(orow + (long long)ox * kC)[lane] =
            __floats2bfloat162_rn(va, vb);
      }
    }
    __syncwarp();  // the staging slice is rewritten by the next tile
  }
}

}  // namespace

extern "C" {

long long crt_conv1_smem_bytes() { return kSmemBytes; }

int crt_conv1_block(const void* x, long long st_b, long long st_c, long long st_y,
                    long long st_x, int B, int H, int W, const float* w1, const float* b1,
                    const void* w2, const float* b2, void* out, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(conv1_block_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const long long n_tiles =
      (long long)B * ((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile);
  const int grid = (int)(n_tiles < sms ? n_tiles : sms);
  if (grid == 0) return (int)cudaSuccess;
  conv1_block_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), st_b, st_c, st_y, st_x, B, H, W, w1, b1,
      static_cast<const __nv_bfloat16*>(w2), b2, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
