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
// conv1_1 0.83 GFLOP (18.8 us at the 989 TFLOP/s bf16 peak), against
// 1.45 MB read and 7.7 MB written (2.7 us at 3.35 TB/s): the tensor cores.
// The unfused chain writes and re-reads two 31 MB intermediates that this
// kernel keeps in shared memory.
//
// Design (sm_90a; one persistent 384-thread block per SM):
//   * The block's three warpgroups work on three 16x16 conv-output tiles
//     at once, each with its own input halo and h1 buffer and its own named
//     barrier, so one warpgroup's halo load, conv1_1 and pooling overlap
//     the others' tensor-core work.  conv1_2's weights (72 KB) are loaded
//     once per block, in the layout Conv1Weights.pack makes: per tap a
//     64 (c_out) x 64 (c_in) K-major tile with the 128-byte swizzle.
//   * conv1_1 runs on the tensor cores too: im2col rows (K = 27 taps x
//     channels, padded to 32 with zero weights) gathered from the 20x20x3
//     halo into A-fragment registers, B = w1 from shared memory, the
//     18x18 h1 tile (conv1_2's halo included) as 6 M = 64 blocks; + b1,
//     ReLU, bf16, zero outside the image (conv1_2's padding, not conv1_1 of
//     the padding, which would be ReLU(b1)).  The tensor cores sum exact
//     products but truncate, in their own order; where a sum lies within
//     128 f32 ulps of a bf16 rounding midpoint (~0.4 % of them, found by
//     three integer operations into a bit mask, then listed), the
//     warpgroup recomputes it in f32 FMA, so h1 rounds as an f32 sum does.
//     Without that, a few h1 values a canvas round the other way and move
//     outputs near zero by more than two bf16 ulps.
//   * conv1_2 is an implicit GEMM on wgmma.m64n64k16 (f32 accumulators):
//     M = the tile's 256 pixels as four M = 64 blocks, N = 64, K = 9 taps x
//     64 channels.  A (the tap-shifted h1 rows) goes to registers with
//     ldmatrix, each lane's row address carrying the tap's shift (which a
//     shared-memory descriptor's fixed strides cannot); B comes from the
//     weights through a wgmma descriptor.  The A fragments of tap t+1 load
//     while tap t's wgmmas run (two register buffers, wgmma.wait_group 1).
//   * Pooling in registers: each warp's 16 M rows are 8 columns of two
//     adjacent conv rows, rows i and i+8 one above the other, so the
//     vertical max is inside a thread and the horizontal one a
//     __shfl_xor_sync(.., 4) away.  Then + b2, ReLU and bf16 pairs to the
//     channels_last output.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;              // conv-output tile, 16 x 16 pixels
constexpr int kH1 = kTile + 2;         // h1 tile with conv1_2's halo, 18 x 18
constexpr int kIn = kTile + 4;         // input tile with conv1_1's halo too, 20 x 20
constexpr int kC = 64;                 // channels of h1 and of the output
constexpr int kTaps = 9;
constexpr int kGroups = 3;             // warpgroups a block, each on its own tile
constexpr int kThreads = 128 * kGroups;
constexpr int kH1Pix = kH1 * kH1;      // 324
constexpr int kInCh = 4;               // halo channels: 3 + a zero slot

constexpr int kW2Bytes = kTaps * kC * kC * 2;            // 73,728: 9 swizzled 8 KB tiles
constexpr int kW1Bytes = kC * kC * 2;                    //  8,192: K padded to 64 columns
constexpr int kBiasBytes = 2 * kC * 4;                   //    512
constexpr int kH1Bytes = kH1Pix * kC * 2;                // 41,472: 128 B a pixel, swizzled
constexpr int kHaloBytes = kIn * kIn * kInCh * 2;        //  3,200
// conv1_1 sums that land near a bf16 rounding midpoint: a list of
// (pixel, channel) entries to recompute in f32 FMA, and its length
constexpr int kTieUlps = 128;
constexpr int kFixCap = 512;
constexpr int kFixBytes = kFixCap * 2 + 16;              //  1,040
constexpr int kFixedBytes = kW2Bytes + kW1Bytes + kBiasBytes;
constexpr int kWgBytes = kH1Bytes + kHaloBytes + kFixBytes;
// + 1 KB so that the weights can start on a 1024-byte boundary (the swizzle's period)
constexpr int kSmemBytes = kFixedBytes + kGroups * kWgBytes + 1024;  // 220,592

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor of a K-major operand with the 128-byte
// swizzle: start address, leading byte offset 16 (unused by this layout),
// stride byte offset 1024 (between 8-row groups), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of the accumulators across a
// wgmma fence or wait.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 64, f32) (+)= A (64 x 16, bf16, registers) . B (16 x 64, bf16,
// shared memory, K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// h1 element (pixel p, channel n): 64 channels a pixel, the 16-byte chunk
// n / 8 stored at chunk (n / 8) ^ (p % 8), so that ldmatrix's eight rows
// (eight neighbouring pixels) and the epilogue's stores meet distinct banks.
__device__ __forceinline__ int h1_at(int p, int n) {
  return p * kC + ((((n >> 3) ^ p) & 7) << 3) + (n & 7);
}

__device__ __forceinline__ void named_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Whether the bf16 rounding of v is within ~kTieUlps f32 ulps of a
// midpoint (low 16 bits near 0x8000), where the tensor cores' accumulation
// (exact products, sums truncated, in their own order) may round h1
// otherwise than an f32 FMA sum.  Three integer operations, no branch.
__device__ __forceinline__ bool near_midpoint(float v) {
  return ((__float_as_uint(v) + (kTieUlps - 1)) & 0xFF00u) == 0x8000u;
}

// h1 of tile pixel m (18x18 raster), channel n, summed in f32 FMA in the
// order (ky, kx, c) from the halo and the swizzled conv1_1 weights.
__device__ __forceinline__ float h1_fma(const __nv_bfloat16* halo, const unsigned char* w1s,
                                        const float* b1s, int m, int n) {
  const __nv_bfloat16* px = halo + ((m / kH1) * kIn + m % kH1) * kInCh;
  const unsigned char* wrow = w1s + n * 128;
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 27; ++k) {
    const int ky = k / 9, kx = (k / 3) % 3, c = k % 3;
    const __nv_bfloat16 w =
        *reinterpret_cast<const __nv_bfloat16*>(wrow + ((((k >> 3) ^ (n & 7)) << 4) | ((k & 7) << 1)));
    s = fmaf(__bfloat162float(px[(ky * kIn + kx) * kInCh + c]), __bfloat162float(w), s);
  }
  return fmaxf(s + b1s[n], 0.f);
}

__global__ void __launch_bounds__(kThreads, 1)
conv1_block_kernel(const __nv_bfloat16* __restrict__ x,  // (B, 3, H, W) strided
                   long long st_b, long long st_c, long long st_y, long long st_x,
                   int B, int H, int W,
                   const __nv_bfloat16* __restrict__ w1p,  // packed by Conv1Weights.pack
                   const float* __restrict__ b1,           // (64,)
                   const __nv_bfloat16* __restrict__ w2p,  // packed by Conv1Weights.pack
                   const float* __restrict__ b2,           // (64,)
                   __nv_bfloat16* __restrict__ out) {      // (B, H/2, W/2, 64)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* w2s = smem;
  unsigned char* w1s = smem + kW2Bytes;
  float* b1s = reinterpret_cast<float*>(smem + kW2Bytes + kW1Bytes);
  float* b2s = b1s + kC;

  const int tid = threadIdx.x;
  // the weights, once per block (already in their shared-memory layout),
  // then made visible to the tensor cores' (async proxy) reads
  for (int i = tid; i < kW2Bytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(w2s)[i] = reinterpret_cast<const uint4*>(w2p)[i];
  for (int i = tid; i < kW1Bytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(w1s)[i] = reinterpret_cast<const uint4*>(w1p)[i];
  if (tid < kC) {
    b1s[tid] = b1[tid];
    b2s[tid] = b2[tid];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int g = tid >> 7;            // warpgroup: its own tiles, buffers and barrier
  const int t = tid & 127;
  const int warp = t >> 5, lane = t & 31;
  const int bar = 1 + g;
  __nv_bfloat16* h1 = reinterpret_cast<__nv_bfloat16*>(smem + kFixedBytes + g * kWgBytes);
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem + kFixedBytes + g * kWgBytes +
                                                         kH1Bytes);
  uint16_t* fix = reinterpret_cast<uint16_t*>(smem + kFixedBytes + g * kWgBytes + kH1Bytes +
                                              kHaloBytes);
  int* n_fix = reinterpret_cast<int*>(fix + kFixCap);
  const uint32_t w1_addr = smem_addr(w1s), w2_addr = smem_addr(w2s);

  // conv1_1's im2col: this lane's 8 K columns (2 k-steps x 2 halves x a
  // pair), as offsets from a pixel's halo slot; K >= 27 reads the pixel's
  // zero channel slot
  int koff[2][2][2];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 16 * s + 8 * hf + 2 * (lane & 3) + e;
        const int ky = k / 9, kx = (k / 3) % 3, c = k % 3;
        koff[s][hf][e] = k < 27 ? (ky * kIn + kx) * kInCh + c : kInCh - 1;
      }
  // conv1_2's ldmatrix rows: lane -> M row ri = lane % 16 of its warp
  // (conv row 2*(warp/2) + ri/8, conv column 8*(warp%2) + ri%8 of an M
  // block) and channel half lane / 16
  const int ri = lane & 15, half = lane >> 4;
  const int p_lane = (2 * (warp >> 1) + (ri >> 3)) * kH1 + 8 * (warp & 1) + (ri & 7);
  const uint32_t h1_addr = smem_addr(h1);
  // the A rows of k-step s (channels 16s .. 16s+15) at h1 pixel p
  auto a_row = [&](int p, int s) -> uint32_t {
    return h1_addr + (uint32_t)(p * kC * 2 + ((((2 * s + half) ^ p) & 7) << 4));
  };

  const int H2 = H >> 1, W2 = W >> 1;
  const int tiles_x = (W + kTile - 1) / kTile;
  const int tiles_y = (H + kTile - 1) / kTile;
  const long long n_tiles = (long long)B * tiles_y * tiles_x;

  for (long long tile = (long long)kGroups * blockIdx.x + g; tile < n_tiles;
       tile += (long long)kGroups * gridDim.x) {
    const int b = (int)(tile / ((long long)tiles_y * tiles_x));
    const int t_yx = (int)(tile - (long long)b * tiles_y * tiles_x);
    const int y0 = (t_yx / tiles_x) * kTile;
    const int x0 = (t_yx % tiles_x) * kTile;
    const __nv_bfloat16* xb = x + b * st_b;

    // 1. input halo: image rows y0-2 .. y0+17, cols x0-2 .. x0+17, zeros
    // outside the image and in the fourth channel slot.  The barrier also
    // orders this tile's h1 writes below after the previous tile's reads.
    if (t == 0) *n_fix = 0;
    for (int p = t; p < kIn * kIn; p += 128) {
      const int y = y0 - 2 + p / kIn, xx = x0 - 2 + p % kIn;
      uint2 v = make_uint2(0u, 0u);
      if (y >= 0 && y < H && xx >= 0 && xx < W) {
        const __nv_bfloat16* px = xb + y * st_y + xx * st_x;
        v = make_uint2(pack_bf16(px[0], px[st_c]), pack_bf16(px[2 * st_c], __float2bfloat16(0.f)));
      }
      reinterpret_cast<uint2*>(halo)[p] = v;
    }
    named_barrier(bar);

    // 2. conv1_1 over the 18x18 h1 tile (image rows y0-1 .., cols x0-1 ..):
    // M = 324 pixels in 6 blocks of 64 (rows past 324 gather pixel 323 and
    // are dropped), K = 32, two M blocks per round
#pragma unroll 1
    for (int rnd = 0; rnd < 3; ++rnd) {
      uint32_t a[2][2][4];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        const int m0 = (2 * rnd + mb) * 64 + 16 * warp + (lane >> 2);
        const int p0 = min(m0, kH1Pix - 1), p1 = min(m0 + 8, kH1Pix - 1);
        const __nv_bfloat16* s0 = halo + ((p0 / kH1) * kIn + p0 % kH1) * kInCh;
        const __nv_bfloat16* s1 = halo + ((p1 / kH1) * kIn + p1 % kH1) * kInCh;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          a[mb][s][0] = pack_bf16(s0[koff[s][0][0]], s0[koff[s][0][1]]);
          a[mb][s][1] = pack_bf16(s1[koff[s][0][0]], s1[koff[s][0][1]]);
          a[mb][s][2] = pack_bf16(s0[koff[s][1][0]], s0[koff[s][1][1]]);
          a[mb][s][3] = pack_bf16(s1[koff[s][1][0]], s1[koff[s][1][1]]);
        }
      }
      float acc[2][32];
      wgmma_fence();
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int s = 0; s < 2; ++s) wgmma_rs(acc[mb], a[mb][s], sw128_desc(w1_addr + 32 * s), s);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      uint64_t near = 0;  // bit (mb, hf, j, e): that sum is near a midpoint
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int m = (2 * rnd + mb) * 64 + 16 * warp + (lane >> 2) + 8 * hf;
          const int y = y0 - 1 + m / kH1, xx = x0 - 1 + m % kH1;
          const bool inside = m < kH1Pix && y >= 0 && y < H && xx >= 0 && xx < W;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = 8 * j + 2 * (lane & 3);
            float v[2] = {0.f, 0.f};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (inside) v[e] = acc[mb][4 * j + 2 * hf + e] + b1s[n + e];
              near |= (uint64_t)near_midpoint(v[e]) << (((mb * 2 + hf) * 8 + j) * 2 + e);
            }
            if (m < kH1Pix)
              *reinterpret_cast<__nv_bfloat162*>(h1 + h1_at(m, n)) =
                  __floats2bfloat162_rn(fmaxf(v[0], 0.f), fmaxf(v[1], 0.f));
          }
        }
      // list them (rare: ~0.4 % of the sums), one loop for all
      while (near) {
        const int bit = __ffsll((long long)near) - 1;
        near &= near - 1;
        const int mb = bit >> 5, hf = (bit >> 4) & 1, j = (bit >> 1) & 7, e = bit & 1;
        const int m = (2 * rnd + mb) * 64 + 16 * warp + (lane >> 2) + 8 * hf;
        const int at = atomicAdd(n_fix, 1);
        if (at < kFixCap) fix[at] = (uint16_t)(m * kC + 8 * j + 2 * (lane & 3) + e);
      }
    }
    named_barrier(bar);
    // the listed sums, recomputed in f32 FMA by the whole warpgroup; where
    // the list overflowed (a degenerate image), every sum of the tile
    const int listed = *n_fix;
    const int n_redo = listed <= kFixCap ? listed : kH1Pix * kC;
    for (int i = t; i < n_redo; i += 128) {
      const int mn = listed <= kFixCap ? fix[i] : i;
      const int m = mn / kC, n = mn % kC;
      const int y = y0 - 1 + m / kH1, xx = x0 - 1 + m % kH1;
      if (y >= 0 && y < H && xx >= 0 && xx < W)
        h1[h1_at(m, n)] = __float2bfloat16(h1_fma(halo, w1s, b1s, m, n));
    }
    named_barrier(bar);

    // 3. conv1_2, two passes of two M blocks (conv rows 8p .. 8p+7), then
    // the pool of each pass
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      // M block mb starts at conv row 8*pass + 4*mb
      const int p_pass = p_lane + 8 * pass * kH1;
      float acc[2][32];
      uint32_t a[2][2][4][4];  // [buffer][M block][k-step][register]
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int s = 0; s < 4; ++s)
          ldmatrix_x4(a[0][mb][s], a_row(p_pass + 4 * mb * kH1, s));
#pragma unroll
      for (int tap = 0; tap < kTaps; ++tap) {
        const int buf = tap & 1;
        wgmma_fence();
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
          for (int s = 0; s < 4; ++s)
            wgmma_rs(acc[mb], a[buf][mb][s], sw128_desc(w2_addr + tap * kC * kC * 2 + 32 * s),
                     (tap | s) != 0);
        wgmma_commit();
        if (tap + 1 < kTaps) {
          // the previous tap's group read the other buffer: wait for it alone
          wgmma_wait<1>();
          const int ky1 = (tap + 1) / 3, kx1 = (tap + 1) % 3;
#pragma unroll
          for (int mb = 0; mb < 2; ++mb)
#pragma unroll
            for (int s = 0; s < 4; ++s)
              ldmatrix_x4(a[buf ^ 1][mb][s], a_row(p_pass + (4 * mb + ky1) * kH1 + kx1, s));
        }
      }
      wgmma_wait<0>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);

      // pool: rows lane/4 and lane/4 + 8 of the warp's M rows are one
      // pixel column of conv rows 2i and 2i+1; lane ^ 4 holds the column
      // beside it.  Lanes with even lane/4 store channel blocks 0-3, their
      // partners 4-7.
      const bool upper = (lane >> 2) & 1;
      const int ox = (x0 >> 1) + 4 * (warp & 1) + (lane >> 3);
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        const int oy = (y0 >> 1) + 4 * pass + 2 * mb + (warp >> 1);
        float v0[8], v1[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          v0[j] = fmaxf(acc[mb][4 * j], acc[mb][4 * j + 2]);
          v1[j] = fmaxf(acc[mb][4 * j + 1], acc[mb][4 * j + 3]);
          v0[j] = fmaxf(v0[j], __shfl_xor_sync(0xffffffffu, v0[j], 4));
          v1[j] = fmaxf(v1[j], __shfl_xor_sync(0xffffffffu, v1[j], 4));
        }
        if (oy < H2 && ox < W2) {
          __nv_bfloat16* orow = out + (((long long)b * H2 + oy) * W2 + ox) * kC;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = jj + 4 * upper;
            const int n = 8 * j + 2 * (lane & 3);
            const float p0 = upper ? v0[jj + 4] : v0[jj];
            const float p1 = upper ? v1[jj + 4] : v1[jj];
            *reinterpret_cast<__nv_bfloat162*>(orow + n) =
                __floats2bfloat162_rn(fmaxf(p0 + b2s[n], 0.f), fmaxf(p1 + b2s[n + 1], 0.f));
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

long long crt_conv1_smem_bytes() { return kSmemBytes; }

// Once per process and device: allow the kernel its dynamic shared memory.
int crt_conv1_prepare() {
  return (int)cudaFuncSetAttribute(conv1_block_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
}

// ``blocks``: the grid size cap, the card's SM count (the wrapper caches it).
int crt_conv1_block(const void* x, long long st_b, long long st_c, long long st_y,
                    long long st_x, int B, int H, int W, const void* w1p, const float* b1,
                    const void* w2p, const float* b2, void* out, int blocks, void* stream) {
  const long long n_tiles =
      (long long)B * ((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile);
  const long long need = (n_tiles + kGroups - 1) / kGroups;
  const int grid = (int)(need < blocks ? need : blocks);
  if (grid == 0) return (int)cudaSuccess;
  conv1_block_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), st_b, st_c, st_y, st_x, B, H, W,
      static_cast<const __nv_bfloat16*>(w1p), b1, static_cast<const __nv_bfloat16*>(w2p), b2,
      static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
