// Fused bicubic upsample + scale average, written out, + strict-peak keys.
//
// Replaces the TPU kernel caffe_rtpose_tpu/ops/nms_pallas.py::_kernel
// (reached through upsample_peak_keys).  For each channel c of the
// low-res map:
//
//     heat_c = U_c = (1/S) sum_s Ay_s . L_s[:, :, c] . Ax_s^T   (th x tw, f32)
//
// and for the first key_channels channels the strict-peak keys of U (above
// the threshold, an f32 scalar in device memory as the TPU kernel's th_ref)
// in the horizontal-pair layout of ops/nms.py::block_keys: (key_channels,
// th * (tw / 2)) int32, entry (y, bx) = H*W - pos of the peak among pixels
// (y, 2bx) and (y, 2bx+1), or 0.  Two strict maxima are never horizontal
// neighbours, so the layout is lossless, and its flattened order is raster
// order, which the sort-free compaction (ops/nms.py::compact_keys) needs.
// The TPU kernel's 2x2-per-128-tile block max (pltpu.roll + selector
// matmuls) was a Mosaic workaround and forced a top_k sort downstream.
//
// What bounds it: the write, 57x368x656 f32 heat (55 MB) plus 18x368x328
// int32 keys (8.7 MB) at COCO 1 scale, >= 19.3 us at 3.35 TB/s, against
// 0.86 MB read.  The upsample itself is ~14 f32 operations a heat pixel; on
// the card it is bound by shared-memory traffic (~300 wavefronts a work
// item), so the design cuts loads per pixel and lets the bytes leave
// while the SM computes (scripts/torch_k3_ablation.py times the phases).
//
// Design.  One warp is one work item, a 32-column x R-row output tile of
// one channel (R from the host, ops/nms_cuda.py::keys_tile_rows: 46 at
// th = 368, 8 tiles of 48 extended rows); a block is 4 independent warps
// on consecutive items (the same tile, neighbouring channels, whose window
// loads share sectors), and no warp waits on another: no block barrier.
// A lane serves a column pair (a, b) in one of the two row halves.  A warp
//   1. loads its channel's source window of every scale into shared memory
//      (the low-res rows and columns the tile's taps reach, ~10 x 8 at
//      factor 8) with L1-cached scalar loads;
//   2. per scale: the vertical pass (lane: a row and every other quad of
//      window columns, 16-byte window loads) writes Vt, the window
//      columns' values transposed (column-major, pitch R+6, so the two
//      halves' stores fall in different banks); the horizontal pass reads
//      each tap of four rows as one 16-byte load of Vt at an offset from
//      the host's tables, one load for both columns of a pair whose taps
//      read the same source columns (every pair at factor 8, scale 1); the
//      scales' sum accumulates in the heat box (R+2 rows x 32 floats, halo
//      rows included);
//   3. computes the tile's two halo columns spread over the lanes;
//   4. sends the box's R interior rows out in one TMA bulk tensor store
//      (cp.async.bulk.tensor.3d ... bulk_group over a CUtensorMap of heat
//      (tw, th, C), L2 evict-first) and meanwhile, for a key channel, runs
//      the key pass: each lane walks down its pair's rows of its half with
//      rows r-1, r, r+1 in registers, its neighbours' column maxima by
//      shuffle (the halo columns' at the tile's edges), into a key box that
//      leaves in a second TMA store (keys (tw/2, th, kc)).  The warp waits
//      only for TMA to have read its boxes, at its end.  TMA clips at the
//      tensors' extents, so the ragged last tiles store without bounds
//      checks.  The bytes of one channel leave while the warp computes its
//      keys and the SM's other 23 warps their tiles (the SM's boxes are
//      the double buffer: one warp's is read out while the others fill).
// Why warp items and a host-chosen R instead of a persistent grid: a warp
// item is ~1 us of work, ~10k of them at COCO 1 scale, so the last wave is
// short without a scheduler; 32-column tiles waste 2.4 % of 656 columns
// (64-column ones 6.8 %) and R = 46 computes 384 rows for 368 (30-row
// tiles: 416).
//
// TMA needs 16-byte global strides (tw % 4 == 0 for heat, tw % 8 == 0 for
// keys) and 16-byte-aligned bases; the wrapper checks them and, for a
// width that misses them, asks for the direct store path: the same tiles,
// each lane storing its pair's values of the box (and its keys) to global
// memory with streaming stores and bounds checks.
//
// The per-pixel FMA order is K1's (bicubic_tile.cuh::tap_sum: taps k = 0..3
// from 0; scales summed in order, then x 1/S), from the same clamped
// window-relative tap tables, so K3's U is K1's, bit for bit, and the two
// kernels find the same peaks.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "bicubic_tile.cuh"

namespace {

using namespace crt;

constexpr int kKeysWarps = 4;   // warps (work items) a block
constexpr int kKeysTileX = 32;  // output columns of a tile: a pair a lane, in two row halves
constexpr int kKeysTaps = kKeysTileX + 2;  // column tap entries a tile: the columns', then the halo's
constexpr unsigned kAll = 0xffffffffu;

__host__ __device__ inline int round32(int n) { return (n + 31) & ~31; }

// Shared memory of one warp, in floats, for S scales, R rows (R + 2 a
// multiple of 16), a widest window of wh rows and a window pitch wp (a
// multiple of 4): the heat box ((R+2) x 32), the halo columns (2 x (R+2)),
// and one region that holds first Vt (wp columns of pitch R+6) and the
// windows of all scales (S x wh x wp), then the key box (R x 16 int32).
// Every part a multiple of 128 bytes.  ops/nms_cuda.py::_keys_smem_bytes
// computes the same.
__host__ __device__ inline int keys_warp_floats(int S, int R, int wh, int wp) {
  const int r2 = R + 2, vt_win = wp * (r2 + 4) + S * wh * wp;
  return r2 * kKeysTileX + round32(2 * r2) + round32(R * 16 > vt_win ? R * 16 : vt_win);
}

long long keys_smem_bytes(int S, int R, int wh, int wp) {
  return 4LL * kKeysWarps * keys_warp_floats(S, R, wh, wp);
}

struct KeysArgs {
  const float* low;  // (S, h, w, C) by strides in elements
  long long st_s, st_y, st_x, st_c;
  int S, C, th, tw, key_channels;
  int rows, tiles_y, tiles_x;  // R, and the tile grid
  const float4* ytap_w;  // (S, tiles_y, R+2): each extended row's 4 tap weights
  const int4* ytap_off;  //   and window offsets, (relative row) * wp
  const float4* xtap_w;  // (S, tiles_x, kKeysTaps): the 32 columns, then x0-1 and x0+32
  const int4* xtap_off;  //   and Vt offsets, (relative column) * (R+6)
  const int* ywin;       // (S, tiles_y, 2) [first row, count]
  const int* xwin;       // (S, tiles_x, 2) [first column, count]
  int wh, wp;            // widest window rows; the window's pitch (>= its widest, % 4 == 0)
  float inv_s;
  int tma;               // 1: TMA bulk stores; 0: the direct store path
  const float* thr;      // f32 device scalar
  float* heat;           // (C, th, tw)
  int32_t* keys;         // (key_channels, th, tw / 2)
};

// A TMA bulk tensor store of the box at src to (x, y, z) of map's tensor,
// in a bulk group of its own.  The L2 policy is evict-first: nothing reads
// the 64 MB back in this kernel, and it is larger than the 50 MB L2.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int x,
                                             int y, int z) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%2, %3, %4}], [%1], %5;"
      ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(static_cast<uint32_t>(__cvta_generic_to_shared(src))), "r"(x), "r"(y), "r"(z),
      "l"(policy)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Makes the warp's shared-memory writes visible to TMA; then lane 0 may
// start a store of them.
__device__ __forceinline__ void publish_to_tma() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncwarp();
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One scale's horizontal pass over the lane's column pair (a, b) and its
// half of the extended rows, four rows at a time: each tap of four rows is
// one 16-byte load from Vt, shared by both columns where their taps read
// the same source columns (kShared: every pair of the warp does, as at any
// factor-8 scale of 1).  The sum of the scales accumulates in the heat box:
// the first scale stores u, a later one adds, the last then x 1/S.  (At
// S = 1, 0 + u and x 1 are skipped: they change no value, at most the sign
// of a zero, which no comparison sees.)
template <bool kShared, bool kFirst, bool kLast>
__device__ __forceinline__ void horizontal_pass(const float* vt, float* box, float4 wa, int4 oa,
                                                float4 wb, int4 ob, int row0, int rows,
                                                float inv_s, int p) {
  for (int j = row0; j < row0 + rows; j += 4) {
    const float4 a0 = lds4(vt + oa.x + j), a1 = lds4(vt + oa.y + j), a2 = lds4(vt + oa.z + j),
                 a3 = lds4(vt + oa.w + j);
    const float4 b0 = kShared ? a0 : lds4(vt + ob.x + j), b1 = kShared ? a1 : lds4(vt + ob.y + j),
                 b2 = kShared ? a2 : lds4(vt + ob.z + j), b3 = kShared ? a3 : lds4(vt + ob.w + j);
    const float* A0 = &a0.x; const float* A1 = &a1.x; const float* A2 = &a2.x; const float* A3 = &a3.x;
    const float* B0 = &b0.x; const float* B1 = &b1.x; const float* B2 = &b2.x; const float* B3 = &b3.x;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 u = make_float2(tap_sum(wa.x, A0[i], wa.y, A1[i], wa.z, A2[i], wa.w, A3[i]),
                             tap_sum(wb.x, B0[i], wb.y, B1[i], wb.z, B2[i], wb.w, B3[i]));
      float2* d = reinterpret_cast<float2*>(box + (j + i) * kKeysTileX) + p;
      if (!kFirst) {
        const float2 sum = *d;
        u.x = sum.x + u.x;
        u.y = sum.y + u.y;
        if (kLast) {
          u.x *= inv_s;
          u.y *= inv_s;
        }
      }
      *d = u;
    }
  }
}

template <bool kShared>
__device__ __forceinline__ void horizontal_scale(bool first, bool last, const float* vt,
                                                 float* box, float4 wa, int4 oa, float4 wb,
                                                 int4 ob, int row0, int rows, float inv_s,
                                                 int p) {
  if (first && last)
    horizontal_pass<kShared, true, true>(vt, box, wa, oa, wb, ob, row0, rows, inv_s, p);
  else if (first)
    horizontal_pass<kShared, true, false>(vt, box, wa, oa, wb, ob, row0, rows, inv_s, p);
  else if (last)
    horizontal_pass<kShared, false, true>(vt, box, wa, oa, wb, ob, row0, rows, inv_s, p);
  else
    horizontal_pass<kShared, false, false>(vt, box, wa, oa, wb, ob, row0, rows, inv_s, p);
}

// At most 80 registers, so that 6 blocks (24 warps) fit an SM, as their
// shared memory does at COCO (37,888 B a block); 88 would leave room for 5.
__global__ void __launch_bounds__(kKeysWarps * 32, 6)
upsample_peak_keys_kernel(const KeysArgs a, const __grid_constant__ CUtensorMap heat_map,
                          const __grid_constant__ CUtensorMap keys_map) {
  extern __shared__ __align__(128) float smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = lane >> 4, p = lane & 15;  // the lane's row half and column pair
  const int item = blockIdx.x * kKeysWarps + warp;
  if (item >= a.tiles_y * a.tiles_x * a.C) return;
  const int c = item % a.C, tile = item / a.C;
  const int ty = tile / a.tiles_x, tx = tile - ty * a.tiles_x;
  const int R = a.rows, r2 = R + 2, vtp = r2 + 4, S = a.S, th = a.th, tw = a.tw, wp = a.wp;
  const int y0 = ty * R, x0 = tx * kKeysTileX;  // the tile's first interior row and column

  // this warp's shared memory, each part 128-byte aligned: heat box, halo
  // columns, then Vt + windows (later the key box)
  float* box = smem_raw + warp * keys_warp_floats(S, R, a.wh, wp);
  float* hcol = box + r2 * kKeysTileX;  // (2, R+2): columns x0-1 and x0+32
  float* vt = hcol + round32(2 * r2);  // (wp, R+6): column-major, 16-byte aligned columns
  float* win = vt + wp * vtp;          // (S, wh, wp)
  int32_t* kbox = reinterpret_cast<int32_t*>(vt);  // (R, 16), once vt and win are done

  // 1. the windows of every scale, lanes along a row's columns, 2 rows at a time
  for (int s = 0; s < S; ++s) {
    const int* wy = a.ywin + (s * a.tiles_y + ty) * 2;
    const int* wx = a.xwin + (s * a.tiles_x + tx) * 2;
    const int cy = wy[1], cx = wx[1];
    const float* src = a.low + s * a.st_s + wy[0] * a.st_y + wx[0] * a.st_x + c * a.st_c;
    float* dst = win + s * a.wh * wp;
    for (int j = p; j < cx; j += 16)
      for (int i = half; i < cy; i += 2) dst[i * wp + j] = __ldg(src + i * a.st_y + j * a.st_x);
  }
  __syncwarp();

  // 2-3. per scale: the vertical pass into Vt (lane: a row, and every other
  // quad of window columns), the horizontal pass into the heat box, the
  // halo columns
  const float4* xw = a.xtap_w + tx * kKeysTaps;
  const int4* xo = a.xtap_off + tx * kKeysTaps;
  for (int s = 0; s < S; ++s) {
    const float* plane = win + s * a.wh * wp;
    const int quads = (a.xwin[(s * a.tiles_x + tx) * 2 + 1] + 3) >> 2;
    for (int r = p; r < r2; r += 16) {
      const int t = (s * a.tiles_y + ty) * r2 + r;
      const float4 w = __ldg(a.ytap_w + t);
      const int4 o = __ldg(a.ytap_off + t);
      for (int q = half; q < quads; q += 2) {
        const float4 v0 = lds4(plane + o.x + 4 * q), v1 = lds4(plane + o.y + 4 * q),
                     v2 = lds4(plane + o.z + 4 * q), v3 = lds4(plane + o.w + 4 * q);
        float* d = vt + 4 * q * vtp + r;
        d[0] = tap_sum(w.x, v0.x, w.y, v1.x, w.z, v2.x, w.w, v3.x);
        d[vtp] = tap_sum(w.x, v0.y, w.y, v1.y, w.z, v2.y, w.w, v3.y);
        d[2 * vtp] = tap_sum(w.x, v0.z, w.y, v1.z, w.z, v2.z, w.w, v3.z);
        d[3 * vtp] = tap_sum(w.x, v0.w, w.y, v1.w, w.z, v2.w, w.w, v3.w);
      }
    }
    __syncwarp();
    const int t = s * a.tiles_x * kKeysTaps;  // scale s of tile column tx
    const float4 wa = __ldg(xw + t + 2 * p), wb = __ldg(xw + t + 2 * p + 1);
    const int4 oa = __ldg(xo + t + 2 * p), ob = __ldg(xo + t + 2 * p + 1);
    const bool first = s == 0, last = s == S - 1;
    const bool same = oa.x == ob.x && oa.y == ob.y && oa.z == ob.z && oa.w == ob.w;
    if (__all_sync(kAll, same))
      horizontal_scale<true>(first, last, vt, box, wa, oa, wb, ob, half * (r2 / 2), r2 / 2,
                             a.inv_s, p);
    else
      horizontal_scale<false>(first, last, vt, box, wa, oa, wb, ob, half * (r2 / 2), r2 / 2,
                              a.inv_s, p);
    for (int i = lane; i < 2 * r2; i += 32) {  // hcol[i]: column i / r2, row i % r2
      const int h = i >= r2, r = i - h * r2;
      const float4 hw = __ldg(xw + t + kKeysTileX + h);
      const int4 ho = __ldg(xo + t + kKeysTileX + h);
      float v = tap_sum(hw.x, vt[ho.x + r], hw.y, vt[ho.y + r], hw.z, vt[ho.z + r], hw.w, vt[ho.w + r]);
      if (!first) {
        v = hcol[i] + v;
        if (last) v *= a.inv_s;
      }
      hcol[i] = v;
    }
    __syncwarp();  // Vt is read; the next scale may overwrite it
  }

  // 4. heat: one TMA store of the box's interior rows, or the direct path
  const int xa = x0 + 2 * p;  // the lane's pair: columns xa, xa + 1
  const int rows_half = R / 2, r_first = 1 + half * rows_half;  // its key and store rows
  if (a.tma) {
    publish_to_tma();
    if (lane == 0) tma_store_3d(&heat_map, box + kKeysTileX, x0, y0, c);
  } else {
    for (int r = r_first; r < r_first + rows_half && y0 + r - 1 < th; ++r) {
      float* dst = a.heat + ((long long)c * th + y0 + r - 1) * tw + xa;
      if (xa < tw) __stcs(dst, box[r * kKeysTileX + 2 * p]);
      if (xa + 1 < tw) __stcs(dst + 1, box[r * kKeysTileX + 2 * p + 1]);
    }
  }

  if (c < a.key_channels) {
    // the strict 8-neighbour test, the reference's nms_layer.cu:15-46, down
    // the lane's pair: with c3 a column's max over rows r-1..r+1 and vm
    // its max over r-1 and r+1, n8(a) = max(c3(a-1), vm(a), c3(b)) and
    // n8(b) = max(c3(a), vm(b), c3(b+1)); c3 of the neighbouring columns by
    // shuffle, at the tile's edges from the halo columns' c3
    float m[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 3; ++k) {  // the halo columns' c3, in place
      const int i = lane + 32 * k, r = i - (i >= r2) * r2;
      if (i < 2 * r2 && r >= 1 && r <= R) m[k] = fmaxf(fmaxf(hcol[i - 1], hcol[i]), hcol[i + 1]);
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int i = lane + 32 * k, r = i - (i >= r2) * r2;
      if (i < 2 * r2 && r >= 1 && r <= R) hcol[i] = m[k];
    }
    __syncwarp();
    const float thr = __ldg(a.thr);
    const bool a_in = xa >= 1 && xa <= tw - 2, b_in = xa + 1 >= 1 && xa + 1 <= tw - 2;
    const int hw = th * tw, tw2 = tw / 2;
    const float2* box2 = reinterpret_cast<const float2*>(box) + p;  // row r at box2[r * 16]
    float2 up = box2[(r_first - 1) * 16], mid = box2[r_first * 16];
    for (int r = r_first; r < r_first + rows_half; ++r) {
      const float2 dn = box2[(r + 1) * 16];
      const float vma = fmaxf(up.x, dn.x), vmb = fmaxf(up.y, dn.y);
      const float c3a = fmaxf(vma, mid.x), c3b = fmaxf(vmb, mid.y);
      float c3l = __shfl_up_sync(kAll, c3b, 1, 16), c3r = __shfl_down_sync(kAll, c3a, 1, 16);
      const float hl = hcol[r], hr = hcol[r2 + r];
      if (p == 0) c3l = hl;
      if (p == 15) c3r = hr;
      const float n8a = fmaxf(fmaxf(c3l, vma), c3b), n8b = fmaxf(fmaxf(c3a, vmb), c3r);
      const int y = y0 + r - 1;
      const bool y_in = y >= 1 && y <= th - 2;
      const bool pa = y_in && a_in && mid.x > thr && mid.x > n8a;
      const bool pb = y_in && b_in && mid.y > thr && mid.y > n8b;
      const int pos = y * tw + xa;
      const int32_t key = pa ? hw - pos : pb ? hw - pos - 1 : 0;
      if (a.tma)
        kbox[(r - 1) * (kKeysTileX / 2) + p] = key;
      else if (y < th && xa + 1 < tw)
        __stcs(a.keys + ((long long)c * th + y) * tw2 + (xa >> 1), key);
      up = mid;
      mid = dn;
    }
    if (a.tma) {
      publish_to_tma();
      if (lane == 0) tma_store_3d(&keys_map, kbox, x0 / 2, y0, c);
    }
  }
  // the boxes must stay until TMA has read them
  if (a.tma && lane == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

size_t g_keys_smem_granted = 0;
bool g_keys_carveout = false;

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime, so
// that the library links against no more than cudart.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D map of a dense (d0, d1, d2) tensor (d0 fastest) of 4-byte elements,
// stored in boxes of (b0, b1, 1).
bool encode_map(CUtensorMap* map, CUtensorMapDataType type, void* ptr, int d0, int d1, int d2,
                int b0, int b1) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)d0 * 4, (cuuint64_t)d0 * d1 * 4};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, type, 3, ptr, dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one K3 block for S scales, R rows a tile and a
// window of wh rows and pitch wp.
long long crt_keys_smem_bytes(int S, int R, int wh, int wp) { return keys_smem_bytes(S, R, wh, wp); }

int crt_upsample_peak_keys(const float* low, long long st_s, long long st_y, long long st_x,
                           long long st_c, int S, int C, int th, int tw, int key_channels, int rows,
                           const float* ytap_w, const int* ytap_off, const float* xtap_w,
                           const int* xtap_off, const int* ywin, const int* xwin, int wh, int wp,
                           float inv_s, int tma, const float* thr, float* heat, int32_t* keys,
                           void* stream) {
  const size_t smem = (size_t)keys_smem_bytes(S, rows, wh, wp);
  cudaError_t e = crt::allow_smem(upsample_peak_keys_kernel, smem, &g_keys_smem_granted);
  if (e != cudaSuccess) return (int)e;
  if (!g_keys_carveout) {  // all of the SM's 228 KB as shared memory: 6 blocks at COCO
    e = cudaFuncSetAttribute(upsample_peak_keys_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    g_keys_carveout = true;
  }
  const int tiles_y = (th + rows - 1) / rows, tiles_x = (tw + kKeysTileX - 1) / kKeysTileX;
  // the maps are kernel arguments: a captured CUDA graph keeps the ones
  // encoded at capture, over the graph's own output buffers
  CUtensorMap heat_map = {}, keys_map = {};
  if (tma && (!encode_map(&heat_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, heat, tw, th, C,
                          kKeysTileX, rows) ||
              (key_channels > 0 &&
               !encode_map(&keys_map, CU_TENSOR_MAP_DATA_TYPE_INT32, keys, tw / 2, th,
                           key_channels, kKeysTileX / 2, rows))))
    return (int)cudaErrorInvalidValue;
  const KeysArgs a{low, st_s, st_y, st_x, st_c, S, C, th, tw, key_channels, rows, tiles_y, tiles_x,
                   reinterpret_cast<const float4*>(ytap_w), reinterpret_cast<const int4*>(ytap_off),
                   reinterpret_cast<const float4*>(xtap_w), reinterpret_cast<const int4*>(xtap_off),
                   ywin, xwin, wh, wp, inv_s, tma, thr, heat, keys};
  const long long items = (long long)tiles_y * tiles_x * C;
  const int grid = (int)((items + kKeysWarps - 1) / kKeysWarps);
  upsample_peak_keys_kernel<<<grid, kKeysWarps * 32, smem, (cudaStream_t)stream>>>(a, heat_map,
                                                                                  keys_map);
  return (int)cudaGetLastError();
}

}  // extern "C"
