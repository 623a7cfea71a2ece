// Weighted combination of bounded shifts, forward and backward, for sm_90a.
//
//   out[b, y, x, c] = sum_d v[b, y, x, d] * src_pad[b, y + d / K, x + d % K, c]
//
// with K = 2R + 1, d over the K*K row-major offsets, src_pad the source
// padded by R on each spatial side, all tensors NHWC and contiguous. The
// backward of a cotangent g of `out`:
//
//   dsrc[b, qy, qx, c] = sum_d v[b, qy - d / K, qx - d % K, d] * g[b, qy - d / K, qx - d % K, c]
//   dv[b, y, x, d]     = sum_c g[b, y, x, c] * src_pad[b, y + d / K, x + d % K, c]
//
// (terms of dsrc whose pixel falls outside the H x W frame are absent;
// columns d >= K*K of dv are zero).
//
// Replaces: hoig_tpu/ops/local_combine.py:_fwd_kernel, _bwd_src_kernel and
// _bwd_v_kernel (Pallas, TPU), which kept one batch element's whole padded
// frame in VMEM. Shared memory on Hopper holds at most 227 KB per block, so
// here a block owns an 8x8 tile of pixels and stages only the windows of
// the tile's (8 + 2R)^2 pixels that it reads.
//
//   * forward (all dtypes): stages the source window and the tile's 64 x K^2
//     coefficient rows, 64 channels at a time; warp = tile row, lane =
//     channel pair.
//   * backward, bf16 inputs (entry points *_tc): both gradients are banded
//     products of the tile against its window, run as warpgroup matrix
//     multiplies on the tensor cores (wgmma, bf16 operands, f32
//     accumulators; see "backward on the tensor cores" below).
//   * backward, f32 inputs: FP32 kernels on the CUDA cores. bwd_src is a
//     gather, no atomics: the tiles cover the PADDED frame; the block stages
//     the window of g that reaches its tile (zero outside the image) and,
//     one offset row dy at a time, column d of the coefficient rows of the
//     pixels it reads. bwd_v: a thread owns one pixel and every fourth
//     offset d, keeps its <= 31 sums in registers and walks the channels in
//     ascending order, 64-channel chunk after chunk (no atomics, no
//     shuffles). The Pallas bwd_src read-modify-wrote shifted slices of the
//     output in the output's dtype; here every sum is kept in f32 and
//     rounded once (a numerical improvement under bf16).
//
// What bounds them on an H100: at the attention's shapes (R = 3 over 128
// channels, R = 5 over 128..512 channels) every element takes K^2
// multiply-adds against a few bytes moved: 2 * K^2 FLOP per output element
// of forward and bwd_src, 2 * C FLOP per element of dv. On the CUDA cores
// (the forward, the f32 backward) that arithmetic bounds them; on the tensor
// cores it is a few microseconds per step and the bytes bound them.
//
// Numerics: forward and the f32 bwd_src accumulate in f32 in ascending d,
// each term rounded as a product and then added (no fused multiply-add; this
// file is built with -fmad=false). That is the exact order and rounding of
// the plain PyTorch versions, so they agree bit for bit. The f32 bwd_v sums
// over channels with explicit fused multiply-adds in f32. The tensor-core
// kernels form the same exact bf16 x bf16 products and add them in f32 in
// the tensor cores' order, then round once to bf16: within one bf16 ulp of
// the plain version, plus 1e-5 of the largest sum of |v| |g| (bwd_src) or of
// the largest |g| |src| (bwd_v).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 8;       // output tile edge (pixels)
constexpr int kChunk = 64;     // channels per block: 32 lanes x 2 channels
constexpr int kThreads = 256;  // 8 warps; warp w owns tile row w

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void copy_pair(float* dst, const float* src) {
  *reinterpret_cast<float2*>(dst) = *reinterpret_cast<const float2*>(src);
}
__device__ __forceinline__ void copy_pair(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = *reinterpret_cast<const __nv_bfloat162*>(src);
}

__device__ __forceinline__ void zero_pair(float* dst) {
  *reinterpret_cast<float2*>(dst) = make_float2(0.f, 0.f);
}
__device__ __forceinline__ void zero_pair(__nv_bfloat16* dst) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(0.f, 0.f);
}

__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store_one(float* dst, float a) { *dst = a; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_fwd_kernel(const T* __restrict__ src, const T* __restrict__ v, T* __restrict__ out,
                   int h, int w, int c, int d_cols, int radius) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = 2 * radius + 1;
  const int kk = k * k;
  const int win = kTile + 2 * radius;
  const int hp = h + 2 * radius;
  const int wp = w + 2 * radius;
  float* v_s = reinterpret_cast<float*>(smem);                            // [64][kk]
  T* src_s = reinterpret_cast<T*>(smem + sizeof(float) * kTile * kTile * kk);  // [win][win][64]

  const int tiles_x = (w + kTile - 1) / kTile;
  const int ty0 = (blockIdx.x / tiles_x) * kTile;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  const int c0 = blockIdx.y * kChunk;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x;

  // coefficient rows of the tile's pixels (only the first K^2 columns)
  for (int i = tid; i < kTile * kTile * kk; i += kThreads) {
    const int p = i / kk;
    const int d = i - p * kk;
    const int y = ty0 + p / kTile;
    const int x = tx0 + p % kTile;
    float val = 0.f;
    if (y < h && x < w) val = to_f32(v[((b * h + y) * w + x) * d_cols + d]);
    v_s[i] = val;
  }
  // source window of the tile in the padded frame, channel pairs
  constexpr int kPairs = kChunk / 2;
  for (int i = tid; i < win * win * kPairs; i += kThreads) {
    const int q = i / kPairs;
    const int cp = i - q * kPairs;
    const int y = ty0 + q / win;
    const int x = tx0 + q % win;
    const int ch = c0 + 2 * cp;
    T* dst = src_s + q * kChunk + 2 * cp;
    if (y < hp && x < wp && ch < c) {
      copy_pair(dst, src + ((b * hp + y) * wp + x) * c + ch);
    } else {
      zero_pair(dst);
    }
  }
  __syncthreads();

  const int row = tid >> 5;
  const int lane = tid & 31;
  float acc0[kTile];
  float acc1[kTile];
#pragma unroll
  for (int px = 0; px < kTile; ++px) {
    acc0[px] = 0.f;
    acc1[px] = 0.f;
  }
  const float* vrow = v_s + row * kTile * kk;
  for (int dy = 0; dy < k; ++dy) {
    const T* srow = src_s + (row + dy) * win * kChunk + 2 * lane;
    for (int dx = 0; dx < k; ++dx) {
      const int d = dy * k + dx;
#pragma unroll
      for (int px = 0; px < kTile; ++px) {
        const float2 s = load_pair(srow + (px + dx) * kChunk);
        const float wv = vrow[px * kk + d];
        acc0[px] = __fadd_rn(acc0[px], __fmul_rn(s.x, wv));
        acc1[px] = __fadd_rn(acc1[px], __fmul_rn(s.y, wv));
      }
    }
  }

  const int y = ty0 + row;
  const int ch = c0 + 2 * lane;
  if (y >= h || ch >= c) return;
#pragma unroll
  for (int px = 0; px < kTile; ++px) {
    const int x = tx0 + px;
    if (x < w) store_pair(out + ((b * h + y) * w + x) * c + ch, acc0[px], acc1[px]);
  }
}

template <typename T>
int launch(const void* src, const void* v, void* out, int b, int h, int w, int c, int d_cols,
           int radius, cudaStream_t stream) {
  const int k = 2 * radius + 1;
  const int win = kTile + 2 * radius;
  const size_t smem = sizeof(float) * kTile * kTile * k * k + sizeof(T) * win * win * kChunk;
  if (smem > 227 * 1024 || c % 2 != 0 || d_cols < k * k) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(combine_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((h + kTile - 1) / kTile) * ((w + kTile - 1) / kTile),
                  (c + kChunk - 1) / kChunk, b);
  combine_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(v), static_cast<T*>(out), h, w, c,
      d_cols, radius);
  return cudaGetLastError();
}

// dsrc over the padded frame. Tile (ty0, tx0) of the padded frame reads g at
// pixels tile - (dy, dx): a window whose origin is (ty0 - 2R, tx0 - 2R).
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_bwd_src_kernel(const T* __restrict__ g, const T* __restrict__ v, T* __restrict__ dsrc,
                       int h, int w, int c, int d_cols, int radius) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = 2 * radius + 1;
  const int win = kTile + 2 * radius;
  const int hp = h + 2 * radius;
  const int wp = w + 2 * radius;
  float* v_s = reinterpret_cast<float*>(smem);                              // [kTile][win][k]
  T* g_s = reinterpret_cast<T*>(smem + sizeof(float) * kTile * win * k);    // [win][win][64]

  const int tiles_x = (wp + kTile - 1) / kTile;
  const int ty0 = (blockIdx.x / tiles_x) * kTile;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  const int oy = ty0 - 2 * radius;
  const int ox = tx0 - 2 * radius;
  const int c0 = blockIdx.y * kChunk;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x;

  constexpr int kPairs = kChunk / 2;
  for (int i = tid; i < win * win * kPairs; i += kThreads) {
    const int q = i / kPairs;
    const int cp = i - q * kPairs;
    const int y = oy + q / win;
    const int x = ox + q % win;
    const int ch = c0 + 2 * cp;
    T* dst = g_s + q * kChunk + 2 * cp;
    if (y >= 0 && y < h && x >= 0 && x < w && ch < c) {
      copy_pair(dst, g + ((b * h + y) * w + x) * c + ch);
    } else {
      zero_pair(dst);
    }
  }

  const int row = tid >> 5;
  const int lane = tid & 31;
  float acc0[kTile];
  float acc1[kTile];
#pragma unroll
  for (int px = 0; px < kTile; ++px) {
    acc0[px] = 0.f;
    acc1[px] = 0.f;
  }
  const float* vrow = v_s + row * win * k;
  for (int dy = 0; dy < k; ++dy) {
    __syncthreads();  // the previous offset row's readers are done with v_s
    // columns dy*K .. dy*K+K-1 of the coefficient rows this offset row reads
    for (int i = tid; i < kTile * win * k; i += kThreads) {
      const int r = i / (win * k);
      const int rem = i - r * win * k;
      const int wx = rem / k;
      const int dx = rem - wx * k;
      const int y = ty0 + r - dy;
      const int x = ox + wx;
      float val = 0.f;
      if (y >= 0 && y < h && x >= 0 && x < w) {
        val = to_f32(v[((b * h + y) * w + x) * d_cols + dy * k + dx]);
      }
      v_s[i] = val;
    }
    __syncthreads();
    const T* grow = g_s + (row + 2 * radius - dy) * win * kChunk + 2 * lane;
    for (int dx = 0; dx < k; ++dx) {
#pragma unroll
      for (int px = 0; px < kTile; ++px) {
        const int wx = px + 2 * radius - dx;
        const float2 s = load_pair(grow + wx * kChunk);
        const float wv = vrow[wx * k + dx];
        acc0[px] = __fadd_rn(acc0[px], __fmul_rn(s.x, wv));
        acc1[px] = __fadd_rn(acc1[px], __fmul_rn(s.y, wv));
      }
    }
  }

  const int y = ty0 + row;
  const int ch = c0 + 2 * lane;
  if (y >= hp || ch >= c) return;
#pragma unroll
  for (int px = 0; px < kTile; ++px) {
    const int x = tx0 + px;
    if (x < wp) store_pair(dsrc + ((b * hp + y) * wp + x) * c + ch, acc0[px], acc1[px]);
  }
}

constexpr int kStride = kChunk + 2;  // elements between staged pixels (33 or 66 banks)
constexpr int kDGroups = 4;          // thread = (pixel, d mod 4)
constexpr int kMaxD = 31;            // offsets per thread: ceil(121 / 4), so R <= 5

template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_bwd_v_kernel(const T* __restrict__ src, const T* __restrict__ g, T* __restrict__ dv,
                     int h, int w, int c, int d_cols, int radius) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = 2 * radius + 1;
  const int kk = k * k;
  const int win = kTile + 2 * radius;
  const int hp = h + 2 * radius;
  const int wp = w + 2 * radius;
  T* src_s = reinterpret_cast<T*>(smem);        // [win * win][kStride]
  T* g_s = src_s + win * win * kStride;         // [kTile * kTile][kStride]

  const int tiles_x = (w + kTile - 1) / kTile;
  const int ty0 = (blockIdx.x / tiles_x) * kTile;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  const long long b = blockIdx.y;
  const int tid = threadIdx.x;
  const int pix = tid & (kTile * kTile - 1);
  const int dgrp = tid / (kTile * kTile);
  const int py = pix / kTile;
  const int px = pix % kTile;
  const int nj = (kk - dgrp + kDGroups - 1) / kDGroups;  // d = dgrp + 4 j < kk

  int off[kMaxD];
  float acc[kMaxD];
#pragma unroll
  for (int j = 0; j < kMaxD; ++j) {
    const int d = dgrp + kDGroups * j;
    off[j] = d < kk ? ((py + d / k) * win + px + d % k) * kStride : 0;
    acc[j] = 0.f;
  }

  constexpr int kPairs = kChunk / 2;
  for (int c0 = 0; c0 < c; c0 += kChunk) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < win * win * kPairs; i += kThreads) {
      const int q = i / kPairs;
      const int cp = i - q * kPairs;
      const int y = ty0 + q / win;
      const int x = tx0 + q % win;
      const int ch = c0 + 2 * cp;
      T* dst = src_s + q * kStride + 2 * cp;
      if (y < hp && x < wp && ch < c) {
        copy_pair(dst, src + ((b * hp + y) * wp + x) * c + ch);
      } else {
        zero_pair(dst);
      }
    }
    for (int i = tid; i < kTile * kTile * kPairs; i += kThreads) {
      const int p = i / kPairs;
      const int cp = i - p * kPairs;
      const int y = ty0 + p / kTile;
      const int x = tx0 + p % kTile;
      const int ch = c0 + 2 * cp;
      T* dst = g_s + p * kStride + 2 * cp;
      if (y < h && x < w && ch < c) {
        copy_pair(dst, g + ((b * h + y) * w + x) * c + ch);
      } else {
        zero_pair(dst);
      }
    }
    __syncthreads();
    const T* gp = g_s + pix * kStride;
    for (int cp = 0; cp < kPairs; ++cp) {
      const float2 gv = load_pair(gp + 2 * cp);
      const T* sp = src_s + 2 * cp;
#pragma unroll
      for (int j = 0; j < kMaxD; ++j) {
        if (j >= nj) break;
        const float2 s = load_pair(sp + off[j]);
        acc[j] = __fmaf_rn(gv.x, s.x, acc[j]);
        acc[j] = __fmaf_rn(gv.y, s.y, acc[j]);
      }
    }
  }

  const int y = ty0 + py;
  const int x = tx0 + px;
  if (y >= h || x >= w) return;
  T* row = dv + ((b * h + y) * w + x) * d_cols;
#pragma unroll
  for (int j = 0; j < kMaxD; ++j) {
    if (j >= nj) break;
    store_one(row + dgrp + kDGroups * j, acc[j]);
  }
  for (int d = kk + dgrp; d < d_cols; d += kDGroups) store_one(row + d, 0.f);
}

template <typename T>
int launch_bwd_src(const void* g, const void* v, void* dsrc, int b, int h, int w, int c,
                   int d_cols, int radius, cudaStream_t stream) {
  const int k = 2 * radius + 1;
  const int win = kTile + 2 * radius;
  const size_t smem = sizeof(float) * kTile * win * k + sizeof(T) * win * win * kChunk;
  if (smem > 227 * 1024 || c % 2 != 0 || d_cols < k * k) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(combine_bwd_src_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int hp = h + 2 * radius;
  const int wp = w + 2 * radius;
  const dim3 grid(((hp + kTile - 1) / kTile) * ((wp + kTile - 1) / kTile),
                  (c + kChunk - 1) / kChunk, b);
  combine_bwd_src_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(v), static_cast<T*>(dsrc), h, w, c, d_cols,
      radius);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd_v(const void* src, const void* g, void* dv, int b, int h, int w, int c,
                 int d_cols, int radius, cudaStream_t stream) {
  const int k = 2 * radius + 1;
  const int win = kTile + 2 * radius;
  const size_t smem = sizeof(T) * (win * win + kTile * kTile) * kStride;
  if (smem > 227 * 1024 || c % 2 != 0 || d_cols < k * k || k * k > kMaxD * kDGroups) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(combine_bwd_v_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((h + kTile - 1) / kTile) * ((w + kTile - 1) / kTile), b);
  combine_bwd_v_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(g), static_cast<T*>(dv), h, w, c, d_cols,
      radius);
  return cudaGetLastError();
}

// ----------------------------------------------- backward on the tensor cores
//
// For bf16 inputs both gradients of a tile are banded matrix products of the
// tile against the (8 + 2R)^2 window of pixels it reads, run as warpgroup
// matrix multiplies (wgmma.mma_async, bf16 operands, f32 accumulators;
// sm_90a). A product of two bf16 values is exact in f32, so the tensor cores
// form the plain version's very products; only the order of the f32 sums
// differs. Window pixel n lies at (n / kWin, n % kWin) of the window, tile
// pixel m at (m / 8, m % 8) of the tile.
//
//   combine_bwd_v_tc_kernel: D = g_tile . src_window^T (M = the tile's 64
//     pixels, N = the window's pixels, K = channels; both operands K-major,
//     as NHWC keeps channels contiguous), and dv[m, d] = D[m, m + off_d],
//     the band: (dy, dx) = window pixel - tile pixel, both in [0, K). The
//     full product costs 2.7x (R = 5) to 4x (R = 3) the band's operations,
//     a few microseconds per step; its bytes are what bound it.
//   combine_bwd_src_tc_kernel: dsrc_tile = Wt . g_window (M = 64 pixels of
//     the padded frame, K = the window's pixels, N = channels; g MN-major),
//     with Wt[m, n] = v[n, (m - n + 2R)] inside the band and zero outside,
//     built in shared memory from the window's coefficient rows.
//
// Tiling. bwd_v: a block owns (image, 8x8 tile, a contiguous range of the
// 64-channel slabs); two warpgroups split the window's pixels, each in
// wgmma of kTcN = 56 columns (3 of them at R = 5: 84 accumulators a
// thread). The slabs stream through two shared-memory stages by cp.async,
// two slabs in flight, a stage refilled as soon as its wgmma are done
// (102 KB at R = 5, two blocks per SM). Where the tiles alone would not
// give every SM a block (32x32: 64 tiles), the channels are split over a
// thread-block cluster of up to 8 blocks along gridDim.y; each block writes
// its partial band (64 x K^2 f32) to its shared memory, and after a cluster
// barrier block r adds the partials of tile rows r, r + splits, ... in rank
// order through distributed shared memory and writes dv rounded once to
// bf16, zero in the columns d >= K^2 (a warp per pixel, a lane per
// column). No float atomics: every run gives the same bits.
// bwd_src: a block owns (image, 8x8 tile of the padded frame, 128
// channels) and four warpgroups. It copies by cp.async the window's
// coefficient rows as they lie in memory (a window row's pixels are one
// run of K^2-value rows; 79 KB at R = 5) and the g window of its channels
// (zero outside the image; 86 KB), scatters the coefficients into Wt (43
// KB) as soon as they are in place, and each warpgroup runs the product
// for 32 of the channels (m64n32k16, K = the window padded to 16). The
// result leaves through shared memory in 16-byte stores. 208 KB at R = 5:
// one block per SM. Channel tails and partial tiles are zero-filled in
// staging and not stored.
//
// What bounds them: bytes (each input read once, dv or dsrc written once:
// about 0.05 ms per shift training step for each kernel on an H100). This
// first version is bound by its staging instead: every block reads its
// window, 5x the tile's own pixels at R = 5, through cp.async of 16 bytes a
// thread, well below the L2's rate; TMA tile loads are the next lever.
constexpr int kTcThreads = 256;        // bwd_v: two warpgroups
constexpr int kSrcThreads = 512;       // bwd_src: four warpgroups, 32 channels each
constexpr int kTcM = kTile * kTile;    // the tile's 64 pixels: wgmma's M
constexpr int kTcSlab = 64;            // bwd_v: channels per stage
constexpr int kTcKc = kTcSlab / 8;     // 16-byte units per pixel and slab
constexpr int kTcN = 56;               // bwd_v: window pixels per wgmma
constexpr int kTcMaxSplits = 8;        // bwd_v: blocks per cluster (portable limit)
constexpr int kSrcCh = 128;            // bwd_src: channels per block
static_assert(kTcThreads == 2 * 128 && kSrcCh == kSrcThreads / 128 * 32, "warpgroups x width");

template <int R>
struct Band {
  static constexpr int kK = 2 * R + 1;
  static constexpr int kKK = kK * kK;
  static constexpr int kWin = kTile + 2 * R;
  static constexpr int kNWin = kWin * kWin;
  // bwd_v: wgmma per warpgroup, and the window's pixels as staged
  static constexpr int kVChunks = (kNWin + 2 * kTcN - 1) / (2 * kTcN);
  static constexpr int kVPad = 2 * kTcN * kVChunks;
  static constexpr int kVStage = kTcKc * (kTcM + kVPad);  // 16-byte units
  static constexpr int kVSmem = 2 * kVStage * 16;
  // bwd_src: the window's pixels padded to wgmma's k16; a slot per window
  // row for its run of coefficient rows (up to kWin pixels x K^2 bf16), with
  // room for the 16-byte units that hold its first and last bytes
  static constexpr int kSrcPad = (kNWin + 15) / 16 * 16;
  static constexpr int kVSlot = (kWin * kKK * 2 + 30 + 15) / 16 * 16;
  static constexpr int kSrcSmem = (kSrcPad / 8 * kTcM + kSrcCh / 8 * kSrcPad) * 16 + kWin * kVSlot;
  static_assert(kTcM * kKK * 4 <= kVSmem, "bwd_v's band fits its staging");
  static_assert(kVSmem <= 227 * 1024 && kSrcSmem <= 227 * 1024, "one block's shared memory");
};

// Units [kc][n] (16 bytes each: channels ch0 + 8 kc .. + 7 of window pixel
// n) of a window of kWidth-pixel rows whose pixel n lies at (oy + n /
// kWidth, ox + n % kWidth) of an (fh, fw) frame; zeros outside the frame,
// at n >= n_valid and past channel c. kQ threads share a pixel and each
// copies every kQ-th unit of it, so that the kQ units of one instruction
// are a contiguous run of the pixel's channels and the units a warp writes
// are whole rows of shared memory; a pixel's address is computed once.
// vec: c % 8 == 0 and a 16-byte aligned tensor (cp.async, to be waited
// for); else a synchronous copy.
template <int kWidth, int kNPad, int kKcs, int kThreads>
__device__ __forceinline__ void stage_window(uint4* dst, const __nv_bfloat16* __restrict__ img,
                                             long long b, int fh, int fw, int oy, int ox,
                                             int n_valid, int c, int ch0, int vec, int tid) {
  constexpr int kQ = kKcs / 4;  // threads per pixel, 4 units each
  static_assert(kKcs % 4 == 0 && (kQ & (kQ - 1)) == 0, "a power of two of threads a pixel");
  for (int i = tid; i < kNPad * kQ; i += kThreads) {
    const int n = i / kQ;
    const int q = i - n * kQ;
    const int y = oy + n / kWidth;
    const int x = ox + n % kWidth;
    const bool pix = n < n_valid && y >= 0 && y < fh && x >= 0 && x < fw;
    const __nv_bfloat16* p = pix ? img + ((b * fh + y) * fw + x) * c + ch0 : img;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int kc = q + kQ * k;
      const bool ok = pix && ch0 + 8 * kc < c;
      uint4* u = dst + kc * kNPad + n;
      if (vec) {
        cp_async<16>(smem_u32(u), ok ? p + 8 * kc : img, ok ? 16 : 0);
      } else {
        *u = ok ? load_bf16x8(reinterpret_cast<const unsigned short*>(p + 8 * kc), c - ch0 - 8 * kc)
                : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kTcThreads, 2)
combine_bwd_v_tc_kernel(const __nv_bfloat16* __restrict__ src, const __nv_bfloat16* __restrict__ g,
                        __nv_bfloat16* __restrict__ dv, int h, int w, int c, int d_cols,
                        int vec) {
  using Bd = Band<R>;
  extern __shared__ __align__(128) uint4 tc_smem[];  // [2][g tile | window], then the band
  constexpr int kAUnits = kTcKc * kTcM;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int tiles_x = (w + kTile - 1) / kTile;
  const int ty0 = (blockIdx.x / tiles_x) * kTile;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  const int splits = gridDim.y;  // the cluster: (1, splits, 1)
  const int rank = blockIdx.y;   // the block's rank in it
  const long long b = blockIdx.z;
  const int n_slabs = (c + kTcSlab - 1) / kTcSlab;
  const int per = (n_slabs + splits - 1) / splits;
  const int s_begin = min(n_slabs, rank * per);
  const int s_end = min(n_slabs, s_begin + per);

  auto stage = [&](int s, int buf) {
    uint4* st = tc_smem + buf * Bd::kVStage;
    stage_window<kTile, kTcM, kTcKc, kTcThreads>(st, g, b, h, w, ty0, tx0, kTcM, c, s * kTcSlab,
                                                 vec, tid);
    stage_window<Bd::kWin, Bd::kVPad, kTcKc, kTcThreads>(st + kAUnits, src, b, h + 2 * R,
                                                         w + 2 * R, ty0, tx0, Bd::kNWin, c,
                                                         s * kTcSlab, vec, tid);
  };

  float d[Bd::kVChunks][kTcN / 2];
#pragma unroll
  for (int j = 0; j < Bd::kVChunks; ++j) {
#pragma unroll
    for (int i = 0; i < kTcN / 2; ++i) d[j][i] = 0.f;
  }
  const uint32_t base = smem_u32(tc_smem);
  // two slabs in flight from the start; a stage is refilled with the slab
  // two on as soon as both warpgroups are done with it
  if (s_begin < s_end) stage(s_begin, 0);
  cp_async_commit();
  if (s_begin + 1 < s_end) stage(s_begin + 1, 1);
  cp_async_commit();
  for (int s = s_begin; s < s_end; ++s) {
    const int buf = (s - s_begin) & 1;
    cp_async_wait<1>();  // slab s is in place (s + 1 may still be in flight)
    fence_proxy_async();
    __syncthreads();
    const uint32_t a_u = base + buf * Bd::kVStage * 16;
    const uint32_t b_u = a_u + (kAUnits + wg * Bd::kVChunks * kTcN) * 16;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < Bd::kVChunks; ++j) fence_acc(d[j]);
#pragma unroll
    for (int kk = 0; kk < kTcKc / 2; ++kk) {
      const uint64_t da = gmma_desc(a_u + 2 * kk * kTcM * 16, kTcM * 16, 8 * 16);
#pragma unroll
      for (int j = 0; j < Bd::kVChunks; ++j) {
        wgmma_m64n56k16<0, 0>(
            d[j], da, gmma_desc(b_u + (2 * kk * Bd::kVPad + j * kTcN) * 16, Bd::kVPad * 16, 8 * 16),
            1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < Bd::kVChunks; ++j) fence_acc(d[j]);
    __syncthreads();  // both warpgroups are done with this stage
    if (s + 2 < s_end) stage(s + 2, buf);
    cp_async_commit();
  }
  cp_async_wait_all();

  // the band of D into shared memory (over the stages): band[m][d]
  float* band = reinterpret_cast<float*>(tc_smem);
  const int warp = (tid & 127) >> 5;
  const int lane = tid & 31;
#pragma unroll
  for (int j = 0; j < Bd::kVChunks; ++j) {
#pragma unroll
    for (int jj = 0; jj < kTcN / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int py = 2 * warp + (e >> 1);
        const int px = lane >> 2;
        const int n = (wg * Bd::kVChunks + j) * kTcN + 8 * jj + 2 * (lane & 3) + (e & 1);
        const int dy = n / Bd::kWin - py;
        const int dx = n % Bd::kWin - px;
        if (n < Bd::kNWin && dy >= 0 && dy < Bd::kK && dx >= 0 && dx < Bd::kK) {
          band[(py * kTile + px) * Bd::kKK + dy * Bd::kK + dx] = d[j][4 * jj + e];
        }
      }
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's band is in place
  // warp px writes pixel px of the tile rows rank, rank + splits, ..., a
  // lane per coefficient column, the partials added in rank order
  static_assert(kTcThreads / 32 == kTile, "a warp per pixel of a tile row");
  const int px = tid >> 5;
  const float* first = splits == 1 ? band : cluster.map_shared_rank(band, 0);
  for (int py = rank; py < kTile && ty0 + py < h && tx0 + px < w; py += splits) {
    const int m = py * kTile + px;
    __nv_bfloat16* out = dv + ((b * h + ty0 + py) * w + tx0 + px) * d_cols;
    for (int dd = lane; dd < d_cols; dd += 32) {
      float sum = 0.f;
      if (dd < Bd::kKK) {
        sum = first[m * Bd::kKK + dd];
        for (int r = 1; r < splits; ++r) {
          sum = __fadd_rn(sum, cluster.map_shared_rank(band, r)[m * Bd::kKK + dd]);
        }
      }
      out[dd] = __float2bfloat16_rn(sum);
    }
  }
  cluster.sync();  // no block leaves while another still reads its band
}

template <int R>
__global__ void __launch_bounds__(kSrcThreads, 1)
combine_bwd_src_tc_kernel(const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ dsrc, int h, int w, int c, int vec) {
  using Bd = Band<R>;
  constexpr int kP = Bd::kSrcPad;
  constexpr int kWtUnits = kP / 8 * kTcM;       // [n / 8][m]: Wt[m, 8 (n / 8) .. + 7]
  constexpr int kGUnits = kSrcCh / 8 * kP;      // [8-channel column][n]
  constexpr int kVUnits = Bd::kVSlot / 16;      // per window row
  // Wt | g window | the window's coefficient rows, a slot per window row
  extern __shared__ __align__(128) uint4 tc_smem[];
  __shared__ int v_head[Bd::kWin];  // the byte of a slot where its first coefficient lies
  uint4* const wt_s = tc_smem;
  uint4* const g_s = tc_smem + kWtUnits;
  const unsigned char* const v_s = reinterpret_cast<const unsigned char*>(g_s + kGUnits);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int hp = h + 2 * R;
  const int wp = w + 2 * R;
  const int tiles_x = (wp + kTile - 1) / kTile;
  const int ty0 = (blockIdx.x / tiles_x) * kTile;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  const int oy = ty0 - 2 * R;  // the window's origin in the image
  const int ox = tx0 - 2 * R;
  const int c0 = blockIdx.y * kSrcCh;
  const long long b = blockIdx.z;
  const int x_lo = max(ox, 0);  // the window's columns inside the image
  const int x_hi = min(ox + Bd::kWin, w);

  // the coefficient rows (K^2 values a pixel) of each window row's pixels in
  // the image, one run as they lie in memory, copied by 16-byte units from
  // the unit that holds its first byte up to its last byte
  auto run = [&](int wy) {
    return reinterpret_cast<uintptr_t>(v + ((b * h + oy + wy) * w + x_lo) * Bd::kKK);
  };
  for (int i = tid; i < Bd::kWin * kVUnits; i += kSrcThreads) {
    const int wy = i / kVUnits;
    const int j = i - wy * kVUnits;
    const int y = oy + wy;
    if (y < 0 || y >= h || x_lo >= x_hi) continue;
    const uintptr_t first = run(wy);
    const uintptr_t end = first + static_cast<uintptr_t>(x_hi - x_lo) * Bd::kKK * 2;
    const uintptr_t unit = (first & ~static_cast<uintptr_t>(15)) + 16 * j;
    if (unit >= end) continue;
    cp_async<16>(smem_u32(v_s + wy * Bd::kVSlot + 16 * j), reinterpret_cast<const void*>(unit),
                 end - unit < 16 ? static_cast<int>(end - unit) : 16);
  }
  cp_async_commit();
  if (tid < Bd::kWin && oy + tid >= 0 && oy + tid < h) v_head[tid] = static_cast<int>(run(tid) & 15);
  stage_window<Bd::kWin, kP, kSrcCh / 8, kSrcThreads>(g_s, g, b, h, w, oy, ox, Bd::kNWin, c, c0,
                                                      vec, tid);
  cp_async_commit();
  for (int i = tid; i < kWtUnits; i += kSrcThreads) wt_s[i] = make_uint4(0u, 0u, 0u, 0u);
  cp_async_wait<1>();  // the coefficients are in place (g may still be in flight)
  __syncthreads();

  // Wt (zeroed above): each tile pixel m's K^2 coefficients scattered to
  // the window pixels it reads, n = m + (2R - dy, 2R - dx) (those outside
  // the image stay zero); thread = (m, every eighth offset row dy), a warp
  // 32 tile pixels of one (dy, dx)
  unsigned short* const wt_h = reinterpret_cast<unsigned short*>(wt_s);
  {
    const int m = tid % kTcM;
    const int my = m / kTile;
    const int mx = m % kTile;
    for (int dy = tid / kTcM; dy < Bd::kK; dy += kSrcThreads / kTcM) {
      const int wy = my + 2 * R - dy;
      if (oy + wy < 0 || oy + wy >= h) continue;
      const unsigned char* vrow = v_s + wy * Bd::kVSlot + v_head[wy] + dy * Bd::kK * 2;
#pragma unroll
      for (int dx = 0; dx < Bd::kK; ++dx) {
        const int wx = mx + 2 * R - dx;
        const int x = ox + wx;
        if (x < 0 || x >= w) continue;
        const int n = wy * Bd::kWin + wx;
        wt_h[((n >> 3) * kTcM + m) * 8 + (n & 7)] =
            *reinterpret_cast<const unsigned short*>(vrow + ((x - x_lo) * Bd::kKK + dx) * 2);
      }
    }
  }
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  float d[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) d[i] = 0.f;
  const uint32_t a_u = smem_u32(wt_s);
  const uint32_t b_u = smem_u32(g_s) + wg * 4 * kP * 16;  // the warpgroup's 4 columns
  wgmma_fence();
  fence_acc(d);
#pragma unroll
  for (int kk = 0; kk < kP / 16; ++kk) {
    wgmma_m64n32k16<0, 1>(d, gmma_desc(a_u + 2 * kk * kTcM * 16, kTcM * 16, 8 * 16),
                          gmma_desc(b_u + kk * 16 * 16, 8 * 16, kP * 16), 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_acc(d);

  // the tile's 64 pixels x 128 channels, rounded to bf16, through shared
  // memory (over the g window, whose readers are done) so that each pixel's
  // channels leave in 16-byte stores: out_s[pixel][channel], 16 bytes of
  // padding between pixels against bank conflicts
  constexpr int kOutPitch = kSrcCh * 2 + 16;  // bytes per pixel
  static_assert(kTcM * kOutPitch <= kGUnits * 16, "the output tile fits over the g window");
  unsigned char* const out_s = reinterpret_cast<unsigned char*>(g_s);
  __syncthreads();
  const int warp = (tid & 127) >> 5;
  const int lane = tid & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = 16 * warp + 8 * half + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ch = wg * 32 + 8 * j + 2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(out_s + m * kOutPitch + ch * 2) =
          __floats2bfloat162_rn(d[4 * j + 2 * half], d[4 * j + 2 * half + 1]);
    }
  }
  __syncthreads();
  constexpr int kUnits = kSrcCh / 8;  // 16-byte units per pixel
  const bool vec_out = vec && reinterpret_cast<uintptr_t>(dsrc) % 16 == 0;
  for (int i = tid; i < kTcM * kUnits; i += kSrcThreads) {
    const int m = i / kUnits;
    const int u = i % kUnits;
    const int y = ty0 + m / kTile;
    const int x = tx0 + m % kTile;
    const int ch = c0 + 8 * u;
    if (y >= hp || x >= wp || ch >= c) continue;
    const unsigned char* from = out_s + m * kOutPitch + u * 16;
    __nv_bfloat16* to = dsrc + ((b * hp + y) * wp + x) * c + ch;
    if (vec_out) {
      *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(from);
    } else {
      for (int e = 0; e < 8 && ch + e < c; ++e) {
        to[e] = reinterpret_cast<const __nv_bfloat16*>(from)[e];
      }
    }
  }
}

// whole 16-byte units of a tensor's channels: cp.async staging
bool vec_ok(int c, const void* p) {
  return c % 8 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int R>
cudaError_t launch_bwd_v_tc(const void* src, const void* g, void* dv, int b, int h, int w, int c,
                            int d_cols, int splits, cudaStream_t stream) {
  constexpr int smem = Band<R>::kVSmem;
  HOIG_TRY(cudaFuncSetAttribute(combine_bwd_v_tc_kernel<R>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((h + kTile - 1) / kTile) * ((w + kTile - 1) / kTile), splits, b);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  HOIG_TRY(cudaLaunchKernelEx(&cfg, combine_bwd_v_tc_kernel<R>,
                              static_cast<const __nv_bfloat16*>(src),
                              static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(dv),
                              h, w, c, d_cols, static_cast<int>(vec_ok(c, src) && vec_ok(c, g))));
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_bwd_src_tc(const void* g, const void* v, void* dsrc, int b, int h, int w, int c,
                              cudaStream_t stream) {
  constexpr int smem = Band<R>::kSrcSmem;
  HOIG_TRY(cudaFuncSetAttribute(combine_bwd_src_tc_kernel<R>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  const dim3 grid(((h + 2 * R + kTile - 1) / kTile) * ((w + 2 * R + kTile - 1) / kTile),
                  (c + kSrcCh - 1) / kSrcCh, b);
  combine_bwd_src_tc_kernel<R><<<grid, kSrcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(dsrc), h, w, c, static_cast<int>(vec_ok(c, g)));
  return cudaGetLastError();
}

// the tensor-core kernels are instantiated for R = 1 .. 5
constexpr int kTcMaxRadius = 5;

bool bad_tc_dims(int b, int h, int w, int c, int d_cols, int radius) {
  const int k = 2 * radius + 1;
  return b < 1 || b > 65535 || h < 1 || w < 1 || c < 2 || c % 2 != 0 || radius < 1 ||
         radius > kTcMaxRadius || d_cols < k * k;
}

}  // namespace

extern "C" int hoig_local_combine_fwd(const void* src, const void* v, void* out, int b, int h,
                                      int w, int c, int d_cols, int radius, int is_bf16,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(src, v, out, b, h, w, c, d_cols, radius, s);
  return launch<float>(src, v, out, b, h, w, c, d_cols, radius, s);
}

// f32 only: bf16 inputs take hoig_local_combine_bwd_src_tc
extern "C" int hoig_local_combine_bwd_src(const void* g, const void* v, void* dsrc, int b, int h,
                                          int w, int c, int d_cols, int radius, int is_bf16,
                                          void* stream) {
  if (is_bf16) return cudaErrorInvalidValue;
  return launch_bwd_src<float>(g, v, dsrc, b, h, w, c, d_cols, radius,
                               static_cast<cudaStream_t>(stream));
}

// f32 only: bf16 inputs take hoig_local_combine_bwd_v_tc
extern "C" int hoig_local_combine_bwd_v(const void* src, const void* g, void* dv, int b, int h,
                                        int w, int c, int d_cols, int radius, int is_bf16,
                                        void* stream) {
  if (is_bf16) return cudaErrorInvalidValue;
  return launch_bwd_v<float>(src, g, dv, b, h, w, c, d_cols, radius,
                             static_cast<cudaStream_t>(stream));
}

// bf16 only: dsrc (B, H+2R, W+2R, C) on the tensor cores, R in 1..5; v
// holds exactly K^2 coefficient columns (d_cols == K^2)
extern "C" int hoig_local_combine_bwd_src_tc(const void* g, const void* v, void* dsrc, int b,
                                             int h, int w, int c, int d_cols, int radius,
                                             void* stream) {
  if (bad_tc_dims(b, h, w, c, d_cols, radius) || d_cols != (2 * radius + 1) * (2 * radius + 1) ||
      (c + kSrcCh - 1) / kSrcCh > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 1: return launch_bwd_src_tc<1>(g, v, dsrc, b, h, w, c, s);
    case 2: return launch_bwd_src_tc<2>(g, v, dsrc, b, h, w, c, s);
    case 3: return launch_bwd_src_tc<3>(g, v, dsrc, b, h, w, c, s);
    case 4: return launch_bwd_src_tc<4>(g, v, dsrc, b, h, w, c, s);
    default: return launch_bwd_src_tc<5>(g, v, dsrc, b, h, w, c, s);
  }
}

// bf16 only: dv (B, H, W, d_cols) on the tensor cores, R in 1..5, the
// channels split over a cluster of `splits` blocks (1..8)
extern "C" int hoig_local_combine_bwd_v_tc(const void* src, const void* g, void* dv, int b, int h,
                                           int w, int c, int d_cols, int radius, int splits,
                                           void* stream) {
  if (bad_tc_dims(b, h, w, c, d_cols, radius) || splits < 1 || splits > kTcMaxSplits) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 1: return launch_bwd_v_tc<1>(src, g, dv, b, h, w, c, d_cols, splits, s);
    case 2: return launch_bwd_v_tc<2>(src, g, dv, b, h, w, c, d_cols, splits, s);
    case 3: return launch_bwd_v_tc<3>(src, g, dv, b, h, w, c, d_cols, splits, s);
    case 4: return launch_bwd_v_tc<4>(src, g, dv, b, h, w, c, d_cols, splits, s);
    default: return launch_bwd_v_tc<5>(src, g, dv, b, h, w, c, d_cols, splits, s);
  }
}

// The tile constants that hoig_torch/ops/local_combine.py repeats (TILING)
// to pick bwd_v's channel splits, in TILING's order: the tile edge,
// bwd_v's channels per stage and its largest cluster, bwd_src's channels
// per block, and the largest radius of the tensor-core kernels. Writes at
// most n of them to out and returns how many there are.
extern "C" int hoig_local_combine_tiling(int* out, int n) {
  const int v[] = {kTile, kTcSlab, kTcMaxSplits, kSrcCh, kTcMaxRadius};
  constexpr int kCount = sizeof(v) / sizeof(v[0]);
  for (int i = 0; i < n && i < kCount; ++i) out[i] = v[i];
  return kCount;
}

extern "C" const char* hoig_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
