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
// here a block owns an 8x8 tile of pixels and works on 64 channels at a
// time, staging only the tile's (8 + 2R)^2 x 64 window.
//
//   * forward: stages the source window and the tile's 64 x K^2 coefficient
//     rows; warp = tile row, lane = channel pair.
//   * bwd_src: a gather, no atomics. The tiles cover the PADDED frame; the
//     block stages the window of g that reaches its tile (zero outside the
//     image) and, one offset row dy at a time, column d of the coefficient
//     rows of the pixels it reads (each output pixel needs column d of a
//     different pixel). The Pallas body read-modify-wrote shifted slices of
//     the output in the output's dtype; here the sum is kept in f32 and
//     rounded once (a numerical improvement under bf16).
//   * bwd_v: per-pixel channel dots. A thread owns one pixel and every
//     fourth offset d, keeps its <= 31 sums in registers and walks the
//     channels in ascending order, 64-channel chunk after chunk, so the sum
//     order is fixed and runs repeat bit for bit (no atomics, no shuffles).
//     Staged pixels are 66 elements apart to spread the banks.
//
// What bounds them on an H100: at the attention's shapes (R = 3 over 128
// channels, R = 5 over 128..512 channels) every element takes K^2
// multiply-adds against a few bytes moved, so all three are bound by
// CUDA-core arithmetic, not by HBM: 2 * K^2 FLOP per output element of
// forward and bwd_src, 2 * C FLOP per element of dv. The designs keep every
// operand read after staging in shared memory (a coefficient is one
// broadcast read per warp, a source pair one 4- or 8-byte read per lane).
//
// Numerics: forward and bwd_src accumulate in f32 in ascending d, each term
// rounded as a product and then added (no fused multiply-add; this file is
// built with -fmad=false). That is the exact order and rounding of the plain
// PyTorch versions, so they agree bit for bit in f32 and bf16. bwd_v sums
// over channels with explicit fused multiply-adds in f32; its order differs
// from a library reduction, so it is held to a tolerance.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
__device__ __forceinline__ void store_one(__nv_bfloat16* dst, float a) {
  *dst = __float2bfloat16_rn(a);
}

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

}  // namespace

extern "C" int hoig_local_combine_fwd(const void* src, const void* v, void* out, int b, int h,
                                      int w, int c, int d_cols, int radius, int is_bf16,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(src, v, out, b, h, w, c, d_cols, radius, s);
  return launch<float>(src, v, out, b, h, w, c, d_cols, radius, s);
}

extern "C" int hoig_local_combine_bwd_src(const void* g, const void* v, void* dsrc, int b, int h,
                                          int w, int c, int d_cols, int radius, int is_bf16,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_bwd_src<__nv_bfloat16>(g, v, dsrc, b, h, w, c, d_cols, radius, s);
  return launch_bwd_src<float>(g, v, dsrc, b, h, w, c, d_cols, radius, s);
}

extern "C" int hoig_local_combine_bwd_v(const void* src, const void* g, void* dv, int b, int h,
                                        int w, int c, int d_cols, int radius, int is_bf16,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_bwd_v<__nv_bfloat16>(src, g, dv, b, h, w, c, d_cols, radius, s);
  return launch_bwd_v<float>(src, g, dv, b, h, w, c, d_cols, radius, s);
}

extern "C" const char* hoig_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
