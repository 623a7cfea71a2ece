// Weighted combination of bounded shifts (forward), for sm_90a.
//
//   out[b, y, x, c] = sum_d v[b, y, x, d] * src_pad[b, y + d / K, x + d % K, c]
//
// with K = 2R + 1, d over the K*K row-major offsets, src_pad the source
// padded by R on each spatial side, all tensors NHWC and contiguous.
//
// Replaces: hoig_tpu/ops/local_combine.py:_fwd_kernel (Pallas, TPU), which
// kept one batch element's whole padded frame in VMEM. Shared memory on
// Hopper holds at most 227 KB per block, so here a block owns an 8x8 tile of
// output pixels and a 64-channel chunk, and stages only the tile's
// (8 + 2R)^2 x 64 source window and its 64 x K^2 coefficient rows.
//
// What bounds it on an H100: at the attention's shapes (R = 3 over 128
// channels, R = 5 over 128..512 channels) every output element takes K^2
// multiply-adds against 2 (bf16) or 4 (f32) bytes written, so the kernel is
// bound by CUDA-core arithmetic, not by HBM: 2 * K^2 FLOP per output element
// against ~3 bytes per element moved. The design keeps every operand read
// after staging in shared memory (a coefficient is one broadcast read per
// warp, a source pair one conflict-free 4- or 8-byte read per lane) so the
// FP32 pipes, not memory, set the pace.
//
// Numerics: f32 accumulation in ascending d, each term rounded as a product
// and then added (no fused multiply-add; this file is built with
// -fmad=false). That is the exact order and rounding of the plain PyTorch
// version, so the two agree bit for bit in f32 and bf16.
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

}  // namespace

extern "C" int hoig_local_combine_fwd(const void* src, const void* v, void* out, int b, int h,
                                      int w, int c, int d_cols, int radius, int is_bf16,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(src, v, out, b, h, w, c, d_cols, radius, s);
  return launch<float>(src, v, out, b, h, w, c, d_cols, radius, s);
}

extern "C" const char* hoig_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
