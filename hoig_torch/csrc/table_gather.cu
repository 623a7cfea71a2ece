// Exact row gather from small per-sample tables, channel-first output, for sm_90a.
//
//   out[b, a, p] = table[b, idx[b, p], a]      table (B, R, A) f32, idx (B, P) int32
//
// Replaces: hoig_tpu/ops/table_gather.py:_gather_kernel (Pallas, TPU). On the
// TPU a row gather was issue-rate-bound, so the kernel did it as a one-hot
// matmul on the MXU with a three-way bf16 split of the table to stay exact.
// Hopper gathers natively: the table (at most a few thousand rows of up to
// 25 floats, a few hundred KB) stays resident in L1/L2, so a plain load of the
// row is exact and only the contract - bit-identical values, channel-first
// layout - carries over.
//
// What bounds it on an H100: HBM bytes. Each output element is written once
// (4 bytes) and each index read once; the table reads hit cache. One thread
// per pixel p walks the row's A columns, so for every column the threads of a
// warp write 32 consecutive floats of out[b, a, :] and the stores coalesce.
// Indices outside [0, R) are clamped into range so that a bad index cannot
// read out of bounds.
//
// scatter_rows, the fixed-order transpose of a row gather (no TPU kernel:
// the backward of the JAX package's jnp.take_along_axis, which XLA
// transposes itself, hoig_tpu/models/generator.py:326, and of every other
// row gather that carries a gradient):
//
//   out[r, :] = sum over j in [starts[r], starts[r+1]) of val[perm[j], :]
//
// perm lists the entries by destination row and, within a row, in
// ascending entry order (the wrapper's stable sort of the destination
// keys); starts are the rows' segment offsets. Each row's sum is taken in
// f32, in that order, starting from 0, and rounded once to T (f32 or bf16):
// no atomic ever adds a value, so the result does not change from run to
// run, and the plain version's masked loop over segment positions
// (hoig_torch/ops/table_gather.py scatter_rows_reference) gives the same
// bits. Design: a group of `lanes` threads (a power of two up to a warp)
// per destination row walks the row's segment; each thread owns VEC
// consecutive channels (16-byte loads where C and the pointers allow) and,
// past lanes * VEC channels, walks the segment again for the next ones.
// What bounds it: HBM bytes, each entry's row read once and each output row
// written once; the reads follow the permutation, so each is a whole row
// (C * sizeof(T) bytes) at a data-dependent address.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ table, const int* __restrict__ idx,
              float* __restrict__ out, int r, int a, int p) {
  const long long b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p) return;
  const int row = min(max(idx[b * p + i], 0), r - 1);
  const float* src = table + (b * r + row) * a;
  float* dst = out + b * a * p + i;
  for (int j = 0; j < a; ++j) dst[(long long)j * p] = __ldg(src + j);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC consecutive elements of T, loaded and stored as one unit
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const T* __restrict__ val, const long long* __restrict__ perm,
                    const long long* __restrict__ starts, T* __restrict__ out, long long rows,
                    int c, int lanes) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long row = t / lanes;
  if (row >= rows) return;
  const int sub = (int)(t % lanes);
  const long long s0 = starts[row];
  const long long s1 = starts[row + 1];
  for (int c0 = sub * VEC; c0 < c; c0 += lanes * VEC) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (long long j = s0; j < s1; ++j) {
      const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(val + perm[j] * c + c0);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = __fadd_rn(acc[i], to_f32(p.v[i]));
    }
    Pack<T, VEC> o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) o.v[i] = from_f32<T>(acc[i]);
    *reinterpret_cast<Pack<T, VEC>*>(out + row * c + c0) = o;
  }
}

template <typename T, int VEC>
cudaError_t launch_scatter(const void* val, const void* perm, const void* starts, void* out,
                           long long rows, int c, cudaStream_t s) {
  // the fewest lanes (a power of two, at most a warp) that cover the row's
  // channels in one pass
  int lanes = 1;
  while (lanes < 32 && lanes * VEC < c) lanes *= 2;
  const long long blocks = (rows * lanes + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  scatter_rows_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(val), static_cast<const long long*>(perm),
      static_cast<const long long*>(starts), static_cast<T*>(out), rows, c, lanes);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" int hoig_gather_rows(const void* table, const void* idx, void* out, int b, int r,
                                int a, int p, void* stream) {
  const dim3 grid((p + kThreads - 1) / kThreads, b);
  gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(idx), static_cast<float*>(out),
      r, a, p);
  return cudaGetLastError();
}

// scatter_rows: val (E_total, C) entries, perm (E_total,) and starts (rows + 1,)
// int64, out (rows, C); val and out both f32 or both bf16 (is_bf16).
extern "C" int hoig_scatter_rows(const void* val, const void* perm, const void* starts, void* out,
                                 long long rows, int c, int is_bf16, void* stream) {
  if (rows < 0 || c < 1) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = aligned16(val) && aligned16(out);
  if (is_bf16) {
    if (wide && c % 8 == 0) {
      return launch_scatter<__nv_bfloat16, 8>(val, perm, starts, out, rows, c, s);
    }
    return launch_scatter<__nv_bfloat16, 1>(val, perm, starts, out, rows, c, s);
  }
  if (wide && c % 4 == 0) return launch_scatter<float, 4>(val, perm, starts, out, rows, c, s);
  return launch_scatter<float, 1>(val, perm, starts, out, rows, c, s);
}

extern "C" const char* hoig_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
