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
#include <cuda_runtime.h>

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

}  // namespace

extern "C" int hoig_gather_rows(const void* table, const void* idx, void* out, int b, int r,
                                int a, int p, void* stream) {
  const dim3 grid((p + kThreads - 1) / kThreads, b);
  gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(idx), static_cast<float*>(out),
      r, a, p);
  return cudaGetLastError();
}

extern "C" const char* hoig_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
