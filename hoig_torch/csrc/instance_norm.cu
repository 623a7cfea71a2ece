// InstanceNorm for sm_90a: statistics, apply and the whole backward.
//
//   mean, rstd = mean and (var + eps)^-1/2 of x[b, c] over its H x W pixels (f32)
//   a = rstd * weight,  o = bias - mean * a    (weight and bias absent: a = rstd, o = -mean rstd)
//   y = x a + o                                (f32, rounded once to T)
//
//   backward, with g = dy:  s1 = sum g,  s2 = sum g (x - mean)  over the pixels
//   dweight = sum_b s2 rstd,  dbias = sum_b s1
//   k1 = s2 weight rstd^3 (-1/n),  k0 = -(k1 mean + s1 weight rstd / n)
//   dx = g a + (x k1 + k0)                     (f32, rounded once to T)
//
// Replaces no Pallas kernel: the JAX package leaves InstanceNorm to XLA's
// fusion (hoig_tpu/models/layers.py). On the card the port ran it as a
// dozen aten passes a call (var_mean over an f32 copy, broadcast mul and
// add, their reductions and the statistics' backward), most of them on
// aten's non-vectorized broadcast path.
//
// What bounds it on an H100: HBM bytes. Every kernel does a few f32
// operations per element, far below the card's operations-per-byte line:
// the statistics read x once, the apply reads x and writes y, the
// backward's sums read x and dy, its dx pass reads both again and writes
// dx. So each pass moves 16 bytes a thread (a vector of VEC = 16 /
// sizeof(T) values) with neighbouring threads on neighbouring addresses,
// and keeps its per-channel numbers (a, o, the mean, k1, k0) in registers.
//
// Layouts: channels_last, where a sample is an (H W) x C matrix with
// channels contiguous (the port's activations), and contiguous NCHW, where
// it is C rows of H W pixels. A block owns one sample, one group of
// channels and one chunk of pixels: channels_last, kLanes threads across
// kLanes * VEC channels and kRows pixel rows; NCHW, a warp a channel, its
// lanes across the chunk. The chunk (pixels a block covers) comes from the
// wrapper (hoig_torch/ops/instance_norm.py `plan`), from the shape alone.
//
// Fixed order, no atomics: every run gives the same bits. Each thread walks
// its pixels in ascending order; a block combines its threads' states in
// thread order and writes one partial per (sample, chunk, channel); the
// next kernel takes the chunks' partials in chunk order: the apply kernel's
// first threads combine the statistics' partials of their block's channels
// (each block of a sample redoes this small sum, in the same order, so all
// agree; chunk 0's block writes a, o, mean and rstd), inorm_bwd_coef_kernel
// adds the sums' partials and the samples' weight and bias gradients in
// order.
//
// Numerics. The statistics are taken in f64 and rounded once to f32: a
// thread sums its values' differences from its first value and their
// squares (a shift that keeps the spread of activations whose mean is large
// against it), and threads and chunks combine by the parallel form of the
// variance (mean = sum n_i m_i / N, M2 = sum M2_i + n_i (m_i - mean)^2),
// never by a sum of squares. So a, b, mean and rstd are the correctly
// rounded values up to f64 rounding: a few f32 ulps of difference in them
// moved an ill-conditioned gradient of the f32 generator (chip_smoke.py
// phase 4) by a tenth of its leaf's largest entry. The backward's sums are
// f32 adds. Built with -fmad=false: each f32 product and sum rounds as the
// plain versions' f32 ops do.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;                 // channels_last: threads across a pixel's channels
constexpr int kRows = kThreads / kLanes;  // channels_last: pixels a block reads at once
constexpr int kWarps = kThreads / 32;     // NCHW: channels a block covers, a warp each
constexpr int kCoefChannels = 32;         // inorm_bwd_coef_kernel: channels a block, a lane each

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

// channels a block covers
template <int VEC, bool CL>
__host__ __device__ constexpr int group_width() {
  return CL ? kLanes * VEC : kWarps;
}

// Calls f(offset) for each vector of VEC elements that this thread owns in
// block (chunk, channel group, sample), in ascending pixel order; offset is
// the vector's first element from the tensor's start.
template <int VEC, bool CL, typename F>
__device__ __forceinline__ void walk(int n, int c, int chunk, F&& f) {
  const long long bi = blockIdx.z;
  const int p0 = blockIdx.x * chunk;
  const int p1 = min(n, p0 + chunk);
  if constexpr (CL) {
    const int c0 = (blockIdx.y * kLanes + threadIdx.x % kLanes) * VEC;
    if (c0 >= c) return;
#pragma unroll 4
    for (int p = p0 + threadIdx.x / kLanes; p < p1; p += kRows) f((bi * n + p) * c + c0);
  } else {
    const int ch = blockIdx.y * kWarps + threadIdx.x / 32;
    if (ch >= c) return;
#pragma unroll 4
    for (int p = p0 + (threadIdx.x % 32) * VEC; p < p1; p += 32 * VEC) f((bi * c + ch) * n + p);
  }
}

// The channel (from 0) of element i of this thread's vectors within the
// block's group, or -1 past the last channel.
template <int VEC, bool CL>
__device__ __forceinline__ int slot_channel(int c, int i) {
  const int local = CL ? (threadIdx.x % kLanes) * VEC + i : threadIdx.x / 32;
  return blockIdx.y * group_width<VEC, CL>() + local < c ? local : -1;
}

// A block's per-thread states (s[t * VEC + i], thread t, element i) that
// belong to its channel `local`, in thread order: the k-th of states_per().
template <int VEC, bool CL>
__device__ __forceinline__ int state_index(int local, int k) {
  if constexpr (CL) return (k * kLanes + local / VEC) * VEC + local % VEC;
  return (local * 32 + k / VEC) * VEC + k % VEC;
}
template <int VEC, bool CL>
__device__ __forceinline__ constexpr int states_per() {
  return kThreads * VEC / group_width<VEC, CL>();
}

// Pixels in chunk j.
__device__ __forceinline__ double chunk_pixels(int n, int chunk, int j) {
  return static_cast<double>(min(chunk, n - j * chunk));
}

// Statistics, pass 1: per (sample, chunk, channel) the mean and second
// moment of the chunk's pixels, in f64, into part's two planes (B, Q, C).
// Each thread sums its values' differences from the first one it read, and
// their squares, in f64; the block combines its threads' (count, mean, M2)
// in thread order.
template <typename T, int VEC, bool CL>
__global__ void __launch_bounds__(kThreads)
inorm_stats_kernel(const T* __restrict__ x, double* __restrict__ part, int b, int n, int c,
                   int chunk) {
  using P = Pack<T, VEC>;
  __shared__ double s_mean[kThreads * VEC], s_m2[kThreads * VEC];
  __shared__ double s_n[kThreads];
  double shift[VEC], s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) shift[i] = s1[i] = s2[i] = 0.0;
  int cnt = 0;
  walk<VEC, CL>(n, c, chunk, [&](long long at) {
    const P v = *reinterpret_cast<const P*>(x + at);
    if (cnt == 0) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) shift[i] = to_f32(v.v[i]);
    }
    ++cnt;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const double d = static_cast<double>(to_f32(v.v[i])) - shift[i];
      s1[i] = s1[i] + d;
      s2[i] = __fma_rn(d, d, s2[i]);
    }
  });
  const double nt = static_cast<double>(cnt);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    s_mean[threadIdx.x * VEC + i] = cnt == 0 ? 0.0 : shift[i] + s1[i] / nt;
    s_m2[threadIdx.x * VEC + i] = cnt == 0 ? 0.0 : s2[i] - s1[i] * s1[i] / nt;
  }
  s_n[threadIdx.x] = nt;
  __syncthreads();
  constexpr int kGroup = group_width<VEC, CL>();
  const int ch = blockIdx.y * kGroup + threadIdx.x;
  if (threadIdx.x >= kGroup || ch >= c) return;
  double tot = 0.0, sum = 0.0;
  for (int k = 0; k < states_per<VEC, CL>(); ++k) {
    const int st = state_index<VEC, CL>(threadIdx.x, k);
    tot = tot + s_n[st / VEC];
    sum = sum + s_n[st / VEC] * s_mean[st];
  }
  const double bm = sum / tot;
  double bm2 = 0.0;
  for (int k = 0; k < states_per<VEC, CL>(); ++k) {
    const int st = state_index<VEC, CL>(threadIdx.x, k);
    const double d = s_mean[st] - bm;
    bm2 = bm2 + (s_m2[st] + s_n[st / VEC] * d * d);
  }
  const long long at = ((long long)blockIdx.z * gridDim.x + blockIdx.x) * c + ch;
  part[at] = bm;
  part[(long long)b * gridDim.x * c + at] = bm2;
}

// Apply: y = x a + o. With part (the statistics' partials), the block's
// first threads combine them into a, o (and chunk 0's block writes a, o,
// mean and rstd, each (B, C)); without, a and o are read (a recompute's
// kept pair).
template <typename T, int VEC, bool CL>
__global__ void __launch_bounds__(kThreads)
inorm_apply_kernel(const T* __restrict__ x, T* __restrict__ y, const double* __restrict__ part,
                   const float* __restrict__ weight, const float* __restrict__ bias, float eps,
                   float* __restrict__ a_io, float* __restrict__ o_io, float* __restrict__ mean_out,
                   float* __restrict__ rstd_out, int b, int n, int c, int chunk) {
  using P = Pack<T, VEC>;
  constexpr int kGroup = group_width<VEC, CL>();
  __shared__ float s_a[kGroup], s_o[kGroup];
  const int ch = blockIdx.y * kGroup + threadIdx.x;
  if (threadIdx.x < kGroup && ch < c) {
    const long long at = (long long)blockIdx.z * c + ch;
    float a, o;
    if (part == nullptr) {
      a = a_io[at];
      o = o_io[at];
    } else {
      // the chunks in order, in f64; a, o, mean and rstd rounded once to f32
      const int q = gridDim.x;
      const double* pm = part + (long long)blockIdx.z * q * c + ch;
      const double* pm2 = pm + (long long)b * q * c;
      double sum = 0.0;
      for (int j = 0; j < q; ++j) sum = sum + chunk_pixels(n, chunk, j) * pm[(long long)j * c];
      const double mean = sum / static_cast<double>(n);
      double m2 = 0.0;
      for (int j = 0; j < q; ++j) {
        const double d = pm[(long long)j * c] - mean;
        m2 = m2 + (pm2[(long long)j * c] + chunk_pixels(n, chunk, j) * d * d);
      }
      const double rstd = 1.0 / sqrt(m2 / static_cast<double>(n) + static_cast<double>(eps));
      double ad = rstd, od = -mean * rstd;
      if (weight != nullptr) {
        ad = ad * weight[ch];
        od = od * weight[ch] + bias[ch];
      }
      a = static_cast<float>(ad);
      o = static_cast<float>(od);
      if (blockIdx.x == 0) {
        a_io[at] = a;
        o_io[at] = o;
        mean_out[at] = static_cast<float>(mean);
        rstd_out[at] = static_cast<float>(rstd);
      }
    }
    s_a[threadIdx.x] = a;
    s_o[threadIdx.x] = o;
  }
  __syncthreads();
  float a[VEC], o[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int local = slot_channel<VEC, CL>(c, i);
    a[i] = local < 0 ? 0.f : s_a[local];
    o[i] = local < 0 ? 0.f : s_o[local];
  }
  walk<VEC, CL>(n, c, chunk, [&](long long at) {
    const P v = *reinterpret_cast<const P*>(x + at);
    P out;
#pragma unroll
    for (int i = 0; i < VEC; ++i) out.v[i] = from_f32<T>(to_f32(v.v[i]) * a[i] + o[i]);
    *reinterpret_cast<P*>(y + at) = out;
  });
}

// This thread's per-element numbers from a (B, C) plane.
template <int VEC, bool CL>
__device__ __forceinline__ void channel_values(const float* plane, int c, float (&out)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int local = slot_channel<VEC, CL>(c, i);
    out[i] = local < 0 ? 0.f
                       : plane[(long long)blockIdx.z * c + blockIdx.y * group_width<VEC, CL>() +
                               local];
  }
}

// Backward, pass 1: per (sample, chunk, channel) the sums of g and of
// g (x - mean), into part's two planes (B, Q, C).
template <typename T, int VEC, bool CL>
__global__ void __launch_bounds__(kThreads)
inorm_bwd_sums_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ mean_in, float* __restrict__ part, int b, int n,
                      int c, int chunk) {
  using P = Pack<T, VEC>;
  __shared__ float s_1[kThreads * VEC], s_2[kThreads * VEC];
  float mean[VEC], s1[VEC], s2[VEC];
  channel_values<VEC, CL>(mean_in, c, mean);
#pragma unroll
  for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.f;
  walk<VEC, CL>(n, c, chunk, [&](long long at) {
    const P xv = *reinterpret_cast<const P*>(x + at);
    const P gv = *reinterpret_cast<const P*>(dy + at);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float g = to_f32(gv.v[i]);
      s1[i] = s1[i] + g;
      s2[i] = s2[i] + g * (to_f32(xv.v[i]) - mean[i]);
    }
  });
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    s_1[threadIdx.x * VEC + i] = s1[i];
    s_2[threadIdx.x * VEC + i] = s2[i];
  }
  __syncthreads();
  constexpr int kGroup = group_width<VEC, CL>();
  const int ch = blockIdx.y * kGroup + threadIdx.x;
  if (threadIdx.x >= kGroup || ch >= c) return;
  float t1 = 0.f, t2 = 0.f;
  for (int k = 0; k < states_per<VEC, CL>(); ++k) {
    const int s = state_index<VEC, CL>(threadIdx.x, k);
    t1 = t1 + s_1[s];
    t2 = t2 + s_2[s];
  }
  const long long at = ((long long)blockIdx.z * gridDim.x + blockIdx.x) * c + ch;
  part[at] = t1;
  part[(long long)b * gridDim.x * c + at] = t2;
}

// Backward, the coefficients: a lane per channel, the warps over the
// samples (warp w takes w, w + kWarps, ...); each (sample, channel) adds
// its q chunks' sums in order and writes k1, k0 to k's planes (B, C); with
// a weight, the samples' dweight and dbias terms are added per warp in
// sample order, then over the warps in order.
__global__ void __launch_bounds__(kThreads)
inorm_bwd_coef_kernel(const float* __restrict__ part, const float* __restrict__ mean_in,
                      const float* __restrict__ rstd_in, const float* __restrict__ weight,
                      float* __restrict__ k, float* __restrict__ gw, float* __restrict__ gb, int b,
                      int n, int c, int q) {
  __shared__ float s_w[kWarps][kCoefChannels], s_b[kWarps][kCoefChannels];
  const int lane = threadIdx.x % kCoefChannels;
  const int warp = threadIdx.x / kCoefChannels;
  const int ch = blockIdx.x * kCoefChannels + lane;
  const long long plane = (long long)b * c;
  const float* p2 = part + (long long)b * q * c;
  float acc_w = 0.f, acc_b = 0.f;
  if (ch < c) {
    const float wt = weight == nullptr ? 1.f : weight[ch];
    for (int bi = warp; bi < b; bi += kWarps) {
      float s1 = 0.f, s2 = 0.f;
      for (int j = 0; j < q; ++j) {
        const long long at = ((long long)bi * q + j) * c + ch;
        s1 = s1 + part[at];
        s2 = s2 + p2[at];
      }
      const long long at = (long long)bi * c + ch;
      const float mean = mean_in[at];
      const float rstd = rstd_in[at];
      if (weight != nullptr) {
        acc_w = acc_w + s2 * rstd;
        acc_b = acc_b + s1;
        s2 = s2 * wt;
        s1 = s1 * wt;
      }
      const float k1 = s2 * (rstd * rstd * rstd * (-1.f / static_cast<float>(n)));
      k[at] = k1;
      k[plane + at] = -(k1 * mean + s1 * rstd * (1.f / static_cast<float>(n)));
    }
  }
  if (weight == nullptr) return;
  s_w[warp][lane] = acc_w;
  s_b[warp][lane] = acc_b;
  __syncthreads();
  if (warp != 0 || ch >= c) return;
  float tw = 0.f, tb = 0.f;
  for (int w = 0; w < kWarps; ++w) {
    tw = tw + s_w[w][lane];
    tb = tb + s_b[w][lane];
  }
  gw[ch] = tw;
  gb[ch] = tb;
}

// Backward, pass 2: dx = g a + (x k1 + k0).
template <typename T, int VEC, bool CL>
__global__ void __launch_bounds__(kThreads)
inorm_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    const float* __restrict__ a_plane, const float* __restrict__ k,
                    T* __restrict__ dx, int b, int n, int c, int chunk) {
  using P = Pack<T, VEC>;
  float a[VEC], k1[VEC], k0[VEC];
  channel_values<VEC, CL>(a_plane, c, a);
  channel_values<VEC, CL>(k, c, k1);
  channel_values<VEC, CL>(k + (long long)b * c, c, k0);
  walk<VEC, CL>(n, c, chunk, [&](long long at) {
    const P xv = *reinterpret_cast<const P*>(x + at);
    const P gv = *reinterpret_cast<const P*>(dy + at);
    P out;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      out.v[i] = from_f32<T>(to_f32(gv.v[i]) * a[i] + (to_f32(xv.v[i]) * k1[i] + k0[i]));
    }
    *reinterpret_cast<P*>(dx + at) = out;
  });
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

// A launch over (sample, channel group, chunk) of one of the four pixel
// kernels: the shape, the layout, and which of VEC = 16 / sizeof(T) or 1
// the data allows.
struct Shape {
  int b, n, c, chunk;
  bool cl;
  cudaStream_t stream;

  int chunks() const { return (n + chunk - 1) / chunk; }
  template <int VEC, bool CL>
  dim3 grid() const {
    return dim3(chunks(), (c + group_width<VEC, CL>() - 1) / group_width<VEC, CL>(), b);
  }
  // 16-byte vectors: every pointer aligned, and no vector across a channel
  // group's end (channels_last) or a chunk's (NCHW)
  template <typename T>
  bool wide(const void* p0, const void* p1, const void* p2) const {
    constexpr int kVec = 16 / sizeof(T);
    const bool fits = cl ? c % kVec == 0 : n % kVec == 0 && chunk % kVec == 0;
    return fits && aligned16(p0) && aligned16(p1) && aligned16(p2);
  }
};

bool valid(const Shape& s) {
  // pixel counts stay exact in f32; the grid's y and z stay within 65535
  return s.b >= 1 && s.n >= 1 && s.c >= 1 && s.chunk >= 1 && s.n <= (1 << 24) &&
         s.b <= 65535 && (s.c + kWarps - 1) / kWarps <= 65535;
}

// Calls f.template run<T, VEC, CL>() for the dtype, the layout and the width.
template <typename F>
cudaError_t dispatch(const Shape& s, bool is_bf16, const void* p0, const void* p1,
                     const void* p2, const F& f) {
  if (is_bf16) {
    using T = __nv_bfloat16;
    if (s.wide<T>(p0, p1, p2)) {
      return s.cl ? f.template run<T, 8, true>(s) : f.template run<T, 8, false>(s);
    }
    return s.cl ? f.template run<T, 1, true>(s) : f.template run<T, 1, false>(s);
  }
  if (s.wide<float>(p0, p1, p2)) {
    return s.cl ? f.template run<float, 4, true>(s) : f.template run<float, 4, false>(s);
  }
  return s.cl ? f.template run<float, 1, true>(s) : f.template run<float, 1, false>(s);
}

struct Stats {
  const void* x;
  double* part;
  template <typename T, int VEC, bool CL>
  cudaError_t run(const Shape& s) const {
    inorm_stats_kernel<T, VEC, CL><<<s.grid<VEC, CL>(), kThreads, 0, s.stream>>>(
        static_cast<const T*>(x), part, s.b, s.n, s.c, s.chunk);
    return cudaGetLastError();
  }
};

struct Apply {
  const void* x;
  void* y;
  const double* part;
  const float *weight, *bias;
  float eps;
  float *a, *o, *mean, *rstd;
  template <typename T, int VEC, bool CL>
  cudaError_t run(const Shape& s) const {
    inorm_apply_kernel<T, VEC, CL><<<s.grid<VEC, CL>(), kThreads, 0, s.stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), part, weight, bias, eps, a, o, mean, rstd,
        s.b, s.n, s.c, s.chunk);
    return cudaGetLastError();
  }
};

struct BwdSums {
  const void *x, *dy;
  const float* mean;
  float* part;
  template <typename T, int VEC, bool CL>
  cudaError_t run(const Shape& s) const {
    inorm_bwd_sums_kernel<T, VEC, CL><<<s.grid<VEC, CL>(), kThreads, 0, s.stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), mean, part, s.b, s.n, s.c,
        s.chunk);
    return cudaGetLastError();
  }
};

struct BwdDx {
  const void *x, *dy;
  const float *a, *k;
  void* dx;
  template <typename T, int VEC, bool CL>
  cudaError_t run(const Shape& s) const {
    inorm_bwd_dx_kernel<T, VEC, CL><<<s.grid<VEC, CL>(), kThreads, 0, s.stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), a, k, static_cast<T*>(dx), s.b,
        s.n, s.c, s.chunk);
    return cudaGetLastError();
  }
};

}  // namespace

// Every entry point takes x (and dy, y, dx) as B samples of n = H W pixels
// and c channels, channels_last (channels_last = 1) or contiguous NCHW, f32
// or bf16 (is_bf16); `chunk` is the pixels a block covers, and the partial
// buffers hold two planes of (B, ceil(n / chunk), C), f64 for the
// statistics and f32 for the backward's sums; k holds two planes of (B, C)
// f32, (k1, k0); a, o, mean and rstd are (B, C) f32.

// Statistics, pass 1: the chunks' partial means and second moments.
extern "C" int hoig_inorm_stats(const void* x, void* part, int b, int n, int c, int chunk,
                                int channels_last, int is_bf16, void* stream) {
  const Shape s{b, n, c, chunk, channels_last != 0, static_cast<cudaStream_t>(stream)};
  if (!valid(s)) return cudaErrorInvalidValue;
  return dispatch(s, is_bf16, x, x, x, Stats{x, static_cast<double*>(part)});
}

// Apply. part non-null: combine the partials of hoig_inorm_stats (same
// shape and chunk), fold weight and bias (both null, or both (C) f32) and
// write a, o, mean and rstd; part null: read a and o (mean, rstd unused).
extern "C" int hoig_inorm_apply(const void* x, void* y, const void* part, const void* weight,
                                const void* bias, float eps, void* a, void* o, void* mean,
                                void* rstd, int b, int n, int c, int chunk, int channels_last,
                                int is_bf16, void* stream) {
  const Shape s{b, n, c, chunk, channels_last != 0, static_cast<cudaStream_t>(stream)};
  if (!valid(s) || (weight == nullptr) != (bias == nullptr)) return cudaErrorInvalidValue;
  return dispatch(s, is_bf16, x, y, x,
                  Apply{x, y, static_cast<const double*>(part), static_cast<const float*>(weight),
                        static_cast<const float*>(bias), eps, static_cast<float*>(a),
                        static_cast<float*>(o), static_cast<float*>(mean),
                        static_cast<float*>(rstd)});
}

// Backward, pass 1: the chunks' sums of dy and dy (x - mean).
extern "C" int hoig_inorm_bwd_sums(const void* x, const void* dy, const void* mean, void* part,
                                   int b, int n, int c, int chunk, int channels_last, int is_bf16,
                                   void* stream) {
  const Shape s{b, n, c, chunk, channels_last != 0, static_cast<cudaStream_t>(stream)};
  if (!valid(s)) return cudaErrorInvalidValue;
  return dispatch(s, is_bf16, x, dy, x,
                  BwdSums{x, dy, static_cast<const float*>(mean), static_cast<float*>(part)});
}

// Backward, the coefficients k1, k0 and, with a weight ((C) f32; null for
// none, and then gw and gb are not written), dweight and dbias ((C) f32).
extern "C" int hoig_inorm_bwd_coef(const void* part, const void* mean, const void* rstd,
                                   const void* weight, void* k, void* gw, void* gb, int b, int n,
                                   int c, int chunk, void* stream) {
  const Shape s{b, n, c, chunk, true, static_cast<cudaStream_t>(stream)};
  if (!valid(s)) return cudaErrorInvalidValue;
  inorm_bwd_coef_kernel<<<(c + kCoefChannels - 1) / kCoefChannels, kThreads, 0, s.stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const float*>(weight), static_cast<float*>(k),
      static_cast<float*>(gw), static_cast<float*>(gb), b, n, c, s.chunks());
  return cudaGetLastError();
}

// Backward, pass 2: dx from x, dy, a and k.
extern "C" int hoig_inorm_bwd_dx(const void* x, const void* dy, const void* a, const void* k,
                                 void* dx, int b, int n, int c, int chunk, int channels_last,
                                 int is_bf16, void* stream) {
  const Shape s{b, n, c, chunk, channels_last != 0, static_cast<cudaStream_t>(stream)};
  if (!valid(s)) return cudaErrorInvalidValue;
  return dispatch(s, is_bf16, x, dy, dx,
                  BwdDx{x, dy, static_cast<const float*>(a), static_cast<const float*>(k), dx});
}

extern "C" const char* hoig_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
