// Fused flow-guided local attention (k = 5), forward and backward, for sm_90a.
//
// For a pixel p of an (H, W) frame, source src (NHWC, C channels, read
// edge-padded: index clamped to the frame), fc_0 source-half weights
// w0s (25, C, 128) with offsets t row-major in [-2, 2]^2, per-axis bilinear
// coefficient fields ay[e], ax[e] (e in [-3, 3]; nonzero only at e = f and
// e = f + 1 for the pixel's relative floor f, with weights 1 - w and w):
//
//   phase A  G[q]   = sum_t src[q + t] @ W_t                  (q on the +-3 halo)
//            acc[p] = acc0[p] + sum_e ay[ey] ax[ex] G[p + e]
//   phase B  attn   = softmax(leaky_relu(acc) @ w1 + b1)      (128 -> 25)
//   phase C  out[p] = (1/25) sum_d V_d[p] src[p + d],  d in [-5, 5]^2,
//            V_d = sum_e ay[ey] ax[ex] attn_(d - e)
//
// Replaces hoig_tpu/ops/attn_pallas.py (Pallas, TPU): `_fwd_kernel`,
// `_bwd_c_kernel`, `_bwd_a_gsrc_kernel` and `_bwd_a_dw_kernel`, one C entry
// point each and a second one on the tensor cores for bf16 inputs where
// the kernel's product is large (fwd, bwd_a_gsrc, bwd_a_dw). The TPU
// kernels kept a row band of the frame with its halo in VMEM (tens of MB)
// and walked the grid in order, carrying dW and g_attn in revisited output
// blocks. A Hopper block has 227 KB of shared memory and
// blocks run in no order, so each entry point here runs a few simple kernels
// in sequence on the stream, with scratch the wrapper allocates:
//
//   * fwd: G (B, H+6, W+6, 128) f32, a 5x5 correlation, from
//     conv5_tc_kernel on the tensor cores for a bf16 source (entry point
//     hoig_attn_fused_fwd_tc), from conv5_kernel in FP32 for an f32 one (an
//     implicit GEMM: 8x8 output pixels x 128 outputs per block, 32-channel
//     slices of the 12x12 source window and of one offset's weights staged in
//     shared memory, 4 x 8 sums per thread); fwd_pixel_kernel then gives a
//     warp one pixel: the 4 nonzero coefficient terms of acc, the 128 -> 25
//     logits against w1 in shared memory, the softmax by warp shuffles, the
//     121 V_d (the 36 that can be nonzero are summed) and the output, lane =
//     channel pair.
//   * bwd_c: bwd_c_kernel, one block per (image, 8x8 tile, 64 channels),
//     builds V in shared memory, forms the source gradient of each padded
//     pixel that folds onto the tile as a gather, folds the margins in
//     registers and divides by 25, and writes the group's partial g_attn
//     dots; bwd_c_gattn_kernel adds the groups in order (its own note below).
//   * bwd_a_gsrc: dg_kernel writes dG[q] = sum_e (ay ax g_acc)[q - e] on the
//     halo, an output of its own that bwd_a_dw then takes (dG is built once
//     per backward); the transposed form of the 5x5 product projects dG
//     back through W_t^T onto the padded frame (conv5_tc_kernel for bf16
//     weights, entry point hoig_attn_fused_bwd_a_gsrc_tc; conv5_kernel for
//     f32 ones); fold_kernel folds the margins.
//   * bwd_a_dw: dW_t = sum_q src_pad[q + 2 + t] (x) dG[q] from the source
//     and dG. bf16 source: dw_tc_kernel on the tensor cores (entry point
//     hoig_attn_fused_bwd_a_dw_tc; its own note below). f32 source:
//     dw_kernel, one block per (offset, 64-channel tile, slice of the
//     pixels) summing src[m] (x) dG[m - t] over its slice into a partial.
//     Both add the slices' partials in order with slice_sum_kernel. No
//     float atomics: every run gives the same bits.
//
// What bounds them on an H100 (at the attention's shapes, C = 128..512 over
// 128^2..32^2 pixels, batch 4): the three 5x5 products (G, the gsrc
// projection, dW) are 2 * 25 * C * 128 operations per pixel of the (H+6) x
// (W+6) frame, far above the card's operations-per-byte line, so all four
// entry points are bound by arithmetic. Under bf16 all three run on the
// tensor cores (wgmma with bf16 operands and f32 accumulators): G and the
// gsrc projection in conv5_tc_kernel (8x8-pixel tiles, two per block
// sharing each offset's weight tile, the A operand read in place from a
// staged 12x12 window, split-K over the offsets where the frame has few
// tiles; its own note below), dW in dw_tc_kernel; the gsrc projection and
// dW as three passes over dG split into hi + mid + lo bf16 parts, exact, so
// that they take JAX's f32 products. For f32 inputs the three products run
// as FP32 fused multiply-adds on the CUDA cores, register-blocked 4 x 8
// with operands from shared memory. Everything else (the coefficient
// terms, softmax, the 36-term combines, the folds) is a few percent of the
// operations and reads each input about once from L2.
//
// Numerics. Built with -fmad=false: every elementwise step (the coefficient
// products, the 4-term acc combine, the V build, the phase-C and bwd-c sums,
// dG, the folds, the divisions by 25) rounds each product and each sum as
// the plain PyTorch versions in hoig_torch/ops/attn_fused.py do, in the same
// order, skipping only terms that are exactly zero; phase-C and bwd-c
// products are rounded to the source dtype, as bf16 * bf16 is in JAX. The
// channel reductions (G, the logits, the g_attn dots, the gsrc projection,
// dW) use explicit fused multiply-adds, or the tensor cores' exact products
// and f32 sums, in an order of their own, so the results that depend on
// them agree with the plain versions to a tolerance.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kK2 = 25;      // attention offsets (5 x 5)
constexpr int kF = 128;      // fc_0 hidden width
constexpr int kHalo = 3;     // G is needed on the +-3 halo of the frame
constexpr int kPad = 5;      // largest total shift per axis
constexpr int kNS = 11;      // total shifts per axis
constexpr int kNV = kNS * kNS;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPixPerBlock = 32;  // per-pixel kernels: 8 warps x 4 pixels

// x rounded to T's precision (the product of two T values rounded in T)
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// The two nonzero bilinear coefficients per axis of one pixel: a*0 on shift
// i*, a*1 on shift i* + 1.
struct Coef {
  int iy, ix;
  float ay0, ay1, ax0, ax1;
};

__device__ __forceinline__ Coef load_coef(const float* fy, const float* fx, const float* wy,
                                          const float* wx, long long p) {
  Coef k;
  k.iy = static_cast<int>(fy[p]);
  k.ix = static_cast<int>(fx[p]);
  k.ay1 = wy[p];
  k.ax1 = wx[p];
  k.ay0 = __fsub_rn(1.f, k.ay1);
  k.ax0 = __fsub_rn(1.f, k.ax1);
  return k;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// V_d of one pixel into v[0..120] (d row-major over [-5, 5]^2), separably:
// Vx[ty, dx] = sum_ex ax[ex] attn[ty, dx - ex], V[dy, dx] = sum_ey ay[ey]
// Vx[dy - ey, dx], ascending e; the terms with a zero coefficient are left
// out (they add exact zeros in the plain version).
__device__ __forceinline__ void build_v(const float* at, const Coef& k, float* v, int lane) {
  for (int d = lane; d < kNV; d += 32) {
    const int dy = d / kNS - kPad;
    const int dx = d % kNS - kPad;
    float val = 0.f;
#pragma unroll
    for (int cy = 0; cy < 2; ++cy) {
      const int ty = dy - (k.iy + cy);
      if (ty < -2 || ty > 2) continue;
      float vx = 0.f;
#pragma unroll
      for (int cx = 0; cx < 2; ++cx) {
        const int tx = dx - (k.ix + cx);
        if (tx < -2 || tx > 2) continue;
        vx = __fadd_rn(vx, __fmul_rn(cx ? k.ax1 : k.ax0, at[(ty + 2) * 5 + tx + 2]));
      }
      val = __fadd_rn(val, __fmul_rn(cy ? k.ay1 : k.ay0, vx));
    }
    v[d] = val;
  }
}

// ------------------------------------------------------------ 5x5 products
//
// out[b, oy, ox, n] = sum_{uy, ux in 0..4} sum_k X[b, oy + uy + off, ox + ux + off, k] * W(u, k, n)
//
// forward (G): X = src read edge-padded (index clamped), off = -5,
//   W(u, k, n) = w0s[u, k, n] (k = channel, n = hidden unit);
// transposed (gsrc projection): X = dG, zero outside its frame, off = -4,
//   W(u, k, n) = w0s[24 - u, n, k] (k = hidden unit, n = channel).
constexpr int kT = 8;             // output tile edge
constexpr int kWin = kT + 4;      // input window edge
constexpr int kKc = 32;           // reduction slice
constexpr int kNt = 128;          // outputs per block

// FP32 on the CUDA cores, for f32 inputs (bf16 ones take conv5_tc_kernel)
template <bool kTransposed>
__global__ void __launch_bounds__(kThreads)
conv5_kernel(const float* __restrict__ x, const float* __restrict__ w0s, float* __restrict__ out,
             int xh, int xw, int kdim, int oh, int ow, int ndim, int off) {
  __shared__ float xs[kWin * kWin][kKc + 1];
  __shared__ float ws[kKc][kNt + 1];
  const int tiles_x = (ow + kT - 1) / kT;
  const int oy0 = (blockIdx.x / tiles_x) * kT;
  const int ox0 = (blockIdx.x % tiles_x) * kT;
  const int n0 = blockIdx.y * kNt;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tp = tid >> 4;  // pixels tp + 16 i of the 8x8 tile
  const int tn = tid & 15;  // outputs tn + 16 j of the block's 128
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kdim; k0 += kKc) {
    __syncthreads();  // the previous slice's readers are done with xs
    for (int i = tid; i < kWin * kWin * kKc; i += kThreads) {
      const int q = i / kKc;
      const int kk = i - q * kKc;
      int y = oy0 + q / kWin + off;
      int xx = ox0 + q % kWin + off;
      const int k = k0 + kk;
      float v = 0.f;
      if (k < kdim) {
        if (kTransposed) {
          if (y >= 0 && y < xh && xx >= 0 && xx < xw) v = x[((b * xh + y) * xw + xx) * kdim + k];
        } else {
          y = clampi(y, 0, xh - 1);
          xx = clampi(xx, 0, xw - 1);
          v = x[((b * xh + y) * xw + xx) * kdim + k];
        }
      }
      xs[q][kk] = v;
    }
    for (int u = 0; u < kK2; ++u) {
      __syncthreads();  // xs is staged; the previous offset's readers are done with ws
      for (int i = tid; i < kKc * kNt; i += kThreads) {
        int kk, n;
        float v = 0.f;
        if (kTransposed) {
          n = i / kKc;
          kk = i - n * kKc;
          if (n0 + n < ndim && k0 + kk < kdim) {
            v = w0s[((long long)(kK2 - 1 - u) * ndim + n0 + n) * kdim + k0 + kk];
          }
        } else {
          kk = i / kNt;
          n = i - kk * kNt;
          if (n0 + n < ndim && k0 + kk < kdim) {
            v = w0s[((long long)u * kdim + k0 + kk) * ndim + n0 + n];
          }
        }
        ws[kk][n] = v;
      }
      __syncthreads();
      const int uy = u / 5;
      const int ux = u % 5;
#pragma unroll 4
      for (int kk = 0; kk < kKc; ++kk) {
        float a[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int pos = tp + 16 * i;
          a[i] = xs[(pos / kT + uy) * kWin + pos % kT + ux][kk];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = ws[kk][tn + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i], bv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pos = tp + 16 * i;
    const int oy = oy0 + pos / kT;
    const int ox = ox0 + pos % kT;
    if (oy >= oh || ox >= ow) continue;
    float* row = out + ((b * oh + oy) * ow + ox) * ndim;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tn + 16 * j;
      if (n < ndim) row[n] = acc[i][j];
    }
  }
}

template <bool kTransposed>
cudaError_t launch_conv5(const float* x, const float* w0s, float* out, int b, int xh, int xw,
                         int kdim, int oh, int ow, int ndim, int off, cudaStream_t s) {
  const dim3 grid(((oh + kT - 1) / kT) * ((ow + kT - 1) / kT), (ndim + kNt - 1) / kNt, b);
  conv5_kernel<kTransposed><<<grid, kThreads, 0, s>>>(x, w0s, out, xh, xw, kdim, oh, ow, ndim,
                                                      off);
  return cudaGetLastError();
}

// ------------------------------------------------------------------- fwd

template <typename T>
__global__ void __launch_bounds__(kThreads)
fwd_pixel_kernel(const T* __restrict__ src, const float* __restrict__ acc0,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ fy, const float* __restrict__ fx,
                 const float* __restrict__ wy, const float* __restrict__ wx,
                 const float* __restrict__ g, T* __restrict__ out, float* __restrict__ acc_out,
                 float* __restrict__ attn_out, long long n_pix, int h, int w, int c) {
  __shared__ float w1s[kF * kK2];
  __shared__ float b1s[kK2];
  __shared__ float hdn_s[kWarps][kF];
  __shared__ float attn_s[kWarps][kK2];
  __shared__ float v_s[kWarps][kNV];
  const int tid = threadIdx.x;
  for (int i = tid; i < kF * kK2; i += kThreads) w1s[i] = w1[i];
  if (tid < kK2) b1s[tid] = b1[tid];
  __syncthreads();
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int hg = h + 2 * kHalo;
  const int wg = w + 2 * kHalo;
  const long long first = (long long)blockIdx.x * kPixPerBlock;
  const long long last = min(n_pix, first + kPixPerBlock);
  for (long long p = first + warp; p < last; p += kWarps) {
    const int x = static_cast<int>(p % w);
    const int y = static_cast<int>((p / w) % h);
    const long long bb = p / ((long long)h * w);
    const Coef k = load_coef(fy, fx, wy, wx, p);

    // phase A: acc = acc0 + the 4 nonzero coefficient terms, ascending (ey, ex)
    float4 a4 = *reinterpret_cast<const float4*>(acc0 + p * kF + 4 * lane);
#pragma unroll
    for (int cy = 0; cy < 2; ++cy) {
#pragma unroll
      for (int cx = 0; cx < 2; ++cx) {
        const float cf = __fmul_rn(cy ? k.ay1 : k.ay0, cx ? k.ax1 : k.ax0);
        const float4 gv = *reinterpret_cast<const float4*>(
            g + ((bb * hg + y + kHalo + k.iy + cy) * wg + x + kHalo + k.ix + cx) * kF + 4 * lane);
        a4.x = __fadd_rn(a4.x, __fmul_rn(cf, gv.x));
        a4.y = __fadd_rn(a4.y, __fmul_rn(cf, gv.y));
        a4.z = __fadd_rn(a4.z, __fmul_rn(cf, gv.z));
        a4.w = __fadd_rn(a4.w, __fmul_rn(cf, gv.w));
      }
    }
    *reinterpret_cast<float4*>(acc_out + p * kF + 4 * lane) = a4;
    float* hd = hdn_s[warp];
    hd[4 * lane + 0] = a4.x >= 0.f ? a4.x : __fmul_rn(0.01f, a4.x);
    hd[4 * lane + 1] = a4.y >= 0.f ? a4.y : __fmul_rn(0.01f, a4.y);
    hd[4 * lane + 2] = a4.z >= 0.f ? a4.z : __fmul_rn(0.01f, a4.z);
    hd[4 * lane + 3] = a4.w >= 0.f ? a4.w : __fmul_rn(0.01f, a4.w);
    __syncwarp();

    // phase B: lane k < 25 owns logit k; softmax over the warp
    float logit = __int_as_float(0xff800000);  // -inf
    if (lane < kK2) {
      float s = 0.f;
      for (int f = 0; f < kF; ++f) s = __fmaf_rn(hd[f], w1s[f * kK2 + lane], s);
      logit = __fadd_rn(s, b1s[lane]);
    }
    const float m = warp_max(logit);
    const float e = lane < kK2 ? expf(__fsub_rn(logit, m)) : 0.f;
    const float sum = warp_sum(e);
    if (lane < kK2) {
      const float at = __fdiv_rn(e, sum);
      attn_out[p * kK2 + lane] = at;
      attn_s[warp][lane] = at;
    }
    __syncwarp();

    // phase C: out = (1/25) sum_d V_d src[p + d] over the 6x6 box of d where
    // V_d can be nonzero, ascending; products rounded to T, f32 sums
    float* v = v_s[warp];
    build_v(attn_s[warp], k, v, lane);
    __syncwarp();
    const int dy0 = k.iy - 2;
    const int dx0 = k.ix - 2;
    for (int c0 = 0; c0 < c; c0 += 64) {
      const int ch = c0 + 2 * lane;
      if (ch >= c) break;
      float o0 = 0.f, o1 = 0.f;
      for (int dy = dy0; dy < dy0 + 6; ++dy) {
        const int sy = clampi(y + dy, 0, h - 1);
        for (int dx = dx0; dx < dx0 + 6; ++dx) {
          const int sx = clampi(x + dx, 0, w - 1);
          const float vd = rnd<T>(v[(dy + kPad) * kNS + dx + kPad]);
          const float2 s = load_pair(src + ((bb * h + sy) * w + sx) * c + ch);
          o0 = __fadd_rn(o0, rnd<T>(__fmul_rn(vd, s.x)));
          o1 = __fadd_rn(o1, rnd<T>(__fmul_rn(vd, s.y)));
        }
      }
      store_pair(out + p * c + ch, __fdiv_rn(o0, 25.f), __fdiv_rn(o1, 25.f));
    }
    __syncwarp();  // v_s, hdn_s and attn_s are reused by the warp's next pixel
  }
}

// ----------------------------------------------------------------- bwd_c
//
// bwd_c_kernel: the phase-C backward of hoig_tpu/ops/attn_pallas.py
// `_bwd_c_kernel` in one pass, with bwd_c_gattn_kernel for the last sum of
// g_attn. For the padded frame (H+10) x (W+10) and d in [0, 10]^2 (shift
// d - 5), with g = g_out:
//
//   gpad[P]   = sum_d T(T(V_d[P - d]) * g[P - d]), ascending d (P - d in the image)
//   gsrc_c    = fold_edges(gpad) / 25 (fold_kernel's order: the margin
//               columns of a row first, then the rows)
//   sdot_j[p] = <g[p], src[clamped p + iy - 2 + jy, ix - 2 + jx]>, j = (jy, jx) in [0, 5]^2
//   g_attn_t  = (1/25) sum_e ay[ey] ax[ex] sdot_(t + e)
//
// V_d of a source pixel q is nonzero only on the 6x6 box of d that starts at
// (iy + 3, ix + 3), q's relative floor; its 36 entries there do not depend on
// the floor: V[jy, jx] = sum_cy ay_cy sum_cx ax_cx attn[jy - cy, jx - cx]
// (build_v's terms, in its order).
//
// Design. Every padded pixel that folds onto an 8x8 tile of output pixels
// (its own pixel, or the 5-wide margins of a border tile) gathers only from
// source pixels within +-5 of the tile, and the dots read the source within
// +-5 too. So a block owns one image, one tile and 64 channels (a lane's
// channel pair), and stages once, in shared memory: the 18x18 window's g_out
// and src for those channels, in T (cp.async, in flight while the rest is
// built), and each window pixel's 36 V values (built from attn and the
// coefficient fields, rounded to T) and box origin; 109 KB under bf16 (two
// blocks per SM), 215 KB under f32. Neither V nor the padded gradient
// reaches device memory. A warp then takes one output pixel at a time (one
// of every row and every column of the tile, so that the border's extra
// work is spread over the warps): for each padded pixel of its fold, the
// lanes test the 121 offsets, 32 at a time without branches, and list the
// terms in ascending d by ballot (source pixel, V); every lane sums its
// channel pair over the list; the fold adds those sums in registers and
// divides by 25. The 36 dots of the pixel come from the same windows, a
// lane's two products each, summed across the warp by a butterfly that
// leaves lane j with dot j (and lane 8 i with dot 32 + i), and go to a small
// scratch per channel group (groups x B*H*W x 36 f32); bwd_c_gattn_kernel
// adds the groups in order and applies the coefficients. No float atomics:
// every run gives the same bits. Under bf16 a pair of products is one
// mul.bf16x2: it rounds the exact product of two bf16 values once, as the
// plain version's f32 product (exact) rounded to bf16 does.
//
// What bounds it: the bytes are src, g_out, attn, the fields, gsrc_c and
// g_attn once each (0.07 ms per fused step on an H100), and the work is 36
// rounded product-adds per pixel and channel for the gather and as many for
// the dots, on the CUDA cores (the products are rounded to T one by one, as
// JAX rounds bf16 * bf16, so the tensor cores do not apply); the term
// lists, the dots' reduction across the warp, the window's 5x re-read of
// g_out and src from L2 and the V build of each block's window, and the
// fold of the border tiles' margins come on top, and bound this version.
// kBcT and kBcCh are repeated in hoig_torch/ops/attn_fused.py (TILING, held
// against hoig_attn_fused_tiling): the channel groups size the partials
constexpr int kBcT = 8;                      // output tile edge
constexpr int kBcWin = kBcT + 2 * kPad;      // 18: the window edge
constexpr int kBcWinPix = kBcWin * kBcWin;   // 324
constexpr int kBcCh = 64;                    // channels per block: a channel pair per lane
constexpr int kBox = 36;                     // V_d that can be nonzero, per source pixel
constexpr int kBcList = 128;                 // term slots per warp (a padded pixel has <= 121)

template <typename T>
constexpr int bc_smem_bytes() {  // g_out and src windows, V, box origins, the warps' term lists
  return (2 * kBcWinPix * kBcCh + kBcWinPix * kBox + kWarps * kBcList) *
             static_cast<int>(sizeof(T)) +
         kBcWinPix * 4 + kWarps * kBcList * 2;
}
// bwd_c_kernel gives warp k the pixels (row, (row + k) % kBcT): one warp per
// tile column covers the tile; the f32 build must fit one block's shared memory
static_assert(kWarps == kBcT, "bwd_c_kernel needs one warp per tile column");
static_assert(bc_smem_bytes<float>() <= 227 * 1024, "bwd_c_kernel's f32 window exceeds 227 KB");

// a channel pair of T as it lies in memory, and the two products of two
// pairs rounded to T, in f32 (under bf16 one mul.bf16x2)
template <typename T> struct Pair2;
template <> struct Pair2<float> { using type = float2; };
template <> struct Pair2<__nv_bfloat16> { using type = __nv_bfloat162; };
__device__ __forceinline__ float2 mul_pair(float2 a, float2 b) {
  return make_float2(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
}
__device__ __forceinline__ float2 mul_pair(__nv_bfloat162 a, __nv_bfloat162 b) {
  const __nv_bfloat162 pr = __hmul2(a, b);
  const uint32_t u = *reinterpret_cast<const uint32_t*>(&pr);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xFFFF0000u));
}
__device__ __forceinline__ float2 splat(float v) { return make_float2(v, v); }
__device__ __forceinline__ __nv_bfloat162 splat(__nv_bfloat16 v) { return __bfloat162bfloat162(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One step of the transposing butterfly over v[0 .. 2 kHalf - 1]: a lane
// keeps the half that its side of the pair owns, and adds its partner's copy
// of that half. After the steps 16, 8, 4, 2, 1, lane l holds the warp's sum
// of v[l].
template <int kHalf>
__device__ __forceinline__ void butterfly_step(float (&v)[kBox], int lane) {
  const bool upper = lane & kHalf;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float keep = upper ? v[i + kHalf] : v[i];
    const float give = upper ? v[i] : v[i + kHalf];
    v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, give, kHalf));
  }
}

// kUnit: bytes per cp.async of the staging, 16 (8 bf16 or 4 f32 channels;
// C a multiple of those, 16-byte aligned tensors) or one channel pair
template <typename T, int kUnit>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)
bwd_c_kernel(const T* __restrict__ src, const float* __restrict__ fy, const float* __restrict__ fx,
             const float* __restrict__ wy, const float* __restrict__ wx,
             const float* __restrict__ attn, const T* __restrict__ gout,
             float* __restrict__ gsrc, float* __restrict__ sdot_part, int h, int w, int c) {
  using P2 = typename Pair2<T>::type;
  constexpr int kPairs = kBcCh / 2;
  extern __shared__ __align__(16) unsigned char bc_smem[];
  T* const gs = reinterpret_cast<T*>(bc_smem);                     // [kBcWinPix][kBcCh]
  T* const ss = gs + kBcWinPix * kBcCh;                             // [kBcWinPix][kBcCh]
  T* const vr = ss + kBcWinPix * kBcCh;                             // [kBcWinPix][kBox]
  T* const lv = vr + kBcWinPix * kBox;                              // [kWarps][kBcList]
  int* const org = reinterpret_cast<int*>(lv + kWarps * kBcList);   // [kBcWinPix]: 8 oy + ox
  unsigned short* const lq = reinterpret_cast<unsigned short*>(org + kBcWinPix);  // [kWarps][kBcList]
  const P2* const gs2 = reinterpret_cast<const P2*>(gs);
  const P2* const ss2 = reinterpret_cast<const P2*>(ss);
  const int tiles_x = (w + kBcT - 1) / kBcT;
  const int ty0 = (blockIdx.x / tiles_x) * kBcT;
  const int tx0 = (blockIdx.x % tiles_x) * kBcT;
  const int wy0 = ty0 - kPad;  // the window's first row and column, in image coordinates
  const int wx0 = tx0 - kPad;
  const int c0 = blockIdx.y * kBcCh;
  const long long img = (long long)blockIdx.z * h * w;
  const int tid = threadIdx.x;

  // the window's pixels that lie in the image: g_out and src by cp.async
  // (zero past C), in flight while V and the box origins are built
  constexpr int kEl = kUnit / static_cast<int>(sizeof(T));  // channels per copy
  constexpr int kUnits = kBcCh / kEl;                         // copies per pixel and tensor
  for (int i = tid; i < kBcWinPix * kUnits; i += kThreads) {
    const int q = i / kUnits;
    const int u = i - q * kUnits;
    const int y = wy0 + q / kBcWin;
    const int x = wx0 + q % kBcWin;
    if (y < 0 || y >= h || x < 0 || x >= w) continue;
    const int ch = c0 + u * kEl;
    const bool ok = ch < c;
    const long long off = ok ? (img + (long long)y * w + x) * c + ch : 0;
    cp_async<kUnit>(smem_u32(gs + q * kBcCh + u * kEl), gout + off, ok ? kUnit : 0);
    cp_async<kUnit>(smem_u32(ss + q * kBcCh + u * kEl), src + off, ok ? kUnit : 0);
  }
  cp_async_commit();
  for (int q = tid; q < kBcWinPix; q += kThreads) {
    const int y = wy0 + q / kBcWin;
    const int x = wx0 + q % kBcWin;
    if (y < 0 || y >= h || x < 0 || x >= w) continue;
    const long long p = img + (long long)y * w + x;
    const Coef k = load_coef(fy, fx, wy, wx, p);
    org[q] = 8 * (k.iy + 3) + k.ix + 3;
    float at[kK2];
#pragma unroll
    for (int t = 0; t < kK2; ++t) at[t] = attn[p * kK2 + t];
#pragma unroll
    for (int jy = 0; jy < 6; ++jy) {
#pragma unroll
      for (int jx = 0; jx < 6; ++jx) {
        float val = 0.f;
#pragma unroll
        for (int cy = 0; cy < 2; ++cy) {
          if (jy - cy < 0 || jy - cy > 4) continue;
          float vx = 0.f;
#pragma unroll
          for (int cx = 0; cx < 2; ++cx) {
            if (jx - cx < 0 || jx - cx > 4) continue;
            vx = __fadd_rn(vx, __fmul_rn(cx ? k.ax1 : k.ax0, at[(jy - cy) * 5 + jx - cx]));
          }
          val = __fadd_rn(val, __fmul_rn(cy ? k.ay1 : k.ay0, vx));
        }
        vr[q * kBox + jy * 6 + jx] = from_float<T>(val);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ch = c0 + 2 * lane;
  T* const my_lv = lv + warp * kBcList;
  unsigned short* const my_lq = lq + warp * kBcList;
  const P2* const gs_lane = gs2 + lane;  // this lane's channel pair of window pixel 0
  const unsigned below = (1u << lane) - 1u;
  // the offsets d = lane + 32 k this lane tests, per axis (past 120: none)
  int cand_dy[4], cand_dx[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int d = lane + 32 * k;
    cand_dy[k] = d < kNV ? d / kNS : 1 << 20;
    cand_dx[k] = d % kNS;
  }
  for (int row = 0; row < kBcT; ++row) {
    const int y = ty0 + row;
    const int x = tx0 + (row + warp) % kBcT;
    if (y >= h || x >= w) continue;  // the same for the whole warp
    const int pw = (y - wy0) * kBcWin + x - wx0;
    const long long p = img + (long long)y * w + x;

    // gsrc_c: the padded pixels (r, cc) that fold onto (y, x), each the sum
    // of its listed terms
    const int r_lo = y == 0 ? 0 : y + kPad;
    const int r_hi = y == h - 1 ? h + 2 * kPad - 1 : y + kPad;
    const int c_lo = x == 0 ? 0 : x + kPad;
    const int c_hi = x == w - 1 ? w + 2 * kPad - 1 : x + kPad;
    float tot0 = 0.f, tot1 = 0.f;
    for (int r = r_lo; r <= r_hi; ++r) {
      float row0 = 0.f, row1 = 0.f;
      for (int cc = c_lo; cc <= c_hi; ++cc) {
        // terms: d with q = (r, cc) - d in the image and d in q's box
        int n = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int qy = r - cand_dy[k];
          const int qx = cc - cand_dx[k];
          const bool in = static_cast<unsigned>(qy) < static_cast<unsigned>(h) &&
                          static_cast<unsigned>(qx) < static_cast<unsigned>(w);
          const int qw = in ? (qy - wy0) * kBcWin + qx - wx0 : 0;
          const int o = org[qw];
          const int by = cand_dy[k] - (o >> 3);
          const int bx = cand_dx[k] - (o & 7);
          const bool ok = in && static_cast<unsigned>(by) < 6u && static_cast<unsigned>(bx) < 6u;
          const T v = vr[ok ? qw * kBox + by * 6 + bx : 0];
          const unsigned m = __ballot_sync(0xffffffffu, ok);
          if (ok) {
            const int at = n + __popc(m & below);
            my_lq[at] = static_cast<unsigned short>(qw * kPairs);
            my_lv[at] = v;
          }
          n += __popc(m);
        }
        __syncwarp();
        float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
        for (int t = 0; t < n; ++t) {
          const float2 pr = mul_pair(splat(my_lv[t]), gs_lane[my_lq[t]]);
          a0 = __fadd_rn(a0, pr.x);
          a1 = __fadd_rn(a1, pr.y);
        }
        __syncwarp();  // the list is rebuilt for the next padded pixel
        row0 = __fadd_rn(row0, a0);
        row1 = __fadd_rn(row1, a1);
      }
      tot0 = __fadd_rn(tot0, row0);
      tot1 = __fadd_rn(tot1, row1);
    }
    if (ch < c) store_pair(gsrc + p * c + ch, __fdiv_rn(tot0, 25.f), __fdiv_rn(tot1, 25.f));

    // the 36 dots over this group's channels, products rounded to T
    const int oy = (org[pw] >> 3) - kPad;  // iy - 2: the box's first shift
    const int ox = (org[pw] & 7) - kPad;
    const P2* rows[6];  // this lane's pair in the box's source rows and columns
    int cols[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      rows[j] = ss2 + (clampi(y + oy + j, 0, h - 1) - wy0) * kBcWin * kPairs + lane;
      cols[j] = (clampi(x + ox + j, 0, w - 1) - wx0) * kPairs;
    }
    const P2 gp = gs_lane[pw * kPairs];
    float sd[kBox];
#pragma unroll
    for (int j = 0; j < kBox; ++j) {
      const float2 pr = mul_pair(gp, rows[j / 6][cols[j % 6]]);
      sd[j] = __fadd_rn(pr.x, pr.y);
    }
    butterfly_step<16>(sd, lane);
    butterfly_step<8>(sd, lane);
    butterfly_step<4>(sd, lane);
    butterfly_step<2>(sd, lane);
    butterfly_step<1>(sd, lane);
    // dots 32..35: the steps 16 and 8 keep one of the four, then a plain sum
    // over the lanes that differ in the low three bits; lane 8 i holds dot 32 + i
    float e2[2], e1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool upper = lane & 16;
      e2[i] = __fadd_rn(upper ? sd[34 + i] : sd[32 + i],
                        __shfl_xor_sync(0xffffffffu, upper ? sd[32 + i] : sd[34 + i], 16));
    }
    {
      const bool upper = lane & 8;
      e1 = __fadd_rn(upper ? e2[1] : e2[0], __shfl_xor_sync(0xffffffffu, upper ? e2[0] : e2[1], 8));
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) e1 = __fadd_rn(e1, __shfl_xor_sync(0xffffffffu, e1, o));
    float* const dst = sdot_part + ((long long)blockIdx.y * gridDim.z * h * w + p) * kBox;
    dst[lane] = sd[0];
    if ((lane & 7) == 0) dst[32 + (lane >> 3)] = e1;
  }
}

// g_attn[p, t] = (1/25) sum_ey ay[ey] sum_ex ax[ex] sdot[p, t + e], ascending
// e, where sdot is the sum of bwd_c_kernel's channel groups' partial dots,
// added in order; a thread per (pixel, t)
__global__ void __launch_bounds__(kThreads)
bwd_c_gattn_kernel(const float* __restrict__ sdot_part, const float* __restrict__ fy,
                   const float* __restrict__ fx, const float* __restrict__ wy,
                   const float* __restrict__ wx, float* __restrict__ gattn, long long n_pix,
                   int groups) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_pix * kK2) return;
  const long long p = i / kK2;
  const int t = static_cast<int>(i - p * kK2);
  const int ty = t / 5 - 2;
  const int tx = t % 5 - 2;
  const Coef k = load_coef(fy, fx, wy, wx, p);
  float val = 0.f;
#pragma unroll
  for (int cy = 0; cy < 2; ++cy) {
    float sx = 0.f;
#pragma unroll
    for (int cx = 0; cx < 2; ++cx) {
      const long long j = p * kBox + (ty + cy + 2) * 6 + tx + cx + 2;
      float sd = sdot_part[j];
      for (int g = 1; g < groups; ++g) sd = __fadd_rn(sd, sdot_part[g * n_pix * kBox + j]);
      sx = __fadd_rn(sx, __fmul_rn(cx ? k.ax1 : k.ax0, sd));
    }
    val = __fadd_rn(val, __fmul_rn(cy ? k.ay1 : k.ay0, sx));
  }
  gattn[i] = __fdiv_rn(val, 25.f);
}

// Fold the edge-padded frame's gradient onto the image (the replicate-pad
// backward): border pixels collect their margin's entries, the columns of a
// row in ascending order first, then the rows in ascending order (the gsrc
// projection's; bwd_c_kernel folds in its tile, in the same order).
__global__ void __launch_bounds__(kThreads)
fold_kernel(const float* __restrict__ gpad, float* __restrict__ out, long long n, int h, int w,
            int c) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int ch = static_cast<int>(i % c);
  const long long pix = i / c;
  const int x = static_cast<int>(pix % w);
  const int y = static_cast<int>((pix / w) % h);
  const long long bb = pix / ((long long)h * w);
  const int hp = h + 2 * kPad;
  const int wp = w + 2 * kPad;
  const int r_lo = y == 0 ? 0 : y + kPad;
  const int r_hi = y == h - 1 ? h + 2 * kPad - 1 : y + kPad;
  const int c_lo = x == 0 ? 0 : x + kPad;
  const int c_hi = x == w - 1 ? w + 2 * kPad - 1 : x + kPad;
  float tot = 0.f;
  for (int r = r_lo; r <= r_hi; ++r) {
    float row = 0.f;
    for (int cc = c_lo; cc <= c_hi; ++cc) row = __fadd_rn(row, gpad[((bb * hp + r) * wp + cc) * c + ch]);
    tot = __fadd_rn(tot, row);
  }
  out[i] = tot;
}

cudaError_t launch_fold(const float* gpad, float* out, int b, int h, int w, int c, cudaStream_t s) {
  const long long n = (long long)b * h * w * c;
  fold_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(gpad, out, n, h, w, c);
  return cudaGetLastError();
}

// --------------------------------------------------------------- bwd_a

// dG[q] = sum_e (ay[ey] ax[ex] g_acc)[q - e] on the halo frame (B, H+6, W+6,
// 128), ascending e; a block per halo pixel, a thread per hidden unit.
__global__ void __launch_bounds__(kF)
dg_kernel(const float* __restrict__ gacc, const float* __restrict__ fy,
          const float* __restrict__ fx, const float* __restrict__ wy,
          const float* __restrict__ wx, float* __restrict__ dg, int h, int w) {
  const int hg = h + 2 * kHalo;
  const int wg = w + 2 * kHalo;
  const long long q = blockIdx.x;
  const int gx = static_cast<int>(q % wg);
  const int gy = static_cast<int>((q / wg) % hg);
  const long long bb = q / ((long long)hg * wg);
  const int f = threadIdx.x;
  float tot = 0.f;
  for (int eyi = 0; eyi < 7; ++eyi) {
    const int y = gy - eyi;
    if (y < 0 || y >= h) continue;
    for (int exi = 0; exi < 7; ++exi) {
      const int x = gx - exi;
      if (x < 0 || x >= w) continue;
      const long long p = (bb * h + y) * w + x;
      const Coef k = load_coef(fy, fx, wy, wx, p);
      const int cy = eyi - kHalo - k.iy;
      const int cx = exi - kHalo - k.ix;
      if (cy < 0 || cy > 1 || cx < 0 || cx > 1) continue;
      const float cf = __fmul_rn(cy ? k.ay1 : k.ay0, cx ? k.ax1 : k.ax0);
      tot = __fadd_rn(tot, __fmul_rn(cf, gacc[p * kF + f]));
    }
  }
  dg[q * kF + f] = tot;
}

cudaError_t launch_dg(const float* gacc, const float* fy, const float* fx, const float* wy,
                      const float* wx, float* dg, int b, int h, int w, cudaStream_t s) {
  const long long n = (long long)b * (h + 2 * kHalo) * (w + 2 * kHalo);
  dg_kernel<<<(unsigned)n, kF, 0, s>>>(gacc, fy, fx, wy, wx, dg, h, w);
  return cudaGetLastError();
}

// partial[s, t, c, f] = sum over padded pixels m of slice s of src_pad[m, c] * dG[m - 2 - t, f]
// (array coordinates; dG zero outside its frame), FP32 on the CUDA cores for
// an f32 source (a bf16 one takes dw_tc_kernel). Block: offset t, 64
// channels, one slice; thread: 4 channels x 8 hidden units.
constexpr int kCt = 64;  // channels per dW block (read as TILING's dw_channels)
constexpr int kMc = 32;  // pixels per staged slice

__global__ void __launch_bounds__(kThreads)
dw_kernel(const float* __restrict__ src, const float* __restrict__ dg, float* __restrict__ part,
          int h, int w, int c, long long n_pos, long long per_slice) {
  __shared__ float ss[kMc][kCt + 1];
  __shared__ float ds[kMc][kF + 1];
  __shared__ long long src_off[kMc];
  __shared__ long long dg_off[kMc];
  const int t = blockIdx.x;
  const int ty = t / 5 - 2;
  const int tx = t % 5 - 2;
  const int c0 = blockIdx.y * kCt;
  const long long m_begin = blockIdx.z * per_slice;
  const long long m_end = min(n_pos, m_begin + per_slice);
  const int hp = h + 2 * kPad;
  const int wp = w + 2 * kPad;
  const int hg = h + 2 * kHalo;
  const int wg = w + 2 * kHalo;
  const int tid = threadIdx.x;
  const int tc = tid >> 4;
  const int tf = tid & 15;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (long long m0 = m_begin; m0 < m_end; m0 += kMc) {
    __syncthreads();  // the previous slice's readers are done
    if (tid < kMc) {
      // element offsets of the slice's source pixel and of dG[m - 2 - t] (-1: zero)
      const long long m = m0 + tid;
      long long so = -1, go = -1;
      if (m < m_end) {
        const int mx = static_cast<int>(m % wp);
        const int my = static_cast<int>((m / wp) % hp);
        const long long bb = m / ((long long)hp * wp);
        so = ((bb * h + clampi(my - kPad, 0, h - 1)) * w + clampi(mx - kPad, 0, w - 1)) * c;
        const int gy = my - 2 - ty;
        const int gx = mx - 2 - tx;
        if (gy >= 0 && gy < hg && gx >= 0 && gx < wg) go = ((bb * hg + gy) * wg + gx) * kF;
      }
      src_off[tid] = so;
      dg_off[tid] = go;
    }
    __syncthreads();
    for (int i = tid; i < kMc * kCt; i += kThreads) {
      const int mm = i / kCt;
      const int cc = i - mm * kCt;
      const long long so = src_off[mm];
      ss[mm][cc] = (so >= 0 && c0 + cc < c) ? src[so + c0 + cc] : 0.f;
    }
    for (int i = tid; i < kMc * kF; i += kThreads) {
      const int mm = i / kF;
      const int f = i - mm * kF;
      const long long go = dg_off[mm];
      ds[mm][f] = go >= 0 ? dg[go + f] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kMc; ++kk) {
      float a[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ss[kk][tc + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = ds[kk][tf + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ch = c0 + tc + 16 * i;
    if (ch >= c) continue;
    float* row = part + (((long long)blockIdx.z * kK2 + t) * c + ch) * kF;
#pragma unroll
    for (int j = 0; j < 8; ++j) row[tf + 16 * j] = acc[i][j];
  }
}

// out[i] = sum over slices s, ascending, of part[s, i] (the second pass of
// every split-K here: dW, and the tensor-core 5x5 products)
__global__ void __launch_bounds__(kThreads)
slice_sum_kernel(const float* __restrict__ part, float* __restrict__ out, long long n, int slices) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float tot = part[i];
  for (int s = 1; s < slices; ++s) tot = __fadd_rn(tot, part[s * n + i]);
  out[i] = tot;
}

cudaError_t launch_slice_sum(const float* part, float* out, long long n, int slices,
                             cudaStream_t s) {
  slice_sum_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(part, out, n,
                                                                                slices);
  return cudaGetLastError();
}

bool bad_dims(int b, int h, int w, int c) {
  return b < 1 || h < 1 || w < 1 || c < 2 || c % 2 != 0 || b > 65535;
}

// -------------------------------------------- 5x5 products on the tensor cores
//
// conv5_tc_kernel: the two products of conv5_kernel for bf16 weights, as
// warpgroup matrix multiplies (wgmma.mma_async m64n128k16, bf16 operands, f32
// accumulators; sm_90a). It replaces, with conv5_kernel's FP32 form for f32
// inputs, phase A of hoig_tpu/ops/attn_pallas.py `_fwd_kernel` and the
// projection of `_bwd_a_gsrc_kernel`.
//
//   forward (G): M = the pixels of the (H+6) x (W+6) frame, N = 128, K = 25
//     offsets x C; A is the bf16 source, read edge-padded; one pass. A
//     product of two bf16 values is exact in f32, as phase A's bf16 x bf16
//     dot with an f32 result is in JAX.
//   transposed (the gsrc projection): M = the pixels of the (H+10) x (W+10)
//     frame, N = C, K = 25 offsets x 128; A is the f32 dG, zero outside its
//     frame, split when staged into three bf16 parts with hi + mid + lo == dG
//     exactly (split3), and each k-step runs three wgmma against the same B
//     tile. w0s is exactly bf16, so each part's product with it is exact in
//     f32 and the three together are JAX's f32 product dG x w0s (the Pallas
//     kernel widens w0s and multiplies in f32); only the order of the f32
//     sums differs, and the tensor cores' own way of adding them.
//
// Tiling. A block is two warpgroups; each owns one 8x8 tile of output pixels
// (the 64 rows of its wgmma) from the linear list of tiles over (image, tile
// row, tile column), and the two share each B tile. For each 64-wide slice
// of the reduction's channels (or hidden units), the block stages each
// tile's 12x12 input window once, in the no-swizzle core-matrix order
// [8-channel chunk][window row][window column], 16 bytes per pixel and
// chunk. The A operand of offset (uy, ux) is then that window read in place:
// 8 neighbouring pixels of a window row are the 8 rows of a core matrix, the
// next output row is 12 pixels on (the descriptor's stride byte offset), the
// next 8 channels 144 pixels on (its leading byte offset). An offset is only
// a descriptor's start address: no re-staging per offset and no A operand
// from registers. The 25 offsets' (64 x 128) B tiles stream through two
// shared-memory buffers by cp.async, the next in flight while the current
// one's wgmma run. Where the frame has few tiles (layers 3-9: 100 tiles of
// G for 132 SMs), the wrapper splits K over contiguous ranges of the 25
// offsets (blockIdx.z); slice_sum_kernel adds the partials in a fixed order
// (no float atomics: every run gives the same bits). K tails (C not a
// multiple of 64) and N tails (C not a multiple of 128) are zero-filled in
// staging; a tile past the frame is computed on zeros and not stored.
//
// What bounds it on an H100: the products are 2 x 25 x C x 128 operations
// per pixel of the frame, 223 GFLOP per call for the forward and three times
// that for the transposed form, 0.23 and 0.68 ms at the tensor cores' 989
// TFLOP/s. Each 16 KB B tile feeds 2 x 64 rows, 128 operations per byte read
// from L2, so the B stream from L2 and the per-offset synchronisation, not
// the tensor cores, bound this first version.
// kT, kTcWG and kTcN are read by hoig_torch/ops/attn_fused.py (TILING,
// hoig_attn_fused_tiling) to pick the split-K factor and size the partials
constexpr int kTcWG = 2;                        // warpgroups per block
constexpr int kTcThreads = 128 * kTcWG;
constexpr int kTcKs = 64;                       // reduction slice staged per pass over the offsets
constexpr int kTcKc = kTcKs / 8;                // 16-byte chunks per pixel and slice
constexpr int kTcWinPix = kWin * kWin;          // 144 pixels per window
constexpr int kTcWinUnits = kTcWinPix * kTcKc;  // 16-byte units per window (and per part)
constexpr int kTcN = 128;                       // outputs per block
constexpr int kTcBUnits = kTcKs * kTcN / 8;     // 16-byte units per B tile (16 KB)

template <bool kTransposed>
constexpr int tc_smem_bytes() {  // the windows (three parts each when transposed), two B tiles
  return (kTcWG * (kTransposed ? 3 : 1) * kTcWinUnits + 2 * kTcBUnits) * 16;
}


// x == hi + mid + lo exactly, each part a bf16 (its 16 bits returned): hi
// keeps x's top 16 bits (truncation, which never rounds past the bf16
// range), mid the top 16 bits of the exact remainder x - hi, and lo the
// rest, which has at most 8 significant bits and is a bf16 itself wherever
// x's lowest bit is not below bf16's smallest subnormal, 2^-133 (every
// |x| >= 2^-110). hoig_torch/ops/attn_fused.py::split_bf16x3 is the plain version.
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const uint32_t hb = __float_as_uint(x) & 0xFFFF0000u;
  const float r1 = __fsub_rn(x, __uint_as_float(hb));
  const uint32_t mb = __float_as_uint(r1) & 0xFFFF0000u;
  const float r2 = __fsub_rn(r1, __uint_as_float(mb));
  hi = hb >> 16;
  mid = mb >> 16;
  lo = __float_as_uint(r2) >> 16;
}

// 8 consecutive f32 values (a, then b) as three 16-byte units of bf16, the
// hi, mid and lo parts of each (split3), element 0 in the low half-word
__device__ __forceinline__ void split3_unit(float4 a, float4 b, uint4 (&u)[3]) {
  const float f[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t part[3][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t h0, m0, l0, h1, m1, l1;
    split3(f[2 * e], h0, m0, l0);
    split3(f[2 * e + 1], h1, m1, l1);
    part[0][e] = h0 | (h1 << 16);
    part[1][e] = m0 | (m1 << 16);
    part[2][e] = l0 | (l1 << 16);
  }
#pragma unroll
  for (int pt = 0; pt < 3; ++pt) {
    u[pt] = make_uint4(part[pt][0], part[pt][1], part[pt][2], part[pt][3]);
  }
}

struct TcTile {
  long long b;
  int oy0, ox0;
  bool ok;
};

template <bool kTransposed>
__global__ void __launch_bounds__(kTcThreads, kTransposed ? 1 : 2)
conv5_tc_kernel(const void* __restrict__ xv, const __nv_bfloat16* __restrict__ w0s,
                float* __restrict__ out, int bsz, int xh, int xw, int kdim, int oh, int ow,
                int ndim, int off, int splits, int vec) {
  extern __shared__ __align__(128) uint4 tc_smem[];
  constexpr int kParts = kTransposed ? 3 : 1;  // hi, mid, lo of dG
  uint4* const a_s = tc_smem;                                 // [kTcWG][kParts][kTcWinUnits]
  uint4* const b_s = tc_smem + kTcWG * kParts * kTcWinUnits;  // [2][kTcBUnits]
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int tiles_x = (ow + kT - 1) / kT;
  const int tiles_img = ((oh + kT - 1) / kT) * tiles_x;
  const long long n_tiles = (long long)bsz * tiles_img;
  auto tile_at = [&](int i) {
    const long long t = (long long)blockIdx.x * kTcWG + i;
    const int r = static_cast<int>(t % tiles_img);
    return TcTile{t / tiles_img, (r / tiles_x) * kT, (r % tiles_x) * kT, t < n_tiles};
  };
  static_assert(kTcWG == 2, "one tile per warpgroup, two warpgroups");
  const TcTile tile0 = tile_at(0);
  const TcTile tile1 = tile_at(1);
  const int n0 = blockIdx.y * kTcN;
  const int u_begin = kK2 * static_cast<int>(blockIdx.z) / splits;
  const int u_end = kK2 * (static_cast<int>(blockIdx.z) + 1) / splits;

  // B tile of offset u for the slice at k0 into buffer buf; lanes are mapped
  // so that a warp reads 64-byte runs of w0s and writes whole 128-byte rows
  // of shared memory
  auto stage_b = [&](int u, int buf, int k0) {
    uint4* bs = b_s + buf * kTcBUnits;
    for (int i = tid; i < kTcBUnits; i += kTcThreads) {
      const int lane = i & 31;
      const int grp = i >> 5;
      if constexpr (!kTransposed) {
        // MN-major: unit nc * kTcKs + k holds w0s[u, k0 + k, 8 nc .. 8 nc + 7]
        const int k = (grp & 7) * 8 + (lane & 7);
        const int nc = (grp >> 3) * 4 + (lane >> 3);
        const bool ok = k0 + k < kdim;
        const __nv_bfloat16* src = ok ? w0s + ((long long)u * kdim + k0 + k) * ndim + n0 + 8 * nc : w0s;
        cp_async<16>(smem_u32(bs + nc * kTcKs + k), src, ok ? 16 : 0);
      } else {
        // K-major: unit kc * kTcN + n holds w0s[24 - u, n0 + n, k0 + 8 kc .. + 7]
        const int n = (grp & 15) * 8 + (lane & 7);
        const int kc = (grp >> 4) * 4 + (lane >> 3);
        const bool ok = n0 + n < ndim;
        const __nv_bfloat16* src =
            ok ? w0s + ((long long)(kK2 - 1 - u) * ndim + n0 + n) * kdim + k0 + 8 * kc : w0s;
        cp_async<16>(smem_u32(bs + kc * kTcN + n), src, ok ? 16 : 0);
      }
    }
  };

  // forward: one accumulator across the whole reduction. Transposed: each
  // offset's 4 x 3 wgmma start a fresh d, which is then added into sum with
  // IEEE f32 additions. The tensor cores add their f32 products in their
  // own way, not rounding each addend; over the whole chain of 9,600
  // products per output that drifted several times further from the plain
  // version than conv5_kernel's FMAs, close to this output's 1e-5 bound in
  // chip_smoke.py
  float d[64];
  float sum[kTransposed ? 64 : 1];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kTransposed ? 64 : 1); ++i) sum[i] = 0.f;
  const uint32_t a_base = smem_u32(a_s + wg * kParts * kTcWinUnits);
  const uint32_t b_base = smem_u32(b_s);

  for (int k0 = 0; k0 < kdim; k0 += kTcKs) {
    __syncthreads();  // both warpgroups' products of the previous slice are done
    // the two windows of this slice, chunk-fastest so that a warp reads
    // whole pixels' channel runs
    for (int i = tid; i < kTcWG * kTcWinUnits; i += kTcThreads) {
      const int wi = i / kTcWinUnits;
      const int j = i - wi * kTcWinUnits;
      const int kc = j % kTcKc;
      const int q = j / kTcKc;
      const int wy = q / kWin;
      const int wx = q - wy * kWin;
      const TcTile t = wi ? tile1 : tile0;
      const int k = k0 + 8 * kc;
      uint4* dst = a_s + wi * kParts * kTcWinUnits + (kc * kWin + wy) * kWin + wx;
      if constexpr (!kTransposed) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (t.ok && k < kdim) {
          const int y = clampi(t.oy0 + wy + off, 0, xh - 1);
          const int x = clampi(t.ox0 + wx + off, 0, xw - 1);
          const unsigned short* p =
              static_cast<const unsigned short*>(xv) + ((t.b * xh + y) * xw + x) * kdim + k;
          v = vec ? *reinterpret_cast<const uint4*>(p) : load_bf16x8(p, kdim - k);
        }
        *dst = v;
      } else {
        uint4 u[3] = {};
        const int y = t.oy0 + wy + off;
        const int x = t.ox0 + wx + off;
        if (t.ok && y >= 0 && y < xh && x >= 0 && x < xw) {  // kdim (128) is whole slices
          const float* p = static_cast<const float*>(xv) + ((t.b * xh + y) * xw + x) * kdim + k;
          const float4* p4 = reinterpret_cast<const float4*>(p);
          split3_unit(p4[0], p4[1], u);
        }
#pragma unroll
        for (int pt = 0; pt < 3; ++pt) dst[pt * kTcWinUnits] = u[pt];
      }
    }
    stage_b(u_begin, 0, k0);
    cp_async_commit();
    for (int u = u_begin; u < u_end; ++u) {
      const int buf = (u - u_begin) & 1;
      cp_async_wait_all();
      fence_proxy_async();
      __syncthreads();  // B(u) and the windows are in place; the other buffer's readers are done
      if (u + 1 < u_end) stage_b(u + 1, buf ^ 1, k0);
      cp_async_commit();
      const uint32_t a_u = a_base + ((u / 5) * kWin + u % 5) * 16;
      const uint32_t b_u = b_base + buf * kTcBUnits * 16;
      wgmma_fence();
      fence_acc(d);
#pragma unroll
      for (int kk = 0; kk < kTcKs / 16; ++kk) {
        const uint32_t a_k = a_u + 2 * kk * kTcWinPix * 16;
        if constexpr (!kTransposed) {
          wgmma_m64n128k16<0, 1>(d, gmma_desc(a_k, kTcWinPix * 16, kWin * 16),
                              gmma_desc(b_u + kk * 16 * 16, 8 * 16, kTcKs * 16), 1);
        } else {
          const uint64_t db = gmma_desc(b_u + 2 * kk * kTcN * 16, kTcN * 16, 8 * 16);
#pragma unroll
          for (int pt = 0; pt < 3; ++pt) {
            wgmma_m64n128k16<0, 0>(
                d, gmma_desc(a_k + pt * kTcWinUnits * 16, kTcWinPix * 16, kWin * 16), db,
                kk + pt > 0);
          }
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(d);
      if constexpr (kTransposed) {
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] = __fadd_rn(sum[i], d[i]);
      }
    }
  }
  if constexpr (kTransposed) {
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = sum[i];
  }

  // accumulator layout of m64nNk16: thread (warp w, lane l) holds rows
  // 16 w + l / 4 (+ 8) and columns 8 j + 2 (l % 4) (+ 1)
  const TcTile t = wg ? tile1 : tile0;
  if (!t.ok) return;
  const int warp = (tid & 127) >> 5;
  const int lane = tid & 31;
  float* dst = out + (long long)blockIdx.z * ((long long)bsz * oh * ow * ndim);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int oy = t.oy0 + 2 * warp + half;
    const int ox = t.ox0 + (lane >> 2);
    if (oy >= oh || ox >= ow) continue;
    float* row = dst + ((t.b * oh + oy) * ow + ox) * ndim + n0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (n0 + col < ndim) store_pair(row + col, d[4 * j + 2 * half], d[4 * j + 2 * half + 1]);
    }
  }
}

// One tensor-core 5x5 product into out (splits == 1) or into splits partials
// in part that slice_sum_kernel then adds into out.
template <bool kTransposed>
cudaError_t launch_conv5_tc(const void* x, const void* w0s, float* out, float* part, int b,
                            int xh, int xw, int kdim, int oh, int ow, int ndim, int off,
                            int splits, int vec, cudaStream_t s) {
  if (splits < 1 || splits > kK2 || reinterpret_cast<uintptr_t>(w0s) % 16 != 0 ||
      (kTransposed && (kdim % kTcKs != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0))) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = tc_smem_bytes<kTransposed>();
  HOIG_TRY(cudaFuncSetAttribute(conv5_tc_kernel<kTransposed>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  const long long tiles = (long long)b * ((oh + kT - 1) / kT) * ((ow + kT - 1) / kT);
  const dim3 grid(static_cast<unsigned>((tiles + kTcWG - 1) / kTcWG), (ndim + kTcN - 1) / kTcN,
                  splits);
  conv5_tc_kernel<kTransposed><<<grid, kTcThreads, smem, s>>>(
      x, static_cast<const __nv_bfloat16*>(w0s), splits > 1 ? part : out, b, xh, xw, kdim, oh,
      ow, ndim, off, splits, vec);
  HOIG_TRY(cudaGetLastError());
  if (splits == 1) return cudaSuccess;
  return launch_slice_sum(part, out, (long long)b * oh * ow * ndim, splits, s);
}

// ---------------------------------------------------- dW on the tensor cores
//
// dw_tc_kernel: B4-bwd-a-dw for a bf16 source, the weight gradient of the
// 5x5 correlation G = src_pad * W, as warpgroup matrix multiplies
// (wgmma.mma_async m64n128k16, bf16 operands, f32 accumulators; sm_90a). It
// replaces, with dw_kernel's FP32 form for f32 inputs, hoig_tpu/ops/
// attn_pallas.py `_bwd_a_dw_kernel`. For each offset t = (ty, tx) in
// [-2, 2]^2:
//
//   dW_t[c, f] = sum_q src_pad[q + 2 + t, c] dG[q, f]
//
// over the pixels q of the (H+6) x (W+6) frame of dG (dw_kernel's sum over
// the padded frame less the pixels where dG is zero): a GEMM with M = C, N =
// 128, K = B (H+6) (W+6). The source is exactly bf16. dG is f32, and is
// split when staged into three bf16 parts with hi + mid + lo == dG exactly
// (split3); each k-step runs three wgmma, one per part, against the same
// source operand, so every product is exact in f32 and the three together
// are JAX's f32 product of the widened source and dG (the Pallas kernel's
// dot_general with preferred_element_type f32). Only the order of the f32
// sums differs: each 64-pixel chunk's 12 wgmma start a fresh accumulator,
// which is then added into an IEEE f32 register sum (the tensor cores' own
// f32 sums drift over long K, as in the gsrc projection).
//
// Design. A block owns one offset, 128 channels (two warpgroups, 64 each,
// sharing the staged dG) and a contiguous range of q; it streams its range
// in chunks of 64 pixels, re-reading the shifted source rows for its
// offset. The other design, a block per tile of q with its source window,
// where each offset is only a descriptor's start address (conv5_tc_kernel's
// way), would read dG once instead of 25 times from L2; but each offset
// then needs its own 64 x 128 accumulator and promoted sum (128 registers a
// thread), so a warpgroup could hold one offset and the window would be
// staged again for each. Here the 25 blocks of one (channel tile, range)
// are adjacent in the grid, run together and read the same dG chunk from
// L2 (dG is 36.8 MB at 128^2, within the 50 MB L2), and DRAM sees dG and
// the source about once. Both operands are MN-major (the reduction runs
// over pixels, the outer dimension of NHWC): a 16-byte unit is 8 channels
// (or 8 hidden units) of one pixel, so the source's units are copied as
// they lie (cp.async) and dG's are split element by element anyway; the
// units sit in the no-swizzle core-matrix order [8-wide column][pixel], 8
// pixels' units of one column making a core matrix (leading byte offset
// 128 bytes along K, stride byte offset 1 KB along M or N, as
// conv5_tc_kernel's MN-major B tile). The next chunk is staged into a
// second buffer while the current one's wgmma run. A thread stages one
// pixel of the chunk, 4 of its 16 source columns and 4 of dG's. K is split
// over contiguous ranges of q where the output tiles (25 x C/128) would
// not fill the card (one block per SM: 128 KB of staging, 128 f32 registers
// of accumulators a thread); slice_sum_kernel adds the partials in a fixed
// order, so a second call gives the same bits. Channel tails (C not a
// multiple of 8 or 128) and the q tail are zero-filled in staging.
//
// What bounds it on an H100: 3 x 2 x 25 x C x 128 operations per pixel of
// the frame, 670.8 GFLOP per fused step, 0.68 ms at the tensor cores' 989
// TFLOP/s; the bytes (the source and dG once from DRAM, dW written) are
// under a tenth of that. In this first version the staging (the split and
// the shared-memory stores, 64 KB per chunk) and the chunk's barrier, not
// the tensor cores, bound it.
// kDwPix and kDwCh are read by hoig_torch/ops/attn_fused.py (TILING,
// hoig_attn_fused_tiling) to pick the split-K factor
constexpr int kDwWG = 2;                                  // warpgroups per block
constexpr int kDwThreads = 128 * kDwWG;
constexpr int kDwM = 64;                                  // channels per warpgroup (wgmma M)
constexpr int kDwCh = kDwWG * kDwM;                       // channels per block
constexpr int kDwPix = 64;                                // pixels per staged chunk (K)
constexpr int kDwCols = kDwCh / 8;                        // 16-byte columns of the source per pixel
constexpr int kDwAUnits = kDwCols * kDwPix;               // the source chunk
constexpr int kDwBUnits = kF / 8 * kDwPix;                // one part of the dG chunk
constexpr int kDwStageUnits = kDwAUnits + 3 * kDwBUnits;  // 64 KB
constexpr int kDwSmem = 2 * kDwStageUnits * 16;           // two stages
static_assert(kDwThreads == 4 * kDwPix && kDwCols == 16 && kF / 8 == 16,
              "a thread stages one pixel and 4 of 16 columns of each operand");

__global__ void __launch_bounds__(kDwThreads, 1)
dw_tc_kernel(const __nv_bfloat16* __restrict__ src, const float* __restrict__ dg,
             float* __restrict__ out, int h, int w, int c, long long n_q, long long per_split,
             int vec) {
  extern __shared__ __align__(128) uint4 dw_smem[];  // [2][source | hi | mid | lo]
  const int tid = threadIdx.x;
  const int wgi = tid >> 7;
  const int t = blockIdx.x;
  const int ty = t / 5 - 2;
  const int tx = t % 5 - 2;
  const int c0 = blockIdx.y * kDwCh;
  const long long q_begin = (long long)blockIdx.z * per_split;
  const long long q_end = min(n_q, q_begin + per_split);
  const int hg = h + 2 * kHalo;
  const int wgr = w + 2 * kHalo;
  // the pixel this thread stages (8 neighbouring pixels per quarter warp, so
  // that a warp writes whole 128-byte rows of shared memory) and its columns
  const int k = (tid >> 5) * 8 + (tid & 7);
  const int col0 = (tid >> 3) & 3;  // columns col0 + 4 r, r = 0..3

  auto stage = [&](long long q0, int buf) {
    uint4* const a_s = dw_smem + buf * kDwStageUnits;
    uint4* const b_s = a_s + kDwAUnits;
    const long long q = q0 + k;
    if (q >= q_end) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int col = col0 + 4 * r;
        a_s[col * kDwPix + k] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int pt = 0; pt < 3; ++pt) {
          b_s[pt * kDwBUnits + col * kDwPix + k] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      return;
    }
    const int qx = static_cast<int>(q % wgr);
    const int qy = static_cast<int>((q / wgr) % hg);
    const long long bb = q / ((long long)hg * wgr);
    // src_pad[q + 2 + t] is src[q + t - 3], clamped to the frame
    const int sy = clampi(qy + ty - kHalo, 0, h - 1);
    const int sx = clampi(qx + tx - kHalo, 0, w - 1);
    const __nv_bfloat16* sp = src + ((bb * h + sy) * w + sx) * c;
    const float* gp = dg + q * kF;
    float4 g[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      g[r][0] = *reinterpret_cast<const float4*>(gp + 8 * (col0 + 4 * r));
      g[r][1] = *reinterpret_cast<const float4*>(gp + 8 * (col0 + 4 * r) + 4);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int col = col0 + 4 * r;
      const int ch = c0 + 8 * col;
      uint4* dst = a_s + col * kDwPix + k;
      if (vec) {
        cp_async<16>(smem_u32(dst), ch < c ? sp + ch : src, ch < c ? 16 : 0);
      } else {
        *dst = load_bf16x8(reinterpret_cast<const unsigned short*>(sp) + ch, c - ch);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint4 u[3];
      split3_unit(g[r][0], g[r][1], u);
#pragma unroll
      for (int pt = 0; pt < 3; ++pt) b_s[pt * kDwBUnits + (col0 + 4 * r) * kDwPix + k] = u[pt];
    }
  };

  float d[64];
  float sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = sum[i] = 0.f;
  const uint32_t base = smem_u32(dw_smem);
  const long long n_chunks = q_end > q_begin ? (q_end - q_begin + kDwPix - 1) / kDwPix : 0;
  if (n_chunks > 0) stage(q_begin, 0);
  cp_async_commit();
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();
  for (long long i = 0; i < n_chunks; ++i) {
    const int buf = static_cast<int>(i & 1);
    const uint32_t a_u = base + (buf * kDwStageUnits + wgi * (kDwM / 8) * kDwPix) * 16;
    const uint32_t b_u = base + (buf * kDwStageUnits + kDwAUnits) * 16;
    wgmma_fence();
    fence_acc(d);
#pragma unroll
    for (int kk = 0; kk < kDwPix / 16; ++kk) {
      const uint64_t da = gmma_desc(a_u + kk * 16 * 16, 8 * 16, kDwPix * 16);
#pragma unroll
      for (int pt = 0; pt < 3; ++pt) {
        wgmma_m64n128k16<1, 1>(d, da, gmma_desc(b_u + (pt * kDwBUnits + kk * 16) * 16, 8 * 16,
                                                kDwPix * 16),
                               kk + pt > 0);
      }
    }
    wgmma_commit();
    // the next chunk into the other stage while the tensor cores run
    if (i + 1 < n_chunks) stage(q_begin + (i + 1) * kDwPix, buf ^ 1);
    cp_async_commit();
    wgmma_wait_all();
    fence_acc(d);
#pragma unroll
    for (int j = 0; j < 64; ++j) sum[j] = __fadd_rn(sum[j], d[j]);
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // the next stage is in place; this one's readers are done
  }

  // accumulator layout of m64nNk16: thread (warp w, lane l) holds rows
  // (channels) 16 w + l / 4 (+ 8) and columns (hidden units) 8 j + 2 (l % 4) (+ 1)
  const int warp = (tid & 127) >> 5;
  const int lane = tid & 31;
  float* dst = out + ((long long)blockIdx.z * kK2 + t) * c * kF;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int ch = c0 + wgi * kDwM + 16 * warp + 8 * half + (lane >> 2);
    if (ch >= c) continue;
    float* row = dst + (long long)ch * kF;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      store_pair(row + 8 * j + 2 * (lane & 3), sum[4 * j + 2 * half], sum[4 * j + 2 * half + 1]);
    }
  }
}

// phases A-tail, B and C from G
template <typename T>
cudaError_t launch_fwd_pixel(const void* src, const void* acc0, const void* w1, const void* b1,
                             const void* fy, const void* fx, const void* wy, const void* wx,
                             const float* g, void* out, void* acc, void* attn, int b, int h, int w,
                             int c, cudaStream_t s) {
  const long long n_pix = (long long)b * h * w;
  fwd_pixel_kernel<T><<<(unsigned)((n_pix + kPixPerBlock - 1) / kPixPerBlock), kThreads, 0, s>>>(
      static_cast<const T*>(src), static_cast<const float*>(acc0), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(fy), static_cast<const float*>(fx),
      static_cast<const float*>(wy), static_cast<const float*>(wx), g, static_cast<T*>(out),
      static_cast<float*>(acc), static_cast<float*>(attn), n_pix, h, w, c);
  return cudaGetLastError();
}

// f32: G as FP32
int fwd(const void* src, const void* acc0, const void* w0s, const void* w1, const void* b1,
        const void* fy, const void* fx, const void* wy, const void* wx, void* out, void* acc,
        void* attn, void* g, int b, int h, int w, int c, cudaStream_t s) {
  float* g_ = static_cast<float*>(g);
  HOIG_TRY(launch_conv5<false>(static_cast<const float*>(src), static_cast<const float*>(w0s), g_,
                               b, h, w, c, h + 2 * kHalo, w + 2 * kHalo, kF, -kPad, s));
  return launch_fwd_pixel<float>(src, acc0, w1, b1, fy, fx, wy, wx, g_, out, acc, attn, b, h, w, c,
                                 s);
}

// bf16: G on the tensor cores
int fwd_tc(const void* src, const void* acc0, const void* w0s, const void* w1, const void* b1,
           const void* fy, const void* fx, const void* wy, const void* wx, void* out, void* acc,
           void* attn, void* g, void* part, int b, int h, int w, int c, int splits,
           cudaStream_t s) {
  float* g_ = static_cast<float*>(g);
  const int vec = c % 8 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  HOIG_TRY(launch_conv5_tc<false>(src, w0s, g_, static_cast<float*>(part), b, h, w, c,
                                  h + 2 * kHalo, w + 2 * kHalo, kF, -kPad, splits, vec, s));
  return launch_fwd_pixel<__nv_bfloat16>(src, acc0, w1, b1, fy, fx, wy, wx, g_, out, acc, attn, b,
                                         h, w, c, s);
}

// bwd_c_kernel over (tiles, channel groups, images), then bwd_c_gattn_kernel
template <typename T, int kUnit>
cudaError_t launch_bwd_c(const void* src, const float* fy, const float* fx, const float* wy,
                         const float* wx, const void* attn, const void* gout, void* gsrc,
                         float* part, int b, int h, int w, int c, int groups, cudaStream_t s) {
  constexpr int smem = bc_smem_bytes<T>();
  HOIG_TRY(cudaFuncSetAttribute(bwd_c_kernel<T, kUnit>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem));
  const dim3 grid(((h + kBcT - 1) / kBcT) * ((w + kBcT - 1) / kBcT), groups, b);
  bwd_c_kernel<T, kUnit><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(src), fy, fx, wy, wx, static_cast<const float*>(attn),
      static_cast<const T*>(gout), static_cast<float*>(gsrc), part, h, w, c);
  return cudaGetLastError();
}

template <typename T>
int bwd_c(const void* src, const void* fy, const void* fx, const void* wy, const void* wx,
          const void* attn, const void* gout, void* gsrc, void* gattn, void* part, int b, int h,
          int w, int c, int groups, cudaStream_t s) {
  const float* fy_ = static_cast<const float*>(fy);
  const float* fx_ = static_cast<const float*>(fx);
  const float* wy_ = static_cast<const float*>(wy);
  const float* wx_ = static_cast<const float*>(wx);
  float* part_ = static_cast<float*>(part);
  const bool vec = c % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(gout) % 16 == 0;
  HOIG_TRY(vec ? launch_bwd_c<T, 16>(src, fy_, fx_, wy_, wx_, attn, gout, gsrc, part_, b, h, w, c,
                                     groups, s)
               : launch_bwd_c<T, 2 * static_cast<int>(sizeof(T))>(src, fy_, fx_, wy_, wx_, attn, gout, gsrc, part_,
                                                b, h, w, c, groups, s));
  const long long n_pix = (long long)b * h * w;
  bwd_c_gattn_kernel<<<(unsigned)((n_pix * kK2 + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      part_, fy_, fx_, wy_, wx_, static_cast<float*>(gattn), n_pix, groups);
  return cudaGetLastError();
}

// f32 weights: the projection as FP32
int bwd_a_gsrc(const void* gacc, const void* fy, const void* fx, const void* wy, const void* wx,
               const void* w0s, void* gsrc, void* dg, void* gpad, int b, int h, int w, int c,
               cudaStream_t s) {
  float* dg_ = static_cast<float*>(dg);
  float* gpad_ = static_cast<float*>(gpad);
  HOIG_TRY(launch_dg(static_cast<const float*>(gacc), static_cast<const float*>(fy),
                     static_cast<const float*>(fx), static_cast<const float*>(wy),
                     static_cast<const float*>(wx), dg_, b, h, w, s));
  HOIG_TRY(launch_conv5<true>(dg_, static_cast<const float*>(w0s), gpad_, b, h + 2 * kHalo,
                              w + 2 * kHalo, kF, h + 2 * kPad, w + 2 * kPad, c, -4, s));
  return launch_fold(gpad_, static_cast<float*>(gsrc), b, h, w, c, s);
}

// bf16 weights: the projection on the tensor cores, dG split in three
int bwd_a_gsrc_tc(const void* gacc, const void* fy, const void* fx, const void* wy, const void* wx,
                  const void* w0s, void* gsrc, void* dg, void* gpad, void* part, int b, int h,
                  int w, int c, int splits, cudaStream_t s) {
  float* dg_ = static_cast<float*>(dg);
  float* gpad_ = static_cast<float*>(gpad);
  HOIG_TRY(launch_dg(static_cast<const float*>(gacc), static_cast<const float*>(fy),
                     static_cast<const float*>(fx), static_cast<const float*>(wy),
                     static_cast<const float*>(wx), dg_, b, h, w, s));
  HOIG_TRY(launch_conv5_tc<true>(dg_, w0s, gpad_, static_cast<float*>(part), b, h + 2 * kHalo,
                                 w + 2 * kHalo, kF, h + 2 * kPad, w + 2 * kPad, c, -4, splits, 0,
                                 s));
  return launch_fold(gpad_, static_cast<float*>(gsrc), b, h, w, c, s);
}

// f32 source: dW as FP32
int bwd_a_dw(const void* src, const void* dg, void* dw, void* part, int b, int h, int w, int c,
             int slices, cudaStream_t s) {
  float* part_ = static_cast<float*>(part);
  const long long n_pos = (long long)b * (h + 2 * kPad) * (w + 2 * kPad);
  const long long per_slice = ((n_pos + slices - 1) / slices + kMc - 1) / kMc * kMc;
  const dim3 grid(kK2, (c + kCt - 1) / kCt, slices);
  dw_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(src), static_cast<const float*>(dg),
                                      part_, h, w, c, n_pos, per_slice);
  HOIG_TRY(cudaGetLastError());
  return launch_slice_sum(part_, static_cast<float*>(dw), (long long)kK2 * c * kF, slices, s);
}

// bf16 source: dW on the tensor cores, into dw (splits == 1) or into splits
// partials in part that slice_sum_kernel then adds into dw
int bwd_a_dw_tc(const void* src, const void* dg, void* dw, void* part, int b, int h, int w, int c,
                int splits, cudaStream_t s) {
  if (reinterpret_cast<uintptr_t>(dg) % 16 != 0) return cudaErrorInvalidValue;
  HOIG_TRY(
      cudaFuncSetAttribute(dw_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDwSmem));
  const long long n_q = (long long)b * (h + 2 * kHalo) * (w + 2 * kHalo);
  const long long per_split = ((n_q + splits - 1) / splits + kDwPix - 1) / kDwPix * kDwPix;
  const int vec = c % 8 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const dim3 grid(kK2, (c + kDwCh - 1) / kDwCh, splits);
  float* out = static_cast<float*>(splits > 1 ? part : dw);
  dw_tc_kernel<<<grid, kDwThreads, kDwSmem, s>>>(static_cast<const __nv_bfloat16*>(src),
                                                 static_cast<const float*>(dg), out, h, w, c, n_q,
                                                 per_split, vec);
  HOIG_TRY(cudaGetLastError());
  if (splits == 1) return cudaSuccess;
  return launch_slice_sum(out, static_cast<float*>(dw), (long long)kK2 * c * kF, splits, s);
}

}  // namespace

extern "C" int hoig_attn_fused_fwd(const void* src, const void* acc0, const void* w0s,
                                   const void* w1, const void* b1, const void* fy, const void* fx,
                                   const void* wy, const void* wx, void* out, void* acc,
                                   void* attn, void* g, int b, int h, int w, int c, int is_bf16,
                                   void* stream) {
  // f32 only: a bf16 source takes hoig_attn_fused_fwd_tc
  if (bad_dims(b, h, w, c) || is_bf16) return cudaErrorInvalidValue;
  return fwd(src, acc0, w0s, w1, b1, fy, fx, wy, wx, out, acc, attn, g, b, h, w, c,
             static_cast<cudaStream_t>(stream));
}

// bf16 only: phase A's product G on the tensor cores (conv5_tc_kernel);
// part: splits x (B, H+6, W+6, 128) f32 partials when splits > 1
extern "C" int hoig_attn_fused_fwd_tc(const void* src, const void* acc0, const void* w0s,
                                      const void* w1, const void* b1, const void* fy,
                                      const void* fx, const void* wy, const void* wx, void* out,
                                      void* acc, void* attn, void* g, void* part, int b, int h,
                                      int w, int c, int splits, void* stream) {
  if (bad_dims(b, h, w, c)) return cudaErrorInvalidValue;
  return fwd_tc(src, acc0, w0s, w1, b1, fy, fx, wy, wx, out, acc, attn, g, part, b, h, w, c,
                splits, static_cast<cudaStream_t>(stream));
}

// part: groups x (B*H*W) x 36 f32, the channel groups' partial g_attn dots;
// groups must be ceil(C / 64), the wrapper's count of bwd_c_kernel's blocks
extern "C" int hoig_attn_fused_bwd_c(const void* src, const void* fy, const void* fx,
                                     const void* wy, const void* wx, const void* attn,
                                     const void* gout, void* gsrc, void* gattn, void* part, int b,
                                     int h, int w, int c, int groups, int is_bf16, void* stream) {
  if (bad_dims(b, h, w, c) || groups != (c + kBcCh - 1) / kBcCh || groups > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return bwd_c<__nv_bfloat16>(src, fy, fx, wy, wx, attn, gout, gsrc, gattn, part, b, h, w, c,
                                groups, s);
  }
  return bwd_c<float>(src, fy, fx, wy, wx, attn, gout, gsrc, gattn, part, b, h, w, c, groups, s);
}

extern "C" int hoig_attn_fused_bwd_a_gsrc(const void* gacc, const void* fy, const void* fx,
                                          const void* wy, const void* wx, const void* w0s,
                                          void* gsrc, void* dg, void* gpad, int b, int h, int w,
                                          int c, int is_bf16, void* stream) {
  // f32 only: bf16 weights take hoig_attn_fused_bwd_a_gsrc_tc
  if (bad_dims(b, h, w, c) || is_bf16) return cudaErrorInvalidValue;
  return bwd_a_gsrc(gacc, fy, fx, wy, wx, w0s, gsrc, dg, gpad, b, h, w, c,
                    static_cast<cudaStream_t>(stream));
}

// bf16 weights only: the gsrc projection on the tensor cores (conv5_tc_kernel,
// dG split in three); part: splits x (B, H+10, W+10, C) f32 when splits > 1
extern "C" int hoig_attn_fused_bwd_a_gsrc_tc(const void* gacc, const void* fy, const void* fx,
                                             const void* wy, const void* wx, const void* w0s,
                                             void* gsrc, void* dg, void* gpad, void* part, int b,
                                             int h, int w, int c, int splits, void* stream) {
  if (bad_dims(b, h, w, c)) return cudaErrorInvalidValue;
  return bwd_a_gsrc_tc(gacc, fy, fx, wy, wx, w0s, gsrc, dg, gpad, part, b, h, w, c, splits,
                       static_cast<cudaStream_t>(stream));
}

// f32 only: a bf16 source takes hoig_attn_fused_bwd_a_dw_tc. dg: the
// (B, H+6, W+6, 128) f32 dG that hoig_attn_fused_bwd_a_gsrc(_tc) wrote;
// part: slices x (25, C, 128) f32
extern "C" int hoig_attn_fused_bwd_a_dw(const void* src, const void* dg, void* dw, void* part,
                                        int b, int h, int w, int c, int slices, int is_bf16,
                                        void* stream) {
  if (bad_dims(b, h, w, c) || is_bf16 || slices < 1 || slices > 65535) return cudaErrorInvalidValue;
  return bwd_a_dw(src, dg, dw, part, b, h, w, c, slices, static_cast<cudaStream_t>(stream));
}

// bf16 source only: dW on the tensor cores (dw_tc_kernel, dG split in
// three); part: splits x (25, C, 128) f32 when splits > 1
extern "C" int hoig_attn_fused_bwd_a_dw_tc(const void* src, const void* dg, void* dw, void* part,
                                           int b, int h, int w, int c, int splits, void* stream) {
  if (bad_dims(b, h, w, c) || splits < 1 || splits > 65535) return cudaErrorInvalidValue;
  return bwd_a_dw_tc(src, dg, dw, part, b, h, w, c, splits, static_cast<cudaStream_t>(stream));
}

// The tile constants that hoig_torch/ops/attn_fused.py repeats (TILING) to
// pick its split-K factors and size bwd_c's partials, in TILING's order:
// conv5_tc_kernel's tile edge, tiles per block and outputs per block;
// dw_tc_kernel's pixels per chunk and channels per block; dw_kernel's
// channels per block; bwd_c_kernel's tile edge and channels per block.
// Writes at most n of them to out and returns how many there are.
extern "C" int hoig_attn_fused_tiling(int* out, int n) {
  const int v[] = {kT, kTcWG, kTcN, kDwPix, kDwCh, kCt, kBcT, kBcCh};
  constexpr int kCount = sizeof(v) / sizeof(v[0]);
  for (int i = 0; i < n && i < kCount; ++i) out[i] = v[i];
  return kCount;
}

extern "C" const char* hoig_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
