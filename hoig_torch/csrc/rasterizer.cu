// Tiled z-buffer rasterizer (face-index map), for sm_90a.
//
// For every pixel (xi, yi) of an S x S image, with NDC centre
// (xp, yp) = ((2 xi + 1 - S) / S, (2 yi + 1 - S) / S), the kernels find the
// face whose three edge functions  e . (xp, yp, 1)  are all >= 0 and whose
// inverse-depth plane  iz = z0 xi + z1 yi + z2  lies in (1/far, 1/near) and
// is the largest; ties go to the lowest face index, background is -1. Face
// setup (edge lines, inverse-depth planes, bounding boxes, the keep mask
// folded into the boxes) and the winner finish stay in PyTorch, as in the
// JAX package.
//
// Replaces: hoig_tpu/ops/rasterizer_pallas.py:_raster_kernel (Pallas, TPU),
// which swept (32 x 128)-pixel tiles over 128-face chunks laid on the vector
// sublanes and skipped whole chunks by a bounding-box test. Here the culling
// is done once per call, into a list of faces per 8 x 8 pixel tile, and a
// tile's pixels walk only the faces of its list. Two kernels:
//
//   bin_kernel: a warp per (image, face). It packs the face's 16 floats (9
//     edge coefficients, 3 plane coefficients, the box) into one 64-byte
//     record, and appends the face to the list of every tile its box meets
//     (the tile's outer pixel centres padded by one pixel pitch) unless one
//     of its edge functions lies below a rounding margin at all four corner
//     pixel centres of the tile (then it covers no pixel there), a lane per
//     tile: an atomic count per tile, lists of fixed capacity `cap`.
//   raster_kernel: a block per (image, tile), a thread per pixel. The
//     tile's faces come 64 at a time into shared memory (one record each);
//     every pixel tests each of them, without branches (the three edge
//     tests, the depth range and the winner rule as one predicate). A tile
//     whose count passed `cap` walks all faces instead and keeps those
//     whose box meets it: a larger set with the same winners.
//
// The list order follows the atomics and varies from run to run, so the
// winner rule does not depend on it: a candidate wins if its inverse depth
// is larger, or equal with a lower face index. That picks what ascending
// order with a strict '>' picks, as the plain version does.
//
// What bounds it on an H100: the image and the face tables are a few MB, so
// device-memory traffic is negligible; the cost is the (pixel, listed face)
// pairs, each three edge tests and one plane evaluation on the FP32 pipes.
// The corner test of bin_kernel keeps 12.1 M of the 28.3 M pairs of the
// tiles that the boxes meet on the serving path's scene (chip_smoke.py
// prints both counts). Probes of other layouts were slower on an H100: a
// thread per listed face testing all 64 pixels with an atomic maximum of
// (depth, index) keys (short lists leave most threads idle), two pixels a
// thread sharing their column's products, and a per-warp cull of the faces
// whose box misses the warp's rows.
//
// Numerics: every plane is evaluated as ((a * x) + (b * y)) + c with separately
// rounded products (this file is built with -fmad=false and uses __fmul_rn /
// __fadd_rn), the order of the plain PyTorch version, so the face-index maps
// agree bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8;                 // tile edge (pixels)
constexpr int kThreads = kTile * kTile;  // raster_kernel: a thread per pixel
constexpr int kChunk = kThreads;         // faces staged per pass
constexpr int kRec = 16;                 // floats of a face record
constexpr int kBinThreads = 256;         // bin_kernel: 8 faces a block

__device__ __forceinline__ float plane(float a, float b, float c, float x, float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, a), __fmul_rn(y, b)), c);
}

__device__ __forceinline__ float ndc(int i, float s) {
  return __fdiv_rn(__fsub_rn(__fadd_rn(__fmul_rn(2.f, (float)i), 1.f), s), s);
}

// the NDC span of tile t along one axis: its outer pixel centres padded by
// one pixel pitch (ascending in t)
__device__ __forceinline__ float tile_lo(int t, float s) { return ndc(t * kTile, s) - 2.f / s; }
__device__ __forceinline__ float tile_hi(int t, float s) {
  return ndc(t * kTile + kTile - 1, s) + 2.f / s;
}

__global__ void __launch_bounds__(kBinThreads)
bin_kernel(const float* __restrict__ edge,  // (B, F, 9)
           const float* __restrict__ izp,   // (B, F, 3)
           const float* __restrict__ bbox,  // (B, F, 4): xmin, xmax, ymin, ymax
           float* __restrict__ recs,        // (B, F, 16)
           int* __restrict__ counts,        // (B, T * T), zero on entry
           int* __restrict__ lists,         // (B, T * T, cap)
           int b, int f, int s, int cap) {
  const int lane = threadIdx.x & 31;
  const long long face = (static_cast<long long>(blockIdx.x) * kBinThreads + threadIdx.x) >> 5;
  if (face >= static_cast<long long>(b) * f) return;  // whole warps
  float val = 0.f;
  if (lane < 9) {
    val = edge[face * 9 + lane];
  } else if (lane < 12) {
    val = izp[face * 3 + lane - 9];
  } else if (lane < kRec) {
    val = bbox[face * 4 + lane - 12];
  }
  if (lane < kRec) recs[face * kRec + lane] = val;
  float e[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) e[k] = __shfl_sync(0xffffffffu, val, k);
  const float xmin = __shfl_sync(0xffffffffu, val, 12);
  const float xmax = __shfl_sync(0xffffffffu, val, 13);
  const float ymin = __shfl_sync(0xffffffffu, val, 14);
  const float ymax = __shfl_sync(0xffffffffu, val, 15);

  // tiles t with tile_hi(t) >= lo_edge and tile_lo(t) <= hi_edge: a range,
  // as both spans ascend with t; found from a guess by the exact tests
  const int tiles = (s + kTile - 1) / kTile;
  const float fs = (float)s;
  auto range = [&](float lo_edge, float hi_edge, int& first, int& last) {
    first = tiles;
    last = -1;
    if (!(tile_hi(tiles - 1, fs) >= lo_edge && tile_lo(0, fs) <= hi_edge)) return;  // or NaN
    // pixel coordinate of an NDC value: (x s + s - 1) / 2
    const float p_lo = (lo_edge * fs + fs - 1.f) * 0.5f;
    const float p_hi = (hi_edge * fs + fs - 1.f) * 0.5f;
    first = min(tiles - 1, max(0, static_cast<int>(floorf(p_lo / kTile))));
    last = min(tiles - 1, max(0, static_cast<int>(floorf(p_hi / kTile))));
    while (first > 0 && tile_hi(first - 1, fs) >= lo_edge) --first;
    while (first < tiles && tile_hi(first, fs) < lo_edge) ++first;
    while (last < tiles - 1 && tile_lo(last + 1, fs) <= hi_edge) ++last;
    while (last >= 0 && tile_lo(last, fs) > hi_edge) --last;
  };
  int x0, x1, y0, y1;
  range(xmin, xmax, x0, x1);
  range(ymin, ymax, y0, y1);
  const int nx = x1 - x0 + 1;
  const int ny = y1 - y0 + 1;
  if (nx <= 0 || ny <= 0) return;
  const long long img = face / f;
  const int id = static_cast<int>(face - img * f);
  for (int i = lane; i < nx * ny; i += 32) {
    const int tx = x0 + i % nx;
    const int ty = y0 + i / nx;
    // An edge function is linear: where its values as evaluated at the
    // tile's four corner pixel centres all lie below -margin, its exact
    // values lie below zero on the whole tile, and so do its values as
    // evaluated at every pixel centre there (each evaluation rounds by at
    // most 3.01 units in the last place of |a x| + |b y| + |c|; the margin
    // is 16 of them, |x| and |y| bounded by the corners'): the face covers
    // no pixel of the tile.
    const float cx[2] = {ndc(tx * kTile, fs), ndc(tx * kTile + kTile - 1, fs)};
    const float cy[2] = {ndc(ty * kTile, fs), ndc(ty * kTile + kTile - 1, fs)};
    const float ax = fmaxf(fabsf(cx[0]), fabsf(cx[1]));
    const float ay = fmaxf(fabsf(cy[0]), fabsf(cy[1]));
    bool misses = false;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float a = e[3 * k], bb = e[3 * k + 1], c = e[3 * k + 2];
      const float margin = 16.f * 5.9604645e-8f * (fabsf(a) * ax + fabsf(bb) * ay + fabsf(c));
      float top = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) top = fmaxf(top, plane(a, bb, c, cx[j & 1], cy[j >> 1]));
      misses |= top < -margin;
    }
    if (misses) continue;
    const long long t = img * tiles * tiles + ty * tiles + tx;
    const int slot = atomicAdd(counts + t, 1);
    if (slot < cap) lists[t * cap + slot] = id;
  }
}

__global__ void __launch_bounds__(kThreads)
raster_kernel(const float* __restrict__ recs,  // (B, F, 16)
              const int* __restrict__ counts,  // (B, T * T)
              const int* __restrict__ lists,   // (B, T * T, cap)
              int* __restrict__ idx_out,       // (B, S, S)
              int f, int s, int cap, float iz_lo, float iz_hi) {
  __shared__ float4 face_s[kChunk][3];  // edges 0-3 | edges 4-7 | edge 8, plane
  __shared__ int id_s[kChunk];

  const int tiles = (s + kTile - 1) / kTile;
  const int tx = blockIdx.x % tiles;
  const int ty = blockIdx.x / tiles;
  const long long b = blockIdx.y;
  const long long t = b * tiles * tiles + blockIdx.x;
  const int tid = threadIdx.x;
  const int px = tx * kTile + tid % kTile;
  const int py = ty * kTile + tid / kTile;
  const float fs = (float)s;
  const float xi = (float)px;
  const float yi = (float)py;
  const float xp = ndc(px, fs);
  const float yp = ndc(py, fs);

  const int count = counts[t];
  const bool all = count > cap;  // the list overflowed: walk every face
  const int n = all ? f : count;
  const int* const list = lists + t * cap;
  const float4* const recs_b = reinterpret_cast<const float4*>(recs + b * f * kRec);

  float best_iz = -1e10f;
  int best = -1;
  for (int base = 0; base < n; base += kChunk) {
    __syncthreads();  // the previous chunk is consumed
    const int j = base + tid;
    int id = -1;
    if (j < n) {
      id = all ? j : list[j];
      const float4* r = recs_b + static_cast<long long>(id) * (kRec / 4);
      face_s[tid][0] = r[0];
      face_s[tid][1] = r[1];
      face_s[tid][2] = r[2];
      if (all) {
        const float4 box = r[3];
        if (!(box.x <= tile_hi(tx, fs) && box.y >= tile_lo(tx, fs) && box.z <= tile_hi(ty, fs) &&
              box.w >= tile_lo(ty, fs))) {
          id = -1;
        }
      }
    }
    id_s[tid] = id;
    __syncthreads();

    const int m = min(kChunk, n - base);
#pragma unroll 4
    for (int k = 0; k < m; ++k) {
      const int fid = id_s[k];
      if (fid < 0) continue;
      const float4 e0 = face_s[k][0];
      const float4 e1 = face_s[k][1];
      const float4 e2 = face_s[k][2];
      const float a0 = plane(e0.x, e0.y, e0.z, xp, yp);
      const float a1 = plane(e0.w, e1.x, e1.y, xp, yp);
      const float a2 = plane(e1.z, e1.w, e2.x, xp, yp);
      const float iz = plane(e2.y, e2.z, e2.w, xi, yi);
      const bool win = (a0 >= 0.f) & (a1 >= 0.f) & (a2 >= 0.f) & (iz > iz_lo) & (iz < iz_hi) &
                       ((iz > best_iz) | ((iz == best_iz) & (fid < best)));
      best_iz = win ? iz : best_iz;
      best = win ? fid : best;
    }
  }
  if (px < s && py < s) idx_out[(b * s + py) * s + px] = best;
}

}  // namespace

// recs (B, F, 16) f32, counts (B, T * T) int32 zeroed by the caller, lists
// (B, T * T, cap) int32 with T = ceil(S / tile): scratch; tile must be the
// kernels' tile edge
extern "C" int hoig_rasterize_zbuffer(const void* edge, const void* izp, const void* bbox,
                                      void* recs, void* counts, void* lists, void* idx_out, int b,
                                      int f, int s, int tile, int cap, float iz_lo, float iz_hi,
                                      void* stream) {
  if (tile != kTile || b < 1 || b > 65535 || f < 1 || s < 1 || cap < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (s + kTile - 1) / kTile;
  const long long warps = static_cast<long long>(b) * f;
  const long long bin_blocks = (warps * 32 + kBinThreads - 1) / kBinThreads;
  if (bin_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  bin_kernel<<<static_cast<unsigned>(bin_blocks), kBinThreads, 0, st>>>(
      static_cast<const float*>(edge), static_cast<const float*>(izp),
      static_cast<const float*>(bbox), static_cast<float*>(recs), static_cast<int*>(counts),
      static_cast<int*>(lists), b, f, s, cap);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  raster_kernel<<<dim3(tiles * tiles, b), kThreads, 0, st>>>(
      static_cast<const float*>(recs), static_cast<const int*>(counts),
      static_cast<const int*>(lists), static_cast<int*>(idx_out), f, s, cap, iz_lo, iz_hi);
  return cudaGetLastError();
}

extern "C" const char* hoig_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
