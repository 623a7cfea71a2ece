// Tiled z-buffer rasterizer (face-index map), for sm_90a.
//
// For every pixel (xi, yi) of an S x S image, with NDC centre
// (xp, yp) = ((2 xi + 1 - S) / S, (2 yi + 1 - S) / S), the kernel finds the face
// whose three edge functions  e . (xp, yp, 1)  are all >= 0 and whose
// inverse-depth plane  iz = z0 xi + z1 yi + z2  lies in (1/far, 1/near) and is
// the largest; ties go to the lowest face index, background is -1. Face setup
// (edge lines, inverse-depth planes, bounding boxes, the keep mask folded into
// the boxes) and the winner finish stay in PyTorch, as in the JAX package.
//
// Replaces: hoig_tpu/ops/rasterizer_pallas.py:_raster_kernel (Pallas, TPU),
// which swept (32 x 128)-pixel tiles over 128-face chunks laid on the vector
// sublanes and skipped whole chunks by a bounding-box test. Here a block owns a
// 16 x 16 pixel tile, one thread per pixel; faces stream through shared memory
// in chunks of 256, and each chunk is compacted, in ascending face order, to
// the faces whose box meets the tile, so a thread evaluates only those.
//
// What bounds it on an H100: the image and the face tables are a few MB, so
// HBM traffic is negligible; the cost is the (pixel, candidate face) pairs,
// each 3 edge tests and one plane evaluation on the FP32 pipes. Culling per
// face rather than per chunk cuts those pairs to the faces whose box covers
// the tile; a candidate is one broadcast shared-memory read per warp.
//
// Numerics: every plane is evaluated as ((a * x) + (b * y)) + c with separately
// rounded products (this file is built with -fmad=false and uses __fmul_rn /
// __fadd_rn), the order of the plain PyTorch version, so the face-index maps
// agree bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;               // tile edge (pixels)
constexpr int kThreads = kTile * kTile;  // one thread per pixel
constexpr int kChunk = kThreads;        // faces staged per pass
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float plane(float a, float b, float c, float x, float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, a), __fmul_rn(y, b)), c);
}

__device__ __forceinline__ float ndc(int i, float s) {
  return __fdiv_rn(__fsub_rn(__fadd_rn(__fmul_rn(2.f, (float)i), 1.f), s), s);
}

__global__ void __launch_bounds__(kThreads)
raster_kernel(const float* __restrict__ edge,  // (B, F, 9)
              const float* __restrict__ izp,   // (B, F, 3)
              const float* __restrict__ bbox,  // (B, F, 4): xmin, xmax, ymin, ymax
              int* __restrict__ idx_out,       // (B, S, S)
              int f, int s, float iz_lo, float iz_hi) {
  __shared__ float e_s[kChunk * 9];
  __shared__ float z_s[kChunk * 3];
  __shared__ int id_s[kChunk];
  __shared__ int warp_count[kWarps];
  __shared__ int n_live;

  const long long b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int px = blockIdx.x * kTile + tid % kTile;
  const int py = blockIdx.y * kTile + tid / kTile;
  const float fs = (float)s;
  const float xi = (float)px;
  const float yi = (float)py;
  const float xp = ndc(px, fs);
  const float yp = ndc(py, fs);

  // tile bounds in NDC: outer pixel centres padded by one pixel pitch
  const float pitch = 2.f / fs;
  const float tx0 = ndc(blockIdx.x * kTile, fs) - pitch;
  const float tx1 = ndc(blockIdx.x * kTile + kTile - 1, fs) + pitch;
  const float ty0 = ndc(blockIdx.y * kTile, fs) - pitch;
  const float ty1 = ndc(blockIdx.y * kTile + kTile - 1, fs) + pitch;

  const float* edge_b = edge + b * f * 9;
  const float* izp_b = izp + b * f * 3;
  const float* bbox_b = bbox + b * f * 4;

  float best_iz = -1e10f;
  int best = -1;
  for (int base = 0; base < f; base += kChunk) {
    // order-preserving compaction of this chunk's faces that meet the tile
    const int fi = base + tid;
    bool live = false;
    if (fi < f) {
      const float* bb = bbox_b + (long long)fi * 4;
      live = bb[0] <= tx1 && bb[1] >= tx0 && bb[2] <= ty1 && bb[3] >= ty0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    __syncthreads();  // previous chunk fully consumed
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    if (tid == 0) {
      int run = 0;
      for (int i = 0; i < kWarps; ++i) {
        const int n = warp_count[i];
        warp_count[i] = run;
        run += n;
      }
      n_live = run;
    }
    __syncthreads();
    if (live) {
      const int slot = warp_count[warp] + __popc(ballot & ((1u << lane) - 1u));
      const float* e = edge_b + (long long)fi * 9;
      for (int j = 0; j < 9; ++j) e_s[slot * 9 + j] = e[j];
      const float* z = izp_b + (long long)fi * 3;
      for (int j = 0; j < 3; ++j) z_s[slot * 3 + j] = z[j];
      id_s[slot] = fi;
    }
    __syncthreads();

    const int n = n_live;
    for (int j = 0; j < n; ++j) {
      const float* e = e_s + j * 9;
      if (plane(e[0], e[1], e[2], xp, yp) >= 0.f && plane(e[3], e[4], e[5], xp, yp) >= 0.f &&
          plane(e[6], e[7], e[8], xp, yp) >= 0.f) {
        const float* z = z_s + j * 3;
        const float iz = plane(z[0], z[1], z[2], xi, yi);
        // ascending faces + strict '>' keeps the lowest index on ties
        if (iz > iz_lo && iz < iz_hi && iz > best_iz) {
          best_iz = iz;
          best = id_s[j];
        }
      }
    }
  }
  if (px < s && py < s) idx_out[(b * s + py) * s + px] = best;
}

}  // namespace

extern "C" int hoig_rasterize_zbuffer(const void* edge, const void* izp, const void* bbox,
                                      void* idx_out, int b, int f, int s, float iz_lo,
                                      float iz_hi, void* stream) {
  const int tiles = (s + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles, b);
  raster_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(edge), static_cast<const float*>(izp),
      static_cast<const float*>(bbox), static_cast<int*>(idx_out), f, s, iz_lo, iz_hi);
  return cudaGetLastError();
}

extern "C" const char* hoig_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
