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
//   out[b * n + r, :] = sum of val[b * E + e, :] over the e, ascending, with idx[b, e] == r
//
// Each row's sum is taken in f32, in ascending entry order, starting from
// 0, and rounded once to T (f32 or bf16): no atomic ever adds a value, so
// the result does not change from run to run, and the plain version
// (hoig_torch/ops/table_gather.py scatter_rows_reference: a stable sort of
// the destination keys, then a masked loop over segment positions) gives
// the same bits. An index outside [0, n) adds to no row.
//
// The order is built on the card, from integers only, so any atomic order
// gives the same result:
//   row_count_kernel        entries per row (integer atomics);
//   row_scan_kernel         exclusive scan of the counts within tiles of
//                           kScanTile rows (a row's segment starts at
//                           loc[r] + tot[r / kScanTile]); lists the rows
//                           longer than the sum kernel sorts itself;
//   row_scan_totals_kernel  exclusive scan of the tiles' totals (one block);
//   row_place_kernel        each entry id into its row's segment, in
//                           whatever order the atomics give;
//   segment_sort_kernel     the listed rows' segments sorted ascending: a
//                           warp's bitonic network in shared memory up to
//                           kWarpSort ids, the block's up to kSortCap, past
//                           that chunks of kSortCap in shared memory merged
//                           by the block's network steps in device memory.
// scatter_rows_kernel then gives each row a group of `lanes` threads, which
// cover the row's channels in one pass (VEC channels each, 16-byte loads
// where C and the pointers allow), stage the segment's ids in shared
// memory (ranking a short segment's ids there, which sorts it), and issue
// kPrefetch row loads before adding them in order.
// What bounds it: HBM bytes, each entry's row read once (C * sizeof(T)
// bytes at a data-dependent address) and each output row written once; the
// order adds a few int32 passes over the entries (idx read twice, the ids
// written and read).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#define HOIG_TRY(...)                       \
  do {                                      \
    const cudaError_t err_ = (__VA_ARGS__); \
    if (err_ != cudaSuccess) return err_;   \
  } while (0)

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

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

constexpr int kScanTile = 4096;  // rows a block of row_scan_kernel scans, 4 a thread
constexpr int kScanThreads = 1024;
constexpr int kCountThreads = 256;
constexpr int kCountBlocks = 132 * 16;  // a grid-stride walk over the entries
constexpr int kSortThreads = 1024;
constexpr int kSortBlocks = 132 * 2;
constexpr int kLogSortCap = 13;
constexpr int kSortCap = 1 << kLogSortCap;                  // ids a block sorts in shared memory
constexpr int kWarpSort = kSortCap / (kSortThreads / 32);  // 256: a warp's share of them
constexpr int kSumThreads = 256;
constexpr int kStage = 2048;    // ids a block of scatter_rows_kernel stages at once
constexpr int kRankMax = 512;   // the longest segment the sum kernel sorts itself
constexpr int kPrefetch = 8;    // row loads a thread issues before adding them

// the scratch (int32), in this order
struct Order {
  int* counts;     // rows + 1: entries per row (zeroed before the count)
  int* n_long;     // 1: rows listed in long_rows (zeroed with the counts)
  int* loc;        // rows + 1: exclusive scan of counts within each tile
  int* tot;        // tiles: exclusive scan of the tiles' totals
  int* long_rows;  // rows: the rows longer than the sum kernel's rank limit
  int* ids;        // entries: each row's entry ids, row by row
};

long long tiles_of(long long rows) { return (rows + 1 + kScanTile - 1) / kScanTile; }

long long scratch_ints(long long rows, long long entries) {
  return 2 * (rows + 1) + 1 + tiles_of(rows) + rows + entries;
}

Order carve(void* scratch, long long rows) {
  Order o;
  o.counts = static_cast<int*>(scratch);
  o.n_long = o.counts + rows + 1;
  o.loc = o.n_long + 1;
  o.tot = o.loc + rows + 1;
  o.long_rows = o.tot + tiles_of(rows);
  o.ids = o.long_rows + rows;
  return o;
}

__device__ __forceinline__ int start_of(const int* loc, const int* tot, int r) {
  return loc[r] + tot[r / kScanTile];
}

// exclusive scan of one int a thread over the block; *total gets the sum.
// ws: 32 ints of shared memory, free again when it returns
__device__ int block_exclusive_scan(int v, int* ws, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < warps ? ws[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    ws[lane] = s;
  }
  __syncthreads();
  const int before = warp ? ws[warp - 1] : 0;
  *total = ws[warps - 1];
  __syncthreads();
  return before + x - v;
}

__global__ void __launch_bounds__(kCountThreads)
row_count_kernel(const long long* __restrict__ idx, int* __restrict__ counts, unsigned e, int n,
                 unsigned entries) {
  // unsigned: j + the grid's stride stays below 2^32 for any int entries
  for (unsigned j = blockIdx.x * kCountThreads + threadIdx.x; j < entries;
       j += gridDim.x * kCountThreads) {
    const long long r = idx[j];
    if (r >= 0 && r < n) atomicAdd(counts + static_cast<int>(j / e) * n + static_cast<int>(r), 1);
  }
}

// len = rows + 1 (the last count is 0, so loc[rows] closes the last segment)
__global__ void __launch_bounds__(kScanThreads)
row_scan_kernel(const int* __restrict__ counts, int* __restrict__ loc, int* __restrict__ tot,
                int* __restrict__ long_rows, int* __restrict__ n_long, int len, int rank_max) {
  __shared__ int ws[32];
  const int base = blockIdx.x * kScanTile + threadIdx.x * 4;
  int v[4];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = base + k;
    v[k] = i < len ? counts[i] : 0;
    sum += v[k];
    if (v[k] > rank_max) long_rows[atomicAdd(n_long, 1)] = i;
  }
  int total;
  int run = block_exclusive_scan(sum, ws, &total);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (base + k < len) loc[base + k] = run;
    run += v[k];
  }
  if (threadIdx.x == 0) tot[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kScanThreads)
row_scan_totals_kernel(int* __restrict__ tot, int tiles) {
  __shared__ int ws[32];
  int carry = 0;
  for (int base = 0; base < tiles; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < tiles ? tot[i] : 0;
    int total;
    const int before = block_exclusive_scan(v, ws, &total);
    if (i < tiles) tot[i] = carry + before;
    carry += total;
  }
}

__global__ void __launch_bounds__(kCountThreads)
row_place_kernel(const long long* __restrict__ idx, int* __restrict__ counts,
                 const int* __restrict__ loc, const int* __restrict__ tot, int* __restrict__ ids,
                 unsigned e, int n, unsigned entries) {
  for (unsigned j = blockIdx.x * kCountThreads + threadIdx.x; j < entries;
       j += gridDim.x * kCountThreads) {
    const long long r = idx[j];
    if (r < 0 || r >= n) continue;
    const int row = static_cast<int>(j / e) * n + static_cast<int>(r);
    ids[start_of(loc, tot, row) + atomicSub(counts + row, 1) - 1] = static_cast<int>(j);
  }
}

// One step of the bitonic network in which every comparator puts the
// smaller id first, over a[0, len) with ids past len taken as +infinity
// (never moved, so never touched): for m a power of two >= len, pair q of
// m / 2 joins lo and hi. flip: the first step of a merge of blocks of
// 2^(lg + 1), lo in a block's first half and hi mirrored in its second;
// otherwise hi = lo + 2^lg inside blocks of 2^(lg + 1).
template <typename I>
__device__ __forceinline__ void network_step(int* a, I len, I m, int lg, bool flip, int t,
                                             int nt) {
  const I half = I(1) << lg;
  for (I q = t; q < m / 2; q += nt) {
    const I blk = (q >> lg) << (lg + 1);
    const I off = q & (half - 1);
    const I lo = blk + off;
    const I hi = flip ? blk + 2 * half - 1 - off : lo + half;
    if (hi < len) {
      const int x = a[lo];
      const int y = a[hi];
      if (y < x) {
        a[lo] = y;
        a[hi] = x;
      }
    }
  }
}

// sort a[0, len) (len <= kSortCap, in shared memory) ascending; threads t of
// nt, sync() between steps
template <typename Sync>
__device__ void bitonic_sort(int* a, int len, int t, int nt, Sync sync) {
  int lm = 0;
  while ((1 << lm) < len) ++lm;
  for (int lk = 1; lk <= lm; ++lk) {
    network_step<int>(a, len, 1 << lm, lk - 1, true, t, nt);
    sync();
    for (int lj = lk - 2; lj >= 0; --lj) {
      network_step<int>(a, len, 1 << lm, lj, false, t, nt);
      sync();
    }
  }
}

// a segment longer than kSortCap, by the whole block: its chunks of
// kSortCap sorted in shared memory, then the merges' steps of kSortCap and
// more in device memory (each followed by the block's barrier, which makes
// the block's writes visible to it), the shorter ones chunk by chunk in
// shared memory
__device__ void sort_long(int* seg, int len, int* buf) {
  const int t = threadIdx.x;
  auto sync = [] { __syncthreads(); };
  for (int c0 = 0; c0 < len; c0 += kSortCap) {
    const int cnt = min(kSortCap, len - c0);
    for (int i = t; i < cnt; i += kSortThreads) buf[i] = seg[c0 + i];
    __syncthreads();
    bitonic_sort(buf, cnt, t, kSortThreads, sync);
    for (int i = t; i < cnt; i += kSortThreads) seg[c0 + i] = buf[i];
    __syncthreads();
  }
  int lm = 0;
  while ((1LL << lm) < len) ++lm;
  for (int lk = kLogSortCap + 1; lk <= lm; ++lk) {
    network_step<long long>(seg, len, 1LL << lm, lk - 1, true, t, kSortThreads);
    __syncthreads();
    for (int lj = lk - 2; lj >= kLogSortCap; --lj) {
      network_step<long long>(seg, len, 1LL << lm, lj, false, t, kSortThreads);
      __syncthreads();
    }
    for (int c0 = 0; c0 < len; c0 += kSortCap) {
      const int cnt = min(kSortCap, len - c0);
      for (int i = t; i < cnt; i += kSortThreads) buf[i] = seg[c0 + i];
      __syncthreads();
      for (int lj = kLogSortCap - 1; lj >= 0; --lj) {
        network_step<int>(buf, cnt, kSortCap, lj, false, t, kSortThreads);
        __syncthreads();
      }
      for (int i = t; i < cnt; i += kSortThreads) seg[c0 + i] = buf[i];
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kSortThreads)
segment_sort_kernel(int* ids, const int* __restrict__ loc, const int* __restrict__ tot,
                    const int* __restrict__ long_rows, const int* __restrict__ n_long) {
  __shared__ int buf[kSortCap];
  const int listed = *n_long;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kSortThreads / 32;
  // a warp per segment of at most kWarpSort ids, in its share of buf
  int* mine = buf + warp * kWarpSort;
  for (int i = blockIdx.x * kWarps + warp; i < listed; i += gridDim.x * kWarps) {
    const int r = long_rows[i];
    const int s0 = start_of(loc, tot, r);
    const int len = start_of(loc, tot, r + 1) - s0;
    if (len > kWarpSort) continue;
    for (int k = lane; k < len; k += 32) mine[k] = ids[s0 + k];
    __syncwarp();
    bitonic_sort(mine, len, lane, 32, [] { __syncwarp(); });
    for (int k = lane; k < len; k += 32) ids[s0 + k] = mine[k];
    __syncwarp();
  }
  __syncthreads();
  // the block per longer segment
  for (int i = blockIdx.x; i < listed; i += gridDim.x) {
    const int r = long_rows[i];
    const int s0 = start_of(loc, tot, r);
    const int len = start_of(loc, tot, r + 1) - s0;
    if (len <= kWarpSort) continue;
    if (len > kSortCap) {
      sort_long(ids + s0, len, buf);
      continue;
    }
    for (int k = threadIdx.x; k < len; k += kSortThreads) buf[k] = ids[s0 + k];
    __syncthreads();
    bitonic_sort(buf, len, threadIdx.x, kSortThreads, [] { __syncthreads(); });
    for (int k = threadIdx.x; k < len; k += kSortThreads) ids[s0 + k] = buf[k];
    __syncthreads();
  }
}

// A group of `lanes` threads per row (kSumThreads / lanes rows a block),
// VEC channels a thread; the segment's ids pass through shared memory in
// chunks of kStage / groups. A segment of at most rank_max ids (never more
// than a chunk) is sorted there: each id's rank is the number of smaller
// ids of the segment (ids are distinct). A longer one was sorted by
// segment_sort_kernel. Every loop that holds a barrier runs as often in
// every thread of the block.
template <typename T, int VEC>
__global__ void __launch_bounds__(kSumThreads)
scatter_rows_kernel(const T* __restrict__ val, const int* __restrict__ ids,
                    const int* __restrict__ loc, const int* __restrict__ tot,
                    T* __restrict__ out, int rows, int c, int lanes, int rank_max) {
  __shared__ int staged[kStage];
  __shared__ int ranked[kStage];
  const int groups = kSumThreads / lanes;
  const int chunk = kStage / groups;
  const int g = threadIdx.x / lanes;
  const int sub = threadIdx.x - g * lanes;
  const int row = blockIdx.x * groups + g;
  int s0 = 0;
  int len = 0;
  if (row < rows) {
    s0 = start_of(loc, tot, row);
    len = start_of(loc, tot, row + 1) - s0;
  }
  int* st = staged + g * chunk;
  int* rk = ranked + g * chunk;
  const bool ranks = len <= rank_max;
  const int* seq = ranks ? rk : st;
  for (int cb = 0; cb < c; cb += lanes * VEC) {
    const int c0 = cb + sub * VEC;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (int k0 = 0; __syncthreads_or(k0 < len); k0 += chunk) {
      const int cnt = min(chunk, len - k0);
      for (int i = sub; i < cnt; i += lanes) st[i] = ids[s0 + k0 + i];
      __syncthreads();
      if (ranks) {
        for (int i = sub; i < cnt; i += lanes) {
          const int v = st[i];
          int r = 0;
          for (int k = 0; k < cnt; ++k) r += st[k] < v;
          rk[r] = v;
        }
      }
      __syncthreads();
      if (c0 < c) {
        for (int i = 0; i < cnt; i += kPrefetch) {
          Pack<T, VEC> p[kPrefetch];
#pragma unroll
          for (int u = 0; u < kPrefetch; ++u) {
            if (i + u < cnt) {
              p[u] = *reinterpret_cast<const Pack<T, VEC>*>(val + (long long)seq[i + u] * c + c0);
            }
          }
#pragma unroll
          for (int u = 0; u < kPrefetch; ++u) {
            if (i + u < cnt) {
#pragma unroll
              for (int v = 0; v < VEC; ++v) acc[v] = __fadd_rn(acc[v], to_f32(p[u].v[v]));
            }
          }
        }
      }
    }
    if (row < rows && c0 < c) {
      Pack<T, VEC> o;
#pragma unroll
      for (int i = 0; i < VEC; ++i) o.v[i] = from_f32<T>(acc[i]);
      *reinterpret_cast<Pack<T, VEC>*>(out + (long long)row * c + c0) = o;
    }
  }
}

// the sum kernel's shape for C channels of VEC: lanes (a power of two, at
// most the block) that cover the channels in one pass where they can, and
// the longest segment it ranks itself: one chunk (8 ids a lane), at most
// kRankMax, so a lane compares at most 8 x kRankMax ids
struct SumPlan {
  int lanes;
  int rank_max;
};

SumPlan sum_plan(int c, int vec) {
  SumPlan s{1, 0};
  while (s.lanes < kSumThreads && s.lanes * vec < c) s.lanes *= 2;
  const int chunk = kStage / (kSumThreads / s.lanes);
  s.rank_max = chunk < kRankMax ? chunk : kRankMax;
  return s;
}

cudaError_t build_order(const long long* idx, const Order& o, int e, int n, int rows, int entries,
                        int rank_max, cudaStream_t s) {
  HOIG_TRY(cudaMemsetAsync(o.counts, 0, sizeof(int) * (rows + 2LL), s));
  const int blocks = static_cast<int>(
      std::min<long long>((entries + kCountThreads - 1) / kCountThreads, kCountBlocks));
  if (entries > 0) {
    row_count_kernel<<<blocks, kCountThreads, 0, s>>>(idx, o.counts, e, n, entries);
    HOIG_TRY(cudaGetLastError());
  }
  const int tiles = static_cast<int>(tiles_of(rows));
  row_scan_kernel<<<tiles, kScanThreads, 0, s>>>(o.counts, o.loc, o.tot, o.long_rows, o.n_long,
                                                  rows + 1, rank_max);
  HOIG_TRY(cudaGetLastError());
  row_scan_totals_kernel<<<1, kScanThreads, 0, s>>>(o.tot, tiles);
  HOIG_TRY(cudaGetLastError());
  if (entries > 0) {
    row_place_kernel<<<blocks, kCountThreads, 0, s>>>(idx, o.counts, o.loc, o.tot, o.ids, e, n,
                                                      entries);
    HOIG_TRY(cudaGetLastError());
  }
  segment_sort_kernel<<<std::min(kSortBlocks, rows), kSortThreads, 0, s>>>(
      o.ids, o.loc, o.tot, o.long_rows, o.n_long);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_scatter(const void* val, const long long* idx, void* out, const Order& o,
                           int e, int n, int rows, int entries, int c, int stages,
                           cudaStream_t s) {
  const SumPlan plan = sum_plan(c, VEC);
  if (stages & 1) HOIG_TRY(build_order(idx, o, e, n, rows, entries, plan.rank_max, s));
  if (stages & 2) {
    const int groups = kSumThreads / plan.lanes;
    scatter_rows_kernel<T, VEC><<<(rows + groups - 1) / groups, kSumThreads, 0, s>>>(
        static_cast<const T*>(val), o.ids, o.loc, o.tot, static_cast<T*>(out), rows, c,
        plan.lanes, plan.rank_max);
  }
  return cudaGetLastError();
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

// The scratch that hoig_scatter_rows needs, in int32s.
extern "C" long long hoig_scatter_rows_scratch(long long rows, long long entries) {
  return scratch_ints(rows, entries);
}

// scatter_rows: val (B * E, C) and out (B * n, C), both f32 or both bf16
// (is_bf16); idx (B, E) int64; scratch of at least
// hoig_scatter_rows_scratch(B * n, B * E) int32s. stages: 1 builds the
// order into the scratch, 2 sums in the order the scratch holds, 3 both
// (what the wrapper runs). B * E and B * n + 2 must fit an int.
extern "C" int hoig_scatter_rows(const void* val, const void* idx, void* out, void* scratch,
                                 long long scratch_len, int b, int e, int n, int c, int is_bf16,
                                 int stages, void* stream) {
  if (b < 1 || e < 0 || n < 1 || c < 1 || stages < 1 || stages > 3) return cudaErrorInvalidValue;
  const long long rows = (long long)b * n;
  const long long entries = (long long)b * e;
  if (rows + 2 > INT_MAX || entries > INT_MAX) return cudaErrorInvalidValue;
  if (scratch_len < scratch_ints(rows, entries)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Order o = carve(scratch, rows);
  const long long* ix = static_cast<const long long*>(idx);
  const int r = static_cast<int>(rows);
  const int en = static_cast<int>(entries);
  const bool wide = aligned16(val) && aligned16(out);
  if (is_bf16) {
    if (wide && c % 8 == 0) {
      return launch_scatter<__nv_bfloat16, 8>(val, ix, out, o, e, n, r, en, c, stages, s);
    }
    return launch_scatter<__nv_bfloat16, 1>(val, ix, out, o, e, n, r, en, c, stages, s);
  }
  if (wide && c % 4 == 0) {
    return launch_scatter<float, 4>(val, ix, out, o, e, n, r, en, c, stages, s);
  }
  return launch_scatter<float, 1>(val, ix, out, o, e, n, r, en, c, stages, s);
}

extern "C" const char* hoig_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
