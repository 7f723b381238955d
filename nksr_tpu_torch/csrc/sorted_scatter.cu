// Sorted row scatter-add kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of scripts/microbench_scatter.py, the
// JAX package's study of the lattice CG adjoint's row stage (rows of w f32
// lanes scatter-added into a dense per-cell table, row indices sorted):
//   rate_write_kernel    <- pallas_rate("write"), body _rate_kernel_write
//   rate_read_kernel     <- pallas_rate("read"),  body _rate_kernel_read
//   blocked_scatter_kernel <- pallas_blocked,     body _blocked_kernel
//
// The two rate kernels.  The TPU study ran pallas_rate on grid=(1,) on
// one TPU v5e chip, which has a single TensorCore: that one grid step
// was the whole chip, and its figure of merit was the chip's time per
// row.  Here the same two functions use the whole card:
//   rate_write: out (bc, w) = zeros((bc, w)).index_add_(0, idx, y), for
//               idx (n,) int32 sorted and y (n, w) f32 (the TPU body never
//               zeroed its table; its defined function is _blocked_kernel
//               at one block);
//   rate_read:  out (1, w) = y[idx].sum(0), the one row the TPU body wrote.
// What bounds them on the H100 is bytes: each index and each row of y it
// needs read once, the output written once (rate_write at the study's
// cap 16384 rows into bc 8192 cells of 32 lanes: 3.2 MB, 0.96 us at 3.35
// TB/s; rate_read 0.98 MB, 0.29 us).  Both bounds lie below what one
// launch costs, so at the study's shape the design's aim is a short chain
// of dependent memory trips with every load it can in flight at once; at
// the row stage's 2^19 rows the bytes bound it.
//
// rate_write: a grid over tiles of cells (ops/sorted_scatter.py's
// rate_write_tiles): each of RATE_THREADS threads owns one (cell, column
// group) of the tile, or k of them where the table is so large that one
// each would take more than about 1024 CTAs (32 cells a CTA at w = 32 with
// float4 groups: 256 CTAs at bc = 8192; 256 cells, k = 8, at the row
// stage's bc = 2^18).  Two warps find the CTA's row range [lo, hi) in the
// sorted idx by a 32-way search (3 trips at 16,384 rows, 4 at 2^19); one
// pass over the range finds each cell's first row; then each thread sums
// its cell's contiguous rows from 0.0 in row order, four rows in flight,
// and writes its output row once.  That is CPU index_add_'s order, so the
// result equals it bit for bit: no atomics, no read of out, an empty cell
// written as 0.0, and two calls bit-equal.  A row whose index lies
// outside [0, bc) is in no CTA's range (the search skips it), so it is
// dropped, and a CTA writes only its own tile of the table whatever the
// input.
//
// rate_read: fixed contiguous slices of idx, one a CTA (their size is
// ops/sorted_scatter.py's rate_read_slices).  A thread owns a column
// group and every g-th index of its slice (g = RATE_THREADS / column
// groups), with eight (index, row) gathers in flight, not one dependent
// chain; the CTA folds its row groups by a fixed tree in shared memory
// into a partial row.  A second launch folds the partials the same way,
// a CTA for every FOLD_GROUPS column groups.  The order of the f32 adds depends on n and w alone, so
// two calls are bit-equal; against y[idx].sum(0) it differs by
// rounding.  An index outside [0, n_y) is dropped.
//
// blocked_scatter_kernel is the full scatter: out (nb * bc, w) =
// zeros.index_add_(0, idx, y) for idx sorted.  What bounds it on the H100
// is bytes: it must write the whole table (682 MB at C0 = 5.3M cells,
// w = 32) and read each row once, against few adds.  Design: one CTA per
// block of bc cells, given by the host-built slot CSR `starts` (the TPU's
// scalar-prefetched slot ranges).  The CTA zeroes its (bc, w) tile in
// shared memory, adds its slot range into it (one thread per (row, lane),
// so a warp reads 128 contiguous bytes of y; shared-memory atomics, since
// sorted duplicates may fall to different warps), and writes the tile out
// with coalesced 16-byte stores: every table byte is written once and
// never read back from HBM.  With unique indices each cell receives one
// row and the result is exact; with duplicates the order of the f32 adds
// varies.  Rows whose index lies outside their block are dropped, so a
// malformed `starts` cannot write outside the tile.  The TPU's padding of
// y and idx for its fixed-size DMA is not needed.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_ops.cuh"

#define RATE_THREADS 256
#define RATE_MAX_CELLS 2048  // cells a CTA of rate_write at most
#define WRITE_UNROLL 4       // rows of a cell loaded at once
#define READ_UNROLL 8        // rows a thread of rate_read has in flight
#define FOLD_GROUPS 4        // column groups a CTA of rate_read's fold

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// First position r in [0, n] with idx[r] >= c, idx sorted, found by the
// 32 lanes of a warp together: each step probes 32 evenly spaced rows at
// once and keeps the stretch between the last probe below c and the
// first at or above it, so n rows take ceil(log32(n + 1)) steps of one
// load a lane.  Every lane returns the same value.
__device__ int64_t warp_lower_bound(const int32_t* __restrict__ idx,
                                    int64_t n, int64_t c) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t p = lo + (lane + 1) * step - 1;
    const unsigned ge =
        __ballot_sync(0xffffffffu, p >= hi || __ldg(idx + p) >= c);
    if (ge == 0) return hi;  // every probe, the last at hi - 1, below c
    lo += (__ffs(ge) - 1) * step;
    hi = min64(lo + step - 1, hi);
  }
  return lo;
}

// eight CTAs an SM (32 registers) with float4 groups; the float variant
// spills there
template <typename V>
__global__ void __launch_bounds__(RATE_THREADS, sizeof(V) == 16 ? 8 : 4)
    rate_write_kernel(const int32_t* __restrict__ idx,
                      const float* __restrict__ y, float* __restrict__ out,
                      int64_t n_rows, int32_t bc, int32_t w, int32_t cells) {
  constexpr int W = sizeof(V) / sizeof(float);
  __shared__ int64_t range[2];
  __shared__ int64_t first[RATE_MAX_CELLS + 1];
  const int64_t c0 = (int64_t)blockIdx.x * cells;
  const int32_t nc = (int32_t)min64(cells, bc - c0);
  if (threadIdx.x < 64) {
    const int side = threadIdx.x >> 5;  // warp 0: lo, warp 1: hi
    const int64_t r = warp_lower_bound(idx, n_rows, c0 + side * nc);
    if ((threadIdx.x & 31) == 0) range[side] = r;
  }
  // only an unsorted idx leaves a cell's first row unset below
  for (int j = threadIdx.x; j <= nc; j += blockDim.x) first[j] = 0;
  __syncthreads();
  const int64_t lo = range[0], hi = max64(range[0], range[1]);
  // first[j] = lower_bound(idx, c0 + j): row r is the first row of every
  // cell in (idx[r - 1], idx[r]], with idx[lo - 1] read as c0 - 1 and
  // idx[hi] as c0 + nc
  for (int64_t r = lo + threadIdx.x; r <= hi; r += blockDim.x) {
    const int64_t prev = r == lo ? c0 - 1 : __ldg(idx + r - 1);
    const int64_t cur = r == hi ? c0 + nc : __ldg(idx + r);
    const int64_t j1 = min64(cur - c0, nc);
    for (int64_t j = max64(prev - c0 + 1, 0); j <= j1; ++j)
      first[j] = r;
  }
  __syncthreads();
  const int nv = w / W;
  const int64_t items = (int64_t)nc * nv;
  for (int64_t t = threadIdx.x; t < items; t += blockDim.x) {
    const int64_t j = t / nv;
    const float* src = y + (t - j * nv) * W;
    const int64_t e = min64(first[j + 1], hi);
    V acc = zero_of<V>();
    for (int64_t r = max64(first[j], lo); r < e; r += WRITE_UNROLL) {
      V v[WRITE_UNROLL];
#pragma unroll
      for (int u = 0; u < WRITE_UNROLL; ++u)
        v[u] = r + u < e
                   ? __ldg(reinterpret_cast<const V*>(src + (r + u) * w))
                   : zero_of<V>();
#pragma unroll
      for (int u = 0; u < WRITE_UNROLL; ++u)
        if (r + u < e) add_to(acc, v[u]);
    }
    *reinterpret_cast<V*>(out + (c0 + j) * w + (t - j * nv) * W) = acc;
  }
}

// dst[c0:c1] = columns [c0, c1) of the sum of the rows of `base` (w f32
// apart) numbered in [lo, hi), by the whole block, in groups V of
// columns (c0 and c1 multiples of V's width): with GATHER row i is
// base[idx[i]], dropped when idx[i] lies outside [0, n_y), else base[i].
// Thread t owns column group t % cpp of each pass of cpp groups and the
// rows lo + g, lo + g + groups, ... for g = t / cpp, READ_UNROLL of them
// in flight; the groups' sums are then folded by a fixed tree in shared
// memory.  The add order depends only on (hi - lo, c1 - c0).
template <typename V, bool GATHER>
__device__ void block_row_sum(const int32_t* __restrict__ idx,
                              const float* base, int64_t n_y, int32_t w,
                              int32_t c0, int32_t c1, int64_t lo,
                              int64_t hi, V* sh, float* dst) {
  constexpr int W = sizeof(V) / sizeof(float);
  const int nv = (c1 - c0) / W;
  const int cpp = min(nv, RATE_THREADS);
  const int groups = RATE_THREADS / cpp;
  const int g = threadIdx.x / cpp, c = threadIdx.x - g * cpp;
  base += c0;
  dst += c0;
  for (int cb = 0; cb < nv; cb += cpp) {
    const int col = cb + c;
    const bool active = g < groups && col < nv;
    V acc = zero_of<V>();
    if (active) {
      const float* src = base + (int64_t)col * W;
      for (int64_t r = lo + g; r < hi; r += (int64_t)READ_UNROLL * groups) {
        int32_t at[READ_UNROLL];  // row of base, -1 for none
#pragma unroll
        for (int u = 0; u < READ_UNROLL; ++u) {
          const int64_t i = r + (int64_t)u * groups;
          at[u] = -1;
          if (i < hi) {
            if (GATHER) {
              const int32_t k = __ldg(idx + i);
              if ((uint64_t)(int64_t)k < (uint64_t)n_y) at[u] = k;
            } else {
              at[u] = (int32_t)i;
            }
          }
        }
        V v[READ_UNROLL];
#pragma unroll
        for (int u = 0; u < READ_UNROLL; ++u) {
          const V* p = reinterpret_cast<const V*>(
              src + (int64_t)max(at[u], 0) * w);
          v[u] = at[u] < 0 ? zero_of<V>() : __ldg(p);
        }
#pragma unroll
        for (int u = 0; u < READ_UNROLL; ++u)
          if (at[u] >= 0) add_to(acc, v[u]);
      }
    }
    sh[threadIdx.x] = acc;
    __syncthreads();
    for (int s = 1; s < groups; s *= 2) {
      if (active && g % (2 * s) == 0 && g + s < groups)
        add_to(sh[threadIdx.x], sh[threadIdx.x + s * cpp]);
      __syncthreads();
    }
    if (g == 0 && col < nv)
      *reinterpret_cast<V*>(dst + (int64_t)col * W) = sh[threadIdx.x];
    __syncthreads();
  }
}

// one partial row a slice of rows_per_cta indices
template <typename V>
__global__ void __launch_bounds__(RATE_THREADS)
    rate_read_partials(const int32_t* __restrict__ idx,
                       const float* __restrict__ y,
                       float* __restrict__ partials, int64_t n_idx,
                       int64_t n_y, int32_t w, int64_t rows_per_cta) {
  __shared__ V sh[RATE_THREADS];
  const int64_t lo = (int64_t)blockIdx.x * rows_per_cta;
  block_row_sum<V, true>(idx, y, n_y, w, 0, w, lo,
                         min64(lo + rows_per_cta, n_idx), sh,
                         partials + (int64_t)blockIdx.x * w);
}

// out = the sum of the n_parts partial rows, FOLD_GROUPS column groups a
// CTA (so the fold's loads spread over SMs, not down one CTA's chain)
template <typename V>
__global__ void __launch_bounds__(RATE_THREADS)
    rate_read_fold(const float* __restrict__ partials,
                   float* __restrict__ out, int64_t n_parts, int32_t w) {
  constexpr int W = sizeof(V) / sizeof(float);
  __shared__ V sh[RATE_THREADS];
  const int32_t c0 = blockIdx.x * FOLD_GROUPS * W;
  block_row_sum<V, false>(nullptr, partials, 0, w, c0,
                          min(c0 + FOLD_GROUPS * W, w), 0, n_parts, sh, out);
}

__global__ void blocked_scatter_kernel(const float* __restrict__ y,
                                       const int32_t* __restrict__ idx,
                                       const int32_t* __restrict__ starts,
                                       float* __restrict__ out, int32_t bc,
                                       int32_t w) {
  extern __shared__ float4 tile4[];
  float* tile = reinterpret_cast<float*>(tile4);
  const int64_t b = blockIdx.x;
  const int32_t n4 = bc * (w / 4);
  for (int32_t e = threadIdx.x; e < n4; e += blockDim.x)
    tile4[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  const int64_t start = starts[b];
  const int64_t n_el = ((int64_t)starts[b + 1] - start) * w;
  const int64_t base = b * bc;
  for (int64_t e = threadIdx.x; e < n_el; e += blockDim.x) {
    const int64_t r = start + e / w;
    const int32_t c = (int32_t)(e % w);
    const int64_t local = (int64_t)idx[r] - base;
    if (local >= 0 && local < bc)
      atomicAdd(tile + local * w + c, y[r * w + c]);
  }
  __syncthreads();
  float4* o4 = reinterpret_cast<float4*>(out) + base * (w / 4);
  for (int32_t e = threadIdx.x; e < n4; e += blockDim.x) o4[e] = tile4[e];
}

// out (bc, w); cells a CTA (at most RATE_MAX_CELLS); vec4 = 1 takes float4
// groups (w % 4 == 0, y and out 16 B aligned).
extern "C" int scatter_rate_write(const int32_t* idx, const float* y,
                                  float* out, int64_t n_rows, int32_t bc,
                                  int32_t w, int32_t cells, int vec4,
                                  void* stream) {
  if (bc <= 0 || w <= 0 || cells <= 0 || cells > RATE_MAX_CELLS ||
      n_rows < 0 || (vec4 && w % 4))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(((int64_t)bc + cells - 1) / cells);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec4)
    rate_write_kernel<float4><<<blocks, RATE_THREADS, 0, st>>>(
        idx, y, out, n_rows, bc, w, cells);
  else
    rate_write_kernel<float><<<blocks, RATE_THREADS, 0, st>>>(
        idx, y, out, n_rows, bc, w, cells);
  return (int)cudaGetLastError();
}

// out (1, w); partials (n_ctas, w) scratch; n_ctas slices of
// rows_per_cta indices cover [0, n_idx).
extern "C" int scatter_rate_read(const int32_t* idx, const float* y,
                                 float* partials, float* out, int64_t n_idx,
                                 int64_t n_y, int32_t w,
                                 int64_t rows_per_cta, int64_t n_ctas,
                                 int vec4, void* stream) {
  if (w <= 0 || n_idx < 0 || rows_per_cta <= 0 || n_ctas <= 0 ||
      n_ctas >= ((int64_t)1 << 31) || rows_per_cta * n_ctas < n_idx ||
      (vec4 && w % 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec4)
    rate_read_partials<float4><<<(unsigned)n_ctas, RATE_THREADS, 0, st>>>(
        idx, y, partials, n_idx, n_y, w, rows_per_cta);
  else
    rate_read_partials<float><<<(unsigned)n_ctas, RATE_THREADS, 0, st>>>(
        idx, y, partials, n_idx, n_y, w, rows_per_cta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nv = vec4 ? w / 4 : w;
  const unsigned fold = (unsigned)((nv + FOLD_GROUPS - 1) / FOLD_GROUPS);
  if (vec4)
    rate_read_fold<float4><<<fold, RATE_THREADS, 0, st>>>(partials, out,
                                                           n_ctas, w);
  else
    rate_read_fold<float><<<fold, RATE_THREADS, 0, st>>>(partials, out,
                                                          n_ctas, w);
  return (int)cudaGetLastError();
}

extern "C" int blocked_sorted_scatter(const float* y, const int32_t* idx,
                                      const int32_t* starts, float* out,
                                      int64_t n_blocks, int32_t bc,
                                      int32_t w, void* stream) {
  // w % 4 == 0 and bc * w * 4 <= 227 KB are checked by the wrapper
  const int smem = bc * w * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      blocked_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  blocked_scatter_kernel<<<(unsigned int)n_blocks, 256, smem,
                           (cudaStream_t)stream>>>(y, idx, starts, out, bc,
                                                   w);
  return (int)cudaGetLastError();
}
