// Fixed-order segment sum and its transpose for Hopper (sm_90a), plain C
// interface.
//
// No TPU kernel is replaced.  The sum stands in for XLA's ordered
// scatter-add, ``z0.at[...].add`` (nksr_tpu/fields/lattice.py:1231-1234),
// and for the CPU's ``index_add_``: both add the rows of a repeated index
// one after another in index order.  CUDA ``index_add_`` sums repeated
// indices with f32 atomics in no fixed order, so two runs on one input
// differ in their last bits; these kernels make every sum in one fixed
// order and two calls on one input are bit-equal.
//
// What the sum computes: rows ``values`` (R, C) f32 and a target per row.
// The order is data, built by the caller without a host sync
// (ops/segment_sum.py, ``segment_order``): ``perm`` lists the rows sorted
// by (target, row), the dropped rows (negative target) first, and
// ``offsets`` (n_targets + 1) gives every target its run: target t sums
// perm[offsets[t] .. offsets[t+1]), empty where no row has it.  Output row
// r is target r (dense) or target rows[r] (compact, one row a distinct
// target):
//   0.0 + values[perm[offsets[t]]] + values[perm[offsets[t] + 1]] + ...
// added left to right, bit for bit what CPU index_add_ and np.add.at
// compute.  Every output row is written, an empty target's as zeros, so a
// dense sum is one launch.
//
// The transpose (the sum's backward) is a row gather: entry i reads the
// cotangent row src[i], or zeros where src[i] < 0 (a dropped entry).
// Each output row is written once, so it is the same on every call.
//
// What bounds them on the H100: they move data and add each value once.
// The sum reads the kept rows once, perm and offsets once, and writes
// the output once; the gather reads each cotangent row it needs and
// writes R rows.  At the training step's depth-0 conv backward (173,232
// entries of 32 f32, 119,026 kept, onto 6,417 rows) that is some 17 MB,
// 5.2 us at 3.35 TB/s, below the ~18 us it takes to launch and time any
// kernel from PyTorch: there the call's host path decides, and the
// wrapper is one allocation and one launch.
//
// Three designs of the sum, chosen by the wrapper from the shapes alone
// (columns, rows, targets; no sync; ops/segment_sum.py ``design``), each
// adding a run's rows in entry order:
//
// * Warp per output row (``segment_sum_warp``).  A warp owns one target.
//   Its lanes split into G = 32 / L groups of L lanes, L the row's width
//   in float4 (C/4, C a multiple of 4) or in floats (C, at other widths),
//   L <= 32.  A round stages G * 8 of the run's perm entries in shared
//   memory with coalesced loads, then each lane loads 8 rows (group g
//   entry d * G + g, d < 8), so 8 G rows are in flight: 32 at C = 32
//   (a conv backward's run of up to 27 entries in one round), 256 at
//   C = 4 and C = 1 (a support scatter's hot voxel of hundreds of rows in
//   a few rounds).  Each group's row is passed to the others by
//   ``__shfl_sync`` and added into the running sum strictly in entry
//   order, so the fold is the same left-to-right fold with no
//   reassociation (every group holds the same sum; group 0 stores it).
//   It answers latency where the targets are few (the conv backward's
//   6,417 rows of 32: 51k column groups, too few to fill the card one a
//   thread, each waiting on a perm load before each row load).
// * Thread per (output row, column group) (``segment_sum_thread``), the
//   first design: a thread walks its run eight rows a round (the rows
//   past the run masked off, so no serial tail).  Taken where the output
//   rows are many (a route B support scatter's 10^5-10^6 targets of 4
//   columns, where a warp a target spends its lanes' shuffles on each
//   row) and for rows wider than 32 lanes (the 128-lane rows).
// * Block per tile of up to 512 output rows (``segment_sum_tile``), where
//   the targets are at least as many as the rows (the reconstruction's
//   encoder splat: 8M rows onto a dense lattice of 8.6M cells, 95% of
//   them empty).  A thread a (target, column group) there spends most of
//   its threads on a zero each; a warp a 64-row tile (this design's first
//   form) left most of its lanes idle, having some three runs a tile.
//   The block zeroes its whole tile with float4 stores, lists the tile's
//   rows with a run in shared memory, and after a barrier deals the
//   (run, column group) items to its threads, each walking its run as the
//   thread design does.  The zeros are the fill the first design left to
//   ``torch.zeros``, a launch of its own.  512 rows a block: in a trial
//   sweep at the encoder splat, 256-512 rows were fastest and alike,
//   128 and fewer or 1024 and more slower.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py; PERF.md section
// 6 has each run's figures): the conv backward's sum (warp) 0.0197 ms
// where zeros + index_add_ takes 0.0273 (launch floor 0.0126); the
// backward at the training splat (64,000 x 7) 0.0180 ms; a training
// step's 335 sums 12.4 ms, route B's lap's 40.9 (thread), against 15.4
// and 57.9 ms of zeros + index_add_.  At the reconstruction's encoder
// splat (8M x 7 onto 8.6M cells, bound 0.1581 ms by bytes), in turns on
// one card (scripts/time_segment_sum.py): the block tile 0.2065 ms, the
// warp tile 0.2692, the first design's torch.zeros + thread-per-segment
// kernel 0.2170.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_ops.cuh"

#define SEG_THREADS 256
#define SEG_UNROLL 8
#define FULL_MASK 0xffffffffu
#define WARP_ROWS 8  // rows a lane loads a round in the warp design
#define TILE_ROWS 512  // most output rows a block owns in the tile design

__device__ __forceinline__ float shfl(float v, int src) {
  return __shfl_sync(FULL_MASK, v, src);
}
__device__ __forceinline__ float4 shfl(float4 v, int src) {
  return make_float4(__shfl_sync(FULL_MASK, v.x, src),
                     __shfl_sync(FULL_MASK, v.y, src),
                     __shfl_sync(FULL_MASK, v.z, src),
                     __shfl_sync(FULL_MASK, v.w, src));
}

// grid ceil(n_out / (SEG_THREADS / 32)) blocks, one warp an output row.
// l: lanes a row (its width in V), 1 <= l <= 32.  A round stages up to
// groups * WARP_ROWS perm entries in shared memory (coalesced, up to
// WARP_ROWS loads a lane), then each lane loads WARP_ROWS rows, group g
// entry d * groups + g of the round, and the rows are added in entry
// order.
template <typename V>
__global__ void __launch_bounds__(SEG_THREADS)
    segment_sum_warp(const float* __restrict__ values, int64_t n_cols, int l,
                     const int32_t* __restrict__ perm,
                     const int32_t* __restrict__ offsets,
                     const int64_t* __restrict__ rows, int64_t n_out,
                     float* __restrict__ out) {
  constexpr int W = sizeof(V) / sizeof(float);
  __shared__ int32_t staged[SEG_THREADS / 32][32 * WARP_ROWS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t r = (int64_t)blockIdx.x * (SEG_THREADS / 32) + w;
  if (r >= n_out) return;  // the whole warp leaves together
  const int64_t t = rows ? __ldg(rows + r) : r;
  const int lo = __ldg(offsets + t), hi = __ldg(offsets + t + 1);
  const int groups = 32 / l;
  const int g = lane / l, j = lane - g * l;  // group, lane in the group
  const bool loads = g < groups;             // the 32 % l spare lanes idle
  const int per_round = groups * WARP_ROWS;
  const float* col = values + (int64_t)j * W;
  int32_t* sp = staged[w];
  V acc = zero_of<V>();
  for (int base = lo; base < hi; base += per_round) {
    const int n = min(per_round, hi - base);
    for (int i = lane; i < n; i += 32) sp[i] = __ldg(perm + base + i);
    __syncwarp();
    V v[WARP_ROWS];
#pragma unroll
    for (int d = 0; d < WARP_ROWS; ++d) {
      const int e = d * groups + g;
      v[d] = loads && e < n ? __ldg(reinterpret_cast<const V*>(
                                  col + (int64_t)sp[e] * n_cols))
                            : zero_of<V>();
    }
    // entries d * groups + q, one after another (the counts are uniform
    // across the warp)
#pragma unroll
    for (int d = 0; d < WARP_ROWS; ++d) {
      const int m = min(groups, n - d * groups);
      for (int q = 0; q < m; ++q) add_to(acc, shfl(v[d], q * l + j));
    }
    __syncwarp();  // the next round restages sp
  }
  if (g == 0) *reinterpret_cast<V*>(out + r * n_cols + (int64_t)j * W) = acc;
}

// One thread's column group of a run perm[lo .. hi): rounds of
// SEG_UNROLL rows, their perm entries and then their rows loaded with
// the rows past hi masked off, then added in order, from 0.0.
template <typename V>
__device__ __forceinline__ V walk_run(const float* __restrict__ values,
                                      int64_t n_cols, int64_t col,
                                      const int32_t* __restrict__ perm,
                                      int lo, int hi) {
  V acc = zero_of<V>();
  for (int e = lo; e < hi; e += SEG_UNROLL) {
    int32_t i[SEG_UNROLL];
    V v[SEG_UNROLL];
#pragma unroll
    for (int u = 0; u < SEG_UNROLL; ++u)
      i[u] = e + u < hi ? __ldg(perm + e + u) : 0;
#pragma unroll
    for (int u = 0; u < SEG_UNROLL; ++u)
      v[u] = e + u < hi ? __ldg(reinterpret_cast<const V*>(
                              values + (int64_t)i[u] * n_cols + col))
                        : zero_of<V>();
#pragma unroll
    for (int u = 0; u < SEG_UNROLL; ++u)
      if (e + u < hi) add_to(acc, v[u]);
  }
  return acc;
}

// grid ceil(n_out * nv / SEG_THREADS): item t = (output row t / nv, column
// group t % nv), a group being one V of columns.
template <typename V>
__global__ void __launch_bounds__(SEG_THREADS)
    segment_sum_thread(const float* __restrict__ values, int64_t n_cols,
                       int nv, const int32_t* __restrict__ perm,
                       const int32_t* __restrict__ offsets,
                       const int64_t* __restrict__ rows, uint32_t n_items,
                       float* __restrict__ out) {
  constexpr int W = sizeof(V) / sizeof(float);
  const uint32_t t = blockIdx.x * SEG_THREADS + threadIdx.x;
  if (t >= n_items) return;
  const uint32_t r = t / nv;  // 32-bit: the wrapper keeps items < 2^32
  const int64_t col = (int64_t)(t - r * nv) * W;
  const int64_t s = rows ? __ldg(rows + r) : r;
  const int lo = __ldg(offsets + s), hi = __ldg(offsets + s + 1);
  *reinterpret_cast<V*>(out + (int64_t)r * n_cols + col) =
      walk_run<V>(values, n_cols, col, perm, lo, hi);
}

// grid ceil(n_out / tile_rows) blocks, one block a tile of tile_rows
// (<= TILE_ROWS) consecutive output rows (targets).  The block zeroes the
// whole tile (float4 stores, the tile starts 16-byte aligned), lists the
// tile's rows with a run in shared memory (a ballot a warp, the warp's
// slots taken by one shared atomic: the list's order varies, each row's
// sum does not), and after the barrier that orders the zeros before the
// sums its threads take the (run, column group) items, consecutive
// threads the column groups of one run, each walking its run as the
// thread design does.
template <typename V>
__global__ void __launch_bounds__(SEG_THREADS)
    segment_sum_tile(const float* __restrict__ values, int64_t n_cols, int nv,
                     const int32_t* __restrict__ perm,
                     const int32_t* __restrict__ offsets, int64_t n_out,
                     int tile_rows, float* __restrict__ out) {
  constexpr int W = sizeof(V) / sizeof(float);
  __shared__ int32_t run_row[TILE_ROWS], run_lo[TILE_ROWS], run_hi[TILE_ROWS];
  __shared__ int n_runs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t t0 = (int64_t)blockIdx.x * tile_rows;
  const int rows = (int)min((int64_t)tile_rows, n_out - t0);
  if (threadIdx.x == 0) n_runs = 0;
  float* tile = out + t0 * n_cols;
  const int n_floats = rows * (int)n_cols;
  for (int i = threadIdx.x; i < n_floats / 4; i += SEG_THREADS)
    reinterpret_cast<float4*>(tile)[i] = zero_of<float4>();
  for (int i = (n_floats & ~3) + threadIdx.x; i < n_floats; i += SEG_THREADS)
    tile[i] = 0.0f;
  __syncthreads();  // n_runs is 0
  for (int b = warp * 32; b < rows; b += SEG_THREADS) {  // whole warps
    const int rr = b + lane;
    int lo = 0, hi = 0;
    if (rr < rows) lo = __ldg(offsets + t0 + rr), hi = __ldg(offsets + t0 + rr + 1);
    const unsigned m = __ballot_sync(FULL_MASK, lo != hi);
    int base = 0;
    if (lane == 0 && m) base = atomicAdd(&n_runs, __popc(m));
    base = __shfl_sync(FULL_MASK, base, 0);
    if (lo != hi) {
      const int k = base + __popc(m & ((1u << lane) - 1));
      run_row[k] = rr, run_lo[k] = lo, run_hi[k] = hi;
    }
  }
  __syncthreads();  // the list, and the zeros before the sums
  const int items = n_runs * nv;
  for (int i = threadIdx.x; i < items; i += SEG_THREADS) {
    const int k = i / nv, j = i - k * nv;
    *reinterpret_cast<V*>(tile + (int64_t)run_row[k] * n_cols + j * W) =
        walk_run<V>(values, n_cols, (int64_t)j * W, perm, run_lo[k],
                    run_hi[k]);
  }
}

// The tile design's rows a block: TILE_ROWS, halved (to 32) while the
// grid would have fewer than four blocks an SM.
static int tile_rows_for(int64_t n_out) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int rows = TILE_ROWS;
  while (rows > 32 && (n_out + rows - 1) / rows < 4 * (int64_t)sms) rows >>= 1;
  return rows;
}

// grid ceil(n_rows * nv / SEG_THREADS): out[i] = src[i] < 0 ? 0 :
// grad[src[i]], one thread a (row, column group).
template <typename V>
__global__ void __launch_bounds__(SEG_THREADS)
    gather_rows_kernel(const float* __restrict__ grad, int64_t n_cols,
                       int nv, const int32_t* __restrict__ src,
                       int64_t n_items, float* __restrict__ out) {
  constexpr int W = sizeof(V) / sizeof(float);
  const int64_t t = (int64_t)blockIdx.x * SEG_THREADS + threadIdx.x;
  if (t >= n_items) return;
  const int64_t i = t / nv;
  const int64_t col = (t - i * nv) * W;
  const int64_t s = __ldg(src + i);
  V v = zero_of<V>();
  if (s >= 0) v = __ldg(reinterpret_cast<const V*>(grad + s * n_cols + col));
  *reinterpret_cast<V*>(out + i * n_cols + col) = v;
}

// Blocks for ``items`` work items; the kernels index items in 32 bits.
static int grid_of(int64_t items, int64_t per_block, unsigned* blocks) {
  if (items >= ((int64_t)1 << 32) - per_block)
    return (int)cudaErrorInvalidValue;
  *blocks = (unsigned)((items + per_block - 1) / per_block);
  return 0;
}

extern "C" {

// values: (n_rows_in, n_cols) f32; perm: the rows in segment order;
// offsets: (n_targets + 1,) int32, target t's run; rows: (n_out,) int64
// target of each output row, or null for row r = target r (n_out =
// n_targets); out: (n_out, n_cols) f32, every row written.  vec4 = 1
// takes float4 loads and stores (n_cols a multiple of 4, values and out
// 16 B aligned).  design: 0 thread per (row, column group), 1 warp per
// row, 2 block per tile of rows (dense output only, out 16 B aligned);
// 1 takes rows of at most 32 lanes (n_cols / 4 with vec4, else n_cols).  n_out == 0
// launches nothing.  Returns cudaGetLastError() after the launch.
int segment_sum(const float* values, int64_t n_cols, const int32_t* perm,
                const int32_t* offsets, const int64_t* rows, int64_t n_out,
                float* out, int vec4, int design, void* stream) {
  if (n_cols <= 0 || n_out < 0 || (vec4 && n_cols % 4) ||
      (design == 2 && (rows || (uintptr_t)out % 16)))
    return (int)cudaErrorInvalidValue;
  if (n_out == 0) return 0;
  const int nv = (int)(vec4 ? n_cols / 4 : n_cols);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned blocks;
  if (design == 2) {
    const int tile_rows = tile_rows_for(n_out);
    if ((int64_t)tile_rows * n_cols >= (int64_t)1 << 31)
      return (int)cudaErrorInvalidValue;
    if (int rc = grid_of(n_out, tile_rows, &blocks)) return rc;
    if (vec4)
      segment_sum_tile<float4><<<blocks, SEG_THREADS, 0, st>>>(
          values, n_cols, nv, perm, offsets, n_out, tile_rows, out);
    else
      segment_sum_tile<float><<<blocks, SEG_THREADS, 0, st>>>(
          values, n_cols, nv, perm, offsets, n_out, tile_rows, out);
  } else if (design == 1) {
    if (nv > 32) return (int)cudaErrorInvalidValue;
    if (int rc = grid_of(n_out, SEG_THREADS / 32, &blocks)) return rc;
    if (vec4)
      segment_sum_warp<float4><<<blocks, SEG_THREADS, 0, st>>>(
          values, n_cols, nv, perm, offsets, rows, n_out, out);
    else
      segment_sum_warp<float><<<blocks, SEG_THREADS, 0, st>>>(
          values, n_cols, nv, perm, offsets, rows, n_out, out);
  } else {
    const int64_t n_items = n_out * nv;
    if (int rc = grid_of(n_items, SEG_THREADS, &blocks)) return rc;
    if (vec4)
      segment_sum_thread<float4><<<blocks, SEG_THREADS, 0, st>>>(
          values, n_cols, nv, perm, offsets, rows, (uint32_t)n_items, out);
    else
      segment_sum_thread<float><<<blocks, SEG_THREADS, 0, st>>>(
          values, n_cols, nv, perm, offsets, rows, (uint32_t)n_items, out);
  }
  return (int)cudaGetLastError();
}

// grad: (n_grad_rows, n_cols) f32; src: (n_rows,) int32 row of grad each
// output row reads, < 0 for zeros; out: (n_rows, n_cols) f32.  vec4 as
// above.  n_rows == 0 launches nothing.  Returns cudaGetLastError().
int segment_sum_backward(const float* grad, int64_t n_cols,
                         const int32_t* src, int64_t n_rows, float* out,
                         int vec4, void* stream) {
  if (n_cols <= 0 || n_rows < 0 || (vec4 && n_cols % 4))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  const int nv = (int)(vec4 ? n_cols / 4 : n_cols);
  const int64_t n_items = n_rows * nv;
  unsigned blocks;
  if (int rc = grid_of(n_items, SEG_THREADS, &blocks)) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec4)
    gather_rows_kernel<float4><<<blocks, SEG_THREADS, 0, st>>>(
        grad, n_cols, nv, src, n_items, out);
  else
    gather_rows_kernel<float><<<blocks, SEG_THREADS, 0, st>>>(
        grad, n_cols, nv, src, n_items, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
