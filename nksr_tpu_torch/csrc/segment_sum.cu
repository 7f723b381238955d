// Fixed-order segment sum for Hopper (sm_90a), plain C interface.
//
// No TPU kernel is replaced.  The kernel stands in for XLA's ordered
// scatter-add, ``z0.at[...].add`` (nksr_tpu/fields/lattice.py:1231-1234),
// and for the CPU's ``index_add_``: both add the rows of a repeated index
// one after another in index order.  CUDA ``index_add_`` sums repeated
// indices with f32 atomics in no fixed order, so two runs on one input
// differ in their last bits; this kernel makes every sum in one fixed
// order and two calls on one input are bit-equal.
//
// What it computes: rows ``values`` (R, C) f32 and a target per row.  The
// order is data, built by the caller (ops/segment_sum.py,
// ``segment_order``): ``perm`` lists the rows sorted by (target, row),
// and segment s, one per distinct target, is perm[offsets[s] ..
// offsets[s+1]).  Output row s (compact) or row targets[s] (dense, the
// rest of the output zeroed by the caller) is
//   0.0 + values[perm[offsets[s]]] + values[perm[offsets[s] + 1]] + ...
// added left to right, bit for bit what CPU index_add_ and np.add.at
// compute.
//
// What bounds it on the H100: it moves data and adds each value once.
// R*C*4 bytes of rows read (each once), R*4 of perm, the output written
// once: at the lattice solve's 2^20 slot rows of 128 lanes, 0.54 GB read
// and 0.22 GB of compact rows written, 0.23 ms at 3.35 TB/s.
//
// Design: no atomics; one thread owns one (segment, column group) and
// walks the segment's rows in order.  Threads run across the columns of
// a segment, so the threads of a warp read neighbouring bytes of one row:
// 16 B (float4) loads where C is a multiple of 4, else 4 B.  At 128 lanes
// a warp is one segment and one 512 B row a step.  Four rows of a segment
// are loaded before any is added, so four loads are in flight while the
// adds still go in row order.  Segments are as long as the data makes
// them: a thread of a long segment walks it alone, so the longest
// segment sets a floor under the kernel's time, and callers keep
// segments short: the lattice solve drops its pad slots from the order
// (some 10^5 zero rows on one cell, 41 ms a call on an H100 if summed).
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py): 0.219 ms at
// the solve's 2^20 slot rows of 128 lanes; 0.220 ms at the encoder
// splat (8M rows x 7 onto 8.6M cells, longest segment 49; bound 0.158
// ms) where zeros + index_add_ takes 0.507 ms.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_ops.cuh"

#define SEG_THREADS 256
#define SEG_UNROLL 4

// grid ceil(n_seg * nv / SEG_THREADS): item t = (segment t / nv, column
// group t % nv), a group being one V of columns.
template <typename V>
__global__ void __launch_bounds__(SEG_THREADS)
    segment_sum_kernel(const float* __restrict__ values, int64_t n_cols,
                       int nv, const int32_t* __restrict__ perm,
                       const int32_t* __restrict__ offsets, int64_t n_items,
                       const int64_t* __restrict__ rows,
                       float* __restrict__ out) {
  constexpr int W = sizeof(V) / sizeof(float);
  const int64_t t = (int64_t)blockIdx.x * SEG_THREADS + threadIdx.x;
  if (t >= n_items) return;
  const int64_t s = t / nv;
  const int64_t col = (t - s * nv) * W;
  const int lo = __ldg(offsets + s), hi = __ldg(offsets + s + 1);
  V acc = zero_of<V>();
  int e = lo;
  for (; e + SEG_UNROLL <= hi; e += SEG_UNROLL) {
    V v[SEG_UNROLL];
#pragma unroll
    for (int u = 0; u < SEG_UNROLL; ++u) {
      const int64_t i = __ldg(perm + e + u);
      v[u] = __ldg(reinterpret_cast<const V*>(values + i * n_cols + col));
    }
#pragma unroll
    for (int u = 0; u < SEG_UNROLL; ++u) add_to(acc, v[u]);
  }
  for (; e < hi; ++e) {
    const int64_t i = __ldg(perm + e);
    add_to(acc, __ldg(reinterpret_cast<const V*>(values + i * n_cols + col)));
  }
  const int64_t r = rows ? __ldg(rows + s) : s;
  *reinterpret_cast<V*>(out + r * n_cols + col) = acc;
}

extern "C" {

// values: (n_rows_in, n_cols) f32; perm: the rows in segment order;
// offsets: (n_seg + 1,) int32; rows: (n_seg,) int64 output row of each
// segment, or null for compact output (row s); out: f32 rows of n_cols.
// vec4 = 1 takes float4 loads and stores (n_cols a multiple of 4, values
// and out 16 B aligned).  n_seg == 0 launches nothing.  Returns
// cudaGetLastError() after the launch.
int segment_sum(const float* values, int64_t n_cols, const int32_t* perm,
                const int32_t* offsets, int64_t n_seg, const int64_t* rows,
                float* out, int vec4, void* stream) {
  if (n_cols <= 0 || n_seg < 0 || (vec4 && n_cols % 4))
    return (int)cudaErrorInvalidValue;
  if (n_seg == 0) return 0;
  const int nv = (int)(vec4 ? n_cols / 4 : n_cols);
  const int64_t n_items = n_seg * nv;
  const int64_t blocks = (n_items + SEG_THREADS - 1) / SEG_THREADS;
  if (blocks >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec4)
    segment_sum_kernel<float4><<<(unsigned)blocks, SEG_THREADS, 0, st>>>(
        values, n_cols, nv, perm, offsets, n_items, rows, out);
  else
    segment_sum_kernel<float><<<(unsigned)blocks, SEG_THREADS, 0, st>>>(
        values, n_cols, nv, perm, offsets, n_items, rows, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
