// AV0 cascade and its adjoint for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels in nksr_tpu/fields/lattice_pallas.py:
//   av0_cascade_pallas          (_kernel_fwd)  -> av0_fwd_lines
//   av0_cascade_pallas followed by the matvec's sorted row gather
//     (nksr_tpu/fields/lattice.py _take_rows_sorted; the same function
//     as its _row_blocks)                      -> av0_rows_kernel
//   av0_adjoint_cascade_pallas  (_kernel_adj + halo fold)
//                               -> av0_adj_bricks, then av0_adj_corners
//   the matvec's ordered scatter-add of its slot rows into the dense
//     buffer (nksr_tpu/fields/lattice.py apply_AT, z0.at[...].add)
//     followed by av0_adjoint_cascade_pallas
//                               -> av0_adj_rows_bricks, then
//                                  av0_adj_rows_tiles
//
// Per depth d and cell corner (i, j, l) in {0,1}^3, with lane group
// g = 8d + 4i + 2j + l:
//   AV0[x, y, z, g*k + kk] = coeff_d[(x>>d)+i, (y>>d)+j, (z>>d)+l, kk]
// reads past the lattice edge are zero.  The adjoint is the exact
// transpose: each coefficient sums the AV0 lanes of every depth-0 cell
// whose depth-d corner lands on it; contributions from beyond the edge
// are dropped.  ``cell_d = cell_0 >> d`` is exact because plan_lattice
// nests the per-depth origins (zero phase).
//
// What bounds them on the H100: both move data and do no arithmetic to
// speak of.  The forward writes cells_0 * lanes values (2.2 GB of bf16
// at the 1M-point bench plan: 8.6M cells x 128 lanes) and reads
// coefficient rows that the L2 mostly serves.  The adjoint reads that
// buffer once and writes the coefficients: the lattice solve hands it
// f32 (4.42 GB at that plan; with the 0.17 GB coefficient write its
// bound is 1.368 ms at 3.35 TB/s), read in bf16 by the matvec.
//
// Forward (av0_fwd_lines), the evaluator's table, its only caller.  It
// is bound by its write: at the bench plan 2.209 GB of bf16 table and
// 0.166 GB of coefficients read once, 0.709 ms at 3.35 TB/s; a plain
// write of the table's bytes (empty_like(out).zero_()) takes 0.673 ms on
// an H100.  The coefficient rows are read again and again (up to 8 * 8^d
// cells read one), from L1 and L2.  Design: a CTA writes a run of one
// z-line (x, y) of depth-0 cells, whose rows lie one after another in the
// output, so x and y come from the block index and only z moves; a
// thread writes one 16 B chunk of the row (two corners at k = 4 in bf16,
// one in f32) for a quad of 4 cells one after another in z, so a warp
// writes whole 128 B lines and a row is done by one warp, all its depths
// at once.  A quad starts at a multiple of 4, so cell i's depth-d
// ancestor along z is row (i >> d) past the quad's first: a thread loads
// each coefficient row its quad reads once (at k = 4 in bf16 5, 3, 2, 2
// rows of 16 B for depths 0 .. 3, against 8 corner reads), picks them
// with constant register indices, and issues every load before its four
// streaming stores.  Depth pointers and dims come from a shared copy of
// the parameters; cells and coefficients are indexed in 64 bits.
// Measured on an H100 80GB HBM3 at 700 W at the bench plan
// (scripts/time_forward.py, trees that differ only here, in turns): bf16
// 0.822 ms (86% of the bound, 82% of the plain write), f32 1.600 ms
// (bound 1.368, plain write 1.346); at route A's plan (18.7M cells) bf16
// 1.775 ms against a bound of 1.536 ms.  The first forward (a thread a
// (cell, depth, corner), the depth in blockIdx.y, so each row's four
// depth pieces came from four passes over the whole table) took 2.631
// ms.  Tried: a 16 B chunk a thread for 4 cells a run-length apart,
// each reading its corners' rows anew (1.029 ms: scattered 16 B loads,
// twice the load instructions a chunk in bf16); a persistent grid-stride
// loop over the lines (0.989 ms, 56 registers); plain stores in place of
// the streaming ones (0.826 ms).
//
// Slot rows (av0_rows_kernel): the lattice matvec reads AV0 only at its
// slot cells (2^20 rows at the bench plan, on 420k distinct cells: 4.9%
// of the lattice).  Building all of AV0 and gathering the rows wrote
// 2.2 GB to keep 0.27 GB; this kernel writes the rows straight from the
// coefficient lattices, as f32 holding values rounded to the compute
// type (the solve's bmm input).  It is a pure gather bound by its write
// (0.54 GB of f32 rows at the bench plan, 0.16 ms at 3.35 TB/s; the
// coefficient rows it touches are a fraction of the 0.17 GB lattices and
// sorted slots make neighbouring warps read neighbouring rows, from L1
// and L2).  Design: items (row, depth, corner) in row-major order, item
// t writing out[t*k .. t*k+k), so a warp writes whole 128 B lines (at
// depth 4, k=4 a warp's 32 items are one 512 B row, 16 B a thread, and
// read one broadcast cell index); one 16 B __ldg of a coefficient row an
// item; streaming stores (the rows are not read back before they leave
// L2, the coefficients are).  Each thread takes two items a block width
// apart and issues both load chains (cell index, then coefficient row)
// before either store; divisions by runtime extents use host-made magic
// numbers (FastDiv); each thread takes its depth's pointer and dims from
// a shared-memory copy of the parameters, filled with constant indices.
// Measured on an H100 at the bench plan (scripts/time_rows.py, trees
// that differ only here, in turns): two items a thread in blocks of 128
// 0.209 ms (79% of the 0.165 ms bound), one item in blocks of 256 0.262
// ms, three items 0.207 ms, select_depth's chain of selects in place of
// the shared copy 0.330 ms.  Cells outside [0, cells_0) give zero rows.
//
// Adjoint, two kernels, no atomics, every f32 sum in a fixed order (two
// calls on one input are bit-equal):
//   * av0_adj_bricks: one CTA per brick of 8^3 depth-0 cells (any plan of
//     depth <= 4 nests every depth-d ancestor, d <= 3, inside one brick).
//     It streams the lanes of depths >= 1 (lane 8k onward) of its rows
//     once: neighbouring threads load neighbouring 16 B, so every 128 B
//     line is used whole.  Each thread sums the 8 children of a depth-1
//     ancestor in registers; shared memory then folds 8 of those into a
//     depth-2 ancestor and 8 of those into the brick, every value owned
//     by one thread.  Depth d's lanes stop at level min(d, 3) and are
//     written as partials P_d, one row of 8k f32 per ancestor (138, 17
//     and 2 MB at the bench plan).
//   * av0_adj_corners: one thread per (depth, coefficient cell) sums the
//     8 corner partials P_d[cell - off(c), c] in corner order, dropping
//     ancestors past the edge.  Depth 0 takes its 8 neighbours straight
//     from the input's depth-0 lanes: a warp's 32 cells read 16 B of 32
//     neighbouring rows per corner, the other half of each sector comes
//     with the next corner, and the neighbouring x-plane (2.6 MB of
//     depth-0 lanes at the bench plan) is still in the 50 MB L2.  A
//     depth above 3 (no plan uses one) loops over the 8^(d-3) brick
//     partials under each ancestor.
//   About 4.9 GB move per f32 call at the bench plan.  An f32 buffer read
//   in bf16 is rounded in registers (__float2bfloat16_rn), bit for bit
//   the cast the solve would otherwise make first.
//
// Slot-row adjoint (av0_cascade_adj_rows): the lattice solve's buffer is
// zero except at its slot cells (420,027 of 8,629,248 depth-0 cells,
// 4.9%, in 3,995 of 16,854 bricks at the bench plan once the pad slots
// are dropped), so the solve never builds it.  The tables
// (fields/lattice_kernels.py, adjoint_rows_tables, once per solve) order
// the kept slots brick-major: by brick, by depth-1 group in the brick, by
// child place in the group, by slot.  Two kernels, no atomics:
//   * av0_adj_rows_bricks: one CTA per occupied brick.  It loads the
//     brick's group starts, segment offsets and slot order into shared
//     memory once, then deals the groups that hold a slot cell to its
//     warps in turn.  A warp walks a group's slots, 4 rows of 512 B in
//     flight at a time, sums each cell's rows in slot order from 0.0 in
//     f32 and rounds the sum once (ROUND); it writes the cell's depth-0
//     lanes (bf16 in the bf16 form) to a compact row for stage 2 and adds
//     its other lanes, child after child, into the group's row in shared
//     memory.  The folds of depths 2 and 3 and the partial stores are the
//     dense stage 1's (fold_brick).  Segments are short at the bench plan
//     (1 to 6 rows), so no cell holds a warp up for long.
//   * av0_adj_rows_tiles: one CTA per 8^3 tile of each depth's
//     coefficients.  A tile whose corners read no ancestor with an
//     occupied brick under it (``tile_live`` 0: 11,497 of 20,260 tiles at
//     the bench plan) writes +0.0 and reads nothing.  A live depth-0 tile
//     loads the cell map of its 9^3 cells (the tile and the one-cell halo
//     below it) into shared memory and sums each coefficient's 8 corners
//     from the compact depth-0 rows, which L1 serves to neighbouring
//     coefficients; a live tile of a coarser depth sums its corner
//     partials as the dense stage 2 does, skipping the groups of empty
//     bricks, whose partials were never written.
// The sums keep the dense form's order and only omit +0.0 terms (absent
// cells, groups of empty bricks, dead tiles), so the result equals the
// dense form's on the buffer the slot rows sum into, bit for bit up to
// the sign of a zero.  What bounds it at the bench plan: 748,076 kept
// slot rows of 512 B read (0.383 GB), their 3 MB of order and 0.172 GB
// of coefficients written, 0.165 ms at 3.35 TB/s; the compact depth-0
// rows (27 MB in bf16) and the occupied bricks' partials (37 MB) cross
// the L2 between the two kernels.  Measured on an H100 80GB HBM3 at
// 700 W (scripts/time_adjoint.py, in turns with the segment-sum form it
// replaced, 0.66 ms): 0.35 ms in bf16, stage 1 0.21 ms (its rows come in
// the solve's slot order, so brick-major reads are scattered 512 B
// rows), stage 2 0.14 ms (its 0.17 GB coefficient write alone needs
// 0.05 ms).
//
// Lessons kept:
//   * per-depth pointers, dims and partial offsets are read from the
//     kernel parameters with constant indices only (select_depth,
//     select_part), or copied with constant indices into shared memory
//     first (av0_rows_kernel): a dynamic index spills the parameter struct
//     to local memory in every thread, which cost 10x the write bound in
//     the first forward.
//   * cell indices are 32-bit outside the forward (dims_ok checks every
//     n_d * 8 < 2^31); element offsets are 64-bit.
//   * depth 0 staged in shared memory instead (a CTA walking x-planes of a
//     16 x 16 (y, z) tile, each plane's depth-0 lanes loaded once) was 3%
//     slower on an H100 than the gather above, whose neighbour rows L1
//     and L2 already serve.
//   * slot-row adjoint, each tried on an H100 against the design above:
//     a fixed group per warp (group mod 8) left most warps idle where a
//     surface crosses a brick in one or two z-groups (stage 1 0.38 ms);
//     8 rows in flight a warp instead of 4 (more registers, fewer CTAs)
//     0.28 ms against 0.23; stage 1 without the register cap for 6 CTAs
//     an SM 0.23 against 0.20 ms; stage 2 staging the 9^3 rows in 61 KB
//     of dynamic shared memory capped every CTA, dead tiles included, at
//     3 an SM (0.22 ms); a persistent grid-stride stage 2 0.25 ms; both
//     of a thread's cells' loads issued before their stores (80
//     registers) 0.19 ms against 0.14; tile liveness from the slot cells
//     themselves instead of their bricks cut stage 2 by 0.01 ms, but its
//     tables took 1 ms more a solve.
// Nothing assumes lanes == 128: lanes = depth * 8 * k.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#define AV0_MAX_DEPTH 8
#define ADJ_LEVELS 3        // a stage-1 brick is 2^3 depth-0 cells a side
#define ADJ_CHUNK 96        // lanes one pass of a brick folds (shared memory)
#define ADJ_THREADS 256
#define ADJ_UNROLL 4       // slot rows a warp loads before it adds them
#define ADJ_PERM_SMEM 1024  // slots of a brick stage 1 keeps in shared memory
#define ADJ_ROWS_CTAS 6     // stage-1 CTAs an SM holds (caps registers)
#define ROWS_THREADS 128    // slot-row kernel: threads a block
#define ROWS_ITEMS 2        // and items a thread
#define FWD_THREADS 256     // dense forward: most threads a block
#define FWD_QUAD 4          // and cells a thread, one after another in z
#define FWD_MAX_LINES 65535 // and most depth-0 x or y (grid.z, grid.y)

extern "C" {
struct Av0Spec {
  int32_t depth;
  int32_t k;
  int32_t dims[AV0_MAX_DEPTH][3];
};
// The adjoint's stage-1 partials (fields/lattice_kernels.py,
// adjoint_partials): for depth d >= 1, one row of 8k f32 per group of
// 2^min(d, 3) depth-0 cells a side, over grid[d] = ceil(dims_0 /
// 2^min(d, 3)) groups, from float offset[d] of the scratch buffer.
struct Av0AdjLayout {
  int32_t grid[AV0_MAX_DEPTH][3];
  int64_t offset[AV0_MAX_DEPTH];
};
}

struct ConstPtrs {
  const float* p[AV0_MAX_DEPTH];
};
struct MutPtrs {
  float* p[AV0_MAX_DEPTH];
};

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One input value as the adjoint sums it: bf16 as it is; f32 as it is,
// or rounded to bf16 first when the compute type is bf16 (ROUND).
template <bool ROUND>
__device__ __forceinline__ float read_as(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <bool ROUND>
__device__ __forceinline__ float read_as(float v) {
  return ROUND ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// k values of one type as one aligned vector: a 16 B row of k=4 f32 is a
// single 128-bit load, k=4 bf16 a single 64-bit store.
template <typename T, int K>
struct alignas(sizeof(T) * K >= 16 ? 16 : sizeof(T) * K) Vec {
  T v[K];
};

// This depth's lattice, read from the kernel parameters with constant
// indices: a dynamic index into a parameter struct makes every thread
// copy the struct to local memory first.
template <typename P, typename Ptr>
__device__ __forceinline__ void select_depth(const Av0Spec& s, const P& ptrs,
                                             int d, Ptr& p, int& xd, int& yd,
                                             int& zd) {
  p = ptrs.p[0];
  xd = s.dims[0][0], yd = s.dims[0][1], zd = s.dims[0][2];
#pragma unroll
  for (int q = 1; q < AV0_MAX_DEPTH; ++q) {
    if (q == d) {
      p = ptrs.p[q];
      xd = s.dims[q][0], yd = s.dims[q][1], zd = s.dims[q][2];
    }
  }
}

// Depth d's partials (d >= 1) and their group grid, likewise.
template <typename F>
__device__ __forceinline__ void select_part(const Av0AdjLayout& lay, F* part,
                                            int d, F*& p, int& gx, int& gy,
                                            int& gz) {
  p = part;
  gx = gy = gz = 0;
#pragma unroll
  for (int q = 1; q < AV0_MAX_DEPTH; ++q) {
    if (q == d) {
      p = part + lay.offset[q];
      gx = lay.grid[q][0], gy = lay.grid[q][1], gz = lay.grid[q][2];
    }
  }
}

// n / d for 0 <= n < 2^31 and 1 <= d < 2^31 with one multiply-high: the
// magic number m and shift s are made on the host (fast_div).
struct FastDiv {
  uint32_t d, m, s;
};
__device__ __forceinline__ uint32_t div_by(uint32_t n, const FastDiv& f) {
  return (__umulhi(n, f.m) + n) >> f.s;
}

struct DepthLattice {
  const float* p;
  int32_t x, y, z;
};

// k f32 coefficients of one row, read through the read-only path in 16 B
// (k >= 4), 8 B or 4 B loads.
template <int K>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K; q += 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p + q));
      v[q] = a.x, v[q + 1] = a.y, v[q + 2] = a.z, v[q + 3] = a.w;
    }
  } else if constexpr (K == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = a.x, v[1] = a.y;
  } else {
    v[0] = __ldg(p);
  }
}

// k f32 values as streaming (evict-first) stores of 16, 8 or 4 B.
template <int K>
__device__ __forceinline__ void store_row(float* p, const float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K; q += 4)
      __stcs(reinterpret_cast<float4*>(p + q),
             make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]));
  } else if constexpr (K == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    __stcs(p, v[0]);
  }
}

// grid (runs, y0, x0), block (chunks of a row, rows of the CTA): the CTA
// writes the rows of the depth-0 cells z in [run * 4 * rows, min((run +
// 1) * 4 * rows, z0)) of the line (x, y), which lie one after another in
// the output; thread (r, t) writes 16 B chunk r of the rows of the
// quad of cells z = run * 4 * rows + 4t + i, i < 4.  Chunk r lies in
// depth d = r / CPD and holds NC neighbouring corners (W of the k values
// of one corner where a chunk holds less than a corner: f32, k = 8), so
// a thread's depth, corners and (x, y) ancestors are fixed.  A quad
// starts at a multiple of 4, so cell i's depth-d ancestor along z is
// row (i >> d) past the quad's first.
template <typename T, int K>
__global__ void __launch_bounds__(FWD_THREADS)
    av0_fwd_lines(Av0Spec s, ConstPtrs coeff, T* __restrict__ out) {
  constexpr int V = 16 / sizeof(T);       // values in a 16 B chunk
  constexpr int CPD = 8 * K / V;          // chunks of one depth's 8k lanes
  constexpr int NC = V >= K ? V / K : 1;  // corners a chunk holds
  constexpr int W = V >= K ? K : V;       // values of each
  constexpr int NL = NC >= 2 ? NC / 2 : 1;  // (x, y) ancestors they read
  constexpr int HI = NC >= 2 ? 1 : 0;       // corners l = 0, 1 or one l
  constexpr int NR = FWD_QUAD + HI;         // z rows a quad reads, at most
  static_assert(FWD_QUAD == 4, "rows are picked for quads aligned to 4");
  __shared__ DepthLattice lat[AV0_MAX_DEPTH];
  if (threadIdx.x == 0 && threadIdx.y == 0) {
#pragma unroll
    for (int q = 0; q < AV0_MAX_DEPTH; ++q)
      if (q < s.depth)
        lat[q] = DepthLattice{coeff.p[q], s.dims[q][0], s.dims[q][1],
                              s.dims[q][2]};
  }
  __syncthreads();
  const int r = threadIdx.x, d = r / CPD, q = r % CPD;
  const int x = blockIdx.z, y = blockIdx.y;
  const int y0 = s.dims[0][1], z0 = s.dims[0][2];
  const int z_first =
      ((int)blockIdx.x * (int)blockDim.y + (int)threadIdx.y) * FWD_QUAD;
  if (z_first >= z0) return;
  const DepthLattice L = lat[d];
  int c0, koff;
  if constexpr (V >= K) {
    c0 = q * NC, koff = 0;
  } else {
    c0 = q / (K / V), koff = q % (K / V) * V;
  }
  // rows j = 0 .. HI + (3 >> d) from row a0: cell i's corner l reads row
  // (i >> d) + l; a chunk of one corner starts at its own l
  const int a0 = (z_first >> d) + (NC >= 2 ? 0 : (c0 & 1));
  float v[NL][NR][W];
#pragma unroll
  for (int p = 0; p < NL; ++p) {
    const int c = c0 + 2 * p;
    const int ax = (x >> d) + ((c >> 2) & 1), ay = (y >> d) + ((c >> 1) & 1);
    const float* src = L.p + ((int64_t)ax * L.y + ay) * L.z * K + koff;
    const bool in_xy = ax < L.x && ay < L.y;
#pragma unroll
    for (int j = 0; j < NR; ++j) {
#pragma unroll
      for (int w = 0; w < W; ++w) v[p][j][w] = 0.0f;
      if (in_xy && j <= HI + (3 >> d) && a0 + j < L.z)
        load_row<W>(src + (int64_t)(a0 + j) * K, v[p][j]);
    }
  }
  const int64_t lanes = (int64_t)s.depth * 8 * K;
  T* dst = out + (((int64_t)x * y0 + y) * z0 + z_first) * lanes + r * V;
#pragma unroll
  for (int i = 0; i < FWD_QUAD; ++i) {
    if (z_first + i >= z0) break;
    Vec<T, V> o;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int p = n / 2, l = n & HI;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        // row (i >> d) + l, with constant indices for d = 0, 1 and >= 2
        const float e = d == 0   ? v[p][i + l][w]
                        : d == 1 ? v[p][(i >> 1) + l][w]
                                 : v[p][l][w];
        o.v[n * W + w] = from_f32<T>(e);
      }
    }
    __stcs(reinterpret_cast<float4*>(dst + i * lanes),
           *reinterpret_cast<const float4*>(&o));
  }
}

// grid ceil(rows * depth * 8 / (ROWS_THREADS * ROWS_ITEMS)): item t =
// (row, depth, corner) in row-major order writes out[t*K .. t*K+K).  A
// block takes ROWS_ITEMS runs of ROWS_THREADS items, one thread an item
// of each run: a thread's loads are all issued before its stores.
// ROUND: values rounded to bf16 and widened back (the compute type's
// values in f32).
template <bool ROUND, int K>
__global__ void __launch_bounds__(ROWS_THREADS)
    av0_rows_kernel(Av0Spec s, ConstPtrs coeff, FastDiv groups, FastDiv zdiv,
                    FastDiv ydiv, const int32_t* __restrict__ cells,
                    float* __restrict__ out, int n_items) {
  __shared__ DepthLattice lat[AV0_MAX_DEPTH];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < AV0_MAX_DEPTH; ++q)
      if (q < s.depth)
        lat[q] = DepthLattice{coeff.p[q], s.dims[q][0], s.dims[q][1],
                              s.dims[q][2]};
  }
  __syncthreads();
  const int y0 = s.dims[0][1], z0 = s.dims[0][2];
  const int n0 = s.dims[0][0] * y0 * z0;
  uint32_t ts[ROWS_ITEMS];
  int cl[ROWS_ITEMS];
#pragma unroll
  for (int i = 0; i < ROWS_ITEMS; ++i) {
    ts[i] = (blockIdx.x * ROWS_ITEMS + i) * ROWS_THREADS + threadIdx.x;
    cl[i] = ts[i] < (uint32_t)n_items ? __ldg(cells + div_by(ts[i], groups))
                                      : -1;
  }
  float v[ROWS_ITEMS][K];
#pragma unroll
  for (int i = 0; i < ROWS_ITEMS; ++i) {
#pragma unroll
    for (int kk = 0; kk < K; ++kk) v[i][kk] = 0.0f;
    const int cell = cl[i];
    if (cell < 0 || cell >= n0) continue;
    const uint32_t row = div_by(ts[i], groups);
    const int g = (int)(ts[i] - row * groups.d);
    const int d = g >> 3, c = g & 7;
    const uint32_t xy = div_by((uint32_t)cell, zdiv);
    const uint32_t x = div_by(xy, ydiv);
    const int z = cell - (int)(xy * (uint32_t)z0);
    const int y = (int)(xy - x * (uint32_t)y0);
    const DepthLattice L = lat[d];
    const int cx = ((int)x >> d) + ((c >> 2) & 1),
              cy = (y >> d) + ((c >> 1) & 1), cz = (z >> d) + (c & 1);
    if (cx < L.x && cy < L.y && cz < L.z)
      load_row<K>(L.p + (((int64_t)cx * L.y + cy) * L.z + cz) * K, v[i]);
  }
#pragma unroll
  for (int i = 0; i < ROWS_ITEMS; ++i) {
    if (ts[i] >= (uint32_t)n_items) continue;
    if constexpr (ROUND) {
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
        v[i][kk] = __bfloat162float(from_f32<__nv_bfloat16>(v[i][kk]));
    }
    store_row<K>(out + (int64_t)ts[i] * K, v[i]);
  }
}

// Store level-L groups (n = 8 >> L a side, rows of ``qs`` floats in
// shared memory from lane lo) of brick (bx, by, bz) as depth d's partial
// rows; groups past the grid (no depth-0 cell below) are not stored.
template <int K>
__device__ __forceinline__ void store_groups(const float* q, int qs, int n,
                                             int lo, float* dst, int gx,
                                             int gy, int gz, int bx, int by,
                                             int bz) {
  constexpr int DW4 = 2 * K;  // float4s in one depth's 8k lanes
  for (int o = threadIdx.x; o < n * n * n * DW4; o += ADJ_THREADS) {
    const int f = o % DW4, a = o / DW4;
    const int x = bx * n + a / (n * n), y = by * n + (a / n) % n,
              z = bz * n + a % n;
    if (x < gx && y < gy && z < gz)
      *reinterpret_cast<float4*>(dst + (((int64_t)x * gy + y) * gz + z) *
                                           (8 * K) + 4 * f) =
          *reinterpret_cast<const float4*>(q + a * qs + lo + 4 * f);
  }
}

// The folds of stage 1 above depth 1, shared by the dense and the
// slot-row form.  q1 holds the brick's 4^3 depth-1 groups (rows of qs
// floats, lanes [0, cw) of depths dlo .. dhi-1, the caller synced after
// filling it); q2 takes its 2^3 depth-2 groups.  Stores depth 1's groups
// (dlo = 1), depth 2's, and the brick's row of each depth >= 3, every
// f32 sum in one fixed order (children in x, y, z bit order).
template <int K>
__device__ __forceinline__ void fold_brick(const Av0AdjLayout& lay,
                                           const float* q1, float* q2, int qs,
                                           int cw, int dlo, int dhi,
                                           float* part, int bx, int by,
                                           int bz) {
  constexpr int DW = 8 * K;
  if (dlo == 1)
    store_groups<K>(q1, qs, 4, 0, part + lay.offset[1], lay.grid[1][0],
                    lay.grid[1][1], lay.grid[1][2], bx, by, bz);
  // level 2: lanes of depths >= 2, 8 depth-1 groups each
  const int l2 = (max(dlo, 2) - dlo) * DW;
  const int w2 = (cw - l2) >> 2;
  for (int o = threadIdx.x; o < 8 * w2; o += ADJ_THREADS) {
    const int lane = l2 + 4 * (o % w2), g = o / w2;
    const int ax = 2 * (g >> 2), ay = 2 * ((g >> 1) & 1), az = 2 * (g & 1);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int ch = 0; ch < 8; ++ch) {
      const int a = ((ax + (ch >> 2)) * 4 + ay + ((ch >> 1) & 1)) * 4 + az +
                    (ch & 1);
      const float4 v = *reinterpret_cast<const float4*>(q1 + a * qs + lane);
      acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
    }
    *reinterpret_cast<float4*>(q2 + g * qs + lane) = acc;
  }
  __syncthreads();
  if (dlo <= 2 && 2 < dhi)
    store_groups<K>(q2, qs, 2, (2 - dlo) * DW, part + lay.offset[2],
                    lay.grid[2][0], lay.grid[2][1], lay.grid[2][2], bx, by,
                    bz);
  // level 3: lanes of depths >= 3, the brick's 8 depth-2 groups, stored
  // as depth d's row of this brick
  const int l3 = (max(dlo, 3) - dlo) * DW;
  for (int o = threadIdx.x; o < (cw - l3) >> 2; o += ADJ_THREADS) {
    const int lane = l3 + 4 * o;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(q2 + g * qs + lane);
      acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
    }
    float* dst;
    int gx, gy, gz;
    select_part(lay, part, dlo + lane / DW, dst, gx, gy, gz);
    *reinterpret_cast<float4*>(dst + (((int64_t)bx * gy + by) * gz + bz) *
                                         DW + lane % DW) = acc;
  }
  __syncthreads();  // q1 and q2 may be refilled
}

// Stage 1 of the dense adjoint.  grid: one CTA per 8^3 brick of depth-0
// cells (z fastest).  Each pass folds the lanes of up to ADJ_CHUNK / 8k
// depths.
template <typename T, bool ROUND, int K>
__global__ void __launch_bounds__(ADJ_THREADS)
    av0_adj_bricks(Av0Spec s, Av0AdjLayout lay, const T* __restrict__ z,
                   float* __restrict__ part) {
  constexpr int VW = 16 / sizeof(T);  // values in one 16 B load
  constexpr int DW = 8 * K;           // lanes of one depth
  constexpr int DPC = ADJ_CHUNK / DW;
  __shared__ __align__(16) float q1[64 * ADJ_CHUNK];  // 4^3 depth-1 groups
  __shared__ __align__(16) float q2[8 * ADJ_CHUNK];   // 2^3 depth-2 groups
  const int x0 = s.dims[0][0], y0 = s.dims[0][1], z0 = s.dims[0][2];
  const int nby = (y0 + 7) >> 3, nbz = (z0 + 7) >> 3;
  const int b = (int)blockIdx.x;
  const int bz = b % nbz, bxy = b / nbz;
  const int by = bxy % nby, bx = bxy / nby;
  const int lanes = s.depth * DW;
  for (int dlo = 1; dlo < s.depth; dlo += DPC) {
    const int dhi = min(dlo + DPC, s.depth);
    const int cw = (dhi - dlo) * DW;
    // level 1: owner (group a, 16 B unit u) sums unit u of its 8 children
    const int nu = cw / VW;
    for (int o = threadIdx.x; o < 64 * nu; o += ADJ_THREADS) {
      const int u = o % nu, a = o / nu;
      const int x = bx * 8 + 2 * (a >> 4), y = by * 8 + 2 * ((a >> 2) & 3),
                zc = bz * 8 + 2 * (a & 3);
      float acc[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) acc[e] = 0.0f;
#pragma unroll
      for (int ch = 0; ch < 8; ++ch) {
        const int cx = x + (ch >> 2), cy = y + ((ch >> 1) & 1),
                  cz = zc + (ch & 1);
        if (cx < x0 && cy < y0 && cz < z0) {
          const Vec<T, VW> v = *reinterpret_cast<const Vec<T, VW>*>(
              z + (((int64_t)cx * y0 + cy) * z0 + cz) * lanes + dlo * DW +
              u * VW);
#pragma unroll
          for (int e = 0; e < VW; ++e) acc[e] += read_as<ROUND>(v.v[e]);
        }
      }
      float* q = q1 + a * ADJ_CHUNK + u * VW;
#pragma unroll
      for (int e = 0; e < VW; e += 4)
        *reinterpret_cast<float4*>(q + e) =
            make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
    }
    __syncthreads();
    fold_brick<K>(lay, q1, q2, ADJ_CHUNK, cw, dlo, dhi, part, bx, by, bz);
  }
}

// Where stage 2 finds a row of its input: the row of a cell of the dense
// buffer is the cell itself (DenseRow); the stage-1 partials of a brick
// that holds no slot were never written and read as zero (OccupiedGroup:
// group (ax, ay, az) of 2^(3 - sh) depth-0 cells a side lies in brick
// (ax, ay, az) >> sh).
struct DenseRow {
  __device__ __forceinline__ int64_t operator()(int64_t flat, int, int,
                                                int) const {
    return flat;
  }
};
struct OccupiedGroup {
  const uint8_t* occ;
  int sh, nby, nbz;
  __device__ __forceinline__ int64_t operator()(int64_t flat, int ax, int ay,
                                                int az) const {
    return __ldg(occ + ((int64_t)(ax >> sh) * nby + (ay >> sh)) * nbz +
                 (az >> sh))
               ? flat
               : -1;
  }
};

// Sum over the 8 corners c of src[row(cell - off(c)), c*K .. c*K+K), rows
// of ``stride`` values over a (gx, gy, gz) grid; cells outside it and
// rows of -1 add nothing.
template <typename TS, bool ROUND, int K, typename RowOf>
__device__ __forceinline__ void corner_sum(const TS* __restrict__ src,
                                           int stride, int gx, int gy, int gz,
                                           int cx, int cy, int cz,
                                           RowOf row_of, float (&acc)[K]) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int ax = cx - ((c >> 2) & 1), ay = cy - ((c >> 1) & 1),
              az = cz - (c & 1);
    if (ax >= 0 && ay >= 0 && az >= 0 && ax < gx && ay < gy && az < gz) {
      const int64_t row =
          row_of(((int64_t)ax * gy + ay) * gz + az, ax, ay, az);
      if (row < 0) continue;
      const Vec<TS, K> v = *reinterpret_cast<const Vec<TS, K>*>(
          src + row * stride + c * K);
#pragma unroll
      for (int kk = 0; kk < K; ++kk) acc[kk] += read_as<ROUND>(v.v[kk]);
    }
  }
}

// Depth d > 3: each ancestor covers 2^sh brick partials a side (sh = d - 3),
// summed in x, y, z order under each corner.  OCC: bricks that hold no
// slot (brick_occ 0) were never written and are skipped.
template <int K, bool OCC>
__device__ void corner_sum_wide(const float* __restrict__ src, int gx, int gy,
                                int gz, int sh, int cx, int cy, int cz,
                                const uint8_t* __restrict__ brick_occ,
                                float (&acc)[K]) {
  const int f = 1 << sh;
  const int ex = (gx + f - 1) >> sh, ey = (gy + f - 1) >> sh,
            ez = (gz + f - 1) >> sh;
  for (int c = 0; c < 8; ++c) {
    const int ax = cx - ((c >> 2) & 1), ay = cy - ((c >> 1) & 1),
              az = cz - (c & 1);
    if (ax < 0 || ay < 0 || az < 0 || ax >= ex || ay >= ey || az >= ez)
      continue;
    for (int qx = ax << sh; qx < min((ax + 1) << sh, gx); ++qx)
      for (int qy = ay << sh; qy < min((ay + 1) << sh, gy); ++qy)
        for (int qz = az << sh; qz < min((az + 1) << sh, gz); ++qz) {
          const int64_t q = ((int64_t)qx * gy + qy) * gz + qz;
          if (OCC && !__ldg(brick_occ + q)) continue;
          const float* row = src + q * (8 * K) + c * K;
#pragma unroll
          for (int kk = 0; kk < K; ++kk) acc[kk] += row[kk];
        }
  }
}

// Stage 2 of the dense adjoint.  grid: ceil(n_d / ADJ_THREADS) blocks for
// each depth, depth 0 first; thread = one coefficient cell of its block's
// depth.
template <typename T, bool ROUND, int K>
__global__ void __launch_bounds__(ADJ_THREADS)
    av0_adj_corners(Av0Spec s, Av0AdjLayout lay, const T* __restrict__ z,
                    const float* __restrict__ part, MutPtrs out) {
  int d = 0, first = 0, start = 0;
#pragma unroll
  for (int q = 0; q < AV0_MAX_DEPTH; ++q) {
    if (q < s.depth) {
      if ((int)blockIdx.x >= start) d = q, first = start;
      start += (s.dims[q][0] * s.dims[q][1] * s.dims[q][2] + ADJ_THREADS - 1) /
               ADJ_THREADS;
    }
  }
  float* dst;
  int xd, yd, zd;
  select_depth(s, out, d, dst, xd, yd, zd);
  const int cell = ((int)blockIdx.x - first) * ADJ_THREADS + threadIdx.x;
  if (cell >= xd * yd * zd) return;
  const int cz = cell % zd, cxy = cell / zd;
  const int cy = cxy % yd, cx = cxy / yd;
  float acc[K];
#pragma unroll
  for (int kk = 0; kk < K; ++kk) acc[kk] = 0.0f;
  if (d == 0) {
    corner_sum<T, ROUND, K>(z, s.depth * 8 * K, s.dims[0][0], s.dims[0][1],
                            s.dims[0][2], cx, cy, cz, DenseRow{}, acc);
  } else {
    const float* src;
    int gx, gy, gz;
    select_part(lay, part, d, src, gx, gy, gz);
    if (d > ADJ_LEVELS)
      corner_sum_wide<K, false>(src, gx, gy, gz, d - ADJ_LEVELS, cx, cy, cz,
                                nullptr, acc);
    else
      corner_sum<float, false, K>(src, 8 * K, gx, gy, gz, cx, cy, cz,
                                  DenseRow{}, acc);
  }
  Vec<float, K> o;
#pragma unroll
  for (int kk = 0; kk < K; ++kk) o.v[kk] = acc[kk];
  *reinterpret_cast<Vec<float, K>*>(dst + (int64_t)cell * K) = o;
}

// ------------------------------------------------------ slot-row adjoint
// The depth-0 lanes of a cell's summed row, as stage 1 hands them to
// stage 2: bf16 when the compute type is bf16 (the values are rounded to
// it, so nothing is lost), else f32.
template <bool ROUND>
using D0Row = typename std::conditional<ROUND, __nv_bfloat16, float>::type;

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
__device__ __forceinline__ void add4(float4& a, const float4& v) {
  a.x += v.x, a.y += v.y, a.z += v.z, a.w += v.w;
}
template <bool ROUND>
__device__ __forceinline__ float4 round4(const float4& v) {
  return make_float4(read_as<ROUND>(v.x), read_as<ROUND>(v.y),
                     read_as<ROUND>(v.z), read_as<ROUND>(v.w));
}
template <typename D>
__device__ __forceinline__ void store4(D* p, const float4& v) {
  Vec<D, 4> o;
  o.v[0] = from_f32<D>(v.x), o.v[1] = from_f32<D>(v.y);
  o.v[2] = from_f32<D>(v.z), o.v[3] = from_f32<D>(v.w);
  *reinterpret_cast<Vec<D, 4>*>(p) = o;
}

// Stage 1 of the slot-row adjoint.  grid: one CTA per occupied brick
// (``bricks``, ascending); dynamic shared memory (adj_rows_smem): the
// brick's 4^3 depth-1 and 2^3 depth-2 groups, qw = (depth - 1) * 8K
// floats each, its 65 group starts, its <= 513 segment offsets, the
// list of its groups that hold a slot cell and the first ADJ_PERM_SMEM
// of its slots, each loaded once, coalesced.  A warp then takes one of
// those groups at a time, in turn, and walks its slots (brick-major,
// so the group's children follow each other in child order and each
// child's slots in slot order) ADJ_UNROLL rows at a time, a 16 B unit of
// the row a thread: each child's rows are summed from 0.0 in f32,
// rounded once (ROUND), then its depth-0 lanes go to d0 (one row a
// segment) and its other lanes are added, child after child, into the
// group's row of q1.  fold_brick then folds depths 2 and 3 as the dense
// stage 1 does.
template <bool ROUND, int K>
__global__ void __launch_bounds__(ADJ_THREADS, ADJ_ROWS_CTAS)
    av0_adj_rows_bricks(Av0Spec s, Av0AdjLayout lay,
                        const float* __restrict__ y,
                        const int32_t* __restrict__ perm,
                        const int32_t* __restrict__ seg_off,
                        const int32_t* __restrict__ bricks,
                        const int32_t* __restrict__ group_seg,
                        D0Row<ROUND>* __restrict__ d0,
                        float* __restrict__ part) {
  constexpr int DW = 8 * K;
  extern __shared__ __align__(16) float q1[];
  const int lanes = s.depth * DW, qw = lanes - DW;
  float* q2 = q1 + 64 * qw;
  int* gs = reinterpret_cast<int*>(q2 + 8 * qw);  // 65
  int* soff = gs + 65;                            // up to 513
  int* glist = soff + 513;                        // 64 + a count
  int* sperm = glist + 65;                        // ADJ_PERM_SMEM
  const int nu = lanes >> 2, nu0 = DW >> 2;  // 16 B units: row, depth 0
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = __ldg(bricks + blockIdx.x);
  for (int a = threadIdx.x; a <= 64; a += ADJ_THREADS)
    gs[a] = __ldg(group_seg + (int64_t)b * 64 + a);
  __syncthreads();
  const int s0 = gs[0], ns = gs[64] - s0;
  for (int i = threadIdx.x; i <= ns; i += ADJ_THREADS)
    soff[i] = __ldg(seg_off + s0 + i);
  __syncthreads();
  const int p0 = soff[0], np = min(soff[ns] - p0, ADJ_PERM_SMEM);
  for (int i = threadIdx.x; i < np; i += ADJ_THREADS)
    sperm[i] = __ldg(perm + p0 + i);
  // the groups that hold a slot cell, in group order: dealt to the warps
  // in turn (a fixed group per warp would leave most warps idle where a
  // surface crosses the brick in one or two z-groups); the others' rows
  // of q1 are zero
  for (int i = threadIdx.x; i < 64 * qw; i += ADJ_THREADS) q1[i] = 0.0f;
  if (warp == 0) {
    int n = 0;
    for (int h = 0; h < 64; h += 32) {
      const bool full = gs[h + lane + 1] > gs[h + lane];
      const unsigned m = __ballot_sync(0xffffffffu, full);
      if (full) glist[n + __popc(m & ((1u << lane) - 1))] = h + lane;
      n += __popc(m);
    }
    if (lane == 0) glist[64] = n;
  }
  __syncthreads();
  for (int w = warp; w < glist[64]; w += ADJ_THREADS / 32) {
    const int a = glist[w];
    const int sl = gs[a] - s0, nch = gs[a + 1] - gs[a];
    const int p_lo = soff[sl], p_hi = soff[sl + nch];
    for (int u0 = 0; u0 < nu; u0 += 32) {
      const int u = u0 + lane;
      const bool on = u < nu;
      float4 g = zero4(), acc = zero4();
      int c = 0, end = nch ? soff[sl + 1] : 0;
      for (int p = p_lo; p < p_hi; p += ADJ_UNROLL) {
        float4 v[ADJ_UNROLL];
#pragma unroll
        for (int q = 0; q < ADJ_UNROLL; ++q) {
          const int i = p + q;
          v[q] = zero4();
          if (on && i < p_hi) {
            const int row = i - p0 < np ? sperm[i - p0] : __ldg(perm + i);
            v[q] = __ldcs(reinterpret_cast<const float4*>(
                              y + (int64_t)row * lanes) + u);
          }
        }
#pragma unroll
        for (int q = 0; q < ADJ_UNROLL; ++q) {
          if (p + q < p_hi) {
            add4(acc, v[q]);
            if (p + q + 1 == end) {  // child c is summed
              const float4 r = round4<ROUND>(acc);
              if (on && u < nu0)
                store4(d0 + (int64_t)(s0 + sl + c) * DW + 4 * u, r);
              else if (on)
                add4(g, r);
              acc = zero4();
              ++c;
              end = c < nch ? soff[sl + c + 1] : 0;
            }
          }
        }
      }
      if (on && u >= nu0)
        *reinterpret_cast<float4*>(q1 + a * qw + 4 * (u - nu0)) = g;
    }
  }
  if (s.depth == 1) return;
  __syncthreads();
  const int nby = (s.dims[0][1] + 7) >> 3, nbz = (s.dims[0][2] + 7) >> 3;
  const int bz = b % nbz, bxy = b / nbz;
  fold_brick<K>(lay, q1, q2, qw, qw, 1, s.depth, part, bxy / nby, bxy % nby,
                bz);
}

// Bytes of stage 1's dynamic shared memory.
static size_t adj_rows_smem(int depth, int k) {
  return (size_t)72 * (depth - 1) * 8 * k * sizeof(float) +
         (65 + 513 + 65 + ADJ_PERM_SMEM) * sizeof(int);
}

// Stage 2 of the slot-row adjoint.  grid: one CTA per 8^3 tile of each
// depth's coefficients (``tile_live``'s order: depth 0 first, z
// fastest); thread = coefficient cells of the tile.  A tile whose
// corners read no ancestor with an occupied brick under it is written
// +0.0 and reads nothing.  A live depth-0 tile
// loads the cell map of its cells and of the one-cell halo below them
// (9^3 cells) into shared memory once; each coefficient then sums its 8
// corners in corner order from the compact depth-0 rows of the cells
// that have one (gathered through L1: neighbouring coefficients read the
// same rows).  A live tile of depth 1 .. 3 sums the stage-1 partials of
// its 8 corner groups (skipping groups of empty bricks), a depth above 3
// the brick partials under each ancestor.
#define TILE_CELLS 729
template <bool ROUND, int K>
__global__ void __launch_bounds__(ADJ_THREADS)
    av0_adj_rows_tiles(Av0Spec s, Av0AdjLayout lay,
                       const D0Row<ROUND>* __restrict__ d0,
                       const int32_t* __restrict__ cell_row,
                       const uint8_t* __restrict__ brick_occ,
                       const uint8_t* __restrict__ tile_live,
                       const float* __restrict__ part, MutPtrs out) {
  using D = D0Row<ROUND>;
  constexpr int DW = 8 * K;
  __shared__ int map[TILE_CELLS];
  int d = 0, first = 0, start = 0;
#pragma unroll
  for (int q = 0; q < AV0_MAX_DEPTH; ++q) {
    if (q < s.depth) {
      if ((int)blockIdx.x >= start) d = q, first = start;
      start += ((s.dims[q][0] + 7) >> 3) * ((s.dims[q][1] + 7) >> 3) *
               ((s.dims[q][2] + 7) >> 3);
    }
  }
  float* dst;
  int xd, yd, zd;
  select_depth(s, out, d, dst, xd, yd, zd);
  const int t = (int)blockIdx.x - first;
  const int tgy = (yd + 7) >> 3, tgz = (zd + 7) >> 3;
  const int tz = t % tgz, txy = t / tgz;
  const int ox = (txy / tgy) * 8, oy = (txy % tgy) * 8, oz = tz * 8;
  const bool live = __ldg(tile_live + blockIdx.x);
  if (live && d == 0) {
    for (int i = threadIdx.x; i < TILE_CELLS; i += ADJ_THREADS) {
      const int x = ox - 1 + i / 81, y = oy - 1 + (i / 9) % 9,
                z = oz - 1 + i % 9;
      map[i] = x >= 0 && y >= 0 && z >= 0 && x < xd && y < yd && z < zd
                   ? __ldg(cell_row + ((int64_t)x * yd + y) * zd + z)
                   : -1;
    }
    __syncthreads();
  }
  for (int o = threadIdx.x; o < 512; o += ADJ_THREADS) {
    const int cx = ox + (o >> 6), cy = oy + ((o >> 3) & 7), cz = oz + (o & 7);
    if (cx >= xd || cy >= yd || cz >= zd) continue;
    float acc[K];
#pragma unroll
    for (int kk = 0; kk < K; ++kk) acc[kk] = 0.0f;
    if (live && d == 0) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int ax = cx - ((c >> 2) & 1), ay = cy - ((c >> 1) & 1),
                  az = cz - (c & 1);
        if (ax < 0 || ay < 0 || az < 0) continue;
        const int r =
            map[((ax - ox + 1) * 9 + ay - oy + 1) * 9 + az - oz + 1];
        if (r < 0) continue;
        const Vec<D, K> v = *reinterpret_cast<const Vec<D, K>*>(
            d0 + (int64_t)r * DW + c * K);
#pragma unroll
        for (int kk = 0; kk < K; ++kk) acc[kk] += read_as<false>(v.v[kk]);
      }
    } else if (live) {
      const float* src;
      int gx, gy, gz;
      select_part(lay, part, d, src, gx, gy, gz);
      if (d > ADJ_LEVELS)
        corner_sum_wide<K, true>(src, gx, gy, gz, d - ADJ_LEVELS, cx, cy, cz,
                                 brick_occ, acc);
      else
        corner_sum<float, false, K>(
            src, 8 * K, gx, gy, gz, cx, cy, cz,
            OccupiedGroup{brick_occ, ADJ_LEVELS - d, (s.dims[0][1] + 7) >> 3,
                          (s.dims[0][2] + 7) >> 3},
            acc);
    }
    Vec<float, K> v;
#pragma unroll
    for (int kk = 0; kk < K; ++kk) v.v[kk] = acc[kk];
    *reinterpret_cast<Vec<float, K>*>(dst + ((int64_t)cx * yd + cy) * zd * K +
                                      (int64_t)cz * K) = v;
  }
}

// The forward's CTA: a row's 16 B chunks by up to FWD_THREADS / chunks
// quads of cells; each z-line's ceil(z0 / 4) quads split into the
// fewest runs of that many, all of one length but the last.
template <typename T, int K>
static void launch_fwd(const Av0Spec& s, const ConstPtrs& c, void* out,
                       cudaStream_t st) {
  const int chunks = s.depth * 8 * K * (int)sizeof(T) / 16;
  const int quads = (int)(((int64_t)s.dims[0][2] + FWD_QUAD - 1) / FWD_QUAD);
  int rows = std::min(FWD_THREADS / chunks, quads);
  const int runs = (quads + rows - 1) / rows;
  rows = (quads + runs - 1) / runs;
  const dim3 grid((unsigned)runs, (unsigned)s.dims[0][1],
                  (unsigned)s.dims[0][0]);
  av0_fwd_lines<T, K><<<grid, dim3(chunks, rows), 0, st>>>(
      s, c, static_cast<T*>(out));
}

static FastDiv fast_div(uint32_t d) {
  uint32_t s = 0;
  while (s < 32 && (1u << s) < d) ++s;
  const uint64_t m = ((uint64_t)1 << 32) * (((uint64_t)1 << s) - d) / d + 1;
  return FastDiv{d, (uint32_t)m, s};
}

template <bool ROUND, int K>
static void launch_rows(const Av0Spec& s, const ConstPtrs& c,
                        const int32_t* cells, float* out, int n_items,
                        cudaStream_t st) {
  const int64_t per_block = ROWS_THREADS * ROWS_ITEMS;
  const unsigned blocks =
      (unsigned)(((int64_t)n_items + per_block - 1) / per_block);
  av0_rows_kernel<ROUND, K><<<blocks, ROWS_THREADS, 0, st>>>(
      s, c, fast_div((uint32_t)(s.depth * 8)),
      fast_div((uint32_t)s.dims[0][2]), fast_div((uint32_t)s.dims[0][1]),
      cells, out, n_items);
}

template <typename T, bool ROUND, int K>
static int launch_adj(const Av0Spec& s, const Av0AdjLayout& lay,
                      const void* z, float* part, const MutPtrs& o,
                      cudaStream_t st) {
  const T* zt = static_cast<const T*>(z);
  const int bricks = ((s.dims[0][0] + 7) >> 3) * ((s.dims[0][1] + 7) >> 3) *
                     ((s.dims[0][2] + 7) >> 3);
  if (s.depth > 1) {
    av0_adj_bricks<T, ROUND, K><<<bricks, ADJ_THREADS, 0, st>>>(s, lay, zt,
                                                                part);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  int blocks = 0;
  for (int d = 0; d < s.depth; ++d)
    blocks += (s.dims[d][0] * s.dims[d][1] * s.dims[d][2] + ADJ_THREADS - 1) /
              ADJ_THREADS;
  av0_adj_corners<T, ROUND, K><<<blocks, ADJ_THREADS, 0, st>>>(s, lay, zt,
                                                               part, o);
  return (int)cudaGetLastError();
}

template <typename T, bool ROUND>
static int adj_k(const Av0Spec& s, const Av0AdjLayout& lay, const void* z,
                 float* part, const MutPtrs& o, cudaStream_t st) {
  switch (s.k) {
    case 1: return launch_adj<T, ROUND, 1>(s, lay, z, part, o, st);
    case 2: return launch_adj<T, ROUND, 2>(s, lay, z, part, o, st);
    case 4: return launch_adj<T, ROUND, 4>(s, lay, z, part, o, st);
    case 8: return launch_adj<T, ROUND, 8>(s, lay, z, part, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The slot-row adjoint's tables (fields/lattice_kernels.py,
// AdjointRowsTables), on the card.
struct RowTables {
  const int32_t* perm;
  const int32_t* seg_off;
  const int32_t* cell_row;
  const int32_t* bricks;
  int n_bricks;
  const int32_t* group_seg;
  const uint8_t* brick_occ;
  const uint8_t* tile_live;
};

// Raise a kernel's dynamic shared memory limit where it needs more than
// the default 48 KB.
template <typename F>
static cudaError_t allow_smem(F* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <bool ROUND, int K>
static int launch_adj_rows(const Av0Spec& s, const Av0AdjLayout& lay,
                           const float* y, const RowTables& t, void* d0,
                           float* part, const MutPtrs& o, cudaStream_t st) {
  using D = D0Row<ROUND>;
  if (t.n_bricks > 0) {
    const size_t smem = adj_rows_smem(s.depth, K);
    cudaError_t e = allow_smem(av0_adj_rows_bricks<ROUND, K>, smem);
    if (e != cudaSuccess) return (int)e;
    av0_adj_rows_bricks<ROUND, K><<<t.n_bricks, ADJ_THREADS, smem, st>>>(
        s, lay, y, t.perm, t.seg_off, t.bricks, t.group_seg,
        static_cast<D*>(d0), part);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  int tiles = 0;
  for (int d = 0; d < s.depth; ++d)
    tiles += ((s.dims[d][0] + 7) >> 3) * ((s.dims[d][1] + 7) >> 3) *
             ((s.dims[d][2] + 7) >> 3);
  av0_adj_rows_tiles<ROUND, K><<<tiles, ADJ_THREADS, 0, st>>>(
      s, lay, static_cast<const D*>(d0), t.cell_row, t.brick_occ,
      t.tile_live, part, o);
  return (int)cudaGetLastError();
}

template <bool ROUND>
static int adj_rows_k(const Av0Spec& s, const Av0AdjLayout& lay,
                      const float* y, const RowTables& t, void* d0,
                      float* part, const MutPtrs& o, cudaStream_t st) {
  switch (s.k) {
    case 1: return launch_adj_rows<ROUND, 1>(s, lay, y, t, d0, part, o, st);
    case 2: return launch_adj_rows<ROUND, 2>(s, lay, y, t, d0, part, o, st);
    case 4: return launch_adj_rows<ROUND, 4>(s, lay, y, t, d0, part, o, st);
    case 8: return launch_adj_rows<ROUND, 8>(s, lay, y, t, d0, part, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

#define AV0_DISPATCH_K(FN, T, ...)             \
  switch (spec->k) {                           \
    case 1: FN<T, 1>(__VA_ARGS__); break;      \
    case 2: FN<T, 2>(__VA_ARGS__); break;      \
    case 4: FN<T, 4>(__VA_ARGS__); break;      \
    case 8: FN<T, 8>(__VA_ARGS__); break;      \
    default: return (int)cudaErrorInvalidValue; \
  }

// Cell counts must fit the kernels' 32-bit thread indices.
static bool dims_ok(const Av0Spec* spec) {
  if (spec->depth < 1 || spec->depth > AV0_MAX_DEPTH) return false;
  for (int d = 0; d < spec->depth; ++d) {
    const int64_t n =
        (int64_t)spec->dims[d][0] * spec->dims[d][1] * spec->dims[d][2];
    if (n <= 0 || n * 8 >= ((int64_t)1 << 31)) return false;
  }
  return true;
}

// The forward indexes cells and coefficients in 64 bits; its grid takes
// the depth-0 lines (x, y) as blockIdx.z and .y.
static bool fwd_dims_ok(const Av0Spec* spec) {
  if (spec->depth < 1 || spec->depth > AV0_MAX_DEPTH) return false;
  for (int d = 0; d < spec->depth; ++d)
    for (int a = 0; a < 3; ++a)
      if (spec->dims[d][a] < 1) return false;
  return spec->dims[0][0] <= FWD_MAX_LINES &&
         spec->dims[0][1] <= FWD_MAX_LINES;
}

// The partial layout the kernels index by: the grids as stage 1 groups
// the depth-0 cells, rows that do not overlap.
static bool layout_ok(const Av0Spec* spec, const Av0AdjLayout* lay) {
  int64_t end = 0;
  for (int d = 1; d < spec->depth; ++d) {
    const int g = d < ADJ_LEVELS ? d : ADJ_LEVELS;
    int64_t rows = 1;
    for (int a = 0; a < 3; ++a) {
      if (lay->grid[d][a] != (spec->dims[0][a] + (1 << g) - 1) >> g)
        return false;
      rows *= lay->grid[d][a];
    }
    if (lay->offset[d] < end) return false;
    end = lay->offset[d] + rows * 8 * spec->k;
  }
  return true;
}

extern "C" {

// coeff[d]: (n_d, k) f32; out: (cells_0, depth*8*k) in f32 (out_bf16=0)
// or bf16 (out_bf16=1).  Returns cudaGetLastError() after the launch.
int av0_cascade_fwd(const Av0Spec* spec, const void* const* coeff, void* out,
                    int out_bf16, void* stream) {
  if (!fwd_dims_ok(spec)) return (int)cudaErrorInvalidValue;
  ConstPtrs c;
  for (int d = 0; d < spec->depth; ++d)
    c.p[d] = static_cast<const float*>(coeff[d]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    AV0_DISPATCH_K(launch_fwd, __nv_bfloat16, *spec, c, out, st)
  } else {
    AV0_DISPATCH_K(launch_fwd, float, *spec, c, out, st)
  }
  return (int)cudaGetLastError();
}

// coeff[d]: (n_d, k) f32; cells: (rows,) int32 depth-0 cells; out:
// (rows, depth*8*k) f32, the values rounded to bf16 when round_bf16=1.
// rows == 0 launches nothing.  Returns cudaGetLastError() after the
// launch.
int av0_rows(const Av0Spec* spec, const void* const* coeff,
             const int32_t* cells, int rows, void* out, int round_bf16,
             void* stream) {
  if (!dims_ok(spec) || rows < 0 ||
      (int64_t)rows * spec->depth * 8 >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  ConstPtrs c;
  for (int d = 0; d < spec->depth; ++d)
    c.p[d] = static_cast<const float*>(coeff[d]);
  const int n_items = rows * spec->depth * 8;
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (round_bf16) {
    AV0_DISPATCH_K(launch_rows, true, *spec, c, cells, o, n_items, st)
  } else {
    AV0_DISPATCH_K(launch_rows, false, *spec, c, cells, o, n_items, st)
  }
  return (int)cudaGetLastError();
}

// z: (cells_0, depth*8*k) in f32 (in_bf16=0) or bf16 (in_bf16=1), an f32
// buffer read in bf16 when round_bf16=1; scratch: the stage-1 partials
// at ``lay``; out[d]: (n_d, k) f32, every element written.  Returns the
// first launch error, else 0.
int av0_cascade_adj(const Av0Spec* spec, const Av0AdjLayout* lay,
                    const void* z, void* scratch, void* const* out,
                    int in_bf16, int round_bf16, void* stream) {
  if (!dims_ok(spec) || !layout_ok(spec, lay))
    return (int)cudaErrorInvalidValue;
  MutPtrs o;
  for (int d = 0; d < spec->depth; ++d) o.p[d] = static_cast<float*>(out[d]);
  float* part = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return adj_k<__nv_bfloat16, false>(*spec, *lay, z, part, o, st);
  if (round_bf16) return adj_k<float, true>(*spec, *lay, z, part, o, st);
  return adj_k<float, false>(*spec, *lay, z, part, o, st);
}

// The slot-row adjoint: the adjoint of the dense buffer whose row of cell
// c is the sum, in slot order from 0.0, of the rows y[i] of the kept
// slots i at c, read in bf16 when round_bf16=1.  y: (slots, depth*8*k)
// f32; the tables as fields/lattice_kernels.py, adjoint_rows_tables,
// builds them (perm: kept slots brick-major; seg_off: each cell's slots
// in perm; cell_row: (cells_0,) segment of a cell, -1 elsewhere; bricks:
// the n_bricks occupied 8^3 bricks ascending, flat over the brick grid
// ceil(dims_0 / 8); group_seg: (64 bricks in the grid + 1,) first
// segment of each (brick, depth-1 group); brick_occ: uint8 over the brick
// grid;
// tile_live: uint8 per 8^3 coefficient tile, depth after depth).  d0:
// (segments, 8k) scratch, bf16 when round_bf16=1 else f32; scratch: the
// stage-1 partials at ``lay`` (only occupied bricks' are written and
// read); out[d]: (n_d, k) f32, every element written.  Returns the first
// launch error, else 0.
int av0_cascade_adj_rows(const Av0Spec* spec, const Av0AdjLayout* lay,
                         const float* y, const int32_t* perm,
                         const int32_t* seg_off, const int32_t* cell_row,
                         const int32_t* bricks, int n_bricks,
                         const int32_t* group_seg, const uint8_t* brick_occ,
                         const uint8_t* tile_live, void* d0, void* scratch,
                         void* const* out, int round_bf16, void* stream) {
  if (!dims_ok(spec) || !layout_ok(spec, lay) || n_bricks < 0)
    return (int)cudaErrorInvalidValue;
  MutPtrs o;
  for (int d = 0; d < spec->depth; ++d) o.p[d] = static_cast<float*>(out[d]);
  float* part = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RowTables t{perm,      seg_off,   cell_row, bricks, n_bricks,
                    group_seg, brick_occ, tile_live};
  if (round_bf16)
    return adj_rows_k<true>(*spec, *lay, y, t, d0, part, o, st);
  return adj_rows_k<false>(*spec, *lay, y, t, d0, part, o, st);
}

}  // extern "C"
