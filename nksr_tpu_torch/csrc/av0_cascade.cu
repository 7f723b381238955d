// AV0 cascade and its adjoint for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels in nksr_tpu/fields/lattice_pallas.py:
//   av0_cascade_pallas          (_kernel_fwd)  -> av0_fwd_kernel
//   av0_adjoint_cascade_pallas  (_kernel_adj + halo fold) -> av0_adj_kernel
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
// coefficient rows that the L2 mostly serves; the adjoint reads the same
// buffer once.
//
// Design:
//   * forward: one thread per (depth-0 cell, depth, corner), the depth
//     from blockIdx.y.  It reads one k-wide f32 coefficient row (one
//     16 B load at k=4) and writes k values in the output type (one 8 B
//     store in bf16); the 8 corner threads of a cell write one contiguous
//     8k-lane block.
//   * adjoint, written as a gather: one thread per (depth d, coarse cell,
//     corner c).  It sums corner c's k lanes over the 2^(3d) depth-0
//     cells below the ancestor whose corner c is this coarse cell,
//     reading the compute type and accumulating in f32; the 8 corner
//     threads of a cell are adjacent lanes and combine by a fixed
//     butterfly.  Every AV0 element is read by exactly one thread, there
//     are no atomics, the result is deterministic, and the Pallas halo
//     fold disappears.  The deepest depth (the longest sums) takes
//     blockIdx.y = 0, so its blocks start first.
//   * per-depth lattice pointers and dims are read from the kernel
//     parameters with constant indices only (select_depth): a dynamic
//     index spills the parameter struct to local memory in every thread,
//     which cost 10x the write bound in the first version.
// Nothing assumes lanes == 128: lanes = depth * 8 * k.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define AV0_MAX_DEPTH 8

extern "C" {
struct Av0Spec {
  int32_t depth;
  int32_t k;
  int32_t dims[AV0_MAX_DEPTH][3];
};
}

struct ConstPtrs {
  const float* p[AV0_MAX_DEPTH];
};
struct MutPtrs {
  float* p[AV0_MAX_DEPTH];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
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

// grid (ceil(cells_0 * 8 / blockDim.x), depth): thread = (cell, corner)
template <typename T, int K>
__global__ void av0_fwd_kernel(Av0Spec s, ConstPtrs coeff, T* __restrict__ out,
                               int cells0) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int cell = t >> 3;
  if (cell >= cells0) return;
  const int c = t & 7;
  const int d = blockIdx.y;
  const float* src;
  int xd, yd, zd;
  select_depth(s, coeff, d, src, xd, yd, zd);
  const int y0 = s.dims[0][1], z0 = s.dims[0][2];
  const int z = cell % z0, xy = cell / z0;
  const int y = xy % y0, x = xy / y0;
  const int cx = (x >> d) + ((c >> 2) & 1), cy = (y >> d) + ((c >> 1) & 1),
            cz = (z >> d) + (c & 1);
  Vec<T, K> o;
  if (cx < xd && cy < yd && cz < zd) {
    const Vec<float, K> v = *reinterpret_cast<const Vec<float, K>*>(
        src + (((int64_t)cx * yd + cy) * zd + cz) * K);
#pragma unroll
    for (int kk = 0; kk < K; ++kk) o.v[kk] = from_f32<T>(v.v[kk]);
  } else {
#pragma unroll
    for (int kk = 0; kk < K; ++kk) o.v[kk] = from_f32<T>(0.0f);
  }
  const int lanes = s.depth * 8 * K;
  *reinterpret_cast<Vec<T, K>*>(out + (int64_t)cell * lanes + (d * 8 + c) * K) =
      o;
}

// grid (ceil(max_d n_d * 8 / blockDim.x), depth), blockIdx.y = q takes
// depth d = depth-1-q so the deepest (longest) sums start first.
// Thread = (coarse cell, corner c): it sums corner c's lanes over the
// 2^(3d) depth-0 children of the ancestor whose corner c is this cell;
// the 8 corner threads of a cell are adjacent lanes of one warp and
// combine by a fixed butterfly, so the result is deterministic.
template <typename T, int K>
__global__ void av0_adj_kernel(Av0Spec s, const T* __restrict__ z, MutPtrs out) {
  const int d = s.depth - 1 - (int)blockIdx.y;
  float* dst;
  int xd, yd, zd;
  select_depth(s, out, d, dst, xd, yd, zd);
  const int n = xd * yd * zd;
  // block-uniform exit: the butterfly below needs every lane of a warp
  if ((int64_t)blockIdx.x * blockDim.x >= (int64_t)n * 8) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int cell = t >> 3;
  const bool live = cell < n;
  const int c = t & 7;
  const int cz = cell % zd, cxy = cell / zd;
  const int cy = cxy % yd, cx = cxy / yd;
  const int x0 = s.dims[0][0], y0 = s.dims[0][1], z0 = s.dims[0][2];
  const int lanes = s.depth * 8 * K;
  float acc[K];
#pragma unroll
  for (int kk = 0; kk < K; ++kk) acc[kk] = 0.0f;
  const int ax = cx - ((c >> 2) & 1), ay = cy - ((c >> 1) & 1),
            az = cz - (c & 1);
  if (live && ax >= 0 && ay >= 0 && az >= 0) {
    const int xb = ax << d, yb = ay << d, zb = az << d;
    const int xe = min(xb + (1 << d), x0), ye = min(yb + (1 << d), y0),
              ze = min(zb + (1 << d), z0);
    for (int x = xb; x < xe; ++x) {
      for (int y = yb; y < ye; ++y) {
        const T* row =
            z + (((int64_t)x * y0 + y) * z0 + zb) * lanes + (d * 8 + c) * K;
        for (int zz = zb; zz < ze; ++zz, row += lanes) {
          const Vec<T, K> v = *reinterpret_cast<const Vec<T, K>*>(row);
#pragma unroll
          for (int kk = 0; kk < K; ++kk) acc[kk] += to_f32(v.v[kk]);
        }
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    float v = acc[kk];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    acc[kk] = v;
  }
  if (live && c == 0) {
#pragma unroll
    for (int kk = 0; kk < K; ++kk) dst[(int64_t)cell * K + kk] = acc[kk];
  }
}

template <typename T, int K>
static void launch_fwd(const Av0Spec& s, const ConstPtrs& c, void* out,
                       int cells0, cudaStream_t st) {
  const int threads = 256;
  const dim3 grid((unsigned)(((int64_t)cells0 * 8 + threads - 1) / threads),
                  (unsigned)s.depth);
  av0_fwd_kernel<T, K><<<grid, threads, 0, st>>>(s, c, static_cast<T*>(out),
                                                  cells0);
}

template <typename T, int K>
static void launch_adj(const Av0Spec& s, const void* z, const MutPtrs& o,
                       int max_cells, cudaStream_t st) {
  const int threads = 256;
  const dim3 grid((unsigned)(((int64_t)max_cells * 8 + threads - 1) / threads),
                  (unsigned)s.depth);
  av0_adj_kernel<T, K><<<grid, threads, 0, st>>>(
      s, static_cast<const T*>(z), o);
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

extern "C" {

// coeff[d]: (n_d, k) f32; out: (cells_0, depth*8*k) in f32 (out_bf16=0)
// or bf16 (out_bf16=1).  Returns cudaGetLastError() after the launch.
int av0_cascade_fwd(const Av0Spec* spec, const void* const* coeff, void* out,
                    int out_bf16, void* stream) {
  if (!dims_ok(spec)) return (int)cudaErrorInvalidValue;
  ConstPtrs c;
  for (int d = 0; d < spec->depth; ++d)
    c.p[d] = static_cast<const float*>(coeff[d]);
  const int cells0 = spec->dims[0][0] * spec->dims[0][1] * spec->dims[0][2];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    AV0_DISPATCH_K(launch_fwd, __nv_bfloat16, *spec, c, out, cells0, st)
  } else {
    AV0_DISPATCH_K(launch_fwd, float, *spec, c, out, cells0, st)
  }
  return (int)cudaGetLastError();
}

// z: (cells_0, depth*8*k) in f32 (in_bf16=0) or bf16 (in_bf16=1);
// out[d]: (n_d, k) f32, every element written.  Returns cudaGetLastError().
int av0_cascade_adj(const Av0Spec* spec, const void* z, void* const* out,
                    int in_bf16, void* stream) {
  if (!dims_ok(spec)) return (int)cudaErrorInvalidValue;
  MutPtrs o;
  int max_cells = 0;
  for (int d = 0; d < spec->depth; ++d) {
    o.p[d] = static_cast<float*>(out[d]);
    const int n = spec->dims[d][0] * spec->dims[d][1] * spec->dims[d][2];
    if (n > max_cells) max_cells = n;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    AV0_DISPATCH_K(launch_adj, __nv_bfloat16, *spec, z, o, max_cells, st)
  } else {
    AV0_DISPATCH_K(launch_adj, float, *spec, z, o, max_cells, st)
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
