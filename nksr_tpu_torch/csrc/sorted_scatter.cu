// Sorted row scatter-add kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of scripts/microbench_scatter.py, the
// JAX package's study of the lattice CG adjoint's row stage (rows of w f32
// lanes scatter-added into a dense per-cell table, row indices sorted):
//   rate_write_kernel    <- pallas_rate("write"), body _rate_kernel_write
//   rate_read_kernel     <- pallas_rate("read"),  body _rate_kernel_read
//   blocked_scatter_kernel <- pallas_blocked,     body _blocked_kernel
//
// The two rate kernels measure one core's per-row dynamic update (read)
// rate, as the TPU kernels did on a grid of one step: ONE CTA, one thread
// per lane, rows in order.  rate_write zeroes its (bc, w) table first (the
// TPU body never did; its defined function is _blocked_kernel at one
// block) and then does out[idx[r], :] += y[r, :] for r = 0, 1, ...; its
// table (1 MiB at w = 32, 4 MiB at w = 128) is larger than one SM's shared
// memory, so it accumulates in global memory, where it stays in L2.  Their
// figure of merit is ns per row, not the HBM bound: one SM of 132 never
// approaches the card's memory rate.  Each output element is summed in
// row order by one thread, so the result is deterministic.
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

__global__ void rate_write_kernel(const int32_t* __restrict__ idx,
                                  const float* __restrict__ y,
                                  float* __restrict__ out, int64_t n_rows,
                                  int32_t bc, int32_t w) {
  const int64_t n_out = (int64_t)bc * w;
  for (int64_t e = threadIdx.x; e < n_out; e += blockDim.x) out[e] = 0.0f;
  __syncthreads();
  for (int32_t c = threadIdx.x; c < w; c += blockDim.x) {
    for (int64_t r = 0; r < n_rows; ++r) {
      const int32_t i = idx[r];
      if ((uint32_t)i < (uint32_t)bc) out[(int64_t)i * w + c] += y[r * w + c];
    }
  }
}

__global__ void rate_read_kernel(const int32_t* __restrict__ idx,
                                 const float* __restrict__ y,
                                 float* __restrict__ out, int64_t n_idx,
                                 int64_t n_y, int32_t w) {
  for (int32_t c = threadIdx.x; c < w; c += blockDim.x) {
    float acc = 0.0f;
#pragma unroll 8
    for (int64_t r = 0; r < n_idx; ++r) {
      const int32_t i = idx[r];
      if ((uint64_t)i < (uint64_t)n_y) acc += y[(int64_t)i * w + c];
    }
    out[c] = acc;
  }
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

extern "C" int scatter_rate_write(const int32_t* idx, const float* y,
                                  float* out, int64_t n_rows, int32_t bc,
                                  int32_t w, void* stream) {
  const int threads = w < 1024 ? w : 1024;
  rate_write_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(idx, y, out,
                                                             n_rows, bc, w);
  return (int)cudaGetLastError();
}

extern "C" int scatter_rate_read(const int32_t* idx, const float* y,
                                 float* out, int64_t n_idx, int64_t n_y,
                                 int32_t w, void* stream) {
  const int threads = w < 1024 ? w : 1024;
  rate_read_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(idx, y, out,
                                                            n_idx, n_y, w);
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
