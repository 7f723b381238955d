// C1 compact-support window and its gradient for Hopper (sm_90a), plain
// C interface.
//
// Replaces the Pallas TPU kernel window_and_grad_fused
// (nksr_tpu/ops/pallas/window_basis.py, body _kernel).  For each query's
// local offset t = x_loc[q, c, :] (voxel units) to its corner c:
//   u_a = max(0, 1 - t_a^2),  s_a = u_a^2
//   w[q, c]     = s_0 * s_1 * s_2
//   dw[q, c, a] = (-4 t_a u_a) * s_b * s_e   ({b, e} the other two axes)
// The kernel computes the Pallas kernel's function, not its block layout:
// it reads the public (Q, 8, 3) f32 layout and writes w (Q, 8) and
// dw (Q, 8, 3).  The axis-major (Q, 24) transpose and the 1024-row padding
// existed for Mosaic's tiling and are gone.
//
// What bounds it on the H100: it only moves data.  Per query it reads
// 96 B and writes 128 B (32 B of w, 96 B of dw) for about 210 f32
// operations, under 1 per byte against the card's 20 (67 TFLOP/s over
// 3.35 TB/s), so the bound is 224 B / 3.35 TB/s: 67 ns per 1k queries,
// 70 us for a 2^20-query wave.
//
// Design: one thread per (query, corner), masked at the ragged edge.  A
// warp's 32 threads read 384 contiguous bytes and write 128 B of w and
// 384 B of dw, so every transaction is coalesced without staging.  Every
// product and difference is an explicitly rounded intrinsic (__fmul_rn,
// __fsub_rn), so nvcc contracts nothing into an FMA and the result is
// bit-equal to the plain PyTorch version, which multiplies in the same
// order (nksr_tpu_torch/ops/window_basis.py window_and_grad_plain).

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void window_grad_kernel(const float* __restrict__ x,
                                   float* __restrict__ w,
                                   float* __restrict__ dw, int64_t n) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float t0 = x[3 * i], t1 = x[3 * i + 1], t2 = x[3 * i + 2];
  const float u0 = fmaxf(__fsub_rn(1.0f, __fmul_rn(t0, t0)), 0.0f);
  const float u1 = fmaxf(__fsub_rn(1.0f, __fmul_rn(t1, t1)), 0.0f);
  const float u2 = fmaxf(__fsub_rn(1.0f, __fmul_rn(t2, t2)), 0.0f);
  const float s0 = __fmul_rn(u0, u0);
  const float s1 = __fmul_rn(u1, u1);
  const float s2 = __fmul_rn(u2, u2);
  w[i] = __fmul_rn(__fmul_rn(s0, s1), s2);
  const float d0 = __fmul_rn(__fmul_rn(-4.0f, t0), u0);
  const float d1 = __fmul_rn(__fmul_rn(-4.0f, t1), u1);
  const float d2 = __fmul_rn(__fmul_rn(-4.0f, t2), u2);
  dw[3 * i] = __fmul_rn(__fmul_rn(d0, s1), s2);
  dw[3 * i + 1] = __fmul_rn(__fmul_rn(d1, s0), s2);
  dw[3 * i + 2] = __fmul_rn(__fmul_rn(d2, s0), s1);
}

extern "C" int window_and_grad(const float* x, float* w, float* dw,
                               int64_t n_rows, void* stream) {
  // n_rows = Q * 8 (query, corner) pairs
  if (n_rows <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n_rows + threads - 1) / threads;
  window_grad_kernel<<<(unsigned int)blocks, threads, 0,
                       (cudaStream_t)stream>>>(x, w, dw, n_rows);
  return (int)cudaGetLastError();
}
