// The fused basis evaluation of the lattice routes for Hopper (sm_90a),
// plain C interface: one kernel writes the lattice solve's rows
// (basis_rows_kernel, launched once for the point rows and once for the
// gradient rows), one evaluates the solved field (basis_field_kernel).
//
// Replaces the Pallas TPU kernel window_and_grad_fused
// (nksr_tpu/ops/pallas/window_basis.py, body _kernel) on the lattice
// routes.  That kernel is the C1 window alone, "the elementwise core that
// multiplies every learned-basis evaluation"; on Hopper the window lives
// in registers inside the basis evaluation it multiplies.  The standalone
// window kernel (csrc/window_basis.cu) stays on the support-row paths,
// which differentiate through the MLP.  The plain PyTorch versions are
// nksr_tpu_torch/fields/basis_kernels.py basis_rows_plain (the JAX
// package's row assembly, nksr_tpu/fields/lattice.py) and
// basis_field_plain (nksr_tpu/fields/lattice_eval.py's query waves).
//
// Per (query, corner c, depth d), in registers:
//   z0     = x / vs_d - cell_d - corner offset (x / vs_d a correctly
//            rounded __fdiv_rn, as core/grid.world_to_grid insists)
//   raw    = 1 + MLP_d(z0, feature row of the corner), SiLU hidden layers,
//            with the three forward tangents d raw / d z0_a when asked
//   w, dw  = prod_a (max(0, 1 - z0_a^2))^2 and its gradient, with the
//            explicitly rounded products of csrc/window_basis.cu
// Rows:  point row lane d*8k + c*k + kk = raw[kk] * (w * act);
//        gradient row a, same lane = (raw * dw_a * act + draw_a * w * act)
//        / vs_d, times the slot's activity.
// Field: value = sum_d sum_(c,kk) raw * w * AV0 lane; gradient likewise
//        with dw (and the tangents), divided by vs_d.
//
// What bounds them on the H100: operations.  At the scene_big width
// (3 + 16 inputs -> 16 -> 16 -> 4, SiLU) a (query, corner, depth) costs
// about 1,400 f32 operations for the value (624 FMAs and 32 SiLUs) and
// some 2,000 more for the three tangents, against 16 B of row written
// (k = 4) and a 64 B feature row gathered mostly from L1 and L2.  At the
// 1M-point bench plan the point rows are 32M triples, about 45 GFLOP:
// 0.67 ms at 67 TFLOP/s, against 0.5 GB of rows, 0.16 ms at 3.35 TB/s.
// Each launch's bound is computed from its own inputs by chip_smoke.py
// (phase 2) and written into PERF.md beside its time.
//
// Design: one thread a (query, corner), so a warp holds 4 queries x 8
// corners; each thread walks the depths.  The MLPs of all depths, packed
// once (fields/basis_kernels.pack_mlps: each layer's weight transposed to
// (inputs, outputs), hidden widths zero-padded to H = 16 or 32, biases
// after their weights), are staged in shared memory at block start and
// read as broadcasts (every lane of a warp reads the same address).
// Hidden activations and the tangents stay in registers: H + 3H values a
// thread, the next layer's H + 3H accumulators beside them.  FMAs run on
// the CUDA cores.  Tensor cores are left out: the layers are 16 wide, the
// reference is f32, and TF32 or bf16 mma would move the rows by more than
// the rounding to bf16 that follows.  The point rows go straight to their
// slot rows (plan_lattice's pt_dest is one-to-one), so no row buffer and
// no index_add_ sit between the kernel and the solve.  A warp writes each
// query's 8k lanes of a depth as one contiguous run.  The field kernel
// sums the 8 corners by xor shuffles (4, 2, 1) in a fixed order and one
// lane a query writes its outputs: no atomics, so two calls are
// bit-equal.  The MLP's sums use FMAs in their own order, so the rows
// differ from the plain version (cuBLAS's order) by a few ulps; every
// other product, difference and division is explicitly rounded in the
// plain version's order.  Cells, rows and lanes are indexed in 64 bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BE_MAX_DEPTH 8
#define BE_MAX_K 8

struct BasisGeom {
  int32_t depth, k, cb, hidden, n_mid, stride;  // stride: floats a depth
  float voxel_size;
  int32_t dims[BE_MAX_DEPTH][3];
  int64_t origins[BE_MAX_DEPTH][3];
  int64_t corner[BE_MAX_DEPTH][8];  // flat-index delta of each cell corner
  const void* feat[BE_MAX_DEPTH];   // padded (cells_d + pad, cb) tables
  const float* act[BE_MAX_DEPTH];   // padded (cells_d + pad,) activity
};

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// the MLP input's rounding to the tables' type (lattice_eval's
// ``z0.to(cdt)``)
__device__ __forceinline__ float round_as(float v, float) { return v; }
__device__ __forceinline__ float round_as(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// feature i of a row, f32 or bf16
template <typename T>
__device__ __forceinline__ void load4(const T* p, float f[4]);
template <>
__device__ __forceinline__ void load4<float>(const float* p, float f[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(const __nv_bfloat16* p,
                                                     float f[4]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  f[0] = __low2float(a); f[1] = __high2float(a);
  f[2] = __low2float(b); f[3] = __high2float(b);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The window and its gradient at the local offset z (lattice.window_grad's
// order: w = (s0 s1) s2, g_a = (du_a s_(a+1)) s_(a+2)).
__device__ __forceinline__ void window(const float z[3], float& w,
                                       float dw[3]) {
  float u[3], s[3], du[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    u[a] = fmaxf(__fsub_rn(1.0f, __fmul_rn(z[a], z[a])), 0.0f);
    s[a] = __fmul_rn(u[a], u[a]);
    du[a] = __fmul_rn(__fmul_rn(-4.0f, z[a]), u[a]);
  }
  w = __fmul_rn(__fmul_rn(s[0], s[1]), s[2]);
#pragma unroll
  for (int a = 0; a < 3; ++a)
    dw[a] = __fmul_rn(__fmul_rn(du[a], s[(a + 1) % 3]), s[(a + 2) % 3]);
}

// One depth's MLP at input (z, feature row ``feat``): raw[kk] = 1 +
// out[kk] and, when ``tan``, dr[a][kk] = d out[kk] / d z_a.  ``w`` is the
// depth's packed block in shared memory (pack_mlps): W0^T (n_in, H), b0
// (H), n_mid x (W^T (H, H), b (H)), Wo^T (H, k), bo (k).
template <int H, bool MAYTAN, typename T>
__device__ __forceinline__ void mlp(const float* __restrict__ w, int cb,
                                    int n_mid, int k, const float z[3],
                                    const T* __restrict__ feat, bool tan,
                                    float raw[BE_MAX_K],
                                    float dr[3][BE_MAX_K]) {
  const int n_in = 3 + cb;
  // H = 16 unrolls whole and keeps every array in registers; H = 32 (off
  // the main path) walks its sums' inputs in a loop, so h and t live in
  // local memory and the source builds in seconds rather than a minute
  constexpr int UI = H <= 16 ? H : 1;
  float h[H], t[3][H];
  const float* b0 = w + n_in * H;
#pragma unroll
  for (int j = 0; j < H; ++j) h[j] = b0[j];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int j = 0; j < H; ++j) h[j] = fmaf(w[a * H + j], z[a], h[j]);
  }
  if (cb % 4 == 0) {
    for (int i = 0; i < cb; i += 4) {
      float f[4];
      load4<T>(feat + i, f);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float* wr = w + (3 + i + ii) * H;
#pragma unroll
        for (int j = 0; j < H; ++j) h[j] = fmaf(wr[j], f[ii], h[j]);
      }
    }
  } else {
    for (int i = 0; i < cb; ++i) {
      const float f = widen(feat[i]);
      const float* wr = w + (3 + i) * H;
#pragma unroll
      for (int j = 0; j < H; ++j) h[j] = fmaf(wr[j], f, h[j]);
    }
  }
  // first layer's tangents: the weight columns of the offset inputs
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int j = 0; j < H; ++j) t[a][j] = (MAYTAN && tan) ? w[a * H + j] : 0.f;
  }
  const float* p = b0 + H;
  for (int l = 0; l <= n_mid; ++l) {
    // SiLU of the previous layer, with its tangents
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float pre = h[j];
      const float s = sigmoid(pre);
      h[j] = pre * s;
      if (MAYTAN && tan) {
        const float ds = s * (1.0f + pre * (1.0f - s));
#pragma unroll
        for (int a = 0; a < 3; ++a) t[a][j] = ds * t[a][j];
      }
    }
    if (l == n_mid) break;
    float h2[H], t2[3][H];
#pragma unroll
    for (int j = 0; j < H; ++j) {
      h2[j] = p[H * H + j];
#pragma unroll
      for (int a = 0; a < 3; ++a) t2[a][j] = 0.f;
    }
#pragma unroll(UI)
    for (int i = 0; i < H; ++i) {
      const float* wr = p + i * H;
#pragma unroll
      for (int j = 0; j < H; ++j) {
        h2[j] = fmaf(wr[j], h[i], h2[j]);
        if (MAYTAN && tan) {
#pragma unroll
          for (int a = 0; a < 3; ++a) t2[a][j] = fmaf(wr[j], t[a][i], t2[a][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < H; ++j) {
      h[j] = h2[j];
#pragma unroll
      for (int a = 0; a < 3; ++a) t[a][j] = t2[a][j];
    }
    p += H * H + H;
  }
  // the output layer: p is Wo^T (H, k), then bo (k)
#pragma unroll
  for (int kk = 0; kk < BE_MAX_K; ++kk) {
    raw[kk] = dr[0][kk] = dr[1][kk] = dr[2][kk] = 0.f;
    if (kk >= k) continue;
    float o = p[H * k + kk];
    float d0 = 0.f, d1 = 0.f, d2 = 0.f;
#pragma unroll(UI)
    for (int i = 0; i < H; ++i) {
      const float wv = p[i * k + kk];
      o = fmaf(wv, h[i], o);
      if (MAYTAN && tan) {
        d0 = fmaf(wv, t[0][i], d0);
        d1 = fmaf(wv, t[1][i], d1);
        d2 = fmaf(wv, t[2][i], d2);
      }
    }
    raw[kk] = 1.0f + o;
    dr[0][kk] = d0; dr[1][kk] = d1; dr[2][kk] = d2;
  }
}

// Stage every depth's packed MLP in shared memory.
__device__ __forceinline__ void stage(float* smem, const float* __restrict__ g,
                                      int n_floats) {
  const float4* src = reinterpret_cast<const float4*>(g);
  float4* dst = reinterpret_cast<float4*>(smem);
  for (int i = threadIdx.x; i < n_floats / 4; i += blockDim.x)
    dst[i] = __ldg(src + i);
  __syncthreads();
}

__device__ __forceinline__ void store_k(float* dst, const float v[BE_MAX_K],
                                        int k) {
  if (k == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else if (k == 8) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int kk = 0; kk < BE_MAX_K; ++kk)
      if (kk < k) dst[kk] = v[kk];
  }
}

// The solve's rows.  GRAD = false: thread (point p, corner c) writes the
// point's row at b_pt row ``slot * p_rows + dest / s_pt`` (slot = dest %
// s_pt), every depth.  GRAD = true: thread (slot s, corner c) writes the
// slot's three gradient rows b_gr[s, a, :], with the tangents when
// ``tan`` (not approx_kernel_grad).
template <int H, bool GRAD>
__global__ void __launch_bounds__(256)
basis_rows_kernel(const BasisGeom g, const float* __restrict__ mlps,
                  const float* __restrict__ xyz,
                  const int64_t* __restrict__ cell0,
                  const int64_t* __restrict__ dest,
                  const int64_t* __restrict__ coords,
                  const int64_t* __restrict__ gdepth,
                  const uint8_t* __restrict__ active,
                  const int64_t* __restrict__ slot_cells, int64_t n,
                  int64_t n_slots, int p_rows, int tan,
                  float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  stage(smem, mlps, g.depth * g.stride);
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n * 8) return;
  const int64_t q = i >> 3;
  const int c = (int)(i & 7);
  const float off[3] = {(float)((c >> 2) & 1), (float)((c >> 1) & 1),
                        (float)(c & 1)};
  const int k = g.k;
  const int64_t lanes = (int64_t)g.depth * 8 * k;
  float x[3];
  int64_t base[3];
  int64_t slot, row;
  float am = 1.0f;
  int dd = 0;
  if (GRAD) {
    slot = q;
    dd = (int)gdepth[q];
    const float scale = ldexpf(g.voxel_size, dd);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      base[a] = coords[3 * q + a];
      x[a] = __fmul_rn((float)base[a], scale);
    }
    am = active[q] ? 1.0f : 0.0f;
    row = q;
  } else {
    const int64_t dst = dest[q];
    slot = dst % n_slots;
    row = slot * p_rows + dst / n_slots;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      base[a] = cell0[3 * q + a];
      x[a] = xyz[3 * q + a];
    }
  }
  for (int d = 0; d < g.depth; ++d) {
    const float vs_d = ldexpf(g.voxel_size, d);
    float z[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      int64_t cd;
      if (GRAD) {
        const int rel = dd - d;
        cd = rel >= 0 ? (base[a] << rel) : (base[a] >> (-rel));
      } else {
        cd = base[a] >> d;
      }
      z[a] = __fsub_rn(__fsub_rn(__fdiv_rn(x[a], vs_d), (float)cd), off[a]);
    }
    const int64_t r = slot_cells[(int64_t)d * n_slots + slot] + g.corner[d][c];
    const float act = __ldg(g.act[d] + r);
    const float* feat = static_cast<const float*>(g.feat[d]) + r * g.cb;
    float raw[BE_MAX_K], dr[3][BE_MAX_K];
    mlp<H, GRAD, float>(smem + d * g.stride, g.cb, g.n_mid, k, z, feat,
                        GRAD && tan, raw, dr);
    float w, dw[3];
    window(z, w, dw);
    const float wa = __fmul_rn(w, act);
    const int64_t lane0 = (int64_t)d * 8 * k + c * k;
    if (GRAD) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float da = __fmul_rn(dw[a], act);
        float v[BE_MAX_K];
#pragma unroll
        for (int kk = 0; kk < BE_MAX_K; ++kk) {
          float db = __fmul_rn(raw[kk], da);
          if (tan) db = __fadd_rn(db, __fmul_rn(dr[a][kk], wa));
          v[kk] = __fmul_rn(__fdiv_rn(db, vs_d), am);
        }
        store_k(out + (row * 3 + a) * lanes + lane0, v, k);
      }
    } else {
      float v[BE_MAX_K];
#pragma unroll
      for (int kk = 0; kk < BE_MAX_K; ++kk) v[kk] = __fmul_rn(raw[kk], wa);
      store_k(out + row * lanes + lane0, v, k);
    }
  }
}

// The field at n queries: value, trust mask (mask0 at the depth-0 cell)
// and, when GRAD, the gradient (with the tangents when ``tan``).  T is
// the tables' type (features and AV0).
template <int H, bool GRAD, typename T>
__global__ void __launch_bounds__(256)
basis_field_kernel(const BasisGeom g, const float* __restrict__ mlps,
                   const T* __restrict__ av0,
                   const uint8_t* __restrict__ mask0,
                   const float* __restrict__ xq, int64_t n, int tan,
                   float* __restrict__ val, uint8_t* __restrict__ mask,
                   float* __restrict__ grad) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  stage(smem, mlps, g.depth * g.stride);
  // whole warps stay to the end: the corner sums are shuffles
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if ((i & ~(int64_t)31) >= n * 8) return;
  const bool live = i < n * 8;
  const int64_t q = live ? (i >> 3) : n - 1;
  const int c = (int)(i & 7);
  const float off[3] = {(float)((c >> 2) & 1), (float)((c >> 1) & 1),
                        (float)(c & 1)};
  const int k = g.k;
  const int64_t lanes = (int64_t)g.depth * 8 * k;
  float x[3];
  int64_t c0[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    x[a] = xq[3 * q + a];
    c0[a] = (int64_t)floorf(__fdiv_rn(x[a], g.voxel_size));
  }
  int64_t cell0 = 0;
  float v = 0.f, gr[3] = {0.f, 0.f, 0.f};
  for (int d = 0; d < g.depth; ++d) {
    const float vs_d = ldexpf(g.voxel_size, d);
    int64_t cd[3];
    bool ok = true;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      cd[a] = c0[a] >> d;
      const int64_t loc = cd[a] - g.origins[d][a];
      ok = ok && loc >= 0 && loc < g.dims[d][a];
    }
    const int64_t cell =
        ok ? ((cd[0] - g.origins[d][0]) * g.dims[d][1] +
              (cd[1] - g.origins[d][1])) * g.dims[d][2] +
                 (cd[2] - g.origins[d][2])
           : 0;
    if (d == 0) cell0 = cell;
    float z[3], zr[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      z[a] = __fsub_rn(__fsub_rn(__fdiv_rn(x[a], vs_d), (float)cd[a]),
                       off[a]);
      zr[a] = round_as(z[a], T());
    }
    const T* feat = static_cast<const T*>(g.feat[d]) +
                    (cell + g.corner[d][c]) * g.cb;
    float raw[BE_MAX_K], dr[3][BE_MAX_K];
    mlp<H, GRAD, T>(smem + d * g.stride, g.cb, g.n_mid, k, zr, feat,
                    GRAD && tan, raw, dr);
    float w, dw[3];
    window(z, w, dw);
    const T* av = av0 + cell0 * lanes + (int64_t)d * 8 * k + c * k;
    float sv = 0.f, sg[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < BE_MAX_K; ++kk) {
      if (kk >= k) break;
      const float a_k = widen(av[kk]);
      sv = __fadd_rn(sv, __fmul_rn(__fmul_rn(raw[kk], w), a_k));
      if (GRAD) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          float db = __fmul_rn(raw[kk], dw[a]);
          if (tan) db = __fadd_rn(db, __fmul_rn(dr[a][kk], w));
          sg[a] = __fadd_rn(sg[a], __fmul_rn(db, a_k));
        }
      }
    }
    // the 8 corners of a query: lanes 8m .. 8m+7 of the warp
#pragma unroll
    for (int m = 4; m >= 1; m >>= 1) {
      sv = __fadd_rn(sv, __shfl_xor_sync(0xffffffffu, sv, m));
      if (GRAD) {
#pragma unroll
        for (int a = 0; a < 3; ++a)
          sg[a] = __fadd_rn(sg[a], __shfl_xor_sync(0xffffffffu, sg[a], m));
      }
    }
    v = __fadd_rn(v, sv);
    if (GRAD) {
#pragma unroll
      for (int a = 0; a < 3; ++a) gr[a] = __fadd_rn(gr[a], __fdiv_rn(sg[a], vs_d));
    }
  }
  if (!live || c != 0) return;
  val[q] = v;
  mask[q] = mask0[cell0];
  if (GRAD) {
#pragma unroll
    for (int a = 0; a < 3; ++a) grad[3 * q + a] = gr[a];
  }
}

constexpr int kThreads = 256;

int smem_bytes(const BasisGeom* g) { return g->depth * g->stride * 4; }

template <typename K>
int prepare(K kernel, int bytes) {
  if (bytes > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return 0;
}

bool geom_ok(const BasisGeom* g) {
  return g->depth >= 1 && g->depth <= BE_MAX_DEPTH && g->k >= 1 &&
         g->k <= BE_MAX_K && (g->k & (g->k - 1)) == 0 && g->cb >= 0 &&
         (g->hidden == 16 || g->hidden == 32) && g->n_mid >= 0 &&
         g->stride % 4 == 0 && smem_bytes(g) <= 227 * 1024;
}

template <int H, bool GRAD>
int launch_rows(const BasisGeom* g, const float* mlps, const float* xyz,
                const int64_t* cell0, const int64_t* dest,
                const int64_t* coords, const int64_t* gdepth,
                const uint8_t* active, const int64_t* slot_cells, int64_t n,
                int64_t n_slots, int p_rows, int tan, float* out,
                cudaStream_t st) {
  const int bytes = smem_bytes(g);
  auto kernel = basis_rows_kernel<H, GRAD>;
  const int rc = prepare(kernel, bytes);
  if (rc) return rc;
  const int64_t blocks = (n * 8 + kThreads - 1) / kThreads;
  kernel<<<(unsigned int)blocks, kThreads, bytes, st>>>(
      *g, mlps, xyz, cell0, dest, coords, gdepth, active, slot_cells, n,
      n_slots, p_rows, tan, out);
  return (int)cudaGetLastError();
}

template <int H, bool GRAD, typename T>
int launch_field(const BasisGeom* g, const float* mlps, const void* av0,
                 const uint8_t* mask0, const float* xq, int64_t n, int tan,
                 float* val, uint8_t* mask, float* grad, cudaStream_t st) {
  const int bytes = smem_bytes(g);
  auto kernel = basis_field_kernel<H, GRAD, T>;
  const int rc = prepare(kernel, bytes);
  if (rc) return rc;
  const int64_t blocks = (n * 8 + kThreads - 1) / kThreads;
  kernel<<<(unsigned int)blocks, kThreads, bytes, st>>>(
      *g, mlps, static_cast<const T*>(av0), mask0, xq, n, tan, val, mask,
      grad);
  return (int)cudaGetLastError();
}

bool rows_ok(int64_t n) {
  return n >= 0 && (n * 8 + kThreads - 1) / kThreads < ((int64_t)1 << 31);
}

}  // namespace

extern "C" {

// Point rows: xyz (n, 3) f32 in plan order, cell0 (n, 3) int64 depth-0
// cells, dest (n,) int64 (plan_lattice's pt_dest), slot_cells (depth,
// s_pt) int64; feat[d] (cells_d + pad, cb) f32 and act[d] (cells_d + pad,)
// f32 in ``g``; out: b_pt (s_pt * p_rows, depth*8*k) f32, zeroed by the
// caller (rows without a point stay zero).  n == 0 launches nothing.
// Returns cudaGetLastError() after the launch.
int basis_rows_points(const BasisGeom* g, const float* mlps, const float* xyz,
                      const int64_t* cell0, const int64_t* dest,
                      const int64_t* slot_cells, int64_t n, int64_t s_pt,
                      int p_rows, float* out, void* stream) {
  if (!geom_ok(g) || !rows_ok(n) || s_pt < 1 || p_rows < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g->hidden == 16)
    return launch_rows<16, false>(g, mlps, xyz, cell0, dest, nullptr, nullptr,
                                  nullptr, slot_cells, n, s_pt, p_rows, 0,
                                  out, st);
  return launch_rows<32, false>(g, mlps, xyz, cell0, dest, nullptr, nullptr,
                                nullptr, slot_cells, n, s_pt, p_rows, 0, out,
                                st);
}

// Gradient rows: coords (s_gr, 3) int64 voxel coords at their own depth,
// gdepth (s_gr,) int64, active (s_gr,) bool, slot_cells (depth, s_gr)
// int64; out: b_gr (s_gr, 3, depth*8*k) f32, every element written.
// tan: 1 for the tangent terms, 0 under approx_kernel_grad.
int basis_rows_grads(const BasisGeom* g, const float* mlps,
                     const int64_t* coords, const int64_t* gdepth,
                     const uint8_t* active, const int64_t* slot_cells,
                     int64_t s_gr, int tan, float* out, void* stream) {
  if (!geom_ok(g) || !rows_ok(s_gr)) return (int)cudaErrorInvalidValue;
  if (s_gr == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g->hidden == 16)
    return launch_rows<16, true>(g, mlps, nullptr, nullptr, nullptr, coords,
                                 gdepth, active, slot_cells, s_gr, s_gr, 1,
                                 tan, out, st);
  return launch_rows<32, true>(g, mlps, nullptr, nullptr, nullptr, coords,
                               gdepth, active, slot_cells, s_gr, s_gr, 1, tan,
                               out, st);
}

// The field: xq (n, 3) f32; av0 (cells_0, depth*8*k) and feat[d] in f32
// (tab_bf16=0) or bf16 (tab_bf16=1); mask0 (cells_0,) bool; out val (n,)
// f32, mask (n,) bool and, when grad, g (n, 3) f32.  n == 0 launches
// nothing.  Returns cudaGetLastError() after the launch.
int basis_field(const BasisGeom* g, const float* mlps, const void* av0,
                const uint8_t* mask0, const float* xq, int64_t n,
                int tab_bf16, int grad, int tan, float* val, uint8_t* mask,
                float* gout, void* stream) {
  if (!geom_ok(g) || !rows_ok(n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BE_FIELD(H, GR, T) \
  return launch_field<H, GR, T>(g, mlps, av0, mask0, xq, n, tan, val, mask, \
                                gout, st)
#define BE_FIELD_T(H, GR)          \
  if (tab_bf16) {                  \
    BE_FIELD(H, GR, __nv_bfloat16); \
  } else {                         \
    BE_FIELD(H, GR, float);        \
  }
  if (g->hidden == 16) {
    if (grad) {
      BE_FIELD_T(16, true)
    } else {
      BE_FIELD_T(16, false)
    }
  }
  if (grad) {
    BE_FIELD_T(32, true)
  }
  BE_FIELD_T(32, false)
#undef BE_FIELD_T
#undef BE_FIELD
}

}  // extern "C"
