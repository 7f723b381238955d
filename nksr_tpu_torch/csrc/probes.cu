// Kernel probes for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU probes of scripts/probe_mosaic.py (`probe`, 11
// kernel bodies) and scripts/probe_mosaic_cascade.py (bisect probes 0-5).
// On the TPU each probe asked whether Mosaic could compile one feature the
// lattice kernels rely on (a relayout, a strided row slice, a lane permute
// or roll, a grid accumulation, an element-offset or shifted block index
// map, a window slice + matrix product).  Here each probe is a tiny kernel
// computing the same function on the probe's fixed shapes, so that a build
// of the card's kernels checks the index arithmetic those features stand
// for.  ops/probes.py holds the plain PyTorch version of each and says the
// function in words.
//
// What bounds them: nothing but launch latency.  The largest moves 128 KB
// and the window product does 0.5 MFLOP.  Design: one thread per output
// element (the strided row write: one per input element, writing two
// rows), so every probe is a gather of its index map; the per-probe
// functors below hold only that map.  The window product is the one
// exception (its own kernel below): a thread summing a 128-long product
// alone waited on 128 loads of z in turn.  Sums run in a fixed order, so
// a probe is exact wherever its inputs' sums are.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 128;  // lanes of the TPU probes' (8, 128) tiling

__device__ __forceinline__ int floor_mod(int v, int m) {
  const int r = v % m;
  return r < 0 ? r + m : r;
}

// dynamic shift of the TPU probes: int(a[0, 0]) % m, Python's modulo
__device__ __forceinline__ int dyn_shift(const float* a, int m) {
  return floor_mod((int)a[0], m);
}

// out = a's flat buffer: a reshape of a row-major array
template <int N>
struct Copy {
  static constexpr int kThreads = N;
  __device__ static void run(const float* a, const float*, float* o, int e) {
    o[e] = a[e];
  }
};

struct StridedRows {  // (256, 128) -> a[0::2]
  static constexpr int kThreads = 128 * L;
  __device__ static void run(const float* a, const float*, float* o, int e) {
    o[e] = a[(2 * (e / L)) * L + e % L];
  }
};

struct LaneReverse {  // (64, 128) -> a[:, ::-1]
  static constexpr int kThreads = 64 * L;
  __device__ static void run(const float* a, const float*, float* o, int e) {
    o[e] = a[(e / L) * L + (L - 1 - e % L)];
  }
};

struct Shift4 {  // concat(a[:, 4:], roll(a, -1, 0)[:, :4])
  static constexpr int kThreads = 64 * L;
  __device__ static void run(const float* a, const float*, float* o, int e) {
    const int i = e / L, j = e % L;
    o[e] = j < L - 4 ? a[i * L + j + 4] : a[((i + 1) % 64) * L + j - (L - 4)];
  }
};

struct DynLaneRoll {  // np.roll(a, int(a[0, 0]) % 128, 1)
  static constexpr int kThreads = 64 * L;
  __device__ static void run(const float* a, const float*, float* o, int e) {
    const int s = dyn_shift(a, L);
    o[e] = a[(e / L) * L + floor_mod(e % L - s, L)];
  }
};

struct LeadSum {  // (256, 128) -> reshape(8, 32, 128).sum(1)
  static constexpr int kThreads = 8 * L;
  __device__ static void run(const float* a, const float*, float* o, int e) {
    const int i = e / L, c = e % L;
    float acc = 0.0f;
    for (int k = 0; k < 32; ++k) acc += a[(32 * i + k) * L + c];
    o[e] = acc;
  }
};

template <int ROWS>
struct PairReplicate {  // (ROWS, 128) -> repeat(a, 2, 0), gathered
  static constexpr int kThreads = 2 * ROWS * L;
  __device__ static void run(const float* a, const float*, float* o, int e) {
    o[e] = a[(e / L / 2) * L + e % L];
  }
};

struct StridedRowWrite {  // o[0::2] = a; o[1::2] = a, scattered
  static constexpr int kThreads = 128 * L;
  __device__ static void run(const float* a, const float*, float* o, int e) {
    const int i = e / L, j = e % L;
    o[(2 * i) * L + j] = a[e];
    o[(2 * i + 1) * L + j] = a[e];
  }
};

struct DynRow {  // a[int(a[0, 0]) % 64] of (64, 128)
  static constexpr int kThreads = L;
  __device__ static void run(const float* a, const float*, float* o, int e) {
    o[e] = a[dyn_shift(a, 64) * L + e];
  }
};

struct Times2 {  // bisect 0: (8, 128) * 2
  static constexpr int kThreads = 8 * L;
  __device__ static void run(const float* a, const float*, float* o, int e) {
    o[e] = a[e] * 2.0f;
  }
};

struct GridAccumulate {  // bisect 1: o = x * 1 at d = 0, o += x at d = 1
  static constexpr int kThreads = 16 * L;
  __device__ static void run(const float* a, const float*, float* o, int e) {
    float acc = 0.0f;
    for (int d = 0; d < 2; ++d) acc = d == 0 ? a[e] * 1.0f : acc + a[e];
    o[e] = acc;
  }
};

struct ElementBlocks {  // bisect 2: out block i = 2 * a[4i : 4i + 8]
  static constexpr int kThreads = 16 * L;
  __device__ static void run(const float* a, const float*, float* o, int e) {
    const int row = e / L;
    o[e] = a[(4 * (row / 8) + row % 8) * L + e % L] * 2.0f;
  }
};

struct ShiftedBlocks {  // bisect 3: out block x = a block (x >> 1) + 1
  static constexpr int kThreads = 32 * L;
  __device__ static void run(const float* a, const float*, float* o, int e) {
    const int row = e / L;
    o[e] = a[(8 * ((row / 8) >> 1) + row % 8) * L + e % L] + 1.0f;
  }
};

// bisect 4: a (3, 17, 32), z (128, 128) -> out (2, 8, 128),
// out[x] = concat_{i, j in {0, 1}} a[x + i, j : j + 8, :] @ z.
// A CTA per output row (x, r), 16 in all: its 128-long window row goes
// to shared memory once; each of kWdSlices groups of 128 threads sums a
// 16-long slice of the product for every column n, with the slice's 16
// loads of z (each z row read once by the CTA, coalesced) issued
// together; the slices' partials fold in a fixed order.
constexpr int kWdSlices = 8;
constexpr int kWdLen = L / kWdSlices;

__global__ void __launch_bounds__(kWdSlices * L)
window_dot_kernel(const float* __restrict__ a, const float* __restrict__ z,
                  float* __restrict__ o) {
  __shared__ float row[L];
  __shared__ float part[kWdSlices][L];
  const int x = blockIdx.x / 8, r = blockIdx.x % 8;
  const int n = threadIdx.x % L, q = threadIdx.x / L;
  if (threadIdx.x < L) {
    const int g = threadIdx.x / 32, c = threadIdx.x % 32;
    row[threadIdx.x] = a[((x + (g >> 1)) * 17 + (g & 1) + r) * 32 + c];
  }
  __syncthreads();
  float zv[kWdLen];
#pragma unroll
  for (int t = 0; t < kWdLen; ++t) zv[t] = __ldg(&z[(q * kWdLen + t) * L + n]);
  float acc = 0.0f;
#pragma unroll
  for (int t = 0; t < kWdLen; ++t) acc = fmaf(row[q * kWdLen + t], zv[t], acc);
  part[q][n] = acc;
  __syncthreads();
  if (q == 0) {
    float sum = part[0][n];
#pragma unroll
    for (int i = 1; i < kWdSlices; ++i) sum += part[i][n];
    o[blockIdx.x * L + n] = sum;
  }
}

template <class P>
__global__ void probe_kernel(const float* __restrict__ a,
                             const float* __restrict__ z,
                             float* __restrict__ o) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < P::kThreads) P::run(a, z, o, e);
}

template <class P>
int launch(const float* a, const float* z, float* o, void* stream) {
  probe_kernel<P><<<(P::kThreads + 255) / 256, 256, 0,
                    (cudaStream_t)stream>>>(a, z, o);
  return (int)cudaGetLastError();
}

}  // namespace

#define PROBE(key, P)                                                   \
  extern "C" int probe_##key(const float* a, const float* z, float* o, \
                             void* stream) {                            \
    return launch<P>(a, z, o, stream);                                  \
  }

PROBE(pack, Copy<64 * L>)
PROBE(unpack, Copy<64 * L>)
PROBE(flat_to_2d, Copy<64 * L>)
PROBE(strided_rows, StridedRows)
PROBE(lane_reverse, LaneReverse)
PROBE(shift4, Shift4)
PROBE(dyn_lane_roll, DynLaneRoll)
PROBE(lead_sum, LeadSum)
PROBE(pair_replicate, PairReplicate<64>)
PROBE(strided_row_write, StridedRowWrite)
PROBE(dyn_row, DynRow)
PROBE(times2, Times2)
PROBE(grid_accumulate, GridAccumulate)
PROBE(element_blocks, ElementBlocks)
PROBE(shifted_blocks, ShiftedBlocks)
PROBE(row_replicate, PairReplicate<8>)

extern "C" int probe_window_dot(const float* a, const float* z, float* o,
                                void* stream) {
  window_dot_kernel<<<2 * 8, kWdSlices * L, 0, (cudaStream_t)stream>>>(
      a, z, o);
  return (int)cudaGetLastError();
}

// The launch floor: a kernel that does nothing, one thread.  Timed as
// each kernel beside it is timed (in one CUDA graph, or by CUDA events
// over back-to-back launches through its ctypes wrapper), it is the least
// time any launch takes, set beside every kernel's byte or operation
// bound.
__global__ void empty_kernel() {}

extern "C" int launch_floor(void* stream) {
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
