// Sorting primitives for the host-side grid builder (core/host_build.py).
//
// The TPU pipeline keeps every sort OFF the device (XLA:TPU sort compile
// time scales with array size — DESIGN.md); the host therefore sorts
// packed int64 voxel keys on every reconstruct call, and numpy's
// comparison argsort is the bottleneck.  LSD radix sort is ~4-8x faster,
// and key distributions here are clustered so most high bytes are
// constant and their passes skip entirely.
//
// C ABI for ctypes (see __init__.py).  Single-threaded on purpose: this
// sandbox pins 1 CPU core, and radix passes are memory-bound anyway.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// byte b of key, biased so signed int64 order == unsigned byte order
inline uint32_t digit(int64_t k, int b) {
  uint64_t u = (uint64_t)k ^ 0x8000000000000000ull;  // sign flip
  return (uint32_t)((u >> (8 * b)) & 0xFF);
}

// which of the 8 byte positions actually vary across the array
uint32_t varying_bytes(const int64_t* keys, int64_t n) {
  if (n == 0) return 0;
  uint64_t acc_or = 0, first = (uint64_t)keys[0] ^ 0x8000000000000000ull;
  for (int64_t i = 1; i < n; ++i) {
    acc_or |= ((uint64_t)keys[i] ^ 0x8000000000000000ull) ^ first;
  }
  uint32_t mask = 0;
  for (int b = 0; b < 8; ++b)
    if ((acc_or >> (8 * b)) & 0xFF) mask |= 1u << b;
  return mask;
}

}  // namespace

extern "C" {

// Stable LSD radix argsort: fills order[0..n) with the permutation that
// sorts keys ascending.  Skips byte positions that are constant.
void radix_argsort_i64(const int64_t* keys, int64_t n, int64_t* order) {
  std::vector<int64_t> kbuf(keys, keys + n), ktmp(n);
  std::vector<int64_t> obuf(n), otmp(n);
  for (int64_t i = 0; i < n; ++i) obuf[i] = i;
  uint32_t bytes = varying_bytes(keys, n);
  int64_t hist[257];
  for (int b = 0; b < 8; ++b) {
    if (!((bytes >> b) & 1)) continue;
    std::memset(hist, 0, sizeof(hist));
    for (int64_t i = 0; i < n; ++i) ++hist[digit(kbuf[i], b) + 1];
    for (int d = 0; d < 256; ++d) hist[d + 1] += hist[d];
    for (int64_t i = 0; i < n; ++i) {
      int64_t pos = hist[digit(kbuf[i], b)]++;
      ktmp[pos] = kbuf[i];
      otmp[pos] = obuf[i];
    }
    kbuf.swap(ktmp);
    obuf.swap(otmp);
  }
  std::memcpy(order, obuf.data(), n * sizeof(int64_t));
}

// In-place radix sort + dedup; returns the unique count.
int64_t radix_sort_unique_i64(int64_t* keys, int64_t n) {
  if (n == 0) return 0;
  std::vector<int64_t> kbuf(keys, keys + n), ktmp(n);
  uint32_t bytes = varying_bytes(keys, n);
  int64_t hist[257];
  for (int b = 0; b < 8; ++b) {
    if (!((bytes >> b) & 1)) continue;
    std::memset(hist, 0, sizeof(hist));
    for (int64_t i = 0; i < n; ++i) ++hist[digit(kbuf[i], b) + 1];
    for (int d = 0; d < 256; ++d) hist[d + 1] += hist[d];
    for (int64_t i = 0; i < n; ++i) ktmp[hist[digit(kbuf[i], b)]++] = kbuf[i];
    kbuf.swap(ktmp);
  }
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i)
    if (i == 0 || kbuf[i] != kbuf[i - 1]) keys[m++] = kbuf[i];
  return m;
}

// Merge-unique of k sorted shifted copies: the union of {base + delta_j}
// for sorted `base` and k deltas, ascending, deduped.  Returns count.
// (Corner/child expansion: each shifted column is already sorted, so the
// union is a k-way merge — no sort at all.)
int64_t merge_unique_i64(const int64_t* base, int64_t n,
                         const int64_t* deltas, int32_t k, int64_t* out) {
  if (n == 0 || k == 0) return 0;
  std::vector<int64_t> ptr(k, 0);
  int64_t m = 0;
  int64_t last = 0;
  bool have_last = false;
  for (;;) {
    int best = -1;
    int64_t bv = 0;
    for (int j = 0; j < k; ++j) {
      if (ptr[j] >= n) continue;
      int64_t v = base[ptr[j]] + deltas[j];
      if (best < 0 || v < bv) { best = j; bv = v; }
    }
    if (best < 0) break;
    ++ptr[best];
    if (!have_last || bv != last) { out[m++] = bv; last = bv; have_last = true; }
  }
  return m;
}

// Fused K-offset stencil join: out[i*K + k] = index of (base[i] +
// deltas[k]) in sorted `keys`, -1 if absent or >= cap.  `base` sorted
// ascending; each shifted column is then also sorted, so K monotone
// cursors into `keys` advance in one row-major pass — no per-column
// temp arrays, no separate mask pass (replaces the numpy loop in
// core/host_build.py::_stencil_tables).
void stencil_join_i64(const int64_t* keys, int64_t n,
                      const int64_t* base, int64_t m,
                      const int64_t* deltas, int32_t K,
                      int32_t cap, int32_t* out) {
  std::vector<int64_t> cur(K, 0);
  for (int64_t i = 0; i < m; ++i) {
    int64_t b = base[i];
    int32_t* row = out + i * K;
    for (int32_t k = 0; k < K; ++k) {
      int64_t v = b + deltas[k];
      int64_t c = cur[k];
      while (c < n && keys[c] < v) ++c;
      cur[k] = c;
      row[k] = (c < n && keys[c] == v && c < cap) ? (int32_t)c : -1;
    }
  }
}

// Fused lattice flat-cell pass: for each coordinate row c, shift to the
// target depth's scale (shift >= 0: c << shift, else arithmetic
// c >> -shift), subtract the lattice origin, bounds-check against dims,
// and emit the row-major flat index (0 when outside — the dense solve's
// "alias to the zero-basis cell" convention, fields/lattice.py
// plan_lattice::flat_cell).  One pass, no temporaries.
void flat_cells_i64(const int64_t* coords, int64_t n, int32_t shift,
                    int64_t ox, int64_t oy, int64_t oz,
                    int64_t X, int64_t Y, int64_t Z, int32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t cx = coords[i * 3], cy = coords[i * 3 + 1],
            cz = coords[i * 3 + 2];
    if (shift >= 0) {
      cx <<= shift; cy <<= shift; cz <<= shift;
    } else {
      cx >>= -shift; cy >>= -shift; cz >>= -shift;
    }
    int64_t lx = cx - ox, ly = cy - oy, lz = cz - oz;
    bool ok = (uint64_t)lx < (uint64_t)X && (uint64_t)ly < (uint64_t)Y &&
              (uint64_t)lz < (uint64_t)Z;
    out[i] = ok ? (int32_t)((lx * Y + ly) * Z + lz) : 0;
  }
}

// Fused floor-divide + pack64 (core/host_build.py pack64 convention:
// bias 2^20, fields 42/21/0).  MUST match numpy bit-for-bit: numpy
// computes float32(x) / float32(voxel) under NEP50 (python float is a
// weak scalar -> stays f32), then floor, then int64 cast — so this
// does the identical single-precision division + floorf.  One pass
// replaces ~9 numpy passes (div, floor, astype, 3 shifts, 2 ors, add)
// measured ~0.5 s of the 1M-point host plan.
void pack_floor_keys_f32(const float* xyz, int64_t n, float voxel,
                         int64_t* out_keys) {
  const int64_t B = (int64_t)1 << 20;
  for (int64_t i = 0; i < n; ++i) {
    int64_t cx = (int64_t)floorf(xyz[i * 3] / voxel) + B;
    int64_t cy = (int64_t)floorf(xyz[i * 3 + 1] / voxel) + B;
    int64_t cz = (int64_t)floorf(xyz[i * 3 + 2] / voxel) + B;
    out_keys[i] = (cx << 42) | (cy << 21) | cz;
  }
}

// Fused per-component halving of packed keys (host_build._half_keys):
// stored field s = c + B with B = 2^20, so (s + B) >> 1 == (c >> 1) + B
// (arithmetic floor halving, exact for all c >= -B).  One pass replaces
// ~9 numpy int64 passes (measured 136 ms/call at 1M rows).
void half_keys_i64(const int64_t* keys, int64_t n, int64_t* out) {
  const int64_t B = (int64_t)1 << 20;
  const int64_t M = ((int64_t)1 << 21) - 1;
  for (int64_t i = 0; i < n; ++i) {
    int64_t k = keys[i];
    int64_t hx = ((k >> 42) + B) >> 1;
    int64_t hy = (((k >> 21) & M) + B) >> 1;
    int64_t hz = ((k & M) + B) >> 1;
    out[i] = (hx << 42) | (hy << 21) | hz;
  }
}

// Unpack packed keys to (n, 3) int32 coords (host_build.unpack64).
void unpack_keys_i64(const int64_t* keys, int64_t n, int32_t* out) {
  const int64_t B = (int64_t)1 << 20;
  const int64_t M = ((int64_t)1 << 21) - 1;
  for (int64_t i = 0; i < n; ++i) {
    int64_t k = keys[i];
    out[i * 3] = (int32_t)((k >> 42) - B);
    out[i * 3 + 1] = (int32_t)(((k >> 21) & M) - B);
    out[i * 3 + 2] = (int32_t)((k & M) - B);
  }
}

// Componentwise min/max of (n, 3) int32 coords in one pass
// (plan_lattice bounds; numpy's axis-reductions cost ~13 ms/call at
// splat-grid scale).  out = [minx, miny, minz, maxx, maxy, maxz].
void minmax_i32(const int32_t* coords, int64_t n, int32_t* out) {
  int32_t mn[3] = {INT32_MAX, INT32_MAX, INT32_MAX};
  int32_t mx[3] = {INT32_MIN, INT32_MIN, INT32_MIN};
  for (int64_t i = 0; i < n; ++i) {
    for (int c = 0; c < 3; ++c) {
      int32_t v = coords[i * 3 + c];
      if (v < mn[c]) mn[c] = v;
      if (v > mx[c]) mx[c] = v;
    }
  }
  for (int c = 0; c < 3; ++c) { out[c] = mn[c]; out[3 + c] = mx[c]; }
}

}  // extern "C"
