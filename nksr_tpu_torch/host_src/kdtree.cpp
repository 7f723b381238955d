// CPU kd-tree for host-side evaluation metrics and preprocessing.
//
// Native counterpart of the reference's kd-tree usage: the CUDA tree in
// the reference's ext/common/kdtree_cuda.cu feeds GT generation on GPU,
// and pykdtree feeds the mesh evaluator on CPU (metrics.py:19-36).  On a
// TPU host the device-side work is done by the grid-bucket kNN (ops/knn.py);
// this native tree covers the *host* paths: chamfer / f-score distances
// over millions of samples, where a Python tree would dominate eval time.
//
// Design: classic median-split static kd-tree over float32 points,
// built iteratively (explicit stack), queried with best-first descent.
// Exposed via a C ABI for ctypes; OpenMP-free (plain threads) to stay
// dependency-light.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Node {
  float split;
  int32_t axis;      // -1 for leaf
  int32_t left;      // node index or start index for leaf
  int32_t right;     // node index or end index for leaf
};

struct Tree {
  std::vector<float> pts;       // (n, 3) reordered
  std::vector<int32_t> index;   // reordered -> original
  std::vector<Node> nodes;
  int32_t root = -1;
};

constexpr int kLeafSize = 16;

int32_t build(Tree& t, std::vector<int32_t>& perm, int lo, int hi,
              const float* xyz) {
  if (hi - lo <= kLeafSize) {
    int32_t id = (int32_t)t.nodes.size();
    t.nodes.push_back({0.f, -1, lo, hi});
    return id;
  }
  // split on the widest axis at the median
  float mn[3] = {1e30f, 1e30f, 1e30f}, mx[3] = {-1e30f, -1e30f, -1e30f};
  for (int i = lo; i < hi; ++i) {
    const float* p = xyz + 3 * perm[i];
    for (int a = 0; a < 3; ++a) {
      mn[a] = std::min(mn[a], p[a]);
      mx[a] = std::max(mx[a], p[a]);
    }
  }
  int axis = 0;
  for (int a = 1; a < 3; ++a)
    if (mx[a] - mn[a] > mx[axis] - mn[axis]) axis = a;
  int mid = (lo + hi) / 2;
  std::nth_element(perm.begin() + lo, perm.begin() + mid,
                   perm.begin() + hi, [&](int32_t a, int32_t b) {
                     return xyz[3 * a + axis] < xyz[3 * b + axis];
                   });
  float split = xyz[3 * perm[mid] + axis];
  int32_t id = (int32_t)t.nodes.size();
  t.nodes.push_back({split, axis, -1, -1});
  int32_t l = build(t, perm, lo, mid, xyz);
  int32_t r = build(t, perm, mid, hi, xyz);
  t.nodes[id].left = l;
  t.nodes[id].right = r;
  return id;
}

inline void query_one(const Tree& t, const float* q, int k, float* best_d2,
                      int32_t* best_i) {
  for (int i = 0; i < k; ++i) {
    best_d2[i] = 1e30f;
    best_i[i] = -1;
  }
  // explicit stack of (node, min possible d2)
  struct Item { int32_t node; float d2; };
  Item stack[128];
  int sp = 0;
  stack[sp++] = {t.root, 0.f};
  while (sp) {
    Item it = stack[--sp];
    if (it.d2 >= best_d2[0]) continue;
    const Node& n = t.nodes[it.node];
    if (n.axis < 0) {
      for (int i = n.left; i < n.right; ++i) {
        const float* p = &t.pts[3 * i];
        float dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
        float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < best_d2[0]) {
          // replace current worst (max-heap on best_d2[0..k))
          int j = 0;  // heap root holds the worst
          best_d2[0] = d2;
          best_i[0] = t.index[i];
          // sift down
          while (true) {
            int c1 = 2 * j + 1, c2 = 2 * j + 2, m = j;
            if (c1 < k && best_d2[c1] > best_d2[m]) m = c1;
            if (c2 < k && best_d2[c2] > best_d2[m]) m = c2;
            if (m == j) break;
            std::swap(best_d2[j], best_d2[m]);
            std::swap(best_i[j], best_i[m]);
            j = m;
          }
        }
      }
    } else {
      float diff = q[n.axis] - n.split;
      int32_t near = diff <= 0 ? n.left : n.right;
      int32_t far = diff <= 0 ? n.right : n.left;
      stack[sp++] = {far, diff * diff};
      stack[sp++] = {near, 0.f};
    }
  }
}

}  // namespace

extern "C" {

void* kdtree_build(const float* xyz, int64_t n) {
  Tree* t = new Tree();
  std::vector<int32_t> perm(n);
  for (int64_t i = 0; i < n; ++i) perm[i] = (int32_t)i;
  t->nodes.reserve(2 * n / kLeafSize + 4);
  t->root = build(*t, perm, 0, (int)n, xyz);
  t->pts.resize(3 * n);
  t->index = perm;
  for (int64_t i = 0; i < n; ++i)
    std::memcpy(&t->pts[3 * i], xyz + 3 * perm[i], 12);
  return t;
}

void kdtree_free(void* h) { delete (Tree*)h; }

// Query k nearest; outputs dist2 (m, k) and idx (m, k), sorted ascending.
void kdtree_query(void* h, const float* q, int64_t m, int32_t k,
                  float* out_d2, int32_t* out_idx, int32_t n_threads) {
  Tree* t = (Tree*)h;
  int nt = n_threads > 0 ? n_threads
                         : (int)std::thread::hardware_concurrency();
  nt = std::max(1, std::min(nt, 64));
  std::atomic<int64_t> next(0);
  const int64_t chunk = 1024;
  auto worker = [&]() {
    std::vector<float> d2(k);
    std::vector<int32_t> idx(k);
    while (true) {
      int64_t start = next.fetch_add(chunk);
      if (start >= m) return;
      int64_t end = std::min(start + chunk, m);
      for (int64_t i = start; i < end; ++i) {
        query_one(*t, q + 3 * i, k, d2.data(), idx.data());
        // sort ascending for output
        std::vector<int> ord(k);
        for (int j = 0; j < k; ++j) ord[j] = j;
        std::sort(ord.begin(), ord.end(),
                  [&](int a, int b) { return d2[a] < d2[b]; });
        for (int j = 0; j < k; ++j) {
          out_d2[i * k + j] = d2[ord[j]];
          out_idx[i * k + j] = idx[ord[j]];
        }
      }
    }
  };
  std::vector<std::thread> threads;
  for (int i = 0; i < nt; ++i) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// Batch binary search over a sorted int64 key array (the host-side lookup
// backbone of core/host_build.py; numpy's searchsorted is single-threaded
// and dominates table construction for multi-million-point clouds).
// out[i] = index of queries[i] in keys, or -1 if absent.
void keysearch_i64(const int64_t* keys, int64_t n, const int64_t* queries,
                   int64_t m, int32_t* out, int32_t n_threads) {
  int nt = n_threads > 0 ? n_threads
                         : (int)std::thread::hardware_concurrency();
  nt = std::max(1, std::min(nt, 64));
  std::atomic<int64_t> next(0);
  const int64_t chunk = 1 << 14;
  auto worker = [&]() {
    while (true) {
      int64_t start = next.fetch_add(chunk);
      if (start >= m) return;
      int64_t end = std::min(start + chunk, m);
      for (int64_t i = start; i < end; ++i) {
        int64_t q = queries[i];
        int64_t lo = 0, hi = n;
        while (lo < hi) {
          int64_t mid = (lo + hi) >> 1;
          if (keys[mid] < q) lo = mid + 1; else hi = mid;
        }
        out[i] = (lo < n && keys[lo] == q) ? (int32_t)lo : -1;
      }
    }
  };
  std::vector<std::thread> threads;
  for (int i = 0; i < nt; ++i) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// Sorted-sorted merge join: positions of sorted queries in sorted keys
// (-1 if absent).  Linear two-pointer scan — the fast path for stencil
// lookups, whose shifted query keys are sorted by construction
// (core/host_build.py).
void sorted_join_i64(const int64_t* keys, int64_t n, const int64_t* q,
                     int64_t m, int32_t* out) {
  int64_t i = 0;
  for (int64_t j = 0; j < m; ++j) {
    int64_t v = q[j];
    while (i < n && keys[i] < v) ++i;
    out[j] = (i < n && keys[i] == v) ? (int32_t)i : -1;
  }
}

}  // extern "C"
