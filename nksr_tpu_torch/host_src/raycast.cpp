// Grid-accelerated mesh occupancy via +z ray parity.
//
// TPU-native counterpart of the reference's ray-cast occupancy IoU
// (the reference's metrics.py:159-188, which uses an Open3D ray-casting
// scene): a query point is inside a watertight mesh iff a ray to
// infinity crosses the surface an odd number of times.  We cast +z rays
// and count crossings with a 2-D (x, y) uniform grid over triangle
// bboxes so each query only tests its own cell's candidate triangles.
//
// Robustness: crossings are counted with a half-open rule on the
// projected edges (top-left style via sign of the edge function), so a
// ray passing exactly through a shared edge/vertex is counted once.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Grid2D {
  float x0, y0, inv_cell;
  int nx, ny;
  // CSR: cell -> triangle indices
  std::vector<int64_t> start;
  std::vector<int32_t> items;
};

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

void build_grid(const float* v, const int32_t* f, int64_t n_f,
                Grid2D& g) {
  // one pass for counts, one for fill
  std::vector<int64_t> count((size_t)g.nx * g.ny, 0);
  std::vector<int> cx0(n_f), cx1(n_f), cy0(n_f), cy1(n_f);
  for (int64_t t = 0; t < n_f; ++t) {
    const float* a = v + 3 * (int64_t)f[3 * t];
    const float* b = v + 3 * (int64_t)f[3 * t + 1];
    const float* c = v + 3 * (int64_t)f[3 * t + 2];
    float xmin = std::fmin(a[0], std::fmin(b[0], c[0]));
    float xmax = std::fmax(a[0], std::fmax(b[0], c[0]));
    float ymin = std::fmin(a[1], std::fmin(b[1], c[1]));
    float ymax = std::fmax(a[1], std::fmax(b[1], c[1]));
    cx0[t] = clampi((int)((xmin - g.x0) * g.inv_cell), 0, g.nx - 1);
    cx1[t] = clampi((int)((xmax - g.x0) * g.inv_cell), 0, g.nx - 1);
    cy0[t] = clampi((int)((ymin - g.y0) * g.inv_cell), 0, g.ny - 1);
    cy1[t] = clampi((int)((ymax - g.y0) * g.inv_cell), 0, g.ny - 1);
    for (int iy = cy0[t]; iy <= cy1[t]; ++iy)
      for (int ix = cx0[t]; ix <= cx1[t]; ++ix)
        count[(size_t)iy * g.nx + ix]++;
  }
  g.start.assign((size_t)g.nx * g.ny + 1, 0);
  for (size_t i = 0; i < count.size(); ++i)
    g.start[i + 1] = g.start[i] + count[i];
  g.items.resize(g.start.back());
  std::vector<int64_t> cursor(g.start.begin(), g.start.end() - 1);
  for (int64_t t = 0; t < n_f; ++t)
    for (int iy = cy0[t]; iy <= cy1[t]; ++iy)
      for (int ix = cx0[t]; ix <= cx1[t]; ++ix)
        g.items[cursor[(size_t)iy * g.nx + ix]++] = (int32_t)t;
}

}  // namespace

extern "C" {

// verts: (n_v, 3) float32; faces: (n_f, 3) int32; queries: (n_q, 3)
// float32; out: (n_q,) uint8 (1 = inside).
void raycast_inside(const float* verts, int64_t n_v, const int32_t* faces,
                    int64_t n_f, const float* queries, int64_t n_q,
                    uint8_t* out, int32_t n_threads) {
  if (n_f == 0 || n_v == 0) {
    std::memset(out, 0, (size_t)n_q);
    return;
  }
  // grid resolution ~ sqrt(n_f) cells per side over the mesh xy-bbox
  float xmin = 1e30f, xmax = -1e30f, ymin = 1e30f, ymax = -1e30f;
  for (int64_t i = 0; i < n_v; ++i) {
    xmin = std::fmin(xmin, verts[3 * i]);
    xmax = std::fmax(xmax, verts[3 * i]);
    ymin = std::fmin(ymin, verts[3 * i + 1]);
    ymax = std::fmax(ymax, verts[3 * i + 1]);
  }
  Grid2D g;
  int side = (int)std::ceil(std::sqrt((double)n_f));
  side = clampi(side, 1, 2048);
  g.nx = side;
  g.ny = side;
  float ex = std::fmax(xmax - xmin, 1e-12f);
  float ey = std::fmax(ymax - ymin, 1e-12f);
  float cell = std::fmax(ex, ey) / side;
  g.x0 = xmin;
  g.y0 = ymin;
  g.inv_cell = 1.0f / cell;
  g.nx = clampi((int)std::ceil(ex / cell), 1, 4096);
  g.ny = clampi((int)std::ceil(ey / cell), 1, 4096);
  build_grid(verts, faces, n_f, g);

  auto worker = [&](int64_t q_lo, int64_t q_hi) {
    for (int64_t q = q_lo; q < q_hi; ++q) {
      const float px = queries[3 * q], py = queries[3 * q + 1],
                  pz = queries[3 * q + 2];
      if (px < xmin || px > xmax || py < ymin || py > ymax) {
        out[q] = 0;
        continue;
      }
      int ix = clampi((int)((px - g.x0) * g.inv_cell), 0, g.nx - 1);
      int iy = clampi((int)((py - g.y0) * g.inv_cell), 0, g.ny - 1);
      int64_t s = g.start[(size_t)iy * g.nx + ix];
      int64_t e = g.start[(size_t)iy * g.nx + ix + 1];
      int crossings = 0;
      for (int64_t it = s; it < e; ++it) {
        int32_t t = g.items[it];
        const float* a = verts + 3 * (int64_t)faces[3 * t];
        const float* b = verts + 3 * (int64_t)faces[3 * t + 1];
        const float* c = verts + 3 * (int64_t)faces[3 * t + 2];
        // 2-D edge functions (doubles: the parity rule needs exact and
        // consistent signs across shared edges)
        double e0 = ((double)b[0] - a[0]) * (py - a[1]) -
                    ((double)b[1] - a[1]) * (px - a[0]);
        double e1 = ((double)c[0] - b[0]) * (py - b[1]) -
                    ((double)c[1] - b[1]) * (px - b[0]);
        double e2 = ((double)a[0] - c[0]) * (py - c[1]) -
                    ((double)a[1] - c[1]) * (px - c[0]);
        bool hit;
        if (e0 > 0 && e1 > 0 && e2 > 0)
          hit = true;
        else if (e0 < 0 && e1 < 0 && e2 < 0)
          hit = true;
        else if (e0 == 0 || e1 == 0 || e2 == 0) {
          // on an edge/vertex in projection: half-open rule — count
          // only if the zero edges are "positive-class" so exactly one
          // of the two triangles sharing the edge counts the crossing
          bool pos = (e0 > 0 || e1 > 0 || e2 > 0);
          bool neg = (e0 < 0 || e1 < 0 || e2 < 0);
          if (pos && !neg)
            hit = (e0 >= 0 && e1 >= 0 && e2 >= 0) &&
                  ((e0 == 0 && (b[1] > a[1] || (b[1] == a[1] && b[0] < a[0]))) ||
                   (e1 == 0 && (c[1] > b[1] || (c[1] == b[1] && c[0] < b[0]))) ||
                   (e2 == 0 && (a[1] > c[1] || (a[1] == c[1] && a[0] < c[0]))) ||
                   (e0 > 0 && e1 > 0 && e2 > 0));
          else
            hit = false;
        } else
          hit = false;
        if (!hit) continue;
        // z of the triangle at (px, py) via barycentric from edge fns
        double area = e0 + e1 + e2;
        if (area == 0) continue;
        double w0 = e1 / area, w1 = e2 / area, w2 = e0 / area;
        double z = w0 * a[2] + w1 * b[2] + w2 * c[2];
        if (z > pz) crossings++;
      }
      out[q] = (uint8_t)(crossings & 1);
    }
  };

  int nt = n_threads > 0 ? n_threads
                         : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt == 1 || n_q < 4096) {
    worker(0, n_q);
  } else {
    std::vector<std::thread> ts;
    int64_t per = (n_q + nt - 1) / nt;
    for (int i = 0; i < nt; ++i) {
      int64_t lo = i * per, hi = std::min<int64_t>(n_q, lo + per);
      if (lo >= hi) break;
      ts.emplace_back(worker, lo, hi);
    }
    for (auto& t : ts) t.join();
  }
}

}  // extern "C"
