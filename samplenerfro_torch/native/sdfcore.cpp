// sdfcore: native triangle-mesh geometry for the port's preprocessing
// tools (voxelize_mesh).
//
// The port's own copy of samplenerfro_tpu/native/sdfcore.cpp, unchanged
// below this header: point containment, signed distance, nearest-vertex
// queries, area-weighted surface sampling and an image-space raycast
// renderer around one binned median-split BVH, exposed through a C ABI for
// ctypes. Host code, threaded over the CPU's cores; it is not a GPU kernel.
//
// Build (tools/sdf.py does it at first use, into build/sdfcore/):
//   g++ -O3 -std=c++17 -shared -fPIC sdfcore.cpp -o libsdfcore.so

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <limits>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Vec3 {
  double x = 0, y = 0, z = 0;
  Vec3() = default;
  Vec3(double a, double b, double c) : x(a), y(b), z(c) {}
  Vec3 operator+(const Vec3& o) const { return {x + o.x, y + o.y, z + o.z}; }
  Vec3 operator-(const Vec3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  Vec3 operator*(double s) const { return {x * s, y * s, z * s}; }
  double dot(const Vec3& o) const { return x * o.x + y * o.y + z * o.z; }
  Vec3 cross(const Vec3& o) const {
    return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
  }
  double norm2() const { return dot(*this); }
  double norm() const { return std::sqrt(norm2()); }
  double operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

struct AABB {
  Vec3 lo{std::numeric_limits<double>::infinity(),
          std::numeric_limits<double>::infinity(),
          std::numeric_limits<double>::infinity()};
  Vec3 hi{-std::numeric_limits<double>::infinity(),
          -std::numeric_limits<double>::infinity(),
          -std::numeric_limits<double>::infinity()};
  void expand(const Vec3& p) {
    lo = {std::min(lo.x, p.x), std::min(lo.y, p.y), std::min(lo.z, p.z)};
    hi = {std::max(hi.x, p.x), std::max(hi.y, p.y), std::max(hi.z, p.z)};
  }
  void expand(const AABB& b) {
    expand(b.lo);
    expand(b.hi);
  }
  // Slab test; returns entry t or +inf if missed. Ray dir need not be unit.
  double ray_hit(const Vec3& o, const Vec3& inv_d, double tmax) const {
    double t0 = 0.0, t1 = tmax;
    for (int a = 0; a < 3; ++a) {
      double ta = (lo[a] - o[a]) * inv_d[a];
      double tb = (hi[a] - o[a]) * inv_d[a];
      if (ta > tb) std::swap(ta, tb);
      t0 = std::max(t0, ta);
      t1 = std::min(t1, tb);
      if (t0 > t1) return std::numeric_limits<double>::infinity();
    }
    return t0;
  }
  double dist2(const Vec3& p) const {
    double d = 0;
    for (int a = 0; a < 3; ++a) {
      double v = p[a];
      if (v < lo[a]) d += (lo[a] - v) * (lo[a] - v);
      if (v > hi[a]) d += (v - hi[a]) * (v - hi[a]);
    }
    return d;
  }
};

// Closest point on triangle (Ericson, Real-Time Collision Detection).
Vec3 closest_on_tri(const Vec3& p, const Vec3& a, const Vec3& b,
                    const Vec3& c) {
  Vec3 ab = b - a, ac = c - a, ap = p - a;
  double d1 = ab.dot(ap), d2 = ac.dot(ap);
  if (d1 <= 0 && d2 <= 0) return a;
  Vec3 bp = p - b;
  double d3 = ab.dot(bp), d4 = ac.dot(bp);
  if (d3 >= 0 && d4 <= d3) return b;
  double vc = d1 * d4 - d3 * d2;
  if (vc <= 0 && d1 >= 0 && d3 <= 0) {
    double v = d1 / (d1 - d3);
    return a + ab * v;
  }
  Vec3 cp = p - c;
  double d5 = ab.dot(cp), d6 = ac.dot(cp);
  if (d6 >= 0 && d5 <= d6) return c;
  double vb = d5 * d2 - d1 * d6;
  if (vb <= 0 && d2 >= 0 && d6 <= 0) {
    double w = d2 / (d2 - d6);
    return a + ac * w;
  }
  double va = d3 * d6 - d5 * d4;
  if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
    double w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
    return b + (c - b) * w;
  }
  double denom = 1.0 / (va + vb + vc);
  double v = vb * denom, w = vc * denom;
  return a + ab * v + ac * w;
}

// Moller-Trumbore; returns t >= 0 or -1.
double ray_tri(const Vec3& o, const Vec3& d, const Vec3& a, const Vec3& b,
               const Vec3& c) {
  const double eps = 1e-12;
  Vec3 e1 = b - a, e2 = c - a;
  Vec3 pv = d.cross(e2);
  double det = e1.dot(pv);
  if (std::fabs(det) < eps) return -1.0;
  double inv = 1.0 / det;
  Vec3 tv = o - a;
  double u = tv.dot(pv) * inv;
  if (u < -1e-10 || u > 1 + 1e-10) return -1.0;
  Vec3 qv = tv.cross(e1);
  double v = d.dot(qv) * inv;
  if (v < -1e-10 || u + v > 1 + 1e-10) return -1.0;
  double t = e2.dot(qv) * inv;
  return t >= 0 ? t : -1.0;
}

struct BVHNode {
  AABB box;
  int left = -1, right = -1;  // internal children
  int start = 0, count = 0;   // leaf triangle range
};

struct Mesh {
  std::vector<Vec3> verts;
  std::vector<std::array<int64_t, 3>> faces;
  std::vector<BVHNode> nodes;
  std::vector<int> tri_order;
  std::vector<double> face_area;
  std::vector<Vec3> face_normal;
  std::vector<double> cum_area;
  double total_area = 0;
  AABB bounds;
  bool robust = true;

  const Vec3& va(int t) const { return verts[faces[tri_order[t]][0]]; }
  const Vec3& vb(int t) const { return verts[faces[tri_order[t]][1]]; }
  const Vec3& vc(int t) const { return verts[faces[tri_order[t]][2]]; }

  void build() {
    int nf = static_cast<int>(faces.size());
    tri_order.resize(nf);
    for (int i = 0; i < nf; ++i) tri_order[i] = i;
    std::vector<Vec3> centroids(nf);
    std::vector<AABB> tri_box(nf);
    face_area.resize(nf);
    face_normal.resize(nf);
    cum_area.resize(nf);
    bounds = AABB();
    for (int i = 0; i < nf; ++i) {
      const Vec3 &a = verts[faces[i][0]], &b = verts[faces[i][1]],
                 &c = verts[faces[i][2]];
      tri_box[i].expand(a);
      tri_box[i].expand(b);
      tri_box[i].expand(c);
      centroids[i] = (a + b + c) * (1.0 / 3.0);
      Vec3 n = (b - a).cross(c - a);
      double nn = n.norm();
      face_area[i] = 0.5 * nn;
      face_normal[i] = nn > 0 ? n * (1.0 / nn) : Vec3{0, 0, 1};
      bounds.expand(tri_box[i]);
    }
    total_area = 0;
    for (int i = 0; i < nf; ++i) {
      total_area += face_area[i];
      cum_area[i] = total_area;
    }
    nodes.clear();
    nodes.reserve(2 * nf);
    build_node(0, nf, centroids, tri_box);
  }

  int build_node(int start, int count, const std::vector<Vec3>& centroids,
                 const std::vector<AABB>& tri_box) {
    int idx = static_cast<int>(nodes.size());
    nodes.emplace_back();
    AABB box;
    for (int i = start; i < start + count; ++i)
      box.expand(tri_box[tri_order[i]]);
    nodes[idx].box = box;
    if (count <= 4) {
      nodes[idx].start = start;
      nodes[idx].count = count;
      return idx;
    }
    Vec3 ext = box.hi - box.lo;
    int axis = 0;
    if (ext.y > ext.x) axis = 1;
    if (ext.z > ext[axis]) axis = 2;
    int mid = start + count / 2;
    std::nth_element(tri_order.begin() + start, tri_order.begin() + mid,
                     tri_order.begin() + start + count,
                     [&](int p, int q) {
                       return centroids[p][axis] < centroids[q][axis];
                     });
    int l = build_node(start, mid - start, centroids, tri_box);
    int r = build_node(mid, start + count - mid, centroids, tri_box);
    nodes[idx].left = l;
    nodes[idx].right = r;
    return idx;
  }

  // Count ray-surface crossings (for parity) in direction d from o.
  int count_hits(const Vec3& o, const Vec3& d) const {
    Vec3 inv{1.0 / d.x, 1.0 / d.y, 1.0 / d.z};
    int count = 0;
    int stack[128];
    int sp = 0;
    stack[sp++] = 0;
    while (sp) {
      const BVHNode& nd = nodes[stack[--sp]];
      if (!std::isfinite(nd.box.ray_hit(
              o, inv, std::numeric_limits<double>::infinity())))
        continue;
      if (nd.count > 0) {
        for (int i = nd.start; i < nd.start + nd.count; ++i) {
          double t = ray_tri(o, d, va(i), vb(i), vc(i));
          if (t > 1e-12) ++count;
        }
      } else {
        stack[sp++] = nd.left;
        stack[sp++] = nd.right;
      }
    }
    return count;
  }

  // First-hit raycast: returns t (or inf) and the hit triangle id.
  double first_hit(const Vec3& o, const Vec3& d, int* tri) const {
    Vec3 inv{1.0 / d.x, 1.0 / d.y, 1.0 / d.z};
    double best = std::numeric_limits<double>::infinity();
    int best_tri = -1;
    int stack[128];
    int sp = 0;
    stack[sp++] = 0;
    while (sp) {
      const BVHNode& nd = nodes[stack[--sp]];
      if (nd.box.ray_hit(o, inv, best) >= best) continue;
      if (nd.count > 0) {
        for (int i = nd.start; i < nd.start + nd.count; ++i) {
          double t = ray_tri(o, d, va(i), vb(i), vc(i));
          if (t > 1e-12 && t < best) {
            best = t;
            best_tri = tri_order[i];
          }
        }
      } else {
        stack[sp++] = nd.left;
        stack[sp++] = nd.right;
      }
    }
    if (tri) *tri = best_tri;
    return best;
  }

  bool contains(const Vec3& p) const {
    if (bounds.dist2(p) > 0) return false;
    if (!robust) return count_hits(p, Vec3{1, 0, 0}) % 2 == 1;
    // Majority vote over fixed irrational directions: robust against
    // edge/vertex grazing hits (the reference rotates into a random frame
    // per raycast, sdf/src/sdf.cpp:270-322).
    static const Vec3 dirs[3] = {
        {0.5377392, 0.7316892, 0.4192322},
        {-0.2624357, 0.5893142, -0.7640921},
        {0.8021933, -0.3951992, -0.4476823}};
    int votes = 0;
    for (const Vec3& d : dirs) votes += count_hits(p, d) % 2;
    return votes >= 2;
  }

  double unsigned_dist(const Vec3& p, int* nearest_vert) const {
    double best = std::numeric_limits<double>::infinity();
    Vec3 best_pt;
    int best_tri = -1;
    // Best-first traversal with a small explicit stack.
    struct Item {
      int node;
      double d2;
    };
    Item stack[128];
    int sp = 0;
    stack[sp++] = {0, nodes[0].box.dist2(p)};
    while (sp) {
      Item it = stack[--sp];
      if (it.d2 >= best) continue;
      const BVHNode& nd = nodes[it.node];
      if (nd.count > 0) {
        for (int i = nd.start; i < nd.start + nd.count; ++i) {
          Vec3 q = closest_on_tri(p, va(i), vb(i), vc(i));
          double d2 = (p - q).norm2();
          if (d2 < best) {
            best = d2;
            best_pt = q;
            best_tri = tri_order[i];
          }
        }
      } else {
        double dl = nodes[nd.left].box.dist2(p);
        double dr = nodes[nd.right].box.dist2(p);
        // Push farther first so nearer is processed next.
        if (dl < dr) {
          if (dr < best) stack[sp++] = {nd.right, dr};
          if (dl < best) stack[sp++] = {nd.left, dl};
        } else {
          if (dl < best) stack[sp++] = {nd.left, dl};
          if (dr < best) stack[sp++] = {nd.right, dr};
        }
      }
    }
    if (nearest_vert) {
      *nearest_vert = -1;
      if (best_tri >= 0) {
        double bd = std::numeric_limits<double>::infinity();
        for (int k = 0; k < 3; ++k) {
          int64_t vi = faces[best_tri][k];
          double d2 = (p - verts[vi]).norm2();
          if (d2 < bd) {
            bd = d2;
            *nearest_vert = static_cast<int>(vi);
          }
        }
      }
    }
    return std::sqrt(best);
  }
};

void parallel_for(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw <= 1 || n < 2048) {
    fn(0, n);
    return;
  }
  int64_t chunk = (n + hw - 1) / hw;
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < hw; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([=, &fn] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

void* sdf_create(const float* verts, int64_t nv, const int32_t* faces,
                 int64_t nf, int robust) {
  auto* m = new Mesh();
  m->robust = robust != 0;
  m->verts.resize(nv);
  for (int64_t i = 0; i < nv; ++i)
    m->verts[i] = Vec3{verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]};
  m->faces.resize(nf);
  for (int64_t i = 0; i < nf; ++i)
    m->faces[i] = {faces[3 * i], faces[3 * i + 1], faces[3 * i + 2]};
  m->build();
  return m;
}

void sdf_destroy(void* handle) { delete static_cast<Mesh*>(handle); }

void sdf_contains(void* handle, const float* pts, int64_t n, uint8_t* out) {
  auto* m = static_cast<Mesh*>(handle);
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      Vec3 p{pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]};
      out[i] = m->contains(p) ? 1 : 0;
    }
  });
}

// Signed distance, positive inside (pysdf convention, sdf/pybind.cpp:22).
void sdf_calc(void* handle, const float* pts, int64_t n, float* out) {
  auto* m = static_cast<Mesh*>(handle);
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      Vec3 p{pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]};
      double d = m->unsigned_dist(p, nullptr);
      out[i] = static_cast<float>(m->contains(p) ? d : -d);
    }
  });
}

void sdf_nn(void* handle, const float* pts, int64_t n, int32_t* out) {
  auto* m = static_cast<Mesh*>(handle);
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      Vec3 p{pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]};
      int nv = -1;
      m->unsigned_dist(p, &nv);
      out[i] = nv;
    }
  });
}

void sdf_sample_surface(void* handle, int64_t n, uint64_t seed, float* out) {
  auto* m = static_cast<Mesh*>(handle);
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> uni(0.0, 1.0);
  for (int64_t i = 0; i < n; ++i) {
    double r = uni(rng) * m->total_area;
    auto it = std::lower_bound(m->cum_area.begin(), m->cum_area.end(), r);
    int64_t tri = it - m->cum_area.begin();
    if (tri >= static_cast<int64_t>(m->faces.size()))
      tri = m->faces.size() - 1;
    double u = uni(rng), v = uni(rng);
    if (u + v > 1) {
      u = 1 - u;
      v = 1 - v;
    }
    const Vec3 &a = m->verts[m->faces[tri][0]], &b = m->verts[m->faces[tri][1]],
               &c = m->verts[m->faces[tri][2]];
    Vec3 p = a + (b - a) * u + (c - a) * v;
    out[3 * i] = static_cast<float>(p.x);
    out[3 * i + 1] = static_cast<float>(p.y);
    out[3 * i + 2] = static_cast<float>(p.z);
  }
}

double sdf_surface_area(void* handle) {
  return static_cast<Mesh*>(handle)->total_area;
}

void sdf_aabb(void* handle, float* out6) {
  auto* m = static_cast<Mesh*>(handle);
  out6[0] = m->bounds.lo.x;
  out6[1] = m->bounds.lo.y;
  out6[2] = m->bounds.lo.z;
  out6[3] = m->bounds.hi.x;
  out6[4] = m->bounds.hi.y;
  out6[5] = m->bounds.hi.z;
}

void sdf_face_normals(void* handle, float* out) {
  auto* m = static_cast<Mesh*>(handle);
  for (size_t i = 0; i < m->faces.size(); ++i) {
    out[3 * i] = m->face_normal[i].x;
    out[3 * i + 1] = m->face_normal[i].y;
    out[3 * i + 2] = m->face_normal[i].z;
  }
}

void sdf_face_areas(void* handle, float* out) {
  auto* m = static_cast<Mesh*>(handle);
  for (size_t i = 0; i < m->faces.size(); ++i) out[i] = m->face_area[i];
}

// Image-space raycast renderer: pinhole camera at origin facing +z
// (sdf/src/renderer.cpp semantics). Ray for pixel (u, v):
// dir = ((u - cx)/fx, (v - cy)/fy, 1).
void sdf_render_depth(void* handle, int width, int height, float fx, float fy,
                      float cx, float cy, float* out) {
  auto* m = static_cast<Mesh*>(handle);
  parallel_for(static_cast<int64_t>(width) * height,
               [&](int64_t lo, int64_t hi) {
                 for (int64_t i = lo; i < hi; ++i) {
                   int px = static_cast<int>(i % width);
                   int py = static_cast<int>(i / width);
                   Vec3 d{(px - cx) / fx, (py - cy) / fy, 1.0};
                   int tri;
                   double t = m->first_hit(Vec3{0, 0, 0}, d, &tri);
                   out[i] = std::isfinite(t) ? static_cast<float>(t) : 0.0f;
                 }
               });
}

void sdf_render_nn(void* handle, int width, int height, float fx, float fy,
                   float cx, float cy, int32_t* out) {
  auto* m = static_cast<Mesh*>(handle);
  parallel_for(static_cast<int64_t>(width) * height,
               [&](int64_t lo, int64_t hi) {
                 for (int64_t i = lo; i < hi; ++i) {
                   int px = static_cast<int>(i % width);
                   int py = static_cast<int>(i / width);
                   Vec3 d{(px - cx) / fx, (py - cy) / fy, 1.0};
                   int tri = -1;
                   double t = m->first_hit(Vec3{0, 0, 0}, d, &tri);
                   if (!std::isfinite(t) || tri < 0) {
                     out[i] = -1;
                     continue;
                   }
                   Vec3 hit = d * t;
                   double bd = std::numeric_limits<double>::infinity();
                   int best = -1;
                   for (int k = 0; k < 3; ++k) {
                     int64_t vi = m->faces[tri][k];
                     double d2 = (hit - m->verts[vi]).norm2();
                     if (d2 < bd) {
                       bd = d2;
                       best = static_cast<int>(vi);
                     }
                   }
                   out[i] = best;
                 }
               });
}

}  // extern "C"
