// First-party C++ BVH for exact nearest-point-on-mesh queries: a copy of
// the JAX package's `native/aabb.cpp`, so that the port builds it from its
// own sources.
//
// Replaces psbody-mesh's C++ AABB tree in the reference's upsample-matrix
// construction (reference: lib/mesh_sampling.py:73 calls
// mesh.compute_aabb_tree().nearest(...)). Host-side, offline use only:
// the mesh pyramid is precomputed once, so this is a build-time tool, not
// part of the device compute path.
//
// Exposed via a C ABI for ctypes (no pybind11 in the image):
//   aabb_build(verts[n*3], n_verts, faces[m*3], n_faces) -> handle
//   aabb_nearest(handle, queries[q*3], n_q, out_face[q], out_bary[q*3])
//   aabb_free(handle)
//
// Build: cape_tpu_torch/meshops/native_aabb.py compiles it at first use
// with the host's C++ compiler into build/cape_tpu_torch/.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

struct Vec3 {
  double x, y, z;
  Vec3 operator-(const Vec3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  Vec3 operator+(const Vec3& o) const { return {x + o.x, y + o.y, z + o.z}; }
  Vec3 operator*(double s) const { return {x * s, y * s, z * s}; }
};

inline double dot(const Vec3& a, const Vec3& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

struct Box {
  Vec3 lo{1e30, 1e30, 1e30};
  Vec3 hi{-1e30, -1e30, -1e30};
  void grow(const Vec3& p) {
    lo.x = std::min(lo.x, p.x); lo.y = std::min(lo.y, p.y); lo.z = std::min(lo.z, p.z);
    hi.x = std::max(hi.x, p.x); hi.y = std::max(hi.y, p.y); hi.z = std::max(hi.z, p.z);
  }
  void grow(const Box& b) { grow(b.lo); grow(b.hi); }
  // squared distance from p to this box (0 if inside)
  double dist2(const Vec3& p) const {
    double d = 0.0;
    double dx = std::max({lo.x - p.x, 0.0, p.x - hi.x});
    double dy = std::max({lo.y - p.y, 0.0, p.y - hi.y});
    double dz = std::max({lo.z - p.z, 0.0, p.z - hi.z});
    d = dx * dx + dy * dy + dz * dz;
    return d;
  }
};

// Exact closest point on triangle (Ericson, Real-Time Collision Detection
// 5.1.5). Returns squared distance; bary receives barycentric coords.
double closest_point_tri(const Vec3& p, const Vec3& a, const Vec3& b,
                         const Vec3& c, double bary[3]) {
  Vec3 ab = b - a, ac = c - a, ap = p - a;
  double d1 = dot(ab, ap), d2 = dot(ac, ap);
  if (d1 <= 0 && d2 <= 0) {
    bary[0] = 1; bary[1] = 0; bary[2] = 0;
    Vec3 d = p - a; return dot(d, d);
  }
  Vec3 bp = p - b;
  double d3 = dot(ab, bp), d4 = dot(ac, bp);
  if (d3 >= 0 && d4 <= d3) {
    bary[0] = 0; bary[1] = 1; bary[2] = 0;
    Vec3 d = p - b; return dot(d, d);
  }
  double vc = d1 * d4 - d3 * d2;
  if (vc <= 0 && d1 >= 0 && d3 <= 0) {
    double v = d1 / (d1 - d3);
    bary[0] = 1 - v; bary[1] = v; bary[2] = 0;
    Vec3 q = a + ab * v; Vec3 d = p - q; return dot(d, d);
  }
  Vec3 cp = p - c;
  double d5 = dot(ab, cp), d6 = dot(ac, cp);
  if (d6 >= 0 && d5 <= d6) {
    bary[0] = 0; bary[1] = 0; bary[2] = 1;
    Vec3 d = p - c; return dot(d, d);
  }
  double vb = d5 * d2 - d1 * d6;
  if (vb <= 0 && d2 >= 0 && d6 <= 0) {
    double w = d2 / (d2 - d6);
    bary[0] = 1 - w; bary[1] = 0; bary[2] = w;
    Vec3 q = a + ac * w; Vec3 d = p - q; return dot(d, d);
  }
  double va = d3 * d6 - d5 * d4;
  if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
    double w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
    bary[0] = 0; bary[1] = 1 - w; bary[2] = w;
    Vec3 q = b + (c - b) * w; Vec3 d = p - q; return dot(d, d);
  }
  double denom = 1.0 / (va + vb + vc);
  double v = vb * denom, w = vc * denom;
  bary[0] = 1 - v - w; bary[1] = v; bary[2] = w;
  Vec3 q = a + ab * v + ac * w; Vec3 d = p - q; return dot(d, d);
}

struct BVH {
  struct Node {
    Box box;
    int32_t left = -1, right = -1;   // children, or
    int32_t first = 0, count = 0;    // leaf triangle range
  };
  std::vector<Vec3> verts;
  std::vector<std::array<int32_t, 3>> faces;
  std::vector<int32_t> order;        // face indices, partitioned by build
  std::vector<Node> nodes;

  Box face_box(int32_t f) const {
    Box b;
    for (int k = 0; k < 3; k++) b.grow(verts[faces[f][k]]);
    return b;
  }
  Vec3 face_centroid(int32_t f) const {
    const Vec3 &a = verts[faces[f][0]], &b = verts[faces[f][1]], &c = verts[faces[f][2]];
    return {(a.x + b.x + c.x) / 3, (a.y + b.y + c.y) / 3, (a.z + b.z + c.z) / 3};
  }

  int32_t build(int32_t first, int32_t count) {
    Node node;
    for (int32_t i = first; i < first + count; i++) node.box.grow(face_box(order[i]));
    int32_t idx = (int32_t)nodes.size();
    nodes.push_back(node);
    if (count <= 4) {
      nodes[idx].first = first;
      nodes[idx].count = count;
      return idx;
    }
    // split along the widest centroid axis at the median
    Box cb;
    for (int32_t i = first; i < first + count; i++) cb.grow(face_centroid(order[i]));
    double ex = cb.hi.x - cb.lo.x, ey = cb.hi.y - cb.lo.y, ez = cb.hi.z - cb.lo.z;
    int axis = (ex > ey && ex > ez) ? 0 : (ey > ez ? 1 : 2);
    auto key = [&](int32_t f) {
      Vec3 c = face_centroid(f);
      return axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
    };
    int32_t mid = first + count / 2;
    std::nth_element(order.begin() + first, order.begin() + mid,
                     order.begin() + first + count,
                     [&](int32_t a, int32_t b) { return key(a) < key(b); });
    int32_t l = build(first, mid - first);
    int32_t r = build(mid, first + count - mid);
    nodes[idx].left = l;
    nodes[idx].right = r;
    return idx;
  }

  void nearest(const Vec3& p, int32_t* out_face, double* out_bary) const {
    double best = std::numeric_limits<double>::max();
    int32_t best_face = -1;
    double best_bary[3] = {0, 0, 0};
    // explicit stack, nearer child first
    std::vector<int32_t> stack;
    stack.reserve(64);
    stack.push_back(0);
    while (!stack.empty()) {
      int32_t ni = stack.back();
      stack.pop_back();
      const Node& n = nodes[ni];
      if (n.box.dist2(p) >= best) continue;
      if (n.left < 0) {
        for (int32_t i = n.first; i < n.first + n.count; i++) {
          int32_t f = order[i];
          double bary[3];
          double d2 = closest_point_tri(p, verts[faces[f][0]], verts[faces[f][1]],
                                        verts[faces[f][2]], bary);
          if (d2 < best) {
            best = d2;
            best_face = f;
            for (int k = 0; k < 3; k++) best_bary[k] = bary[k];
          }
        }
      } else {
        double dl = nodes[n.left].box.dist2(p);
        double dr = nodes[n.right].box.dist2(p);
        if (dl < dr) {
          if (dr < best) stack.push_back(n.right);
          if (dl < best) stack.push_back(n.left);
        } else {
          if (dl < best) stack.push_back(n.left);
          if (dr < best) stack.push_back(n.right);
        }
      }
    }
    *out_face = best_face;
    for (int k = 0; k < 3; k++) out_bary[k] = best_bary[k];
  }
};

}  // namespace

extern "C" {

void* aabb_build(const double* verts, int32_t n_verts, const int32_t* faces,
                 int32_t n_faces) {
  BVH* bvh = new BVH();
  bvh->verts.resize(n_verts);
  for (int32_t i = 0; i < n_verts; i++)
    bvh->verts[i] = {verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]};
  bvh->faces.resize(n_faces);
  for (int32_t i = 0; i < n_faces; i++)
    bvh->faces[i] = {faces[3 * i], faces[3 * i + 1], faces[3 * i + 2]};
  bvh->order.resize(n_faces);
  for (int32_t i = 0; i < n_faces; i++) bvh->order[i] = i;
  bvh->nodes.reserve(2 * n_faces);
  if (n_faces > 0) bvh->build(0, n_faces);
  return bvh;
}

void aabb_nearest(void* handle, const double* queries, int32_t n_queries,
                  int32_t* out_face, double* out_bary) {
  const BVH* bvh = static_cast<BVH*>(handle);
  for (int32_t i = 0; i < n_queries; i++) {
    Vec3 p{queries[3 * i], queries[3 * i + 1], queries[3 * i + 2]};
    bvh->nearest(p, &out_face[i], &out_bary[3 * i]);
  }
}

void aabb_free(void* handle) { delete static_cast<BVH*>(handle); }

}  // extern "C"
