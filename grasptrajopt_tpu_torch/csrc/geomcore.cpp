// geomcore: native host-side geometry core of grasptrajopt_tpu_torch, a
// copy of the JAX package's native/geomcore.cpp.
//
// The port keeps its hot compute on the card (csrc/*.cu); this library
// speeds up the host-side runtime around it, the work the reference
// delegates to third-party native engines (trimesh's loaders, sklearn's
// KD-tree):
//
//   - OBJ / binary-STL triangle mesh parsing (asset prep: every robot
//     link's visual mesh is loaded at model-build time)
//   - a median-split KD-tree with nearest-neighbor queries
//   - a z-buffer triangle rasterizer (envs/render.py's depth camera)
//
// Exposed as a plain C ABI consumed through ctypes
// (grasptrajopt_tpu_torch/native/__init__.py). No Python.h dependency, so
// the library builds with just g++.

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <memory>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- mesh IO

struct MeshBuffer {
  std::vector<double> vertices;  // xyz triples
  std::vector<int32_t> faces;    // index triples
};

static double parse_double(const char*& p) {
  char* end = nullptr;
  double v = strtod(p, &end);
  p = end;
  return v;
}

// Parse an OBJ file: v records and f records (fan-triangulated, handles
// v/vt/vn syntax and negative indices).
void* geom_load_obj(const char* path) {
  std::ifstream in(path);
  if (!in) return nullptr;
  auto mesh = std::make_unique<MeshBuffer>();
  std::string line;
  std::vector<int32_t> poly;
  while (std::getline(in, line)) {
    const char* p = line.c_str();
    if (p[0] == 'v' && p[1] == ' ') {
      p += 2;
      double x = parse_double(p);
      double y = parse_double(p);
      double z = parse_double(p);
      mesh->vertices.push_back(x);
      mesh->vertices.push_back(y);
      mesh->vertices.push_back(z);
    } else if (p[0] == 'f' && p[1] == ' ') {
      p += 2;
      poly.clear();
      while (*p) {
        while (*p == ' ') ++p;
        if (!*p) break;
        long idx = strtol(p, const_cast<char**>(&p), 10);
        if (idx == 0) break;
        long n_verts = static_cast<long>(mesh->vertices.size() / 3);
        int32_t vi = idx > 0 ? static_cast<int32_t>(idx - 1)
                             : static_cast<int32_t>(n_verts + idx);
        poly.push_back(vi);
        // skip /vt/vn block
        while (*p && *p != ' ') ++p;
      }
      for (size_t k = 1; k + 1 < poly.size(); ++k) {
        mesh->faces.push_back(poly[0]);
        mesh->faces.push_back(poly[k]);
        mesh->faces.push_back(poly[k + 1]);
      }
    }
  }
  if (mesh->vertices.empty()) return nullptr;
  return mesh.release();
}

// Parse a binary STL file (each triangle becomes 3 unique vertices, the
// same layout as the Python loader).
void* geom_load_stl(const char* path) {
  std::ifstream in(path, std::ios::binary);
  if (!in) return nullptr;
  char header[84];
  if (!in.read(header, 84)) return nullptr;
  uint32_t n_tri;
  std::memcpy(&n_tri, header + 80, 4);
  auto mesh = std::make_unique<MeshBuffer>();
  mesh->vertices.reserve(static_cast<size_t>(n_tri) * 9);
  mesh->faces.reserve(static_cast<size_t>(n_tri) * 3);
  std::vector<char> rec(50);
  for (uint32_t t = 0; t < n_tri; ++t) {
    if (!in.read(rec.data(), 50)) return nullptr;
    float v[9];
    std::memcpy(v, rec.data() + 12, 36);
    for (int k = 0; k < 9; ++k) mesh->vertices.push_back(static_cast<double>(v[k]));
    int32_t base = static_cast<int32_t>(t) * 3;
    mesh->faces.push_back(base);
    mesh->faces.push_back(base + 1);
    mesh->faces.push_back(base + 2);
  }
  return mesh.release();
}

int64_t geom_mesh_num_vertices(void* handle) {
  return static_cast<MeshBuffer*>(handle)->vertices.size() / 3;
}

int64_t geom_mesh_num_faces(void* handle) {
  return static_cast<MeshBuffer*>(handle)->faces.size() / 3;
}

void geom_mesh_copy(void* handle, double* vertices_out, int32_t* faces_out) {
  auto* mesh = static_cast<MeshBuffer*>(handle);
  std::memcpy(vertices_out, mesh->vertices.data(), mesh->vertices.size() * sizeof(double));
  std::memcpy(faces_out, mesh->faces.data(), mesh->faces.size() * sizeof(int32_t));
}

void geom_mesh_free(void* handle) { delete static_cast<MeshBuffer*>(handle); }

// ---------------------------------------------------------------- KD-tree

struct KDTree {
  // implicit balanced tree over point indices, median split
  std::vector<double> pts;     // xyz triples (owned copy)
  std::vector<int32_t> index;  // permutation defining the tree layout
  int64_t n = 0;

  void build(int64_t lo, int64_t hi, int depth) {
    if (hi - lo <= 1) return;
    int axis = depth % 3;
    int64_t mid = (lo + hi) / 2;
    std::nth_element(
        index.begin() + lo, index.begin() + mid, index.begin() + hi,
        [&](int32_t a, int32_t b) { return pts[a * 3 + axis] < pts[b * 3 + axis]; });
    build(lo, mid, depth + 1);
    build(mid + 1, hi, depth + 1);
  }

  void query(const double* q, int64_t lo, int64_t hi, int depth,
             double& best_d2, int32_t& best_i) const {
    if (hi <= lo) return;
    int axis = depth % 3;
    int64_t mid = (lo + hi) / 2;
    int32_t pi = index[mid];
    const double* p = &pts[pi * 3];
    double d2 = 0;
    for (int k = 0; k < 3; ++k) {
      double d = q[k] - p[k];
      d2 += d * d;
    }
    if (d2 < best_d2) {
      best_d2 = d2;
      best_i = pi;
    }
    double delta = q[axis] - p[axis];
    int64_t near_lo = delta < 0 ? lo : mid + 1;
    int64_t near_hi = delta < 0 ? mid : hi;
    int64_t far_lo = delta < 0 ? mid + 1 : lo;
    int64_t far_hi = delta < 0 ? hi : mid;
    query(q, near_lo, near_hi, depth + 1, best_d2, best_i);
    if (delta * delta < best_d2) query(q, far_lo, far_hi, depth + 1, best_d2, best_i);
  }
};

void* geom_kdtree_build(const double* points, int64_t n) {
  auto tree = std::make_unique<KDTree>();
  tree->n = n;
  tree->pts.assign(points, points + n * 3);
  tree->index.resize(n);
  for (int64_t i = 0; i < n; ++i) tree->index[i] = static_cast<int32_t>(i);
  tree->build(0, n, 0);
  return tree.release();
}

void geom_kdtree_query(void* handle, const double* queries, int64_t m,
                       double* dists_out, int32_t* idx_out) {
  auto* tree = static_cast<KDTree*>(handle);
  auto run = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      double best_d2 = 1e300;
      int32_t best_i = -1;
      tree->query(queries + i * 3, 0, tree->n, 0, best_d2, best_i);
      dists_out[i] = std::sqrt(best_d2);
      idx_out[i] = best_i;
    }
  };
  // dense field builds make 10^5-10^6 independent queries; fan out over
  // hardware threads (queries are read-only on the tree, outputs disjoint)
  int64_t nthreads = std::min<int64_t>(
      std::max(1u, std::thread::hardware_concurrency()), (m + 4095) / 4096);
  if (nthreads <= 1) {
    run(0, m);
    return;
  }
  std::vector<std::thread> workers;
  int64_t chunk = (m + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(m, lo + chunk);
    if (lo >= hi) break;
    workers.emplace_back(run, lo, hi);
  }
  for (auto& w : workers) w.join();
}

void geom_kdtree_free(void* handle) { delete static_cast<KDTree*>(handle); }

// ------------------------------------------------------------- rasterizer
//
// Perspective z-buffer triangle rasterizer — the framework's software
// depth camera. Replaces the reference's GPU renderers (PyBullet's
// getCameraImage for scene observation, pyrender/OpenGL for the
// mesh_to_sdf virtual scans; SURVEY.md C10/C20). Pinhole model matching
// fields/depth_point_cloud.py: camera looks down +z, x right, y down,
// pixel u = fx*x/z + cx, v = fy*y/z + cy; output depth is camera-frame z.
//
// Vertices arrive already in the camera frame. 1/z is interpolated
// linearly in screen space (perspective-correct depth). Triangles with
// any vertex behind the near plane are skipped (adequate: scene cameras
// never intersect geometry). No backface culling — meshes are not
// guaranteed closed and a depth sensor z-test makes culling unnecessary.
//
// Accumulates into caller-owned buffers so multi-object scenes compose:
//   depth_buf (H*W float32) initialised to +inf (or a far value),
//   id_buf    (H*W int32)   object id of the nearest surface per pixel,
//   face_buf  (H*W int32)   triangle index per pixel (may be null).

void geom_rasterize(const double* verts_cam, int64_t n_verts,
                    const int32_t* faces, int64_t n_faces,
                    double fx, double fy, double cx, double cy,
                    int32_t width, int32_t height, int32_t obj_id,
                    float* depth_buf, int32_t* id_buf, int32_t* face_buf) {
  (void)n_verts;
  const double znear = 1e-6;
  for (int64_t f = 0; f < n_faces; ++f) {
    const int32_t* tri = faces + f * 3;
    double x[3], y[3], w[3];  // screen u, v, 1/z
    bool ok = true;
    for (int k = 0; k < 3; ++k) {
      const double* p = verts_cam + static_cast<int64_t>(tri[k]) * 3;
      if (p[2] <= znear) { ok = false; break; }
      w[k] = 1.0 / p[2];
      x[k] = fx * p[0] * w[k] + cx;
      y[k] = fy * p[1] * w[k] + cy;
    }
    if (!ok) continue;
    int32_t x0 = static_cast<int32_t>(std::floor(std::min({x[0], x[1], x[2]})));
    int32_t x1 = static_cast<int32_t>(std::ceil(std::max({x[0], x[1], x[2]})));
    int32_t y0 = static_cast<int32_t>(std::floor(std::min({y[0], y[1], y[2]})));
    int32_t y1 = static_cast<int32_t>(std::ceil(std::max({y[0], y[1], y[2]})));
    x0 = std::max(x0, 0);
    y0 = std::max(y0, 0);
    x1 = std::min(x1, width - 1);
    y1 = std::min(y1, height - 1);
    if (x0 > x1 || y0 > y1) continue;
    // edge functions: area * barycentric
    double ax = x[1] - x[0], ay = y[1] - y[0];
    double bx = x[2] - x[0], by = y[2] - y[0];
    double area = ax * by - ay * bx;
    if (std::abs(area) < 1e-12) continue;
    double inv_area = 1.0 / area;
    for (int32_t v = y0; v <= y1; ++v) {
      for (int32_t u = x0; u <= x1; ++u) {
        // pixel center sampling
        double px = u + 0.5, py = v + 0.5;
        double dx = px - x[0], dy = py - y[0];
        double b1 = (dx * by - dy * bx) * inv_area;
        double b2 = (ax * dy - ay * dx) * inv_area;
        double b0 = 1.0 - b1 - b2;
        if (b0 < 0.0 || b1 < 0.0 || b2 < 0.0) continue;
        double wi = b0 * w[0] + b1 * w[1] + b2 * w[2];
        if (wi <= 0.0) continue;
        float z = static_cast<float>(1.0 / wi);
        int64_t pix = static_cast<int64_t>(v) * width + u;
        if (z < depth_buf[pix]) {
          depth_buf[pix] = z;
          id_buf[pix] = obj_id;
          if (face_buf) face_buf[pix] = static_cast<int32_t>(f);
        }
      }
    }
  }
}

}  // extern "C"
