// fastgeo: native host-side geometry kernels for facedeform-tpu.
//
// The reference's irregular substrate is HDK-native C++: GEO_PointTree
// (KD-tree, capture.cpp:15-17), GQ_Detail::groupEdgePoints (edge-ring BFS,
// capture.cpp:134) and GU_RayIntersect (closest prim, capture.cpp:81).
// The rebuild keeps dense distance math on the device (ops/distances.py)
// and mirrors the pointer-chasing pieces here: a multi-source BFS over CSR
// adjacency and a 3-D KD-tree nearest-neighbor query.  Exposed as a plain
// C ABI consumed via ctypes (native/__init__.py), with
// numpy/scipy fallbacks when the shared library is unavailable.
//
// Build: g++ -O3 -march=native -shared -fPIC fastgeo.cpp -o libfastgeo.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <queue>
#include <vector>

extern "C" {

// Multi-source BFS: mark every vertex within max_edges hops of any seed.
// indptr: (n+1) int64 CSR row starts; indices: int32 neighbors;
// seeds: (n_seeds) int64; out_mask: (n) uint8, written 0/1.
void fd_bfs_rings(const int64_t* indptr, const int32_t* indices, int64_t n,
                  const int64_t* seeds, int64_t n_seeds, int64_t max_edges,
                  uint8_t* out_mask) {
  std::memset(out_mask, 0, static_cast<size_t>(n));
  std::vector<int64_t> frontier;
  frontier.reserve(static_cast<size_t>(n_seeds));
  for (int64_t i = 0; i < n_seeds; ++i) {
    const int64_t s = seeds[i];
    if (s < 0 || s >= n) continue;
    if (!out_mask[s]) {
      out_mask[s] = 1;
      frontier.push_back(s);
    }
  }
  std::vector<int64_t> next;
  for (int64_t ring = 0; ring < max_edges && !frontier.empty(); ++ring) {
    next.clear();
    for (const int64_t v : frontier) {
      for (int64_t e = indptr[v]; e < indptr[v + 1]; ++e) {
        const int32_t u = indices[e];
        if (!out_mask[u]) {
          out_mask[u] = 1;
          next.push_back(u);
        }
      }
    }
    frontier.swap(next);
  }
}

namespace {

// Minimal median-split 3-D KD-tree over an index permutation.
struct KDTree {
  const float* pts;  // (n, 3)
  std::vector<int32_t> perm;

  void build(const float* p, int64_t n) {
    pts = p;
    perm.resize(static_cast<size_t>(n));
    std::iota(perm.begin(), perm.end(), 0);
    build_range(0, n, 0);
  }

  void build_range(int64_t lo, int64_t hi, int axis) {
    if (hi - lo <= 8) return;  // leaf bucket
    const int64_t mid = (lo + hi) / 2;
    std::nth_element(
        perm.begin() + lo, perm.begin() + mid, perm.begin() + hi,
        [&](int32_t a, int32_t b) { return pts[3 * a + axis] < pts[3 * b + axis]; });
    build_range(lo, mid, (axis + 1) % 3);
    build_range(mid + 1, hi, (axis + 1) % 3);
  }

  void nearest(const float* q, int64_t lo, int64_t hi, int axis,
               float& best_d2, int32_t& best_i) const {
    if (hi - lo <= 8) {
      for (int64_t k = lo; k < hi; ++k) {
        const int32_t i = perm[static_cast<size_t>(k)];
        const float dx = pts[3 * i] - q[0];
        const float dy = pts[3 * i + 1] - q[1];
        const float dz = pts[3 * i + 2] - q[2];
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < best_d2) { best_d2 = d2; best_i = i; }
      }
      return;
    }
    const int64_t mid = (lo + hi) / 2;
    const int32_t mi = perm[static_cast<size_t>(mid)];
    {
      const float dx = pts[3 * mi] - q[0];
      const float dy = pts[3 * mi + 1] - q[1];
      const float dz = pts[3 * mi + 2] - q[2];
      const float d2 = dx * dx + dy * dy + dz * dz;
      if (d2 < best_d2) { best_d2 = d2; best_i = mi; }
    }
    const float delta = q[axis] - pts[3 * mi + axis];
    const int next_axis = (axis + 1) % 3;
    if (delta < 0.f) {
      nearest(q, lo, mid, next_axis, best_d2, best_i);
      if (delta * delta < best_d2) nearest(q, mid + 1, hi, next_axis, best_d2, best_i);
    } else {
      nearest(q, mid + 1, hi, next_axis, best_d2, best_i);
      if (delta * delta < best_d2) nearest(q, lo, mid, next_axis, best_d2, best_i);
    }
  }
};

}  // namespace

// Nearest point index for each query.  pts: (n, 3) f32; queries: (m, 3) f32;
// out_idx: (m) int64; out_d2: (m) f32 (nullable).
void fd_nearest(const float* pts, int64_t n, const float* queries, int64_t m,
                int64_t* out_idx, float* out_d2) {
  KDTree tree;
  tree.build(pts, n);
  for (int64_t j = 0; j < m; ++j) {
    float best_d2 = 3.4e38f;
    int32_t best_i = 0;
    tree.nearest(queries + 3 * j, 0, n, 0, best_d2, best_i);
    out_idx[j] = best_i;
    if (out_d2) out_d2[j] = best_d2;
  }
}

// Multi-source Dijkstra over CSR adjacency, edge weights = euclidean
// length between the endpoint positions (geodesic surface distance along
// the edge graph).  sources: (n_src) int64 seed vertices; source_dist:
// (n_src) f32 initial distance per seed (marker-to-seed offset), nullable
// for zeros.  out_dist: (n) f32, 3.4e38 where unreachable.
void fd_dijkstra(const int64_t* indptr, const int32_t* indices, int64_t n,
                 const float* pts, const int64_t* sources,
                 const float* source_dist, int64_t n_src, float* out_dist) {
  const float kInf = 3.4e38f;
  std::fill(out_dist, out_dist + n, kInf);
  using Item = std::pair<float, int64_t>;  // (distance, vertex)
  std::priority_queue<Item, std::vector<Item>, std::greater<Item>> pq;
  for (int64_t i = 0; i < n_src; ++i) {
    const int64_t s = sources[i];
    if (s < 0 || s >= n) continue;
    const float d0 = source_dist ? source_dist[i] : 0.f;
    if (d0 < out_dist[s]) {
      out_dist[s] = d0;
      pq.emplace(d0, s);
    }
  }
  while (!pq.empty()) {
    const auto [d, v] = pq.top();
    pq.pop();
    if (d > out_dist[v]) continue;  // stale queue entry
    const float vx = pts[3 * v], vy = pts[3 * v + 1], vz = pts[3 * v + 2];
    for (int64_t e = indptr[v]; e < indptr[v + 1]; ++e) {
      const int32_t u = indices[e];
      const float dx = pts[3 * u] - vx;
      const float dy = pts[3 * u + 1] - vy;
      const float dz = pts[3 * u + 2] - vz;
      const float nd = d + std::sqrt(dx * dx + dy * dy + dz * dz);
      if (nd < out_dist[u]) {
        out_dist[u] = nd;
        pq.emplace(nd, u);
      }
    }
  }
}

// Unique undirected edges of an (f, k) face array -> CSR adjacency.
// Two-phase: call with counts_only=1 to size out_indices, then fill.
// Returns the number of directed edge slots written (2 * unique edges).
int64_t fd_build_adjacency(const int32_t* faces, int64_t n_faces, int64_t arity,
                           int64_t n_points, int64_t* out_indptr,
                           int32_t* out_indices, int64_t indices_capacity) {
  std::vector<std::pair<int32_t, int32_t>> edges;
  edges.reserve(static_cast<size_t>(n_faces * arity));
  for (int64_t f = 0; f < n_faces; ++f) {
    for (int64_t k = 0; k < arity; ++k) {
      int32_t a = faces[f * arity + k];
      int32_t b = faces[f * arity + (k + 1) % arity];
      // -1-padded polygon entries (mixed-arity meshes) carry no edge; an
      // unchecked -1 would index count[] out of bounds below.
      if (a < 0 || b < 0) continue;
      if (a == b) continue;  // degenerate (e.g. fanned quad padding)
      if (a > b) std::swap(a, b);
      edges.emplace_back(a, b);
    }
  }
  std::sort(edges.begin(), edges.end());
  edges.erase(std::unique(edges.begin(), edges.end()), edges.end());
  const int64_t total = static_cast<int64_t>(edges.size()) * 2;
  if (out_indices == nullptr || indices_capacity < total) return total;

  std::vector<int64_t> count(static_cast<size_t>(n_points), 0);
  for (const auto& e : edges) { count[e.first]++; count[e.second]++; }
  out_indptr[0] = 0;
  for (int64_t i = 0; i < n_points; ++i) out_indptr[i + 1] = out_indptr[i] + count[i];
  std::vector<int64_t> cursor(out_indptr, out_indptr + n_points);
  for (const auto& e : edges) {
    out_indices[cursor[e.first]++] = e.second;
    out_indices[cursor[e.second]++] = e.first;
  }
  return total;
}

}  // extern "C"

// ------------------------------------------------------------------ OBJ IO
// Native Wavefront OBJ parser: the framework's mesh-ingest runtime path.
// Python line-by-line parsing costs ~10 s per million vertices; this is a
// single-pass buffered scanner (~two orders faster).  Two-phase ABI:
// fd_obj_count sizes the buffers, fd_obj_parse fills them.  Faces are
// right-padded with -1 up to max_arity.

#include <cstdio>
#include <cstdlib>

namespace {

struct ObjScan {
  int64_t n_verts = 0, n_normals = 0, n_faces = 0, max_arity = 0;
};

// Parse one whitespace-separated float, advancing p.
inline bool read_float(const char*& p, const char* end, float& out) {
  while (p < end && (*p == ' ' || *p == '\t')) ++p;
  if (p >= end || *p == '\n' || *p == '\r') return false;
  char* q = nullptr;
  out = strtof(p, &q);
  if (q == p) return false;
  p = q;
  return true;
}

// Parse a face vertex token "v", "v/t", "v/t/n", "v//n"; returns the
// (1-based, possibly negative) vertex index.
inline bool read_face_index(const char*& p, const char* end, long& out) {
  while (p < end && (*p == ' ' || *p == '\t')) ++p;
  if (p >= end || *p == '\n' || *p == '\r') return false;
  char* q = nullptr;
  out = strtol(p, &q, 10);
  if (q == p) return false;
  p = q;
  while (p < end && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') ++p;
  return true;
}

bool scan_obj(const char* path, ObjScan& s, float* verts, float* normals,
              int32_t* faces, int64_t max_arity) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  const long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  if (size > 0 && std::fread(buf.data(), 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    std::fclose(f);
    return false;
  }
  std::fclose(f);
  buf[static_cast<size_t>(size)] = '\0';
  const char* p = buf.data();
  const char* end = buf.data() + size;
  int64_t vi = 0, ni = 0, fi = 0;
  while (p < end) {
    if (p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
      if (verts) {
        const char* q = p + 2;
        read_float(q, end, verts[3 * vi]);
        read_float(q, end, verts[3 * vi + 1]);
        read_float(q, end, verts[3 * vi + 2]);
      }
      ++vi;
    } else if (p[0] == 'v' && p[1] == 'n' && (p[2] == ' ' || p[2] == '\t')) {
      if (normals) {
        const char* q = p + 3;
        read_float(q, end, normals[3 * ni]);
        read_float(q, end, normals[3 * ni + 1]);
        read_float(q, end, normals[3 * ni + 2]);
      }
      ++ni;
    } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      const char* q = p + 2;
      long idx;
      int64_t arity = 0;
      while (read_face_index(q, end, idx)) {
        if (faces && arity < max_arity) {
          // negative OBJ indices are relative to the vertices seen so far
          faces[fi * max_arity + arity] =
              static_cast<int32_t>(idx > 0 ? idx - 1 : vi + idx);
        }
        ++arity;
      }
      if (arity > s.max_arity) s.max_arity = arity;
      if (faces) {
        for (int64_t k = arity; k < max_arity; ++k)
          faces[fi * max_arity + k] = -1;
      }
      ++fi;
    }
    while (p < end && *p != '\n') ++p;
    ++p;
  }
  s.n_verts = vi;
  s.n_normals = ni;
  s.n_faces = fi;
  return true;
}

}  // namespace

extern "C" {

// Pass 1: sizes.  Returns 1 on success.
int32_t fd_obj_count(const char* path, int64_t* n_verts, int64_t* n_normals,
                     int64_t* n_faces, int64_t* max_arity) {
  ObjScan s;
  if (!scan_obj(path, s, nullptr, nullptr, nullptr, 0)) return 0;
  *n_verts = s.n_verts;
  *n_normals = s.n_normals;
  *n_faces = s.n_faces;
  *max_arity = s.max_arity;
  return 1;
}

// Pass 2: fill pre-sized buffers (faces: n_faces x max_arity, -1 padded).
int32_t fd_obj_parse(const char* path, float* verts, float* normals,
                     int32_t* faces, int64_t max_arity) {
  ObjScan s;
  return scan_obj(path, s, verts, normals, faces, max_arity) ? 1 : 0;
}

// Buffered OBJ writer; faces -1-padded (n_faces x arity), normals nullable.
int32_t fd_obj_write(const char* path, const float* verts, int64_t n_verts,
                     const float* normals, int64_t n_normals,
                     const int32_t* faces, int64_t n_faces, int64_t arity) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 0;
  std::vector<char> buf(1 << 22);
  std::setvbuf(f, buf.data(), _IOFBF, buf.size());
  std::fputs("# facedeform-tpu\n", f);
  for (int64_t i = 0; i < n_verts; ++i)
    std::fprintf(f, "v %.9g %.9g %.9g\n", verts[3 * i], verts[3 * i + 1],
                 verts[3 * i + 2]);
  for (int64_t i = 0; i < n_normals; ++i)
    std::fprintf(f, "vn %.9g %.9g %.9g\n", normals[3 * i], normals[3 * i + 1],
                 normals[3 * i + 2]);
  for (int64_t i = 0; i < n_faces; ++i) {
    std::fputc('f', f);
    for (int64_t k = 0; k < arity; ++k) {
      const int32_t v = faces[i * arity + k];
      if (v < 0) break;
      std::fprintf(f, " %d", v + 1);
    }
    std::fputc('\n', f);
  }
  std::fclose(f);
  return 1;
}

}  // extern "C"
