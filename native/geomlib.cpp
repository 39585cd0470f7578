// geomlib: native mesh pipeline for the model compiler.
//
// STL parsing, vertex dedup, 3D quickhull, and hull mass properties.
// Host-side counterpart of the mesh processing the reference delegates to
// libmujoco's qhull path when loading robot models (reference models under
// model/test/*/stl are consumed via mj_loadXML).  Exposed as a C ABI for
// ctypes; scipy remains the Python fallback when this library isn't built.
//
// Build: make -C native   (produces libgeomlib.so)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <cstdlib>
#include <vector>
#include <array>
#include <unordered_map>
#include <algorithm>

namespace {

struct V3 {
  double x, y, z;
  V3 operator-(const V3 &o) const { return {x - o.x, y - o.y, z - o.z}; }
  V3 operator+(const V3 &o) const { return {x + o.x, y + o.y, z + o.z}; }
  V3 operator*(double s) const { return {x * s, y * s, z * s}; }
};

inline V3 cross(const V3 &a, const V3 &b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline double dot(const V3 &a, const V3 &b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
inline double norm(const V3 &a) { return std::sqrt(dot(a, a)); }

// ---------------------------------------------------------------------------
// Quickhull 3D
// ---------------------------------------------------------------------------

struct Face {
  int v[3];
  V3 normal;          // outward unit-ish normal
  double offset;      // plane offset: dot(normal, p) == offset on the plane
  std::vector<int> outside;
  bool alive = true;
};

struct Hull {
  const std::vector<V3> &pts;
  std::vector<Face> faces;
  double eps;

  explicit Hull(const std::vector<V3> &p) : pts(p) {}

  void face_plane(Face &f) {
    V3 a = pts[f.v[0]], b = pts[f.v[1]], c = pts[f.v[2]];
    V3 n = cross(b - a, c - a);
    double l = norm(n);
    if (l > 1e-300) n = n * (1.0 / l);
    f.normal = n;
    f.offset = dot(n, a);
  }

  double dist(const Face &f, int p) const {
    return dot(f.normal, pts[p]) - f.offset;
  }

  bool build() {
    const int n = (int)pts.size();
    if (n < 4) return false;
    // bbox scale -> epsilon
    V3 lo = pts[0], hi = pts[0];
    for (const V3 &p : pts) {
      lo.x = std::min(lo.x, p.x); lo.y = std::min(lo.y, p.y);
      lo.z = std::min(lo.z, p.z);
      hi.x = std::max(hi.x, p.x); hi.y = std::max(hi.y, p.y);
      hi.z = std::max(hi.z, p.z);
    }
    double scale = std::max({hi.x - lo.x, hi.y - lo.y, hi.z - lo.z, 1e-12});
    eps = 1e-10 * scale;

    // initial simplex: extremes on x, then farthest point pair/plane
    int i0 = 0, i1 = 0;
    for (int i = 1; i < n; i++) {
      if (pts[i].x < pts[i0].x) i0 = i;
      if (pts[i].x > pts[i1].x) i1 = i;
    }
    if (i0 == i1) return false;
    int i2 = -1; double best = eps;
    for (int i = 0; i < n; i++) {
      double d = norm(cross(pts[i1] - pts[i0], pts[i] - pts[i0]));
      if (d > best) { best = d; i2 = i; }
    }
    if (i2 < 0) return false;
    int i3 = -1; best = eps;
    V3 nrm = cross(pts[i1] - pts[i0], pts[i2] - pts[i0]);
    double l = norm(nrm); if (l > 0) nrm = nrm * (1.0 / l);
    double off = dot(nrm, pts[i0]);
    for (int i = 0; i < n; i++) {
      double d = std::fabs(dot(nrm, pts[i]) - off);
      if (d > best) { best = d; i3 = i; }
    }
    if (i3 < 0) return false;
    // orient: i3 below (i0,i1,i2)
    if (dot(nrm, pts[i3]) - off > 0) std::swap(i1, i2);

    auto add_face = [&](int a, int b, int c) {
      Face f; f.v[0] = a; f.v[1] = b; f.v[2] = c;
      face_plane(f);
      faces.push_back(f);
      return (int)faces.size() - 1;
    };
    add_face(i0, i1, i2);
    add_face(i0, i2, i3);
    add_face(i0, i3, i1);
    add_face(i1, i3, i2);

    // assign outside sets
    for (int i = 0; i < n; i++) {
      if (i == i0 || i == i1 || i == i2 || i == i3) continue;
      for (Face &f : faces) {
        if (dist(f, i) > eps) { f.outside.push_back(i); break; }
      }
    }

    // iterate
    for (size_t iter = 0; iter < 16u * (size_t)n + 64u; iter++) {
      int fi = -1;
      for (int k = 0; k < (int)faces.size(); k++)
        if (faces[k].alive && !faces[k].outside.empty()) { fi = k; break; }
      if (fi < 0) break;

      // farthest point of this face
      Face &f = faces[fi];
      int far_p = f.outside[0]; double far_d = dist(f, far_p);
      for (int p : f.outside) {
        double dd = dist(f, p);
        if (dd > far_d) { far_d = dd; far_p = p; }
      }

      // find visible faces (flood from fi) and horizon edges
      std::vector<int> visible;
      std::vector<char> vis(faces.size(), 0);
      std::vector<int> stack = {fi};
      vis[fi] = 1;
      while (!stack.empty()) {
        int k = stack.back(); stack.pop_back();
        visible.push_back(k);
        // neighbors: faces sharing an edge (linear scan; hulls are small)
        for (int m2 = 0; m2 < (int)faces.size(); m2++) {
          if (vis[m2] || !faces[m2].alive) continue;
          int shared = 0;
          for (int a = 0; a < 3; a++)
            for (int b = 0; b < 3; b++)
              if (faces[k].v[a] == faces[m2].v[b]) shared++;
          if (shared >= 2 && dist(faces[m2], far_p) > eps) {
            vis[m2] = 1;
            stack.push_back(m2);
          }
        }
      }
      // horizon: edges of visible faces adjacent to non-visible alive faces
      std::vector<std::pair<int, int>> horizon;
      auto edge_in_nonvisible = [&](int a, int b) {
        for (int m2 = 0; m2 < (int)faces.size(); m2++) {
          if (!faces[m2].alive || vis[m2]) continue;
          int cnt = 0;
          for (int t = 0; t < 3; t++)
            if (faces[m2].v[t] == a || faces[m2].v[t] == b) cnt++;
          if (cnt >= 2) return true;
        }
        return false;
      };
      for (int k : visible) {
        for (int e = 0; e < 3; e++) {
          int a = faces[k].v[e], b = faces[k].v[(e + 1) % 3];
          if (edge_in_nonvisible(a, b)) horizon.push_back({a, b});
        }
      }
      // collect orphaned outside points
      std::vector<int> orphans;
      for (int k : visible) {
        orphans.insert(orphans.end(), faces[k].outside.begin(),
                       faces[k].outside.end());
        faces[k].outside.clear();
        faces[k].alive = false;
      }
      // new cone faces
      std::vector<int> newfaces;
      for (auto &e : horizon) {
        int nf = add_face(e.first, e.second, far_p);
        // ensure outward orientation: hull centroid below
        newfaces.push_back(nf);
      }
      // fix orientation of new faces using interior point
      V3 interior = (pts[i0] + pts[i1] + pts[i2] + pts[i3]) * 0.25;
      for (int nf : newfaces) {
        Face &g = faces[nf];
        if (dot(g.normal, interior) - g.offset > 0) {
          std::swap(g.v[1], g.v[2]);
          face_plane(g);
        }
      }
      // redistribute orphans
      for (int p : orphans) {
        if (p == far_p) continue;
        for (int nf : newfaces) {
          if (dist(faces[nf], p) > eps) {
            faces[nf].outside.push_back(p);
            break;
          }
        }
      }
    }
    return true;
  }
};

std::vector<V3> dedup(const std::vector<V3> &verts) {
  struct Key {
    int64_t a, b, c;
    bool operator==(const Key &o) const {
      return a == o.a && b == o.b && c == o.c;
    }
  };
  struct KeyHash {
    size_t operator()(const Key &k) const {
      return std::hash<int64_t>()(k.a * 73856093 ^ k.b * 19349663 ^
                                  k.c * 83492791);
    }
  };
  std::unordered_map<Key, int, KeyHash> seen;
  std::vector<V3> out;
  for (const V3 &v : verts) {
    Key k{(int64_t)std::llround(v.x * 1e9), (int64_t)std::llround(v.y * 1e9),
          (int64_t)std::llround(v.z * 1e9)};
    if (seen.emplace(k, (int)out.size()).second) out.push_back(v);
  }
  return out;
}

}  // namespace

extern "C" {

// Parse STL (binary or ascii) -> deduplicated vertices.  Returns count or
// negative error; *out malloc'd (x,y,z triples), freed via geomlib_free.
int geomlib_load_stl(const char *path, double **out) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return -1;
  char head[6] = {0};
  if (std::fread(head, 1, 5, f) != 5) { std::fclose(f); return -2; }
  std::vector<V3> verts;
  bool ascii = std::strncmp(head, "solid", 5) == 0;
  if (ascii) {
    // sniff: binary files sometimes start with "solid" too
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::vector<char> buf(std::min<long>(size, 512) + 1, 0);
    size_t got = std::fread(buf.data(), 1, buf.size() - 1, f);
    buf[got] = 0;
    ascii = std::strstr(buf.data(), "facet") != nullptr;
    std::fseek(f, 0, SEEK_SET);
  }
  if (ascii) {
    char line[512];
    while (std::fgets(line, sizeof line, f)) {
      const char *p = line;
      while (*p == ' ' || *p == '\t') p++;
      if (std::strncmp(p, "vertex", 6) == 0) {
        V3 v;
        if (std::sscanf(p + 6, "%lf %lf %lf", &v.x, &v.y, &v.z) == 3)
          verts.push_back(v);
      }
    }
  } else {
    std::fseek(f, 80, SEEK_SET);
    uint32_t ntri = 0;
    if (std::fread(&ntri, 4, 1, f) != 1) { std::fclose(f); return -3; }
    std::vector<uint8_t> rec(50);
    verts.reserve((size_t)ntri * 3);
    for (uint32_t i = 0; i < ntri; i++) {
      if (std::fread(rec.data(), 1, 50, f) != 50) { std::fclose(f); return -4; }
      float v[9];
      std::memcpy(v, rec.data() + 12, 36);
      for (int k = 0; k < 3; k++)
        verts.push_back({(double)v[3 * k], (double)v[3 * k + 1],
                         (double)v[3 * k + 2]});
    }
  }
  std::fclose(f);
  std::vector<V3> uniq = dedup(verts);
  *out = (double *)std::malloc(uniq.size() * 3 * sizeof(double));
  for (size_t i = 0; i < uniq.size(); i++) {
    (*out)[3 * i] = uniq[i].x;
    (*out)[3 * i + 1] = uniq[i].y;
    (*out)[3 * i + 2] = uniq[i].z;
  }
  return (int)uniq.size();
}

// Convex hull of n points.  Outputs hull vertices (remapped) and outward
// faces as index triples into the hull vertex array.
int geomlib_convex_hull(const double *pts, int n, double **hull_verts,
                        int *n_hull, int **faces_out, int *n_faces) {
  std::vector<V3> p(n);
  for (int i = 0; i < n; i++) p[i] = {pts[3 * i], pts[3 * i + 1],
                                      pts[3 * i + 2]};
  Hull h(p);
  if (!h.build()) return -1;
  std::vector<int> remap(n, -1);
  std::vector<V3> hv;
  std::vector<std::array<int, 3>> tris;
  for (const Face &f : h.faces) {
    if (!f.alive) continue;
    std::array<int, 3> tri;
    for (int k = 0; k < 3; k++) {
      int v = f.v[k];
      if (remap[v] < 0) {
        remap[v] = (int)hv.size();
        hv.push_back(p[v]);
      }
      tri[k] = remap[v];
    }
    tris.push_back(tri);
  }
  *n_hull = (int)hv.size();
  *n_faces = (int)tris.size();
  *hull_verts = (double *)std::malloc(hv.size() * 3 * sizeof(double));
  for (size_t i = 0; i < hv.size(); i++) {
    (*hull_verts)[3 * i] = hv[i].x;
    (*hull_verts)[3 * i + 1] = hv[i].y;
    (*hull_verts)[3 * i + 2] = hv[i].z;
  }
  *faces_out = (int *)std::malloc(tris.size() * 3 * sizeof(int));
  for (size_t i = 0; i < tris.size(); i++)
    for (int k = 0; k < 3; k++) (*faces_out)[3 * i + k] = tris[i][k];
  return 0;
}

// Mass properties of a closed oriented triangle surface (unit density).
// out[0]=volume, out[1..3]=com, out[4..12]=inertia about com (row major).
int geomlib_mass_properties(const double *verts, const int *faces,
                            int n_faces, double *out) {
  double vol = 0;
  V3 mom{0, 0, 0};
  for (int i = 0; i < n_faces; i++) {
    V3 a{verts[3 * faces[3 * i]], verts[3 * faces[3 * i] + 1],
         verts[3 * faces[3 * i] + 2]};
    V3 b{verts[3 * faces[3 * i + 1]], verts[3 * faces[3 * i + 1] + 1],
         verts[3 * faces[3 * i + 1] + 2]};
    V3 c{verts[3 * faces[3 * i + 2]], verts[3 * faces[3 * i + 2] + 1],
         verts[3 * faces[3 * i + 2] + 2]};
    double v = dot(a, cross(b, c)) / 6.0;
    vol += v;
    mom = mom + (a + b + c) * (v / 4.0);
  }
  if (std::fabs(vol) < 1e-300) return -1;
  V3 com = mom * (1.0 / vol);
  double C[3][3] = {{0}};
  for (int i = 0; i < n_faces; i++) {
    V3 a{verts[3 * faces[3 * i]], verts[3 * faces[3 * i] + 1],
         verts[3 * faces[3 * i] + 2]};
    V3 b{verts[3 * faces[3 * i + 1]], verts[3 * faces[3 * i + 1] + 1],
         verts[3 * faces[3 * i + 1] + 2]};
    V3 c{verts[3 * faces[3 * i + 2]], verts[3 * faces[3 * i + 2] + 1],
         verts[3 * faces[3 * i + 2] + 2]};
    double v = dot(a, cross(b, c)) / 6.0;
    V3 p[3] = {a - com, b - com, c - com};
    double q[3][3];
    for (int r = 0; r < 3; r++) {
      q[r][0] = (r == 0 ? p[0].x : r == 1 ? p[1].x : p[2].x);
      q[r][1] = (r == 0 ? p[0].y : r == 1 ? p[1].y : p[2].y);
      q[r][2] = (r == 0 ? p[0].z : r == 1 ? p[1].z : p[2].z);
    }
    for (int ii = 0; ii < 3; ii++)
      for (int jj = 0; jj < 3; jj++) {
        double s = 0;
        for (int r = 0; r < 3; r++) s += q[r][ii] * q[r][jj];
        double t = 0;
        for (int r = 0; r < 3; r++)
          for (int r2 = 0; r2 < 3; r2++) t += q[r][ii] * q[r2][jj];
        // integral x_i x_j over tet = v/20 * (sum self + sum all pairs)
        C[ii][jj] += v / 20.0 * (s + t);
      }
  }
  double trace = C[0][0] + C[1][1] + C[2][2];
  out[0] = vol;
  out[1] = com.x; out[2] = com.y; out[3] = com.z;
  for (int ii = 0; ii < 3; ii++)
    for (int jj = 0; jj < 3; jj++)
      out[4 + 3 * ii + jj] = (ii == jj ? trace : 0.0) - C[ii][jj];
  return 0;
}

void geomlib_free(void *p) { std::free(p); }

}  // extern "C"
