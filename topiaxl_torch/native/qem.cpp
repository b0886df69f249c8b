// Quadric-error-metric edge-collapse mesh decimation.
//
// Native runtime component of the extraction pipeline: the reference
// delegates decimation to pymeshlab's C++ quadric collapse
// (utils/meshutils.py:63-116); this is our own implementation, exposed
// through a C ABI and loaded via ctypes (topiaxl_torch/native/__init__.py).
//
// Algorithm: per-vertex 4x4 plane quadrics (Garland–Heckbert), a lazy
// min-heap of candidate collapses keyed by quadric cost with version
// stamps, midpoint/endpoint/optimal placement, and a normal-flip guard.
//
// Build: g++ -O3 -shared -fPIC qem.cpp -o libtopiaxl_native.so

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_set>
#include <vector>

namespace {

struct Quadric {
  double m[10] = {0};  // symmetric 4x4: xx xy xz xw yy yz yw zz zw ww

  void add_plane(double a, double b, double c, double d, double w) {
    m[0] += w * a * a; m[1] += w * a * b; m[2] += w * a * c; m[3] += w * a * d;
    m[4] += w * b * b; m[5] += w * b * c; m[6] += w * b * d;
    m[7] += w * c * c; m[8] += w * c * d;
    m[9] += w * d * d;
  }
  void add(const Quadric& o) {
    for (int i = 0; i < 10; ++i) m[i] += o.m[i];
  }
  double eval(const double p[3]) const {
    double x = p[0], y = p[1], z = p[2];
    return m[0]*x*x + 2*m[1]*x*y + 2*m[2]*x*z + 2*m[3]*x
         + m[4]*y*y + 2*m[5]*y*z + 2*m[6]*y
         + m[7]*z*z + 2*m[8]*z
         + m[9];
  }
  // solve for minimizing point; returns false if near-singular
  bool optimal(double out[3]) const {
    double A[9] = {m[0], m[1], m[2], m[1], m[4], m[5], m[2], m[5], m[7]};
    double b[3] = {-m[3], -m[6], -m[8]};
    double det = A[0]*(A[4]*A[8]-A[5]*A[7]) - A[1]*(A[3]*A[8]-A[5]*A[6])
               + A[2]*(A[3]*A[7]-A[4]*A[6]);
    if (std::fabs(det) < 1e-12) return false;
    double inv = 1.0 / det;
    out[0] = inv * ( b[0]*(A[4]*A[8]-A[5]*A[7]) - A[1]*(b[1]*A[8]-A[5]*b[2])
                   + A[2]*(b[1]*A[7]-A[4]*b[2]));
    out[1] = inv * ( A[0]*(b[1]*A[8]-A[5]*b[2]) - b[0]*(A[3]*A[8]-A[5]*A[6])
                   + A[2]*(A[3]*b[2]-b[1]*A[6]));
    out[2] = inv * ( A[0]*(A[4]*b[2]-b[1]*A[7]) - A[1]*(A[3]*b[2]-b[1]*A[6])
                   + b[0]*(A[3]*A[7]-A[4]*A[6]));
    return true;
  }
};

struct Candidate {
  double cost;
  int v0, v1;
  uint32_t stamp0, stamp1;
  bool operator<(const Candidate& o) const { return cost > o.cost; }  // min-heap
};

struct Vec3 {
  double x, y, z;
};

inline Vec3 sub(const Vec3& a, const Vec3& b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
inline Vec3 cross(const Vec3& a, const Vec3& b) {
  return {a.y*b.z - a.z*b.y, a.z*b.x - a.x*b.z, a.x*b.y - a.y*b.x};
}
inline double dot(const Vec3& a, const Vec3& b) {
  return a.x*b.x + a.y*b.y + a.z*b.z;
}

}  // namespace

extern "C" int qem_decimate(
    const float* verts_in, int64_t nv,
    const int64_t* faces_in, int64_t nf,
    int64_t target_faces,
    float* verts_out, int64_t* nv_out,
    int64_t* faces_out, int64_t* nf_out) {
  std::vector<Vec3> V(nv);
  for (int64_t i = 0; i < nv; ++i)
    V[i] = {verts_in[3*i], verts_in[3*i+1], verts_in[3*i+2]};
  std::vector<std::array<int, 3>> F;
  F.reserve(nf);
  for (int64_t i = 0; i < nf; ++i)
    F.push_back(std::array<int, 3>{(int)faces_in[3*i], (int)faces_in[3*i+1],
                                   (int)faces_in[3*i+2]});

  std::vector<Quadric> Q(nv);
  std::vector<std::vector<int>> vfaces(nv);
  std::vector<char> face_alive(nf, 1);
  int64_t alive = nf;

  auto face_plane = [&](int f, double* abcd) -> bool {
    const auto& t = F[f];
    Vec3 n = cross(sub(V[t[1]], V[t[0]]), sub(V[t[2]], V[t[0]]));
    double len = std::sqrt(dot(n, n));
    if (len < 1e-18) return false;
    abcd[0] = n.x / len; abcd[1] = n.y / len; abcd[2] = n.z / len;
    abcd[3] = -(abcd[0]*V[t[0]].x + abcd[1]*V[t[0]].y + abcd[2]*V[t[0]].z);
    return true;
  };

  for (int64_t f = 0; f < nf; ++f) {
    double p[4];
    if (!face_plane((int)f, p)) { face_alive[f] = 0; --alive; continue; }
    for (int c = 0; c < 3; ++c) {
      Q[F[f][c]].add_plane(p[0], p[1], p[2], p[3], 1.0);
      vfaces[F[f][c]].push_back((int)f);
    }
  }

  std::vector<uint32_t> stamp(nv, 0);
  std::vector<int> remap(nv);
  for (int64_t i = 0; i < nv; ++i) remap[i] = (int)i;
  auto root = [&](int v) {
    while (remap[v] != v) { remap[v] = remap[remap[v]]; v = remap[v]; }
    return v;
  };

  auto best_pos = [&](int a, int b, double* out) {
    Quadric q = Q[a]; q.add(Q[b]);
    double p[3];
    if (q.optimal(p)) {
      // reject wildly distant optima (near-singular systems)
      double mx = std::max({std::fabs(V[a].x), std::fabs(V[a].y),
                            std::fabs(V[a].z), std::fabs(V[b].x),
                            std::fabs(V[b].y), std::fabs(V[b].z), 1.0});
      if (std::fabs(p[0]) < 10*mx && std::fabs(p[1]) < 10*mx &&
          std::fabs(p[2]) < 10*mx) {
        out[0]=p[0]; out[1]=p[1]; out[2]=p[2];
        return q.eval(p);
      }
    }
    double cands[3][3] = {
      {V[a].x, V[a].y, V[a].z},
      {V[b].x, V[b].y, V[b].z},
      {(V[a].x+V[b].x)/2, (V[a].y+V[b].y)/2, (V[a].z+V[b].z)/2}};
    double best = 1e300; int bi = 2;
    for (int i = 0; i < 3; ++i) {
      double c = q.eval(cands[i]);
      if (c < best) { best = c; bi = i; }
    }
    out[0]=cands[bi][0]; out[1]=cands[bi][1]; out[2]=cands[bi][2];
    return best;
  };

  std::priority_queue<Candidate> heap;
  auto push_edge = [&](int a, int b) {
    a = root(a); b = root(b);
    if (a == b) return;
    if (a > b) std::swap(a, b);
    double pos[3];
    double cost = best_pos(a, b, pos);
    heap.push({cost, a, b, stamp[a], stamp[b]});
  };

  {
    std::unordered_set<int64_t> seen;
    seen.reserve(nf * 3);
    for (int64_t f = 0; f < nf; ++f) {
      if (!face_alive[f]) continue;
      for (int c = 0; c < 3; ++c) {
        int a = F[f][c], b = F[f][(c+1)%3];
        if (a > b) std::swap(a, b);
        int64_t key = (int64_t)a * nv + b;
        if (seen.insert(key).second) push_edge(a, b);
      }
    }
  }

  // reusable per-collapse buffers (allocation in the hot loop dominates
  // otherwise)
  std::vector<int> merged;
  merged.reserve(64);
  std::vector<int> neighbors;
  neighbors.reserve(64);
  std::vector<uint32_t> nb_mark(nv, 0);
  uint32_t collapse_id = 0;

  while (alive > target_faces && !heap.empty()) {
    Candidate c = heap.top(); heap.pop();
    int a = root(c.v0), b = root(c.v1);
    if (a == b) continue;
    if (stamp[c.v0] != c.stamp0 || stamp[c.v1] != c.stamp1) continue;

    double pos[3];
    best_pos(a, b, pos);

    // normal-flip guard: moving a or b to pos must not flip any
    // surviving incident face
    bool flip = false;
    for (int v : {a, b}) {
      for (int f : vfaces[v]) {
        if (!face_alive[f]) continue;
        int i0 = root(F[f][0]), i1 = root(F[f][1]), i2 = root(F[f][2]);
        // skip faces that will collapse (contain both a and b)
        bool hasA = (i0==a||i1==a||i2==a), hasB = (i0==b||i1==b||i2==b);
        if (hasA && hasB) continue;
        Vec3 p[3];
        for (int k = 0; k < 3; ++k) {
          int vi = root(F[f][k]);
          p[k] = (vi == a || vi == b) ? Vec3{pos[0], pos[1], pos[2]} : V[vi];
        }
        Vec3 pn[3] = {V[i0], V[i1], V[i2]};
        Vec3 n_old = cross(sub(pn[1], pn[0]), sub(pn[2], pn[0]));
        Vec3 n_new = cross(sub(p[1], p[0]), sub(p[2], p[0]));
        if (dot(n_old, n_new) < 0) { flip = true; break; }
      }
      if (flip) break;
    }
    if (flip) continue;

    // collapse b -> a
    remap[b] = a;
    V[a] = {pos[0], pos[1], pos[2]};
    Q[a].add(Q[b]);
    ++stamp[a]; ++stamp[b];

    // merge face lists; kill degenerate faces; collect neighbor verts
    ++collapse_id;
    merged.clear();
    neighbors.clear();
    for (int v : {a, b}) {
      for (int f : vfaces[v]) {
        if (!face_alive[f]) continue;
        int i0 = root(F[f][0]), i1 = root(F[f][1]), i2 = root(F[f][2]);
        if (i0 == i1 || i1 == i2 || i0 == i2) {
          face_alive[f] = 0; --alive;
          continue;
        }
        merged.push_back(f);
        for (int iv : {i0, i1, i2}) {
          if (iv != a && nb_mark[iv] != collapse_id) {
            nb_mark[iv] = collapse_id;
            neighbors.push_back(iv);
          }
        }
      }
    }
    std::sort(merged.begin(), merged.end());
    merged.erase(std::unique(merged.begin(), merged.end()), merged.end());
    vfaces[a].assign(merged.begin(), merged.end());
    vfaces[b].clear();
    vfaces[b].shrink_to_fit();

    for (int nb : neighbors) push_edge(a, nb);
  }

  // compact output
  std::vector<int> new_id(nv, -1);
  int64_t vcount = 0, fcount = 0;
  for (int64_t f = 0; f < nf; ++f) {
    if (!face_alive[f]) continue;
    int i0 = root(F[f][0]), i1 = root(F[f][1]), i2 = root(F[f][2]);
    if (i0 == i1 || i1 == i2 || i0 == i2) continue;
    int ids[3] = {i0, i1, i2};
    for (int k = 0; k < 3; ++k) {
      if (new_id[ids[k]] < 0) {
        new_id[ids[k]] = (int)vcount;
        verts_out[3*vcount] = (float)V[ids[k]].x;
        verts_out[3*vcount+1] = (float)V[ids[k]].y;
        verts_out[3*vcount+2] = (float)V[ids[k]].z;
        ++vcount;
      }
      faces_out[3*fcount + k] = new_id[ids[k]];
    }
    ++fcount;
  }
  *nv_out = vcount;
  *nf_out = fcount;
  return 0;
}
