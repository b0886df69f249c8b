// Marching cubes isosurface extraction (classic Lorensen-style cell
// triangulation; reference uses PyMCubes at inference.py:119). The
// 256-entry case table is GENERATED at init from first principles:
// for each corner-sign configuration we trace the closed loops of
// edge crossings over the cube's faces and fan-triangulate each loop.
// Ambiguous faces (two diagonal inside corners) are resolved by a fixed
// rule — pair the crossings that share an inside corner — which depends
// only on the face's corner signs, so the two cells sharing a face
// always agree and the global surface is watertight.
//
// Vertices are welded exactly across cells via global edge ids
// (3 * voxel_index + axis), so the output needs no post-weld pass.
//
// Exposed via ctypes as mc_extract (same capacity-negotiation contract
// as mt_extract in mt.cpp).

#include <array>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Edge {
  int c0, c1;  // corner ids (bit2=i, bit1=j, bit0=k)
  int axis;    // 0=i, 1=j, 2=k (the axis along which the edge runs)
};

// corner c -> lattice offset
inline int ci(int c) { return (c >> 2) & 1; }
inline int cj(int c) { return (c >> 1) & 1; }
inline int ck(int c) { return c & 1; }

struct Tables {
  std::array<Edge, 12> edges;
  // per config: triangles as triples of edge ids
  std::array<std::vector<std::array<int, 3>>, 256> tris;
  // per edge id: owning-voxel offset (di,dj,dk) + axis for the global id
  std::array<std::array<int, 4>, 12> edge_key;
};

Tables build_tables() {
  Tables T;
  // --- enumerate the 12 edges -------------------------------------------
  int ne = 0;
  const int axis_bit[3] = {4, 2, 1};  // i, j, k
  for (int c = 0; c < 8; ++c)
    for (int a = 0; a < 3; ++a)
      if (!(c & axis_bit[a])) {
        T.edges[ne] = {c, c | axis_bit[a], a};
        T.edge_key[ne] = {ci(c), cj(c), ck(c), a};
        ++ne;
      }

  // --- the 6 faces: fixed coordinate (axis, value) -----------------------
  // face -> list of edge ids lying in that face
  std::array<std::vector<int>, 6> face_edges;
  auto on_face = [&](int corner, int f) {
    int a = f >> 1, v = f & 1;
    int coord = a == 0 ? ci(corner) : a == 1 ? cj(corner) : ck(corner);
    return coord == v;
  };
  for (int f = 0; f < 6; ++f)
    for (int e = 0; e < 12; ++e)
      if (on_face(T.edges[e].c0, f) && on_face(T.edges[e].c1, f))
        face_edges[f].push_back(e);

  // the two faces adjacent to each edge
  std::array<std::array<int, 2>, 12> edge_faces;
  for (int e = 0; e < 12; ++e) {
    int n = 0;
    for (int f = 0; f < 6; ++f)
      for (int fe : face_edges[f])
        if (fe == e) edge_faces[e][n++] = f;
  }

  // --- per config: trace crossing loops ---------------------------------
  for (int cfg = 1; cfg < 255; ++cfg) {
    auto inside = [&](int c) { return (cfg >> c) & 1; };
    bool cut[12];
    for (int e = 0; e < 12; ++e)
      cut[e] = inside(T.edges[e].c0) != inside(T.edges[e].c1);

    // partner of a cut edge on a given face: the cut edge it connects to.
    // 2 crossings on the face -> each other; 4 crossings (ambiguous) ->
    // the one sharing the same INSIDE corner (separates inside corners).
    auto partner_on_face = [&](int e, int f) -> int {
      int cuts[4], n = 0;
      for (int fe : face_edges[f])
        if (cut[fe]) cuts[n++] = fe;
      if (n == 2) return cuts[0] == e ? cuts[1] : cuts[0];
      // n == 4: find the edge sharing e's inside endpoint
      int ein = inside(T.edges[e].c0) ? T.edges[e].c0 : T.edges[e].c1;
      for (int q = 0; q < n; ++q) {
        if (cuts[q] == e) continue;
        int qin = inside(T.edges[cuts[q]].c0) ? T.edges[cuts[q]].c0
                                              : T.edges[cuts[q]].c1;
        if (qin == ein) return cuts[q];
      }
      return -1;  // unreachable for valid configs
    };

    bool used[12] = {};
    for (int e0 = 0; e0 < 12; ++e0) {
      if (!cut[e0] || used[e0]) continue;
      // walk the loop: from each edge, leave via the face we did not
      // arrive through
      std::vector<int> loop;
      int e = e0, f = edge_faces[e0][0];
      do {
        loop.push_back(e);
        used[e] = true;
        int nxt = partner_on_face(e, f);
        // next face: the other face of nxt
        f = edge_faces[nxt][0] == f ? edge_faces[nxt][1]
                                    : edge_faces[nxt][0];
        e = nxt;
      } while (e != e0);

      // orient: Newell normal of the midpoint polygon must point from
      // inside (value < iso) toward outside
      auto mid = [&](int eid, double p[3]) {
        const Edge &E = T.edges[eid];
        p[0] = 0.5 * (ci(E.c0) + ci(E.c1));
        p[1] = 0.5 * (cj(E.c0) + cj(E.c1));
        p[2] = 0.5 * (ck(E.c0) + ck(E.c1));
      };
      double N[3] = {0, 0, 0};
      size_t n = loop.size();
      for (size_t t = 0; t < n; ++t) {
        double a[3], b[3];
        mid(loop[t], a);
        mid(loop[(t + 1) % n], b);
        N[0] += (a[1] - b[1]) * (a[2] + b[2]);
        N[1] += (a[2] - b[2]) * (a[0] + b[0]);
        N[2] += (a[0] - b[0]) * (a[1] + b[1]);
      }
      double D[3] = {0, 0, 0};  // mean inside->outside direction
      for (int eid : loop) {
        const Edge &E = T.edges[eid];
        int in = inside(E.c0) ? E.c0 : E.c1;
        int out = in == E.c0 ? E.c1 : E.c0;
        D[0] += ci(out) - ci(in);
        D[1] += cj(out) - cj(in);
        D[2] += ck(out) - ck(in);
      }
      if (N[0] * D[0] + N[1] * D[1] + N[2] * D[2] < 0) {
        for (size_t t = 1; t < (n + 1) / 2; ++t) std::swap(loop[t], loop[n - t]);
      }
      for (size_t t = 1; t + 1 < n; ++t)
        T.tris[cfg].push_back({loop[0], loop[t], loop[t + 1]});
    }
  }
  return T;
}

const Tables &tables() {
  static Tables T = build_tables();
  return T;
}

}  // namespace

extern "C" int mc_extract(
    const float *grid, int64_t R0, int64_t R1, int64_t R2, float iso,
    float *out_v, int64_t cap_v, int64_t *out_f, int64_t cap_f,
    int64_t *nv_out, int64_t *nf_out) {
  const Tables &T = tables();
  const int64_t sI = R1 * R2, sJ = R2;

  std::unordered_map<int64_t, int64_t> vert_of_edge;
  vert_of_edge.reserve(1 << 16);
  int64_t nv = 0, nf = 0;
  bool overflow = false;

  for (int64_t i = 0; i + 1 < R0; ++i) {
    for (int64_t j = 0; j + 1 < R1; ++j) {
      const float *p00 = grid + i * sI + j * sJ;
      const float *p01 = p00 + sJ;
      const float *p10 = p00 + sI;
      const float *p11 = p10 + sJ;
      // corner value pointers indexed by corner id (bit2=i, bit1=j, bit0=k)
      const float *cp[8] = {p00, p00 + 1, p01, p01 + 1,
                            p10, p10 + 1, p11, p11 + 1};
      // note: corner c = (di<<2)|(dj<<1)|dk reads cp[c][k] where the +1
      // for dk is folded into the pointer
      for (int64_t k = 0; k + 1 < R2; ++k) {
        int cfg = 0;
        for (int c = 0; c < 8; ++c) cfg |= (cp[c][k] < iso) << c;
        if (cfg == 0 || cfg == 255) continue;
        const auto &tris = T.tris[cfg];
        for (const auto &tri : tris) {
          int64_t vid[3];
          for (int t = 0; t < 3; ++t) {
            int e = tri[t];
            const auto &kk = T.edge_key[e];
            int64_t vox = (i + kk[0]) * sI + (j + kk[1]) * sJ + (k + kk[2]);
            int64_t key = vox * 3 + kk[3];
            auto it = vert_of_edge.find(key);
            if (it != vert_of_edge.end()) {
              vid[t] = it->second;
            } else {
              const Edge &E = T.edges[e];
              float v0 = cp[E.c0][k], v1 = cp[E.c1][k];
              float d = v1 - v0;
              float tt = (d > 1e-12f || d < -1e-12f) ? (iso - v0) / d : 0.5f;
              tt = tt < 0.f ? 0.f : (tt > 1.f ? 1.f : tt);
              float px = float(i + ci(E.c0)), py = float(j + cj(E.c0)),
                    pz = float(k + ck(E.c0));
              if (E.axis == 0) px += tt;
              else if (E.axis == 1) py += tt;
              else pz += tt;
              if (nv < cap_v) {
                out_v[nv * 3 + 0] = px;
                out_v[nv * 3 + 1] = py;
                out_v[nv * 3 + 2] = pz;
              } else {
                overflow = true;
              }
              vid[t] = nv;
              vert_of_edge.emplace(key, nv);
              ++nv;
            }
          }
          if (vid[0] == vid[1] || vid[1] == vid[2] || vid[0] == vid[2])
            continue;  // degenerate (crossing at a corner)
          if (nf < cap_f) {
            out_f[nf * 3 + 0] = vid[0];
            out_f[nf * 3 + 1] = vid[1];
            out_f[nf * 3 + 2] = vid[2];
          } else {
            overflow = true;
          }
          ++nf;
        }
      }
    }
  }
  *nv_out = nv;
  *nf_out = nf;
  return overflow ? 1 : 0;
}
