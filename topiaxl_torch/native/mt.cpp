// Marching-tetrahedra isosurface extraction (C ABI, single pass).
//
// Native backend for topiaxl_torch/extract/isosurface.py — same algorithm as
// the vectorized numpy implementation (6-tet cube split, edge-key vertex
// welding, gradient-oriented winding) but ~20x faster on the single-core
// hosts the pipeline runs on. The numpy path remains the fallback and
// the executable spec.
//
// Build: part of libtopiaxl_native.so (see topiaxl_torch/native/__init__.py).

#include <cmath>
#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {

// 6 tetrahedra sharing the 0->7 diagonal; corners numbered i*4+j*2+k
const int TETS[6][4] = {
    {0, 5, 1, 7}, {0, 1, 3, 7}, {0, 3, 2, 7},
    {0, 2, 6, 7}, {0, 6, 4, 7}, {0, 4, 5, 7},
};

struct Builder {
  const float* g;
  int64_t R0, R1, R2;
  float iso;
  std::unordered_map<uint64_t, int64_t> vert_ids;
  std::vector<float> verts;      // index-coordinate xyz
  std::vector<int64_t> faces;

  inline float val(int64_t id) const { return g[id]; }

  int64_t edge_vertex(int64_t ia, int64_t ib) {
    float va = val(ia), vb = val(ib);
    if (ia > ib) { std::swap(ia, ib); std::swap(va, vb); }
    uint64_t key = (uint64_t)ia * (uint64_t)(R0 * R1 * R2) + (uint64_t)ib;
    auto it = vert_ids.find(key);
    if (it != vert_ids.end()) return it->second;
    float denom = vb - va;
    float t = std::fabs(denom) > 1e-12f ? (iso - va) / denom : 0.5f;
    t = t < 0.f ? 0.f : (t > 1.f ? 1.f : t);
    int64_t ai = ia / (R1 * R2), aj = (ia / R2) % R1, ak = ia % R2;
    int64_t bi = ib / (R1 * R2), bj = (ib / R2) % R1, bk = ib % R2;
    int64_t id = (int64_t)(verts.size() / 3);
    verts.push_back(ai + t * (bi - ai));
    verts.push_back(aj + t * (bj - aj));
    verts.push_back(ak + t * (bk - ak));
    vert_ids.emplace(key, id);
    return id;
  }

  void tri(int64_t a, int64_t b, int64_t c) {
    if (a == b || b == c || a == c) return;
    faces.push_back(a); faces.push_back(b); faces.push_back(c);
  }
};

}  // namespace

extern "C" int mt_extract(
    const float* grid, int64_t R0, int64_t R1, int64_t R2, float iso,
    float* out_v, int64_t cap_v,
    int64_t* out_f, int64_t cap_f,
    int64_t* nv_out, int64_t* nf_out) {
  Builder B;
  B.g = grid; B.R0 = R0; B.R1 = R1; B.R2 = R2; B.iso = iso;

  int64_t corner_off[8];
  for (int c = 0; c < 8; ++c) {
    int di = (c >> 2) & 1, dj = (c >> 1) & 1, dk = c & 1;
    corner_off[c] = (int64_t)di * R1 * R2 + (int64_t)dj * R2 + dk;
  }

  for (int64_t i = 0; i + 1 < R0; ++i) {
    for (int64_t j = 0; j + 1 < R1; ++j) {
      const float* row = grid + (i * R1 + j) * R2;
      const float* rows[4] = {
          row, row + R2, row + R1 * R2, row + R1 * R2 + R2};
      for (int64_t k = 0; k + 1 < R2; ++k) {
        // quick reject: all 8 corners same side
        bool any_in = false, any_out = false;
        for (int r = 0; r < 4 && !(any_in && any_out); ++r) {
          for (int d = 0; d < 2; ++d) {
            (rows[r][k + d] < iso ? any_in : any_out) = true;
          }
        }
        if (!any_in || !any_out) continue;

        int64_t base = (i * R1 + j) * R2 + k;
        int64_t cid[8];
        float cv[8];
        bool cin[8];
        for (int c = 0; c < 8; ++c) {
          cid[c] = base + corner_off[c];
          cv[c] = grid[cid[c]];
          cin[c] = cv[c] < iso;
        }

        for (int t = 0; t < 6; ++t) {
          const int* T = TETS[t];
          int in_slots[4], out_slots[4];
          int n_in = 0, n_out = 0;
          for (int s = 0; s < 4; ++s) {
            if (cin[T[s]]) in_slots[n_in++] = s;
            else out_slots[n_out++] = s;
          }
          if (n_in == 0 || n_in == 4) continue;

          auto gid = [&](int slot) { return cid[T[slot]]; };

          if (n_in == 1 || n_in == 3) {
            int lone = (n_in == 1) ? in_slots[0] : out_slots[0];
            int others[3], m = 0;
            for (int s = 0; s < 4; ++s) if (s != lone) others[m++] = s;
            int64_t e0 = B.edge_vertex(gid(lone), gid(others[0]));
            int64_t e1 = B.edge_vertex(gid(lone), gid(others[1]));
            int64_t e2 = B.edge_vertex(gid(lone), gid(others[2]));
            B.tri(e0, e1, e2);
          } else {  // 2 vs 2
            int a = in_slots[0], b = in_slots[1];
            int c = out_slots[0], d = out_slots[1];
            int64_t kac = B.edge_vertex(gid(a), gid(c));
            int64_t kad = B.edge_vertex(gid(a), gid(d));
            int64_t kbc = B.edge_vertex(gid(b), gid(c));
            int64_t kbd = B.edge_vertex(gid(b), gid(d));
            B.tri(kac, kad, kbd);
            B.tri(kac, kbd, kbc);
          }
        }
      }
    }
  }

  int64_t nv = (int64_t)(B.verts.size() / 3);
  int64_t nf = (int64_t)(B.faces.size() / 3);
  if (nv > cap_v || nf > cap_f) {
    *nv_out = nv; *nf_out = nf;
    return 1;  // caller retries with bigger buffers
  }

  // orient: normal toward increasing field (central differences at the
  // rounded centroid)
  for (int64_t f = 0; f < nf; ++f) {
    int64_t* F = &B.faces[3 * f];
    const float* v0 = &B.verts[3 * F[0]];
    const float* v1 = &B.verts[3 * F[1]];
    const float* v2 = &B.verts[3 * F[2]];
    float e1[3] = {v1[0] - v0[0], v1[1] - v0[1], v1[2] - v0[2]};
    float e2[3] = {v2[0] - v0[0], v2[1] - v0[1], v2[2] - v0[2]};
    float n[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                  e1[2] * e2[0] - e1[0] * e2[2],
                  e1[0] * e2[1] - e1[1] * e2[0]};
    auto clampi = [](int64_t x, int64_t lo, int64_t hi) {
      return x < lo ? lo : (x > hi ? hi : x);
    };
    int64_t ci = clampi((int64_t)std::lround((v0[0] + v1[0] + v2[0]) / 3.f), 1, R0 - 2);
    int64_t cj = clampi((int64_t)std::lround((v0[1] + v1[1] + v2[1]) / 3.f), 1, R1 - 2);
    int64_t ck = clampi((int64_t)std::lround((v0[2] + v1[2] + v2[2]) / 3.f), 1, R2 - 2);
    auto at = [&](int64_t a, int64_t b, int64_t c) {
      return grid[(a * R1 + b) * R2 + c];
    };
    float gx = at(ci + 1, cj, ck) - at(ci - 1, cj, ck);
    float gy = at(ci, cj + 1, ck) - at(ci, cj - 1, ck);
    float gz = at(ci, cj, ck + 1) - at(ci, cj, ck - 1);
    if (n[0] * gx + n[1] * gy + n[2] * gz < 0) std::swap(F[1], F[2]);
  }

  for (int64_t i = 0; i < nv * 3; ++i) out_v[i] = B.verts[i];
  for (int64_t i = 0; i < nf * 3; ++i) out_f[i] = B.faces[i];
  *nv_out = nv; *nf_out = nf;
  return 0;
}
