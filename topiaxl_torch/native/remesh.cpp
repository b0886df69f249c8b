// Isotropic explicit remeshing (reference: pymeshlab's
// meshing_isotropic_explicit_remeshing used inside utils/meshutils.py
// decimate_mesh/clean_mesh when remesh=True). Classic Botsch-Kobbelt
// loop: per iteration, (1) split edges longer than 4/3 L, (2) collapse
// edges shorter than 4/5 L under a link-condition guard, (3) flip edges
// toward valence 6, (4) tangential Laplacian smoothing. Target edge
// length L is a parameter (callers derive it from the bbox diagonal).
//
// Exposed via ctypes as isotropic_remesh with the usual capacity
// contract (rc=1 + required sizes when the output buffers are small).

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

using V3 = std::array<double, 3>;
using Tri = std::array<int64_t, 3>;

inline V3 sub(const V3 &a, const V3 &b) {
  return {a[0] - b[0], a[1] - b[1], a[2] - b[2]};
}
inline V3 add(const V3 &a, const V3 &b) {
  return {a[0] + b[0], a[1] + b[1], a[2] + b[2]};
}
inline V3 mul(const V3 &a, double s) { return {a[0] * s, a[1] * s, a[2] * s}; }
inline double dot(const V3 &a, const V3 &b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}
inline V3 cross(const V3 &a, const V3 &b) {
  return {a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
          a[0] * b[1] - a[1] * b[0]};
}
inline double len(const V3 &a) { return std::sqrt(dot(a, a)); }

struct Mesh {
  std::vector<V3> v;
  std::vector<Tri> f;
  std::vector<bool> vdead;
  std::vector<bool> fdead;

  V3 face_normal(const Tri &t) const {
    return cross(sub(v[t[1]], v[t[0]]), sub(v[t[2]], v[t[0]]));
  }

  void compact() {
    std::vector<int64_t> remap(v.size(), -1);
    std::vector<V3> nv;
    nv.reserve(v.size());
    std::vector<Tri> nf;
    nf.reserve(f.size());
    for (const auto &t : f) {
      if (fdead[&t - &f[0]]) continue;
      Tri out;
      bool ok = true;
      for (int c = 0; c < 3; ++c) {
        int64_t vi = t[c];
        if (vdead[vi]) { ok = false; break; }
        if (remap[vi] < 0) {
          remap[vi] = (int64_t)nv.size();
          nv.push_back(v[vi]);
        }
        out[c] = remap[vi];
      }
      if (ok && out[0] != out[1] && out[1] != out[2] && out[0] != out[2])
        nf.push_back(out);
    }
    v.swap(nv);
    f.swap(nf);
    vdead.assign(v.size(), false);
    fdead.assign(f.size(), false);
  }
};

inline uint64_t ekey(int64_t a, int64_t b) {
  if (a > b) std::swap(a, b);
  return (uint64_t)a << 32 | (uint64_t)b;
}

// 1-ring vertex adjacency from live faces
std::vector<std::vector<int64_t>> vertex_ring(const Mesh &m) {
  std::vector<std::vector<int64_t>> ring(m.v.size());
  for (size_t i = 0; i < m.f.size(); ++i) {
    if (m.fdead[i]) continue;
    const Tri &t = m.f[i];
    for (int c = 0; c < 3; ++c) {
      ring[t[c]].push_back(t[(c + 1) % 3]);
      ring[t[c]].push_back(t[(c + 2) % 3]);
    }
  }
  for (auto &r : ring) {
    std::sort(r.begin(), r.end());
    r.erase(std::unique(r.begin(), r.end()), r.end());
  }
  return ring;
}

void split_long(Mesh &m, double L) {
  double hi = 4.0 / 3.0 * L;
  double hi2 = hi * hi;
  std::unordered_map<uint64_t, int64_t> mid;  // edge -> midpoint vertex
  size_t nf0 = m.f.size();
  for (size_t i = 0; i < nf0; ++i) {
    if (m.fdead[i]) continue;
    Tri t = m.f[i];
    int64_t mids[3];
    int nsplit = 0;
    for (int c = 0; c < 3; ++c) {
      int64_t a = t[c], b = t[(c + 1) % 3];
      V3 d = sub(m.v[a], m.v[b]);
      if (dot(d, d) > hi2) {
        uint64_t k = ekey(a, b);
        auto it = mid.find(k);
        if (it == mid.end()) {
          m.v.push_back(mul(add(m.v[a], m.v[b]), 0.5));
          m.vdead.push_back(false);
          it = mid.emplace(k, (int64_t)m.v.size() - 1).first;
        }
        mids[c] = it->second;
        ++nsplit;
      } else {
        mids[c] = -1;
      }
    }
    if (!nsplit) continue;
    m.fdead[i] = true;
    int64_t a = t[0], b = t[1], c = t[2];
    int64_t mab = mids[0], mbc = mids[1], mca = mids[2];
    auto emit = [&](int64_t x, int64_t y, int64_t z) {
      m.f.push_back({x, y, z});
      m.fdead.push_back(false);
    };
    if (nsplit == 3) {
      emit(a, mab, mca); emit(b, mbc, mab); emit(c, mca, mbc);
      emit(mab, mbc, mca);
    } else if (nsplit == 2) {
      // rotate so the unsplit edge is (c, a)
      while (mids[2] != -1) {
        int64_t ta = t[0];
        t = {t[1], t[2], ta};
        int64_t m0 = mids[0];
        mids[0] = mids[1]; mids[1] = mids[2]; mids[2] = m0;
      }
      a = t[0]; b = t[1]; c = t[2]; mab = mids[0]; mbc = mids[1];
      emit(a, mab, c); emit(mab, mbc, c); emit(mab, b, mbc);
    } else {
      while (mids[0] == -1) {
        int64_t ta = t[0];
        t = {t[1], t[2], ta};
        int64_t m0 = mids[0];
        mids[0] = mids[1]; mids[1] = mids[2]; mids[2] = m0;
      }
      a = t[0]; b = t[1]; c = t[2]; mab = mids[0];
      emit(a, mab, c); emit(mab, b, c);
    }
  }
}

void collapse_short(Mesh &m, double L) {
  double lo = 4.0 / 5.0 * L, hi = 4.0 / 3.0 * L;
  double lo2 = lo * lo;
  auto ring = vertex_ring(m);
  // vertex -> incident live faces
  std::vector<std::vector<int64_t>> vf(m.v.size());
  for (size_t i = 0; i < m.f.size(); ++i) {
    if (m.fdead[i]) continue;
    for (int c = 0; c < 3; ++c) vf[m.f[i][c]].push_back((int64_t)i);
  }
  std::vector<bool> locked(m.v.size(), false);
  for (size_t i = 0; i < m.f.size(); ++i) {
    if (m.fdead[i]) continue;
    for (int c = 0; c < 3; ++c) {
      int64_t a = m.f[i][c], b = m.f[i][(c + 1) % 3];
      if (locked[a] || locked[b] || m.vdead[a] || m.vdead[b] || a == b)
        continue;
      V3 d = sub(m.v[a], m.v[b]);
      if (dot(d, d) >= lo2) continue;
      // link condition: common ring of a and b must be exactly the two
      // opposite vertices (interior edge)
      int common = 0;
      for (int64_t x : ring[a]) {
        if (x == b) continue;
        for (int64_t y : ring[b])
          if (x == y) { ++common; break; }
      }
      if (common != 2) continue;
      // target position: midpoint; reject if any surviving edge from the
      // merged vertex would exceed the split threshold (oscillation guard)
      V3 p = mul(add(m.v[a], m.v[b]), 0.5);
      bool ok = true;
      for (int64_t x : ring[a])
        if (x != b && len(sub(p, m.v[x])) > hi) { ok = false; break; }
      for (int64_t x : ring[b])
        if (ok && x != a && len(sub(p, m.v[x])) > hi) { ok = false; break; }
      if (!ok) continue;
      // collapse b into a
      m.v[a] = p;
      m.vdead[b] = true;
      for (int64_t fi : vf[b]) {
        if (m.fdead[fi]) continue;
        Tri &t = m.f[fi];
        bool hasA = (t[0] == a || t[1] == a || t[2] == a);
        for (int k = 0; k < 3; ++k)
          if (t[k] == b) t[k] = a;
        if (hasA || t[0] == t[1] || t[1] == t[2] || t[0] == t[2])
          m.fdead[fi] = true;
        else
          vf[a].push_back(fi);
      }
      // freeze the neighborhood for this pass
      locked[a] = true;
      for (int64_t x : ring[a]) locked[x] = true;
      for (int64_t x : ring[b]) locked[x] = true;
      break;  // this face's edges are stale now
    }
  }
}

void flip_for_valence(Mesh &m) {
  std::vector<int> val(m.v.size(), 0);
  std::unordered_map<uint64_t, std::array<int64_t, 2>> e2f;
  e2f.reserve(m.f.size() * 2);
  for (size_t i = 0; i < m.f.size(); ++i) {
    if (m.fdead[i]) continue;
    const Tri &t = m.f[i];
    for (int c = 0; c < 3; ++c) {
      ++val[t[c]];
      auto it = e2f.find(ekey(t[c], t[(c + 1) % 3]));
      if (it == e2f.end())
        it = e2f.emplace(ekey(t[c], t[(c + 1) % 3]),
                         std::array<int64_t, 2>{-1, -1}).first;
      auto &slot = it->second;
      if (slot[0] < 0) slot[0] = (int64_t)i;
      else slot[1] = (int64_t)i;
    }
  }
  std::unordered_set<uint64_t> existing;
  existing.reserve(e2f.size());
  for (auto &kv : e2f) existing.insert(kv.first);

  auto dev = [&](int64_t vtx, int d) { return std::abs(val[vtx] + d - 6); };
  for (auto &kv : e2f) {
    auto [f0, f1] = kv.second;
    if (f0 < 0 || f1 < 0) continue;
    if (m.fdead[f0] || m.fdead[f1]) continue;
    int64_t a = (int64_t)(kv.first >> 32), b = (int64_t)(kv.first & 0xffffffff);
    // an earlier flip this pass may have rewritten f0/f1 so they no
    // longer contain (a, b) — flipping through a stale reference tears
    // the surface
    auto still_has = [&](int64_t fi) {
      int hit = 0;
      for (int c = 0; c < 3; ++c)
        if (m.f[fi][c] == a || m.f[fi][c] == b) ++hit;
      return hit == 2;
    };
    if (!still_has(f0) || !still_has(f1)) continue;
    auto opposite = [&](int64_t fi) -> int64_t {
      for (int c = 0; c < 3; ++c) {
        int64_t x = m.f[fi][c];
        if (x != a && x != b) return x;
      }
      return -1;
    };
    int64_t c0 = opposite(f0), c1 = opposite(f1);
    if (c0 < 0 || c1 < 0 || c0 == c1) continue;
    if (existing.count(ekey(c0, c1))) continue;  // flip would duplicate
    int before = std::abs(val[a] - 6) + std::abs(val[b] - 6)
               + std::abs(val[c0] - 6) + std::abs(val[c1] - 6);
    int after = dev(a, -1) + dev(b, -1) + dev(c0, 1) + dev(c1, 1);
    if (after >= before) continue;
    // geometric guard: keep both new faces on the old orientation side
    V3 n_old = add(m.face_normal(m.f[f0]), m.face_normal(m.f[f1]));
    Tri t0, t1;
    // preserve winding: f0 contains (a, b) in some order
    bool ab = false;
    for (int c = 0; c < 3; ++c)
      if (m.f[f0][c] == a && m.f[f0][(c + 1) % 3] == b) ab = true;
    if (ab) { t0 = {a, c1, c0}; t1 = {b, c0, c1}; }
    else    { t0 = {a, c0, c1}; t1 = {b, c1, c0}; }
    V3 n0 = m.face_normal(t0), n1 = m.face_normal(t1);
    if (dot(n0, n_old) <= 0 || dot(n1, n_old) <= 0) continue;
    m.f[f0] = t0;
    m.f[f1] = t1;
    --val[a]; --val[b]; ++val[c0]; ++val[c1];
    existing.erase(kv.first);
    existing.insert(ekey(c0, c1));
  }
}

void smooth_tangential(Mesh &m, double lambda) {
  std::vector<V3> nrm(m.v.size(), {0, 0, 0});
  std::vector<V3> cen(m.v.size(), {0, 0, 0});
  std::vector<int> cnt(m.v.size(), 0);
  for (size_t i = 0; i < m.f.size(); ++i) {
    if (m.fdead[i]) continue;
    const Tri &t = m.f[i];
    V3 fn = m.face_normal(t);
    for (int c = 0; c < 3; ++c) {
      nrm[t[c]] = add(nrm[t[c]], fn);
      cen[t[c]] = add(cen[t[c]], m.v[t[(c + 1) % 3]]);
      cen[t[c]] = add(cen[t[c]], m.v[t[(c + 2) % 3]]);
      cnt[t[c]] += 2;
    }
  }
  for (size_t i = 0; i < m.v.size(); ++i) {
    if (m.vdead[i] || !cnt[i]) continue;
    V3 g = sub(mul(cen[i], 1.0 / cnt[i]), m.v[i]);
    double nl = len(nrm[i]);
    if (nl > 1e-20) {
      V3 n = mul(nrm[i], 1.0 / nl);
      g = sub(g, mul(n, dot(g, n)));  // tangential component only
    }
    m.v[i] = add(m.v[i], mul(g, lambda));
  }
}

}  // namespace

extern "C" int isotropic_remesh(
    const float *verts, int64_t nv, const int64_t *faces, int64_t nf,
    float target_len, int64_t iterations,
    float *out_v, int64_t cap_v, int64_t *out_f, int64_t cap_f,
    int64_t *nv_out, int64_t *nf_out) {
  Mesh m;
  m.v.resize(nv);
  for (int64_t i = 0; i < nv; ++i)
    m.v[i] = {verts[i * 3], verts[i * 3 + 1], verts[i * 3 + 2]};
  m.f.resize(nf);
  for (int64_t i = 0; i < nf; ++i)
    m.f[i] = {faces[i * 3], faces[i * 3 + 1], faces[i * 3 + 2]};
  m.vdead.assign(nv, false);
  m.fdead.assign(nf, false);

  double L = target_len;
  for (int64_t it = 0; it < iterations; ++it) {
    split_long(m, L);
    m.compact();
    collapse_short(m, L);
    m.compact();
    flip_for_valence(m);
    smooth_tangential(m, 0.5);
  }
  m.compact();

  *nv_out = (int64_t)m.v.size();
  *nf_out = (int64_t)m.f.size();
  if ((int64_t)m.v.size() > cap_v || (int64_t)m.f.size() > cap_f) return 1;
  for (size_t i = 0; i < m.v.size(); ++i)
    for (int c = 0; c < 3; ++c) out_v[i * 3 + c] = (float)m.v[i][c];
  for (size_t i = 0; i < m.f.size(); ++i)
    for (int c = 0; c < 3; ++c) out_f[i * 3 + c] = m.f[i][c];
  return 0;
}
