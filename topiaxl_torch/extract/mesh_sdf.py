"""Signed distance and surface samples of a triangle mesh (counterpart of
``topiaxl/extract/mesh_sdf.py``).

PrimX fitting (``pipelines/fit.py``) needs a target SDF callable. The
unsigned distance is the closest-point test of every point of a chunk
against every face at once (dense [chunk, F]) on the device. The sign is
that of the offset from the closest point along the normal of the face
that attains the minimum (the argmin face), as the JAX package signs it;
its module docstring names the angle-weighted pseudonormal test, which
neither package runs. Near a shared edge or vertex the argmin face is a
tie that floating-point order can break either way (XLA against PyTorch,
CPU against card), and a concave mesh's sign can then flip there; on a
convex mesh every face of the tie gives the same sign.

Memory: each [chunk, F, 3] intermediate is materialised (XLA fuses them):
at chunk 2048 and 20k faces one of them is 0.5 GB.
"""

from __future__ import annotations

import numpy as np
import torch


def _safe(d):
    return torch.where(d.abs() < 1e-30, 1e-30, d)


def _closest_point_on_tri(p, a, b, c):
    """Closest point on each triangle (Ericson, Real-Time Collision
    Detection). p: [P, 1, 3]; a/b/c: [1, F, 3] -> [P, F, 3]."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = (ab * ap).sum(-1)
    d2 = (ac * ap).sum(-1)
    bp = p - b
    d3 = (ab * bp).sum(-1)
    d4 = (ac * bp).sum(-1)
    cp = p - c
    d5 = (ab * cp).sum(-1)
    d6 = (ac * cp).sum(-1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom = _safe(va + vb + vc)
    v = vb / denom
    w = vc / denom
    pt_face = a + v[..., None] * ab + w[..., None] * ac

    t_ab = (d1 / _safe(d1 - d3)).clamp(0, 1)
    pt_ab = a + t_ab[..., None] * ab
    t_ac = (d2 / _safe(d2 - d6)).clamp(0, 1)
    pt_ac = a + t_ac[..., None] * ac
    num = d4 - d3
    den = (d4 - d3) + (d5 - d6)
    t_bc = (num / _safe(den)).clamp(0, 1)
    pt_bc = b + t_bc[..., None] * (c - b)

    # the cascade's later wheres take priority: face < edges < vertices
    out = pt_face
    out = torch.where(((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0))[..., None],
                      pt_bc, out)
    out = torch.where(((vb <= 0) & (d2 >= 0) & (d6 <= 0))[..., None], pt_ac,
                      out)
    out = torch.where(((vc <= 0) & (d1 >= 0) & (d3 <= 0))[..., None], pt_ab,
                      out)
    out = torch.where(((d1 <= 0) & (d2 <= 0))[..., None], a + 0 * out, out)
    out = torch.where(((d3 >= 0) & (d4 <= d3))[..., None], b + 0 * out, out)
    out = torch.where(((d6 >= 0) & (d5 <= d6))[..., None], c + 0 * out, out)
    return out


def _sdf_chunk(pts, tri_a, tri_b, tri_c, face_normals):
    """Signed distance of pts [P, 3] to the mesh -> [P]."""
    p = pts[:, None, :]
    cp = _closest_point_on_tri(p, tri_a[None], tri_b[None], tri_c[None])
    d2 = ((p - cp) ** 2).sum(-1)                         # [P, F]
    fi = d2.argmin(dim=1)                                # [P]
    rows = torch.arange(len(pts), device=pts.device)
    dmin = torch.sqrt(d2[rows, fi])
    nearest = cp[rows, fi]
    sign = torch.sign(((pts - nearest) * face_normals[fi]).sum(-1))
    return dmin * torch.where(sign == 0, 1.0, sign)


class MeshSDF:
    """Callable SDF of a (preferably watertight) mesh on ``device``:
    numpy points [P, 3] -> numpy [P] f32, ``chunk`` points at a time."""

    def __init__(self, verts: np.ndarray, faces: np.ndarray,
                 chunk: int = 2048, device="cuda"):
        v = torch.as_tensor(np.asarray(verts, np.float32), device=device)
        f = torch.as_tensor(np.asarray(faces, np.int64), device=device)
        self.device = torch.device(device)
        self.tri_a, self.tri_b, self.tri_c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
        n = torch.linalg.cross(self.tri_b - self.tri_a,
                               self.tri_c - self.tri_a)
        norm = torch.linalg.norm(n, dim=-1, keepdim=True)
        self.face_normals = n / norm.clamp_min(1e-12)
        self.chunk = chunk
        self._areas = norm[:, 0].cpu().numpy() / 2.0

    @torch.no_grad()
    def __call__(self, pts: np.ndarray) -> np.ndarray:
        pts = torch.as_tensor(np.asarray(pts, np.float32), device=self.device)
        out = [_sdf_chunk(pts[s:s + self.chunk], self.tri_a, self.tri_b,
                          self.tri_c, self.face_normals)
               for s in range(0, len(pts), self.chunk)]
        return torch.cat(out).cpu().numpy()

    def sample_surface(self, n: int, seed: int = 0) -> np.ndarray:
        """Area-weighted surface samples [n, 3], drawn with numpy's
        ``default_rng(seed)`` exactly as the JAX package draws them."""
        rng = np.random.default_rng(seed)
        probs = self._areas / self._areas.sum()
        fi = rng.choice(len(probs), size=n, p=probs)
        u = rng.uniform(0, 1, (n, 1)).astype(np.float32)
        v = rng.uniform(0, 1, (n, 1)).astype(np.float32)
        flip = (u + v) > 1
        u = np.where(flip, 1 - u, u)
        v = np.where(flip, 1 - v, v)
        a = self.tri_a.cpu().numpy()[fi]
        b = self.tri_b.cpu().numpy()[fi]
        c = self.tri_c.cpu().numpy()[fi]
        return a + u * (b - a) + v * (c - a)
