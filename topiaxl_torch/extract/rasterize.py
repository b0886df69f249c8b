"""UV-atlas rasterization for texture baking (host-side, vectorized).

Replaces nvdiffrast on the bake path (reference inference.py:172-174):
rasterize the UV-space triangles at texture resolution and interpolate
the 3D surface position per texel (positions + coverage mask only — the
reference takes no gradients here either). Triangles are bucketed by
bounding-box size so every bucket rasterizes as one dense vectorized
numpy op instead of a per-triangle Python loop.

Texel convention: texel (row r, col c) has uv = ((c+0.5)/W, (r+0.5)/H);
v grows with the image row (see extract/glb.py docstring).
"""

from __future__ import annotations

import numpy as np


def rasterize_uv_atlas(
    uv_corners: np.ndarray,      # [F, 3, 2] uv per face corner, in [0,1]
    attr_corners: np.ndarray,    # [F, 3, A] attribute per corner (e.g. xyz)
    height: int,
    width: int,
    backend: str = "auto",
):
    """Returns (attr_map [H, W, A] float32, mask [H, W] bool).

    backend 'native' (C++ bbox fill, topiaxl_torch/native/raster.cpp) is ~50x
    the numpy bucketed path on single-core hosts; 'numpy' is the
    executable spec; 'auto' prefers native.
    """
    if backend in ("auto", "native"):
        try:
            from ..native import raster_uv

            return raster_uv(uv_corners, attr_corners, height, width)
        except Exception:
            if backend == "native":
                raise
    F = uv_corners.shape[0]
    A = attr_corners.shape[-1]
    out = np.zeros((height * width, A), np.float32)
    covered = np.zeros(height * width, bool)
    if F == 0:
        return out.reshape(height, width, A), covered.reshape(height, width)

    # pixel-space corners
    px = uv_corners[..., 0] * width - 0.5   # [F, 3]
    py = uv_corners[..., 1] * height - 0.5

    x0 = np.maximum(np.ceil(px.min(1)).astype(np.int64), 0)
    x1 = np.minimum(np.floor(px.max(1)).astype(np.int64), width - 1)
    y0 = np.maximum(np.ceil(py.min(1)).astype(np.int64), 0)
    y1 = np.minimum(np.floor(py.max(1)).astype(np.int64), height - 1)
    bw = x1 - x0 + 1
    bh = y1 - y0 + 1
    valid = (bw > 0) & (bh > 0)
    span = np.maximum(bw, bh)

    buckets = [1, 2, 4, 8, 16, 32, 64, 128]
    max_span = int(span[valid].max()) if valid.any() else 0
    while buckets[-1] < max_span:
        buckets.append(buckets[-1] * 2)

    lo = 0
    for s in buckets:
        sel = np.nonzero(valid & (span > lo) & (span <= s))[0]
        lo = s
        if sel.size == 0:
            continue
        _raster_bucket(
            px[sel], py[sel], attr_corners[sel], x0[sel], y0[sel],
            s, width, height, out, covered,
        )

    return out.reshape(height, width, A), covered.reshape(height, width)


def _raster_bucket(px, py, attrs, x0, y0, s, width, height, out, covered):
    M = px.shape[0]
    # candidate pixel lattice per triangle: [M, s, s]
    gx = x0[:, None, None] + np.arange(s)[None, None, :]
    gy = y0[:, None, None] + np.arange(s)[None, :, None]
    fx = gx.astype(np.float32)
    fy = gy.astype(np.float32)

    ax, ay = px[:, 0, None, None], py[:, 0, None, None]
    bx, by = px[:, 1, None, None], py[:, 1, None, None]
    cx, cy = px[:, 2, None, None], py[:, 2, None, None]

    det = (bx - ax) * (cy - ay) - (cx - ax) * (by - ay)
    det = np.where(np.abs(det) < 1e-12, 1e-12, det)
    w1 = ((fx - ax) * (cy - ay) - (cx - ax) * (fy - ay)) / det
    w2 = ((bx - ax) * (fy - ay) - (fx - ax) * (by - ay)) / det
    w0 = 1.0 - w1 - w2

    eps = 1e-6
    inside = (
        (w0 >= -eps) & (w1 >= -eps) & (w2 >= -eps)
        & (gx >= 0) & (gx < width) & (gy >= 0) & (gy < height)
    )

    idx = (gy * width + gx)[inside]
    vals = (
        w0[..., None] * attrs[:, None, None, 0]
        + w1[..., None] * attrs[:, None, None, 1]
        + w2[..., None] * attrs[:, None, None, 2]
    )[inside]
    out[idx] = vals.astype(np.float32)
    covered[idx] = True
