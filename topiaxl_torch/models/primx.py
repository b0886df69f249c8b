"""PrimX neural field (counterpart of ``topiaxl/models/primx.py``).

N volumetric primitives, each a (scale, position) and a dense S^3 x 6
payload [SDF, R, G, B, roughness, metallic]. A query blends trilinear
samples of the covering primitives with normalised tent weights; at
inference, uncovered points get a nearest-voxel signed-distance
fallback.

Per point the candidates are an exact top-k over the dense [P, N] weight
matrix. Trilinear sampling is ``grid_sample(align_corners=True,
padding_mode="zeros")`` semantics, done as 8 corner gathers from the
[N * S^3, C] payload rows: volumes are never expanded per point. Payload
volumes are [z, y, x] against xyz coordinates.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PrimXParams(NamedTuple):
    """srt [N, 4] = (scale, x, y, z); feat [N, C * S^3] channel-major."""

    srt: torch.Tensor
    feat: torch.Tensor


def local_grid(prim_shape: int) -> np.ndarray:
    """Voxel-centre offsets in xyz for flat voxel index i*S^2 + j*S + k,
    with (x, y, z) = (lin[k], lin[j], lin[i])."""
    lin = np.linspace(-1.0, 1.0, prim_shape, dtype=np.float32)
    zz, yy, xx = np.meshgrid(lin, lin, lin, indexing="ij")
    return np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)


def prim_weights(srt: torch.Tensor, x: torch.Tensor):
    """Unnormalised tent weights ``relu(1 - ||(x - pos) / scale||_inf)``
    [P, N] and their sum [P, 1]."""
    rel = (x[:, None, :] - srt[None, :, 1:4]) / srt[None, :, 0:1]
    w = torch.relu(1.0 - rel.abs().amax(dim=-1))
    return w, w.sum(dim=-1, keepdim=True)


def sdf2alpha(sdf: torch.Tensor, var: float = 0.005) -> torch.Tensor:
    """Soft SDF -> opacity ``exp(-(sdf / var)^2)``."""
    return torch.exp(-((sdf / var) ** 2))


def gather_trilinear(rows: torch.Tensor, idx: torch.Tensor,
                     coords: torch.Tensor, S: int) -> torch.Tensor:
    """Sample volume ``idx`` [P, K] of ``rows`` [N * S^3, C] (voxel z-major)
    at local xyz ``coords`` [P, K, 3] in [-1, 1] -> [P, K, C], with
    zeros outside the volume (any leading shape, ``idx`` shaped as
    ``coords[..., 0]``)."""
    t = (coords + 1.0) * 0.5 * (S - 1)          # [P, K, 3] voxel units
    i0f = torch.floor(t)
    frac = t - i0f
    i0 = i0f.long()
    base = idx.long() * S**3
    # one gather of single elements, not of C-wide rows: on an H100 the row
    # gather (rows[flat]) took 330.5 of the 570.8 device ms of
    # ``python -m topiaxl_torch.cli.profile``'s recon region, this one 12.3
    C = rows.shape[1]
    elems = rows.reshape(-1)
    lanes = torch.arange(C, device=rows.device)
    out = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                d = (dx, dy, dz)
                w = torch.ones_like(frac[..., 0])
                ok = torch.ones_like(w, dtype=torch.bool)
                ii = []
                for a in range(3):          # a: 0 = x, 1 = y, 2 = z
                    ia = i0[..., a] + d[a]
                    ok = ok & (ia >= 0) & (ia <= S - 1)
                    w = w * (frac[..., a] if d[a] else 1.0 - frac[..., a])
                    ii.append(ia.clamp(0, S - 1))
                flat = base + (ii[2] * S + ii[1]) * S + ii[0]
                vals = elems[flat[..., None] * C + lanes]    # [P, K, C]
                out = out + vals * (w * ok)[..., None]
    return out


def query(params: PrimXParams, x: torch.Tensor, dim_feat: int = 6,
          prim_shape: int = 8, top_k: int = 32, with_fallback: bool = True,
          outputs: tuple | None = None):
    """Field at points x [P, 3] -> dict(sdf [P,1], tex [P,3], mat [P,2],
    feat [P,C]), restricted to ``outputs`` when given."""
    N = params.srt.shape[0]
    S, C = prim_shape, dim_feat
    pos = params.srt[:, 1:4]
    scale = params.srt[:, 0:1]

    w, wsum = prim_weights(params.srt, x)
    w_top, idx = torch.topk(w, min(top_k, N), dim=-1)          # [P, K]
    coords = (x[:, None, :] - pos[idx]) / scale[idx]          # [P, K, 3]

    # sample only the channels the caller needs
    need = set(outputs) if outputs is not None else {"feat"}
    if need <= {"sdf"}:
        ch0, ch1 = 0, 1
    elif need <= {"tex", "mat"}:
        ch0, ch1 = 1, C
    else:
        ch0, ch1 = 0, C
    rows = params.feat.reshape(N, C, S**3)[:, ch0:ch1].transpose(1, 2)
    rows = rows.reshape(N * S**3, ch1 - ch0)
    sampled = gather_trilinear(rows, idx, coords, S)
    wn = torch.where(w_top > 0, w_top, 0.0) / (wsum + 1e-6)
    blended = (sampled * wn[..., None]).sum(dim=1)             # [P, nch]
    if (ch0, ch1) == (0, C):
        feat = blended
    else:
        feat = blended.new_zeros((x.shape[0], C))
        feat[:, ch0:ch1] = blended

    if with_fallback:
        covered = wsum[:, 0] > 0
        near = torch.linalg.norm(x[:, None, :] - pos[None], dim=-1).argmin(-1)
        grid = torch.as_tensor(local_grid(S), device=x.device)
        cand = pos[near][:, None, :] + scale[near][:, :, None] * grid[None]
        pts_dist = torch.linalg.norm(x[:, None, :] - cand, dim=-1)  # [P, S^3]
        min_dist, f_idx = pts_dist.min(dim=-1)
        sdf_near = params.feat[near, f_idx]
        approx_sdf = sdf_near + min_dist * torch.sign(sdf_near)
        sdf = torch.where(covered, feat[:, 0], approx_sdf)[:, None]
    else:
        sdf = feat[:, 0:1]

    out = {
        "sdf": sdf,
        "tex": feat[:, 1:4].clamp(0.0, 1.0),
        "mat": feat[:, 4:6].clamp(0.0, 1.0),
        "feat": feat,
    }
    if outputs is not None:
        out = {k: out[k] for k in outputs}
    return out


def query_chunked(params: PrimXParams, pts: torch.Tensor, chunk: int = 32768,
                  **kw):
    """``query`` over a large point set in chunks of ``chunk`` points."""
    outs = [query(params, pts[i:i + chunk], **kw)
            for i in range(0, pts.shape[0], chunk)]
    return {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}
