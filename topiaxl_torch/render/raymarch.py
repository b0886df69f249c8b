"""Volumetric-primitive raymarcher (counterpart of
``topiaxl/render/raymarch.py``), plain PyTorch.

Three dense stages per chunk of rays, as the JAX package has them:

1. **Hit search**: a slab test of every ray against all K prims (their
   axis-aligned boxes, or each prim's own frame with ``prim_rot``), then
   each ray's ``max_hits`` nearest prims by entry distance.
2. **Sampling**: ``num_steps // max_hits`` samples spread evenly over the
   clipped [t_in, t_out] interval of each hit prim, each reading the
   prim's rgba payload trilinearly (``primx.gather_trilinear``:
   ``grid_sample(align_corners=True)``, zeros outside) times the border
   fade exp(-fadescale * sum |y|^fadeexp).
3. **Compositing**: the reference's order-dependent additive clamp as a
   sort by t and a cumsum: contrib_i = min(A_i, 1) - min(A_i - dA_i, 1).

The result does not depend on how ties fall: prims that miss a ray
(entry parked at 1e10) are masked out of the samples by ``hit_valid``,
and samples with no opacity (parked at 1e10) add exactly zero; the sort
is stable.
"""

from __future__ import annotations

import torch

from ..models.primx import gather_trilinear
from .camera import Camera

_BIG = 1e10


def compute_rays(camera: Camera):
    """Per-pixel origin [H, W, 3], unit direction R^T [px, py, 1] [H, W, 3]
    and t range [H, W, 2] (the ray's span in [-1, 1]^3, tmin clamped at 0),
    on the camera's device."""
    H, W = camera.height, camera.width
    dev = camera.campos.device
    xs = (torch.arange(W, dtype=torch.float32, device=dev)
          - camera.princpt[0]) / camera.focal[0]
    ys = (torch.arange(H, dtype=torch.float32, device=dev)
          - camera.princpt[1]) / camera.focal[1]
    py, px = torch.meshgrid(ys, xs, indexing="ij")            # [H, W]
    R = camera.camrot
    # R^T d written out: no matmul, so no TF32 and the same sums anywhere
    raydir = px[..., None] * R[0] + py[..., None] * R[1] + R[2]
    raydir = raydir / torch.linalg.norm(raydir, dim=-1, keepdim=True)
    raypos = camera.campos.expand_as(raydir)
    safe = torch.where(raydir.abs() < 1e-12, 1e-12, raydir)
    t1 = (-1.0 - raypos) / safe
    t2 = (1.0 - raypos) / safe
    tmin = torch.minimum(t1, t2).amax(dim=-1)
    tmax = torch.maximum(t1, t2).amin(dim=-1)
    return raypos, raydir, torch.stack([tmin.clamp_min(0.0), tmax], dim=-1)


def subsample_rays(camera: Camera, factor: int,
                   generator: torch.Generator | None = None):
    """Every ``factor``-th pixel's rays on the [H / f, W / f] grid, at a
    random phase in [0, factor - 2] drawn from ``generator`` (training) or
    the centred phase factor // 2 (eval)."""
    raypos, raydir, tmm = compute_rays(camera)
    if factor <= 1:
        return raypos, raydir, tmm
    if generator is not None:
        off = torch.randint(0, factor - 1, (2,), generator=generator,
                            device=generator.device)
        y0, x0 = int(off[0]), int(off[1])
    else:
        y0 = x0 = factor // 2
    sl = (slice(y0, y0 + factor * (camera.height // factor), factor),
          slice(x0, x0 + factor * (camera.width // factor), factor))
    return raypos[sl], raydir[sl], tmm[sl]


def _rotate_t(rot: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R^T v over the last axis: sum_i rot[..., i, j] v[..., i]."""
    return (v[..., 0:1] * rot[..., 0, :] + v[..., 1:2] * rot[..., 1, :]
            + v[..., 2:3] * rot[..., 2, :])


def _slab(lo, hi, origin, inv_d):
    """Entry and exit t of rays (origin, 1 / direction) [R, 3] through
    boxes [K, 3]: one axis at a time, so no [R, K, 3] tensor is made."""
    tin = tout = None
    for a in range(3):
        t1 = (lo[None, :, a] - origin[:, a, None]) * inv_d[:, a, None]
        t2 = (hi[None, :, a] - origin[:, a, None]) * inv_d[:, a, None]
        mn, mx = torch.minimum(t1, t2), torch.maximum(t1, t2)
        tin = mn if tin is None else torch.maximum(tin, mn)
        tout = mx if tout is None else torch.minimum(tout, mx)
    return tin, tout


def raymarch(payload: torch.Tensor, prim_pos: torch.Tensor,
             prim_scale_inv: torch.Tensor, raypos: torch.Tensor,
             raydir: torch.Tensor, tminmax: torch.Tensor,
             num_steps: int = 192, max_hits: int = 16,
             fadescale: float = 8.0, fadeexp: float = 8.0,
             prim_rot: torch.Tensor | None = None,
             warp: torch.Tensor | None = None) -> torch.Tensor:
    """March a flat chunk of rays -> rgba [R, 4] (rgb premultiplied).

    payload [K, S, S, S, 4] rgba channels-last (voxel z-major); prim_pos
    [K, 3]; prim_scale_inv [K] or [K, 3] (local = (x - pos) * scale_inv);
    raypos, raydir [R, 3]; tminmax [R, 2]. ``prim_rot`` [K, 3, 3] applies
    the full SRT transform, local = R^T (x - pos) * scale_inv, and runs
    the slab test in each prim's frame. ``warp`` [K, Sw, Sw, Sw, 3] reads
    each sample's payload coordinate from the warp volume at its local
    coordinate; the fade and the inside test keep the unwarped one.
    """
    K, S = payload.shape[0], payload.shape[1]
    if prim_scale_inv.dim() == 1:
        prim_scale_inv = prim_scale_inv[:, None]
    extent = 1.0 / prim_scale_inv[:, 0]                       # [K]
    tmin = tminmax[:, 0:1]
    tmax = tminmax[:, 1:2]

    # ---- stage 1: hit search ----------------------------------------------
    if prim_rot is None:
        safe = torch.where(raydir.abs() < 1e-12, 1e-12, raydir)
        tin, tout = _slab(prim_pos - extent[:, None], prim_pos + extent[:, None],
                          raypos, 1.0 / safe)
    else:
        # o_loc = R^T (o - pos) / extent, d_loc = R^T d / extent; the prim
        # is the unit cube in its frame
        rot = prim_rot[None]                                  # [1, K, 3, 3]
        o_loc = _rotate_t(rot, raypos[:, None, :] - prim_pos[None])
        d_loc = _rotate_t(rot, raydir[:, None, :].expand_as(o_loc))
        o_loc = o_loc / extent[None, :, None]
        d_loc = d_loc / extent[None, :, None]
        safe_d = torch.where(d_loc.abs() < 1e-12, 1e-12, d_loc)
        t1 = (-1.0 - o_loc) / safe_d
        t2 = (1.0 - o_loc) / safe_d
        tin = torch.minimum(t1, t2).amax(dim=-1)
        tout = torch.maximum(t1, t2).amin(dim=-1)
    hit = (tout >= torch.maximum(tin, tmin)) & (tin <= tmax) & (tout >= 0)
    tin_h = torch.where(hit, tin, _BIG)
    any_hit = hit.any(dim=1)

    # the max_hits nearest prims by entry distance
    kh = min(max_hits, K)
    tin_top, idx = torch.topk(tin_h, kh, dim=1, largest=False)  # [R, kh]
    hit_valid = tin_top < _BIG

    # ---- stage 2: per-prim interval sampling ------------------------------
    sp = max(num_steps // kh, 1)                              # samples a prim
    tin_k = torch.maximum(torch.gather(tin, 1, idx), tmin)
    tout_k = torch.minimum(torch.gather(tout, 1, idx), tmax)
    seg = (tout_k - tin_k).clamp_min(0.0) * hit_valid         # [R, kh]
    dt_k = seg / sp
    offs = (torch.arange(sp, dtype=torch.float32, device=seg.device)
            + 0.5) / sp
    t = tin_k[..., None] + seg[..., None] * offs              # [R, kh, sp]
    pts = raypos[:, None, None, :] + raydir[:, None, None, :] * t[..., None]

    rel = pts - prim_pos[idx][:, :, None, :]                  # [R, kh, sp, 3]
    if prim_rot is not None:
        rel = _rotate_t(prim_rot[idx][:, :, None], rel)
    y0 = rel * prim_scale_inv[:, 0][idx][:, :, None, None]
    inside = (y0.abs() < 1.0).all(dim=-1) & hit_valid[..., None]

    idx_full = idx[:, :, None].expand(y0.shape[:-1])
    y_sample = y0
    if warp is not None:
        Sw = warp.shape[1]
        y_sample = gather_trilinear(warp.reshape(K * Sw**3, 3), idx_full, y0,
                                    Sw)
    samples = gather_trilinear(payload.reshape(K * S**3, 4), idx_full,
                               y_sample, S)
    fade = torch.exp(-fadescale * (y0.abs() ** fadeexp).sum(dim=-1))
    dA = samples[..., 3] * fade * inside * dt_k[..., None]    # [R, kh, sp]

    # ---- stage 3: global t order + cumsum clamp ----------------------------
    R = raypos.shape[0]
    dA = dA.reshape(R, kh * sp)
    t_flat = torch.where(dA > 0, t.reshape(R, kh * sp), _BIG)  # park empties
    order = torch.argsort(t_flat, dim=1, stable=True)
    dA_s = torch.gather(dA, 1, order)
    rgb_s = torch.gather(samples[..., :3].reshape(R, kh * sp, 3), 1,
                         order[..., None].expand(R, kh * sp, 3))
    A = torch.cumsum(dA_s, dim=1)
    contrib = A.clamp(max=1.0) - (A - dA_s).clamp(max=1.0)
    rgb_out = (rgb_s * contrib[..., None]).sum(dim=1)
    alpha_out = A[:, -1].clamp(max=1.0)
    rgba = torch.cat([rgb_out, alpha_out[:, None]], dim=-1)
    return torch.where(any_hit[:, None], rgba, 0.0)


def render_primx(srt: torch.Tensor, feat: torch.Tensor, camera: Camera,
                 prim_shape: int = 8, num_steps: int = 192,
                 max_hits: int = 16, chunk: int = 32768,
                 payload: torch.Tensor | None = None,
                 prim_rot: torch.Tensor | None = None) -> torch.Tensor:
    """Render a PrimX asset (srt [K, 4], feat [K, 6 S^3]) -> rgba image
    [H, W, 4], rgb in the 0..255 scale and alpha in 0..1, through
    ``chunk`` rays at a time (the result does not depend on ``chunk``).
    ``payload`` replaces the asset's own rgba volumes; ``prim_rot``
    [K, 3, 3] applies the full SRT prim transform. The camera lives on
    the asset's device."""
    from .visualize import primx_to_payload

    if payload is None:
        payload = primx_to_payload(srt, feat, prim_shape)
    pos = srt[:, 1:4]
    sinv = 1.0 / srt[:, 0]
    raypos, raydir, tmm = compute_rays(camera)
    H, W = camera.height, camera.width
    rp, rd, tm = raypos.reshape(-1, 3), raydir.reshape(-1, 3), tmm.reshape(-1, 2)
    out = [raymarch(payload, pos, sinv, rp[i:i + chunk], rd[i:i + chunk],
                    tm[i:i + chunk], num_steps=num_steps, max_hits=max_hits,
                    prim_rot=prim_rot)
           for i in range(0, H * W, chunk)]
    return torch.cat(out).reshape(H, W, 4)
