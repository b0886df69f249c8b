"""PrimX fitting (counterpart of ``topiaxl/pipelines/fit.py``): turn a
target SDF (and texture) field into N volumetric primitives.

The reference never released this stage (``PrimSDF._init_param`` is a
stub, models/primsdf.py:48-50) but ships its loss (the staged PrimSDFLoss,
dva/losses.py:102-148) and its knobs (init_scale, auto_scale_init,
init_sampling). Primitives start on a jittered lattice, or on a subsample
of the surface points when they are given, scaled to their neighbour
spacing; then Adam fits them through the differentiable field query
(``query(training=True)``), one update a step, with the scales clipped to
a band around their start after each update.

Random draws: the placement takes the caller's ``torch.Generator``
(``randperm`` for the surface subsample, ``rand`` for the jitter); the
point batches come from ``np.random.default_rng(0)`` exactly as the JAX
package draws them, so both packages fit on the same batches.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..models import primx as PX
from ..models.primx import PrimXParams
from .losses import primsdf_fit_loss


def auto_scale(pos: torch.Tensor) -> torch.Tensor:
    """Each primitive's scale, 1.2x its nearest neighbour's distance
    (at least 1e-3) -> [N, 1]. The [N, N] distances are norms of
    differences, as the JAX package computes them (``torch.cdist``'s
    matmul form loses precision for near neighbours)."""
    d = torch.linalg.norm(pos[:, None, :] - pos[None, :, :], dim=-1)
    d = d + 1e9 * torch.eye(len(pos), device=pos.device)
    return (d.min(dim=1).values * 1.2).clamp_min(1e-3)[:, None]


def init_prims(num_prims: int, generator: torch.Generator,
               surface_points: np.ndarray | None = None,
               init_scale: float = 0.05, auto_scale_init: bool = True,
               init_sampling: str = "uniform", prim_shape: int = 8,
               dim_feat: int = 6) -> PrimXParams:
    """Place primitives on the generator's device (reference knobs:
    configs/inference_dit.yml:28-31): a subsample of ``surface_points``
    when there are enough of them; else 'uniform' scatters centres on a
    lattice in [-0.9, 0.9]^3 jittered by a quarter of its spacing, and any
    other sampling draws them uniformly there. ``auto_scale_init`` sets
    each scale from the neighbour spacing, else ``init_scale``."""
    dev = generator.device
    if surface_points is not None and len(surface_points) >= num_prims:
        idx = torch.randperm(len(surface_points), generator=generator,
                             device=dev)[:num_prims]
        pos = torch.as_tensor(np.asarray(surface_points, np.float32),
                              device=dev)[idx]
    elif init_sampling == "uniform":
        side = int(round(num_prims ** (1 / 3)))
        while side**3 < num_prims:
            side += 1
        lin = np.linspace(-0.9, 0.9, side, dtype=np.float32)
        gz, gy, gx = np.meshgrid(lin, lin, lin, indexing="ij")
        lattice = np.stack([gx, gy, gz], -1).reshape(-1, 3)[:num_prims]
        jit_amp = float((lin[1] - lin[0]) * 0.25) if side > 1 else 0.1
        jitter = torch.rand((num_prims, 3), generator=generator,
                            device=dev) * 2.0 - 1.0
        pos = torch.as_tensor(lattice, device=dev) + jit_amp * jitter
    else:
        pos = torch.rand((num_prims, 3), generator=generator,
                         device=dev) * 1.8 - 0.9

    if auto_scale_init:
        scale = auto_scale(pos)
    else:
        scale = torch.full((num_prims, 1), float(init_scale), device=dev)
    srt = torch.cat([scale, pos], dim=-1)
    feat = torch.zeros((num_prims, dim_feat * prim_shape**3), device=dev)
    return PrimXParams(srt=srt, feat=feat)


class FitConfig(NamedTuple):
    prim_shape: int = 8
    dim_feat: int = 6
    batch_points: int = 8192
    lr: float = 5e-3
    shape_opt_steps: int = 2000
    tex_opt_steps: int = 6000
    near_surface_frac: float = 0.5
    near_surface_sigma: float = 0.05
    weights: dict = None  # type: ignore


DEFAULT_WEIGHTS = {"sdf_l1": 1.0, "rgb_l1": 1.0, "mat_l1": 1.0,
                   "vol_sum": 1e-4}


def fit_weights(cfg: FitConfig, target_tex, target_mat) -> dict:
    """The loss weights of a fit: the texture term off without a texture
    target, the material term gone without a material target."""
    weights = dict(cfg.weights or DEFAULT_WEIGHTS)
    if target_tex is None:
        weights["rgb_l1"] = 0.0
    if target_mat is None:
        weights.pop("mat_l1", None)
    return weights


def fit_loss(params: PrimXParams, pts, tgt_sdf, tgt_tex, tgt_mat, it: int,
             cfg: FitConfig, weights: dict):
    """The staged loss of the field at ``pts`` [P, 3] against its targets
    -> (total, loss dict)."""
    out = PX.query(params, pts, dim_feat=cfg.dim_feat,
                   prim_shape=cfg.prim_shape, training=True)
    N = params.srt.shape[0]
    preds = {"sdf": out["sdf"], "tex": out["feat"][:, 1:4],
             "mat": out["feat"][:, 4:6],
             # PrimSDFLoss takes 1/scale (dva/losses.py:122-124)
             "prim_scale": 1.0 / params.srt[:, 0:1].expand(N, 3)[None]}
    inputs = {"sdf": tgt_sdf, "tex": tgt_tex, "mat": tgt_mat}
    return primsdf_fit_loss(inputs, preds, weights, it,
                            shape_opt_steps=cfg.shape_opt_steps,
                            tex_opt_steps=cfg.tex_opt_steps)


def scale_bounds(scale0: torch.Tensor):
    """The band the scales are clipped to after every update, relative to
    their start: it stops prims shrinking out of coverage to zero their
    own loss."""
    return (scale0 * 0.5).clamp_min(5e-3), (scale0 * 3.0).clamp_max(0.9)


def fit_step(params: PrimXParams, optimizer: torch.optim.Optimizer,
             batch: tuple, it: int, cfg: FitConfig, weights: dict, bounds):
    """One Adam update of the leaf tensors ``params`` (in place) on
    ``batch`` = (pts, sdf, tex, mat), then the scale clip -> (loss, dict)."""
    optimizer.zero_grad(set_to_none=True)
    loss, ld = fit_loss(params, *batch, it, cfg, weights)
    loss.backward()
    optimizer.step()
    with torch.no_grad():
        params.srt[:, 0].clamp_(bounds[0], bounds[1])
    return loss.detach(), ld


def sample_batch(rng: np.random.Generator, cfg: FitConfig,
                 surf_pool: np.ndarray | None) -> np.ndarray:
    """One batch of fitting points [P, 3]: uniform in [-1, 1]^3 and, for
    ``near_surface_frac`` of them, surface samples (or uniform points in
    [-0.8, 0.8]^3) with Gaussian jitter; the JAX package's draws."""
    P = cfg.batch_points
    n_near = int(P * cfg.near_surface_frac)
    uni = rng.uniform(-1, 1, (P - n_near, 3)).astype(np.float32)
    if surf_pool is not None and len(surf_pool):
        base = surf_pool[rng.integers(0, len(surf_pool), n_near)]
    else:
        base = rng.uniform(-0.8, 0.8, (n_near, 3)).astype(np.float32)
    near = base + rng.normal(0, cfg.near_surface_sigma,
                             (n_near, 3)).astype(np.float32)
    return np.concatenate([uni, near]).clip(-1, 1)


def fit_primx(target_sdf: Callable[[np.ndarray], np.ndarray],
              generator: torch.Generator, num_prims: int = 2048,
              target_tex: Callable[[np.ndarray], np.ndarray] | None = None,
              target_mat: Callable[[np.ndarray], np.ndarray] | None = None,
              surface_points: np.ndarray | None = None,
              config: FitConfig = FitConfig(),
              verbose: bool = False) -> PrimXParams:
    """Fit PrimX params, on the generator's device, to target callables
    evaluated on host points (numpy in, numpy out). Runs
    ``config.tex_opt_steps`` updates: shape until ``shape_opt_steps``,
    then texture."""
    cfg = config
    dev = generator.device
    weights = fit_weights(cfg, target_tex, target_mat)
    params = init_prims(num_prims, generator, surface_points=surface_points,
                        prim_shape=cfg.prim_shape, dim_feat=cfg.dim_feat)
    params = PrimXParams(params.srt.requires_grad_(),
                         params.feat.requires_grad_())
    optimizer = torch.optim.Adam(list(params), lr=cfg.lr)
    bounds = scale_bounds(params.srt[:, 0].detach().clone())

    rng = np.random.default_rng(0)
    surf_pool = (None if surface_points is None
                 else np.asarray(surface_points, np.float32))
    for it in range(cfg.tex_opt_steps):
        pts = sample_batch(rng, cfg, surf_pool)
        tgt_sdf = np.asarray(target_sdf(pts), np.float32).reshape(-1, 1)
        tgt_tex = (np.asarray(target_tex(pts), np.float32) if target_tex
                   else np.zeros((len(pts), 3), np.float32))
        tgt_mat = (np.asarray(target_mat(pts), np.float32) if target_mat
                   else np.zeros((len(pts), 2), np.float32))
        batch = tuple(torch.from_numpy(a).to(dev)
                      for a in (pts, tgt_sdf, tgt_tex, tgt_mat))
        loss, _ = fit_step(params, optimizer, batch, it, cfg, weights, bounds)
        if verbose and it % 200 == 0:
            print(f"fit iter {it}: loss {float(loss):.5f}", flush=True)
    return PrimXParams(params.srt.detach(), params.feat.detach())
