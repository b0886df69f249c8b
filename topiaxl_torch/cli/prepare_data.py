"""Dataset preparation CLI:
``python -m topiaxl_torch.cli.prepare_data config.yml
data.input_glob='a/*.obj' data.output_dir=shards [k=v ...]``.

The counterpart of ``topiaxl.cli.prepare_data``: it turns one's own
meshes into the token shards that ``python -m topiaxl_torch.cli.train
train.data_glob=...`` reads. Per mesh: load the OBJ -> normalise it to the
unit cube -> its signed distance field (``extract/mesh_sdf.py``) and 20000
surface samples -> fit ``model.num_prims`` primitives to it
(``pipelines/fit.py``) -> VAE-encode them to normalised DiT tokens
(``pipelines/data.py:encode_assets``) -> render and encode the
conditioning tokens (``condition_from_primx``) -> append to ``.npz``
shards of ``data.assets_per_shard`` assets (``x`` [A, N, 4 + L], ``y``
[A, M, C]).

Only the VAE and the conditioner are built (through the registry, by
``class_name``), with the checkpoints the config names; the DiT is not.
Keys: ``data.input_glob``, ``data.output_dir`` (default
``<output_dir>/shards``), ``data.assets_per_shard`` (64),
``data.shape_opt_steps`` (2000) and ``data.tex_opt_steps`` (0, as the JAX
CLI ships it: the fit runs ``tex_opt_steps`` steps in all, so 0 fits
nothing; set it above ``shape_opt_steps``), ``data.device`` (default
``cuda``; there is no silent fallback to the CPU).
"""

from __future__ import annotations

import logging
import os
import sys
import time

import numpy as np
import torch

logger = logging.getLogger("topiaxl_torch.prepare_data")


def prepare_asset(path: str, vae, conditioner, generator: torch.Generator,
                  latent_mean, latent_std, latent_nf: float = 1.0,
                  num_prims: int = 2048, fit_cfg=None,
                  record: dict | None = None):
    """One mesh file -> (x tokens [N, 4 + L], y conditioning tokens [M, C])
    as f32 numpy. ``record`` (a dict) receives the fitted params and the
    seconds of the mesh SDF (set-up, surface samples and every evaluation
    during the fit), the fit (without those evaluations), the encode and
    the conditioning."""
    from ..extract.mesh_sdf import MeshSDF
    from ..extract.objio import load_obj, normalize_to_unit_cube
    from ..pipelines.data import encode_assets
    from ..pipelines.fit import FitConfig, fit_primx
    from .infer import _sync

    fit_cfg = fit_cfg or FitConfig()
    dev = generator.device
    t0 = time.perf_counter()
    mesh = load_obj(path)
    v, _, _ = normalize_to_unit_cube(mesh["v"])
    sdf = MeshSDF(v, mesh["f"], device=dev)
    surface = sdf.sample_surface(20000)
    sdf_s = [time.perf_counter() - t0]

    def target_sdf(pts):
        _sync(dev)      # the previous fit step's device work is the fit's
        t = time.perf_counter()
        out = sdf(pts)
        sdf_s.append(time.perf_counter() - t)
        return out

    t0 = time.perf_counter()
    params = fit_primx(target_sdf, generator, num_prims=num_prims,
                       surface_points=surface, config=fit_cfg)
    _sync(dev)
    fit_s = time.perf_counter() - t0 - sum(sdf_s[1:])

    t0 = time.perf_counter()
    x = encode_assets(vae, params.srt, params.feat, latent_mean, latent_std,
                      latent_nf, dim_feat=fit_cfg.dim_feat)
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.no_grad():
        y = conditioner.condition_from_primx(params.srt[None],
                                             params.feat[None],
                                             generator=generator)
        y = y[0].float().cpu().numpy()
    if record is not None:
        record.update(params=params, mesh_sdf_s=sum(sdf_s), fit_s=fit_s,
                      encode_s=encode_s,
                      condition_s=time.perf_counter() - t0,
                      fit_steps=fit_cfg.tex_opt_steps)
    return x.astype(np.float32), y.astype(np.float32)


def main(argv=None, records_out: list | None = None) -> int:
    """Run the CLI; ``records_out`` (a list) receives one ``prepare_asset``
    record per mesh, with its path."""
    import glob as globlib

    from ..core.config import load_config
    from ..models.latent_stats import resolve_latent_stats
    from ..pipelines.fit import FitConfig
    from ..pipelines.train import _step_generators
    from .infer import build_encoders

    argv = list(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(level=logging.INFO)
    if not argv:
        print(__doc__)
        return 1
    cfg = load_config(argv[0], overrides=argv[1:])
    data = cfg.get("data") or {}
    files = sorted(globlib.glob(data["input_glob"]))
    if not files:
        raise FileNotFoundError(f"no meshes match {data['input_glob']}")
    out_dir = data.get("output_dir") or os.path.join(cfg.output_dir, "shards")
    os.makedirs(out_dir, exist_ok=True)
    per_shard = int(data.get("assets_per_shard", 64))
    device = torch.device(data.get("device", "cuda"))
    seed = int(cfg.global_seed)

    vae, conditioner = build_encoders(
        cfg, device, torch.Generator(device=device).manual_seed(seed))
    latent_mean, latent_std = resolve_latent_stats(cfg.model)
    fit_cfg = FitConfig(
        prim_shape=int(cfg.model.prim_shape),
        dim_feat=int(cfg.model.dim_feat),
        shape_opt_steps=int(data.get("shape_opt_steps", 2000)),
        tex_opt_steps=int(data.get("tex_opt_steps", 0)))

    xs, ys, shard_idx = [], [], 0

    def flush():
        nonlocal xs, ys, shard_idx
        if not xs:
            return
        path = os.path.join(out_dir, f"shard_{shard_idx:05d}.npz")
        np.savez(path, x=np.stack(xs), y=np.stack(ys))
        logger.info("wrote %s (%d assets)", path, len(xs))
        xs, ys, shard_idx = [], [], shard_idx + 1

    for i, path in enumerate(files):
        record = {"path": path}
        x, y = prepare_asset(
            path, vae, conditioner, _step_generators(seed, i, device)[0],
            latent_mean, latent_std,
            latent_nf=float(cfg.model.get("latent_nf", 1.0)),
            num_prims=int(cfg.model.num_prims), fit_cfg=fit_cfg,
            record=record)
        xs.append(x)
        ys.append(y)
        if records_out is not None:
            records_out.append(record)
        logger.info("prepared %s (%d/%d)", os.path.basename(path), i + 1,
                    len(files))
        if len(xs) >= per_shard:
            flush()
    flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
