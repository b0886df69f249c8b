"""Inference CLI: ``python -m topiaxl_torch.cli.infer config.yml [k=v ...]``.

Reads the same YAML as ``topiaxl.cli.infer`` (through the port's copy
of its loader, ``topiaxl_torch.core.config.load_config``), builds the
DiT, VAE and DINOv2 encoder from the config's fields, loads the reference checkpoints (DiT
under ``ema``, VAE under ``model_state_dict``, DINOv2's own state_dict)
or warns and keeps the seeded random init, and runs image -> PrimX ->
GLB for every image in ``inference.input_dir``. Per image it writes
``denoised.npz`` and, with ``inference.export_glb``, ``pbr_mesh.glb``,
``texture.jpg`` and ``roughness_metallic.jpg``.

``inference.device`` (default ``cuda``) picks the device; there is no
silent fallback to the CPU.
"""

from __future__ import annotations

import logging
import os
import sys
import time

import numpy as np
import torch

logger = logging.getLogger("topiaxl_torch.infer")

_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "fp32": torch.float32, "float32": torch.float32}


def prepare_image(path: str, foreground_ratio: float = 0.85,
                  matting: str = "auto") -> np.ndarray:
    """Load, matte, recenter: [H, W, 3] f32 in [0, 255], background 0.

    An existing alpha channel wins; otherwise GrabCut, then a near-white
    threshold for synthetic white-background renders. ``matting``:
    'auto' | 'grabcut' | 'threshold' (U^2-Net is not ported yet)."""
    import cv2

    from ..ops.matting import remove_background

    if matting not in ("auto", "grabcut", "threshold"):
        raise ValueError(f"matting={matting!r} is not available in the port")
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 2:
        img = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
    if img.shape[-1] == 4:
        rgba = cv2.cvtColor(img, cv2.COLOR_BGRA2RGBA)
    else:
        rgb = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        alpha = remove_background(rgb) if matting != "threshold" else None
        if alpha is None:
            if matting == "grabcut":
                raise ValueError(f"grabcut matting degenerated on {path}")
            bg = rgb.astype(np.int32).sum(-1) > 3 * 247
            alpha = np.where(bg, 0, 255).astype(np.uint8)
        rgba = np.dstack([rgb, alpha])

    ys, xs = np.nonzero(rgba[..., 3] > 0)
    if len(ys) == 0:
        raise ValueError(f"no foreground found in {path}")
    fg = rgba[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
    size = max(fg.shape[:2])
    sq = np.zeros((size, size, 4), np.uint8)
    oy = (size - fg.shape[0]) // 2
    ox = (size - fg.shape[1]) // 2
    sq[oy:oy + fg.shape[0], ox:ox + fg.shape[1]] = fg
    new_size = int(size / foreground_ratio)
    out = np.zeros((new_size, new_size, 4), np.uint8)
    o = (new_size - size) // 2
    out[o:o + size, o:o + size] = sq
    mask = out[..., 3:4] > 0
    return (out[..., :3] * mask).astype(np.float32)


def _load_state_dict(path: str, key: str | None = None) -> dict:
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return sd[key] if key is not None else sd


def build_models(cfg, device, generator: torch.Generator):
    """(dit, vae, encoder) from the config's model fields, with checkpoints
    loaded where the config names them."""
    from ..models.conditioner.image import DinoV2Wrapper
    from ..models.dit import DiT
    from ..models.vae3d import VAE3D

    g = cfg.model.generator
    dit = DiT(seq_length=g.get("seq_length", 2048),
              in_channels=g.get("in_channels", 68),
              condition_channels=g.get("condition_channels", 768),
              hidden_size=g.get("hidden_size", 1152), depth=g.get("depth", 28),
              num_heads=g.get("num_heads", 16),
              mlp_ratio=g.get("mlp_ratio", 4.0),
              attn_proj_bias=g.get("attn_proj_bias", False),
              learn_sigma=g.get("learn_sigma", True),
              dtype=_DTYPES[g.get("dtype", "bf16")], device=device,
              generator=generator).eval()
    v = cfg.model.vae
    vae = VAE3D(in_channels=v.get("in_channels", 6),
                latent_channels=v.get("latent_channels", 1),
                out_channels=v.get("out_channels", 6),
                down_channels=tuple(v.get("down_channels", (32, 256))),
                mid_attention=v.get("mid_attention", True),
                up_channels=tuple(v.get("up_channels", (256, 32))),
                layers_per_block=v.get("layers_per_block", 2),
                dtype=_DTYPES[v.get("dtype", "bf16")], device=device,
                generator=generator).eval()
    e = cfg.model.conditioner.encoder_config
    encoder = DinoV2Wrapper(e.get("model_name", "dinov2_vitb14_reg"),
                            dtype=_DTYPES[e.get("dtype", "bf16")],
                            device=device, generator=generator).eval()

    if cfg.get("checkpoint_path"):
        dit.load_state_dict(_load_state_dict(cfg.checkpoint_path, "ema"))
        logger.info("loaded DiT EMA weights from %s", cfg.checkpoint_path)
    else:
        logger.warning("no checkpoint_path: DiT runs with random init")
    if cfg.model.get("vae_checkpoint_path"):
        vae.load_state_dict(_load_state_dict(cfg.model.vae_checkpoint_path,
                                             "model_state_dict"))
    else:
        logger.warning("no vae_checkpoint_path: VAE runs with random init")
    if cfg.model.conditioner.get("encoder_checkpoint_path"):
        encoder.vit.load_state_dict(
            _load_state_dict(cfg.model.conditioner.encoder_checkpoint_path))
    else:
        logger.warning("no DINOv2 checkpoint: conditioner runs random init")
    return dit, vae, encoder


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, timings_out: list | None = None) -> int:
    """Run the CLI; ``timings_out`` (a list) receives one dict of
    per-image stage seconds (encode, stage1, stage2)."""
    from topiaxl_torch.core.config import load_config

    from ..diffusion.schedule import create_diffusion
    from ..models.latent_stats import resolve_latent_stats
    from ..pipelines import infer as P

    argv = list(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(level=logging.INFO)
    if not argv:
        print(__doc__)
        return 1
    cfg = load_config(argv[0], overrides=argv[1:])
    device = torch.device(cfg.inference.get("device", "cuda"))
    inference_dir = os.path.join(cfg.output_dir, "inference_folder")
    os.makedirs(inference_dir, exist_ok=True)

    gen = torch.Generator(device=device).manual_seed(int(cfg.inference.seed))
    dit, vae, encoder = build_models(cfg, device, gen)
    diffusion = create_diffusion(
        timestep_respacing=(f"ddim{cfg.inference.ddim}"
                            if cfg.inference.ddim > 0 else None),
        noise_schedule=cfg.diffusion.noise_schedule,
        diffusion_steps=cfg.diffusion.diffusion_steps,
        parameterization=cfg.diffusion.parameterization, device=device)
    latent_mean, latent_std = resolve_latent_stats(cfg.model)

    img_dir = cfg.inference.input_dir
    img_list = sorted(f for f in os.listdir(img_dir) if f.lower().endswith(
        (".png", ".jpg", ".jpeg", ".webp")))
    logger.info("running inference on %d images", len(img_list))
    matting = cfg.inference.get("matting", "auto")
    for name in img_list:
        stem = os.path.splitext(name)[0]
        out_dir = os.path.join(inference_dir, stem)
        os.makedirs(out_dir, exist_ok=True)
        rec = {"image": stem}
        t0 = time.perf_counter()
        image = prepare_image(os.path.join(img_dir, name), matting=matting)
        with torch.inference_mode():
            y = encoder(torch.from_numpy(image[None]).to(device))
        _sync(device)
        rec["encode_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        params = P.generate_primx(
            dit, vae, diffusion, y, latent_mean, latent_std,
            latent_nf=float(cfg.model.get("latent_nf", 1.0)),
            cfg_scale=float(cfg.inference.get("cfg", 0.0)),
            prim_shape=cfg.model.prim_shape, dim_feat=cfg.model.dim_feat,
            generator=gen)
        P.save_primx(os.path.join(out_dir, "denoised.npz"), params)
        rec["stage1_s"] = time.perf_counter() - t0
        logger.info("stage1 done: %s (recon.jpg skipped: the renderer is "
                    "not ported yet)", stem)

        t0 = time.perf_counter()
        if cfg.inference.export_glb:
            try:
                glb = P.extract_glb(
                    params, out_dir,
                    mc_resolution=cfg.inference.mc_resolution,
                    decimate=cfg.inference.decimate,
                    batch_size=cfg.inference.batch_size,
                    prim_shape=cfg.model.prim_shape,
                    dim_feat=cfg.model.dim_feat,
                    fast_unwrap=cfg.inference.get("fast_unwrap", True),
                    remesh=cfg.inference.get("remesh", False),
                    ssaa=int(cfg.inference.get("ssaa", 1)))
                logger.info("stage2 done: %s", glb)
            except P.EmptyIsosurfaceError as e:
                # e.g. an untrained model; stage-1 output is already saved
                logger.error("stage2 failed for %s: %s", stem, e)
        rec["stage2_s"] = time.perf_counter() - t0
        logger.info("%s: encode %.3fs, stage1 %.3fs, stage2 %.3fs", stem,
                    rec["encode_s"], rec["stage1_s"], rec["stage2_s"])
        if timings_out is not None:
            timings_out.append(rec)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
