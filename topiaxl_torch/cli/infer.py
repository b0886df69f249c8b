"""Inference CLI: ``python -m topiaxl_torch.cli.infer config.yml [k=v ...]``.

Reads the same YAML as ``topiaxl.cli.infer`` (through the port's copy
of its loader, ``topiaxl_torch.core.config.load_config``), builds the
generator, VAE and conditioner that ``model.*.class_name`` name through
the port's registry (``topiaxl_torch/registry.py``: ``topiaxl.DiT`` or
``topiaxl.DiTAdditivePosEmb``, ``topiaxl.VAE3D``, ``topiaxl.ImageConditioner``
over ``topiaxl.DinoV2Wrapper`` or ``topiaxl.CLIPImageEncoder``), loads the
reference checkpoints (DiT under ``ema``, VAE under ``model_state_dict``,
DINOv2's own state_dict in ``model.conditioner.encoder_checkpoint_path``;
a CLIP encoder reads a local transformers-layout directory,
``encoder_config.model_name_or_path``, and with ``tokens: true`` feeds
all of B/32's 50 tokens to the 768-wide cross-attention) or warns and
keeps the seeded random init, and runs image -> PrimX -> GLB for every image in
``inference.input_dir``. ``inference.u2net_checkpoint`` (a torch
``.pth``) mattes with U^2-Net ahead of GrabCut, as ``inference.matting``
(auto | u2net | grabcut | threshold) asks; ``model.native_checkpoint_dir``
(orbax) raises when it names a directory: the port reads no orbax. Per
image it writes ``denoised.npz``, the frontal snapshot ``recon.jpg`` (rgb
| coloured prim boxes, ``image_height`` x 2 ``image_width``) and, with
``debug``, the orbit videos; with ``inference.export_glb``,
``pbr_mesh.glb``, ``texture.jpg`` and ``roughness_metallic.jpg``.

``inference.device`` (default ``cuda``) picks the device; there is no
silent fallback to the CPU. ``inference.sampler`` picks the chain:
``ddim`` (default), ``dpm`` (DPM-Solver++(2M) over the same respaced
timesteps, e.g. ``inference.ddim=12``) or ``ancestral``; any other name
raises. ``model.generator.quant=true`` serves the DiT's block matmuls
W8A8 (``ops/int8.py``). On a card each image's chain replays one CUDA
graph (``pipelines/chain_graph.py``), captured at the first image.
"""

from __future__ import annotations

import logging
import os
import sys
import time

import numpy as np
import torch

logger = logging.getLogger("topiaxl_torch.infer")

def prepare_image(path: str, foreground_ratio: float = 0.85,
                  matting: str = "auto", matter=None) -> np.ndarray:
    """Load, matte, recenter: [H, W, 3] f32 in [0, 255], background 0.

    Matting order: an existing alpha channel wins; otherwise the learned
    U^2-Net matting (``matter``, from ``ops.matting.load_u2net``) when
    weights were loaded, its soft saliency binarised at > 32; otherwise
    GrabCut; a near-white threshold last, for synthetic white-background
    renders. ``matting``: 'auto' | 'u2net' | 'grabcut' | 'threshold'."""
    import cv2

    from ..ops.matting import remove_background

    if matting not in ("auto", "u2net", "grabcut", "threshold"):
        raise ValueError(f"matting={matting!r}: expected auto, u2net, grabcut "
                         f"or threshold")
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 2:
        img = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
    if img.shape[-1] == 4:
        rgba = cv2.cvtColor(img, cv2.COLOR_BGRA2RGBA)
    else:
        rgb = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        alpha = None
        if matting == "u2net" and matter is None:
            raise ValueError(
                "matting='u2net' but no U^2-Net weights were loaded "
                "(set inference.u2net_checkpoint)")
        if matting in ("auto", "u2net") and matter is not None:
            alpha = matter(rgb)
            # saliency maps are soft; binarise faint backgrounds away
            alpha = np.where(alpha > 32, alpha, 0).astype(np.uint8)
            if not (alpha > 0).any():
                alpha = None
        if alpha is None and matting in ("auto", "grabcut"):
            alpha = remove_background(rgb)
        if alpha is None:
            if matting == "grabcut":
                raise ValueError(f"grabcut matting degenerated on {path}")
            if matting == "u2net":
                raise ValueError(f"u2net matting found nothing in {path}")
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


def refuse_unported_checkpoints(cfg) -> None:
    """Raise where the config names weights the JAX CLI would read and the
    port cannot: orbax trees in ``model.native_checkpoint_dir``, which the
    JAX CLI loads ahead of ``checkpoint_path`` (serving something else
    without a word)."""
    native = cfg.model.get("native_checkpoint_dir")
    if native and os.path.isdir(native):
        raise ValueError(
            f"model.native_checkpoint_dir={native!r}: the port reads no orbax "
            f"trees; give the reference's torch checkpoints instead "
            f"(checkpoint_path, model.vae_checkpoint_path, "
            f"model.conditioner.encoder_checkpoint_path)")


def build_encoders(cfg, device, generator: torch.Generator):
    """(vae, conditioner) built through the registry from the config's
    ``model.vae`` and ``model.conditioner`` (each by its ``class_name``),
    with the checkpoints loaded where the config names them: all that data
    preparation needs (``cli/prepare_data.py``)."""
    from .. import registry  # noqa: F401  (fills the factory table)
    from ..core.config import build

    refuse_unported_checkpoints(cfg)
    vae = build(cfg.model.vae, device=device, generator=generator).eval()
    conditioner = build(cfg.model.conditioner, device=device,
                        generator=generator).eval()
    if cfg.model.get("vae_checkpoint_path"):
        vae.load_state_dict(_load_state_dict(cfg.model.vae_checkpoint_path,
                                             "model_state_dict"))
    else:
        logger.warning("no vae_checkpoint_path: VAE runs with random init")
    # ``encoder_checkpoint_path`` holds DINOv2 weights, as the JAX CLI
    # reads it; a CLIP encoder loads its own from ``model_name_or_path``
    encoder = getattr(conditioner, "encoder", None)
    vit = getattr(encoder, "vit", None)
    ckpt = cfg.model.conditioner.get("encoder_checkpoint_path")
    if ckpt and encoder is not None:
        if vit is None:
            raise ValueError(
                f"model.conditioner.encoder_checkpoint_path={ckpt!r} names "
                f"DINOv2 weights, but the encoder is "
                f"{type(encoder).__name__} (give its model_name_or_path)")
        vit.load_state_dict(_load_state_dict(ckpt))
    elif vit is not None:
        logger.warning("no DINOv2 checkpoint: conditioner runs random init")
    return vae, conditioner


def build_models(cfg, device, generator: torch.Generator):
    """(dit, vae, conditioner) built through the registry from the config's
    ``model.generator``, ``model.vae`` and ``model.conditioner`` (each by
    its ``class_name``), with checkpoints loaded where the config names
    them. With ``model.generator.quant`` the DiT serves W8A8: its float
    weights (checkpoint or random init) are quantized once, as
    ``topiaxl/cli/infer.py:_maybe_quantize`` does."""
    from .. import registry  # noqa: F401  (fills the factory table)
    from ..core.config import build
    from ..models.dit import DiT, quantize_dit_state_dict

    refuse_unported_checkpoints(cfg)
    g = cfg.model.generator
    dit = build(g, device=device, generator=generator, quant=False).eval()
    if not isinstance(dit, DiT):
        raise TypeError(f"model.generator.class_name={g.class_name!r} builds "
                        f"{type(dit).__name__}, not a DiT")
    vae, conditioner = build_encoders(cfg, device, generator)

    if cfg.get("checkpoint_path"):
        dit.load_state_dict(_load_state_dict(cfg.checkpoint_path, "ema"))
        logger.info("loaded DiT EMA weights from %s", cfg.checkpoint_path)
    else:
        logger.warning("no checkpoint_path: DiT runs with random init")
    if g.get("quant", False):
        # built from its own seed: the caller's generator stream (the VAE,
        # the encoder, the noise) is the float build's
        qdit = build(g, device=device, quant=True).eval()
        qdit.load_state_dict(quantize_dit_state_dict(qdit, dit.state_dict()))
        logger.info("quantized the DiT's block matmuls for int8 serving")
        dit = qdit
    return dit, vae, conditioner


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, timings_out: list | None = None) -> int:
    """Run the CLI; ``timings_out`` (a list) receives one dict of
    per-image stage seconds (encode, stage1, recon, stage2)."""
    from topiaxl_torch.core.config import load_config

    from ..diffusion.schedule import create_diffusion
    from ..models.latent_stats import resolve_latent_stats
    from ..ops.matting import load_u2net
    from ..pipelines import infer as P
    from ..render.visualize import (visualize_primvolume,
                                    visualize_video_primvolume)

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
    dit, vae, conditioner = build_models(cfg, device, gen)
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
    matter = load_u2net(cfg.inference.get("u2net_checkpoint", ""),
                        device=device)
    matting = cfg.inference.get("matting", "auto")
    if matter is not None:
        logger.info("matting: U^2-Net (%s)", matter.model.arch)
    for name in img_list:
        stem = os.path.splitext(name)[0]
        out_dir = os.path.join(inference_dir, stem)
        os.makedirs(out_dir, exist_ok=True)
        rec = {"image": stem}
        t0 = time.perf_counter()
        image = prepare_image(os.path.join(img_dir, name), matting=matting,
                              matter=matter)
        with torch.inference_mode():
            y = conditioner.encode_image(
                torch.from_numpy(image[None]).to(device))
        _sync(device)
        rec["encode_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        params = P.generate_primx(
            dit, vae, diffusion, y, latent_mean, latent_std,
            latent_nf=float(cfg.model.get("latent_nf", 1.0)),
            cfg_scale=float(cfg.inference.get("cfg", 0.0)),
            prim_shape=cfg.model.prim_shape, dim_feat=cfg.model.dim_feat,
            generator=gen, sampler=cfg.inference.get("sampler", "ddim"))
        P.save_primx(os.path.join(out_dir, "denoised.npz"), params)
        rec["stage1_s"] = time.perf_counter() - t0

        # the frontal rgb | prim-box snapshot and, with debug, the orbit
        t0 = time.perf_counter()
        visualize_primvolume(os.path.join(out_dir, "recon.jpg"), params,
                             cfg.image_height, cfg.image_width,
                             cfg.model.prim_shape)
        if cfg.get("debug"):
            visualize_video_primvolume(out_dir, params, 60, cfg.image_height,
                                       cfg.image_width)
        rec["recon_s"] = time.perf_counter() - t0
        logger.info("stage1 done: %s", stem)

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
        logger.info("%s: encode %.3fs, stage1 %.3fs, recon %.3fs, stage2 "
                    "%.3fs", stem, rec["encode_s"], rec["stage1_s"],
                    rec["recon_s"], rec["stage2_s"])
        if timings_out is not None:
            timings_out.append(rec)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
