"""PrimX visualisation (counterpart of ``topiaxl/render/visualize.py``):
recon snapshots, orbit videos, coloured prim boxes.

``visualize_primvolume`` renders a frontal rgb | coloured-box pair into
one JPEG; ``visualize_video_primvolume`` renders an orbit (angles
linspace(1.5 pi, 3.5 pi)) into rgb.mp4, prim.mp4 and mat.mp4 at 20 fps,
or into folders of frame JPEGs where no mp4 writer is installed
(``imageio`` with an ffmpeg backend); it logs which it wrote.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..models.primx import sdf2alpha
from .camera import frontal_camera, orbit_camera
from .raymarch import render_primx

logger = logging.getLogger("topiaxl_torch.render")


def primx_to_payload(srt: torch.Tensor, feat: torch.Tensor,
                     prim_shape: int = 8, sdf_var: float = 0.005,
                     channels: str = "tex") -> torch.Tensor:
    """PrimX payload -> raymarch rgba volumes [K, S, S, S, 4]: rgb =
    tex * 255, alpha = exp(-(sdf / var)^2) * 255; ``channels='mat'``
    renders rgb = (roughness, metallic, 0) * 255 instead."""
    S = prim_shape
    K = feat.shape[0]
    vol = feat.reshape(K, 6, S, S, S)
    alpha = sdf2alpha(vol[:, 0], var=sdf_var) * 255.0
    if channels == "mat":
        rgb = torch.cat([vol[:, 4:6], torch.zeros_like(vol[:, 0:1])],
                        dim=1) * 255.0
    else:
        rgb = vol[:, 1:4] * 255.0
    rgba = torch.cat([rgb, alpha[:, None]], dim=1)            # [K, 4, S, S, S]
    return rgba.permute(0, 2, 3, 4, 1)


def colored_box_payload(num_prims: int, prim_shape: int = 8,
                        alpha: float = 10000.0, seed: int = 123456,
                        device="cuda") -> torch.Tensor:
    """Randomly coloured, lit boxes: a colour per prim from a numpy seed,
    diffuse shading from the dominant cube-face normal against
    lightdir = normalize(-[3, 3, 3]), clamped at 0.2, times 1.4."""
    S = prim_shape
    rng = np.random.RandomState(seed)
    colors = rng.rand(num_prims, 3).astype(np.float32) * 255.0

    lin = np.linspace(-1.0, 1.0, S, dtype=np.float32)
    zz, yy, xx = np.meshgrid(lin, lin, lin, indexing="ij")
    ax, ay, az = np.abs(xx), np.abs(yy), np.abs(zz)
    nx = np.where((ax >= ay) & (ax >= az), np.sign(xx), 0.0)
    ny = np.where((ay >= ax) & (ay >= az), np.sign(yy), 0.0)
    nz = np.where((az >= ax) & (az >= ay), np.sign(zz), 0.0)
    normal = np.stack([nx, -ny, -nz], axis=-1)
    normal /= np.maximum(np.linalg.norm(normal, axis=-1, keepdims=True), 1e-9)

    lightdir = -np.ones(3, np.float32) / np.sqrt(3.0)
    mult = np.clip((normal @ lightdir), 0.2, None) * 1.4       # [S, S, S]

    rgb = colors[:, None, None, None, :] * mult[None, ..., None]
    a = np.full((num_prims, S, S, S, 1), alpha, np.float32)
    return torch.as_tensor(np.concatenate([rgb, a], axis=-1),
                           dtype=torch.float32, device=device)


def _split(recon_param, prim_shape: int | None):
    """(srt, feat, prim_shape) of a [B, N, 4 + 6 S^3] tensor's first asset
    or of a PrimXParams."""
    if hasattr(recon_param, "srt"):
        srt, feat = recon_param.srt, recon_param.feat
    else:
        srt, feat = recon_param[0, :, :4], recon_param[0, :, 4:]
    if prim_shape is None:
        prim_shape = int(round((feat.shape[1] / 6) ** (1 / 3)))
    return srt, feat, prim_shape


def _render_pair(srt, feat, camera, prim_shape: int, num_steps: int,
                 max_hits: int):
    rgba = render_primx(srt, feat, camera, prim_shape=prim_shape,
                        num_steps=num_steps, max_hits=max_hits)
    boxes = render_primx(srt, feat, camera, prim_shape=prim_shape,
                         num_steps=num_steps, max_hits=max_hits,
                         payload=colored_box_payload(srt.shape[0], prim_shape,
                                                     device=srt.device))
    return rgba.cpu().numpy(), boxes.cpu().numpy()


def _u8(img: np.ndarray) -> np.ndarray:
    return np.clip(img, 0, 255).astype(np.uint8)


@torch.inference_mode()
def visualize_primvolume(path: str, recon_param, height: int = 518,
                         width: int = 518, prim_shape: int | None = None,
                         num_steps: int = 128, max_hits: int = 8):
    """recon_param [B, N, 4 + 6 S^3] (or PrimXParams): writes the
    frontal rgb | boxes JPEG [H, 2W] and returns the two rgba renders
    [H, W, 4] (numpy)."""
    import cv2

    srt, feat, prim_shape = _split(recon_param, prim_shape)
    cam = frontal_camera(height, width, device=srt.device)
    rgb, boxes = _render_pair(srt, feat, cam, prim_shape, num_steps, max_hits)
    img = np.concatenate([rgb[..., :3], boxes[..., :3]], axis=1)
    cv2.imwrite(path, _u8(img[..., ::-1]))
    return rgb, boxes


@torch.inference_mode()
def visualize_video_primvolume(out_dir: str, recon_param, view_counts: int = 60,
                               height: int = 518, width: int = 518,
                               prim_shape: int | None = None,
                               num_steps: int = 128, max_hits: int = 8,
                               fps: int = 20,
                               with_materials: bool = True) -> dict:
    """The orbit's rgb, prim (coloured boxes) and, with materials, mat
    (roughness = R, metallic = G) videos, ``view_counts + 1`` frames each;
    returns {name: "mp4" or "jpg"}, what ``_write_video`` wrote."""
    srt, feat, prim_shape = _split(recon_param, prim_shape)
    mat_payload = (primx_to_payload(srt, feat, prim_shape, channels="mat")
                   if with_materials else None)
    frames = {"rgb": [], "prim": [], "mat": []}
    for ang in np.linspace(1.5, 3.5, view_counts + 1) * np.pi:
        cam = orbit_camera(float(ang), height, width, device=srt.device)
        rgb, boxes = _render_pair(srt, feat, cam, prim_shape, num_steps,
                                  max_hits)
        frames["rgb"].append(_u8(rgb[..., :3]))
        frames["prim"].append(_u8(boxes[..., :3]))
        if mat_payload is not None:
            mat = render_primx(srt, feat, cam, prim_shape=prim_shape,
                               num_steps=num_steps, max_hits=max_hits,
                               payload=mat_payload)
            frames["mat"].append(_u8(mat[..., :3].cpu().numpy()))
    os.makedirs(out_dir, exist_ok=True)
    return {name: _write_video(os.path.join(out_dir, f"{name}.mp4"), fr, fps)
            for name, fr in frames.items() if fr}


@torch.inference_mode()
def visualize_multiview_primvolume(path: str, recon_param, views: int = 4,
                                   height: int = 518, width: int = 518,
                                   prim_shape: int | None = None,
                                   num_steps: int = 128,
                                   max_hits: int = 8) -> None:
    """A grid of ``views`` orbit views: the rgb row over the box row."""
    import cv2

    srt, feat, prim_shape = _split(recon_param, prim_shape)
    rgb_row, box_row = [], []
    for vi in range(views):
        cam = orbit_camera(2 * np.pi * vi / views, height, width,
                           device=srt.device)
        rgb, boxes = _render_pair(srt, feat, cam, prim_shape, num_steps,
                                  max_hits)
        rgb_row.append(rgb[..., :3])
        box_row.append(boxes[..., :3])
    img = np.concatenate(
        [np.concatenate(rgb_row, axis=1), np.concatenate(box_row, axis=1)],
        axis=0)
    cv2.imwrite(path, _u8(img[..., ::-1]))


def _write_video(path: str, frames, fps: int) -> str:
    """``path`` as an mp4 through imageio, or, where imageio or its mp4
    backend is missing, the frames as ``<path without .mp4>/NNNN.jpg``.
    Returns which ("mp4" or "jpg")."""
    try:
        import imageio

        with imageio.get_writer(path, fps=fps) as w:
            for fr in frames:
                w.append_data(fr)
        branch = "mp4"
    except (ImportError, ValueError) as e:   # no imageio, or no mp4 backend
        import cv2

        base = os.path.splitext(path)[0]
        os.makedirs(base, exist_ok=True)
        for i, fr in enumerate(frames):
            cv2.imwrite(f"{base}/{i:04d}.jpg", fr[..., ::-1])
        branch = "jpg"
        logger.info("%s: no mp4 writer (%s): wrote %d frame JPEGs in %s",
                    path, type(e).__name__, len(frames), base)
    else:
        logger.info("%s: wrote %d frames", path, len(frames))
    return branch
