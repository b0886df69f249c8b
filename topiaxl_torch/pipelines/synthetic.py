"""Synthetic inputs for smoke and profiling runs without trained weights.

Random DiT weights give degenerate fields, so stage 2 is exercised on a
sphere shell of primitives whose payloads are the exact SDF of that
sphere (the torch counterpart of ``bench.py:_sphere_asset_device``), and
stage 1 on a synthetic object photo (``bench.py:_write_bench_image``).
The fidelity measurement scores the extraction chain on a textured
sphere against its own field (``textured_sphere`` and ``psnr``, copies of
``tests/test_fidelity.py:_textured_sphere`` and ``_psnr``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.primx import PrimXParams, local_grid

SPHERE_R = 0.55


def write_bench_image(path: str, shift: int = 0) -> None:
    """A deterministic synthetic object photo on white, 512²."""
    import cv2

    img = np.full((512, 512, 3), 255, np.uint8)
    cv2.circle(img, (256 + shift, 276), 140, (170, 96, 52), -1)
    cv2.rectangle(img, (196, 116 + shift), (316, 236 + shift), (52, 118, 196), -1)
    cv2.circle(img, (256, 276), 60, (240, 220, 96), -1)
    cv2.imwrite(path, img)


def sphere_asset(device, n: int = 2048, S: int = 8, seed: int = 0) -> PrimXParams:
    """``n`` prims of scale 0.07 on the r = 0.55 sphere (directions from a
    numpy seed): SDF |p| - 0.55, RGB from position, rough 0.8, metal 0.2."""
    v = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, 3)).astype(np.float32)).to(device)
    pos = v / v.norm(dim=1, keepdim=True) * SPHERE_R
    world = pos[:, None, :] + 0.07 * torch.from_numpy(local_grid(S)).to(device)
    sdf = world.norm(dim=2) - SPHERE_R
    rgb = (0.5 + 0.5 * world.transpose(1, 2)).clamp(0.0, 1.0)
    mat = torch.cat([torch.full((n, 1, S**3), 0.8, device=device),
                     torch.full((n, 1, S**3), 0.2, device=device)], 1)
    feat = torch.cat([sdf[:, None], rgb, mat], 1).reshape(n, -1)
    return PrimXParams(torch.cat([torch.full((n, 1), 0.07, device=device),
                                  pos], 1), feat)


def textured_sphere(n: int = 512, radius: float = 0.55, prim_shape: int = 8,
                    device="cpu") -> PrimXParams:
    """``n`` prims of scale 0.11 on the sphere (directions from numpy's
    seed 0): SDF |p| - radius, albedo 0.5 + 0.5 * unit position, rough 0.7,
    metal 0.3; built in numpy exactly as the JAX test builds it, then moved
    to ``device``."""
    rng = np.random.default_rng(0)
    v = rng.standard_normal((n, 3)).astype("f")
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pos = (v * radius).astype("f")
    scale = np.full((n, 1), 0.11, "f")
    world = (pos[:, None, :]
             + scale[:, 0][:, None, None] * local_grid(prim_shape)[None])
    sdf = np.linalg.norm(world, axis=2) - radius
    rgb = np.clip(0.5 + 0.5 * world.transpose(0, 2, 1)
                  / np.maximum(np.linalg.norm(world, axis=2)[:, None, :], 1e-6),
                  0, 1)
    mat = np.concatenate([np.full((n, 1, prim_shape**3), 0.7),
                          np.full((n, 1, prim_shape**3), 0.3)], 1)
    feat = np.concatenate([sdf[:, None, :], rgb, mat], 1).reshape(n, -1)
    return PrimXParams(
        torch.from_numpy(np.concatenate([scale, pos], 1)).to(device),
        torch.from_numpy(feat.astype("f")).to(device))


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR in dB of two arrays in [0, 1] (99 where they are equal)."""
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 99.0 if mse == 0 else 10.0 * np.log10(1.0 / mse)
