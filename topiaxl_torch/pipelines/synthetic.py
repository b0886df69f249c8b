"""Synthetic inputs for smoke and profiling runs without trained weights.

Random DiT weights give degenerate fields, so stage 2 is exercised on a
sphere shell of primitives whose payloads are the exact SDF of that
sphere (the torch counterpart of ``bench.py:_sphere_asset_device``), and
stage 1 on a synthetic object photo (``bench.py:_write_bench_image``).
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
