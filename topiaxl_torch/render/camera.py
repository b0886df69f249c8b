"""Cameras for PrimX rendering (counterpart of ``topiaxl/render/camera.py``).

Positions live in the normalised volume frame (object in [-1, 1]^3).
Pinhole constants as the reference: focal 2084.9526697685183 at 1024 px,
principal point 512, a frontal camera at z = +5 with R = diag(1, -1, -1),
an orbit of radius 5 at height 0. The pose is computed in numpy float32,
as the JAX package computes it, then placed on ``device``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

REF_FOCAL_1024 = 2084.9526697685183
ORBIT_RADIUS = 5.0


class Camera(NamedTuple):
    campos: torch.Tensor   # [3] in normalised volume units
    camrot: torch.Tensor   # [3, 3] world -> camera rotation (rows)
    focal: torch.Tensor    # [2] pixels
    princpt: torch.Tensor  # [2] pixels
    height: int
    width: int


def _intrinsics(height: int, width: int):
    # the reference scales K's row 0 by H / 1024 and row 1 by W / 1024
    rh = height / 1024.0
    rw = width / 1024.0
    focal = np.array([REF_FOCAL_1024 * rh, REF_FOCAL_1024 * rw], np.float32)
    princpt = np.array([512.0 * rh, 512.0 * rw], np.float32)
    return focal, princpt


def _camera(campos, R, focal, princpt, height, width, device) -> Camera:
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Camera(t(campos), t(R), t(focal), t(princpt), height, width)


def frontal_camera(height: int = 518, width: int = 518,
                   device="cuda") -> Camera:
    """The fixed frontal view."""
    R = np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]], np.float32)
    t = np.array([0.0, 0.0, ORBIT_RADIUS], np.float32)
    return _camera(-R.T @ t, R, *_intrinsics(height, width), height, width,
                   device)


def orbit_camera(angle, height: int = 518, width: int = 518,
                 cam_height: float = 0.0, device="cuda") -> Camera:
    """Pose on the orbit at ``angle`` radians (a float or a 0-d tensor),
    looking at the origin."""
    angle = float(angle)
    r = ORBIT_RADIUS
    position = np.array(
        [r * np.cos(angle), cam_height, r * np.sin(angle)], np.float32)
    forward = position / np.linalg.norm(position)
    world_up = np.array([0.0, 1.0, 0.0], np.float32)
    right = -np.cross(world_up, forward)
    right /= np.linalg.norm(right)
    up = np.cross(forward, right)
    up /= np.linalg.norm(up)
    R = np.stack([right, up, forward], axis=0)
    t = np.array([0.0, 0.0, r], np.float32)
    return _camera(-R.T @ t, R, *_intrinsics(height, width), height, width,
                   device)


def camera_from_rt_k(Rt: np.ndarray, K: np.ndarray, height: int, width: int,
                     volradius: float = 1.0, device="cuda") -> Camera:
    """From reference-style extrinsics [3, 4] and intrinsics [3, 3];
    ``volradius`` divides the translation of an Rt given in the
    reference's mm-scale convention."""
    Rt = np.asarray(Rt, np.float32)
    K = np.asarray(K, np.float32)
    R = Rt[:3, :3]
    t = Rt[:3, 3] / volradius
    focal = np.array([K[0, 0], K[1, 1]], np.float32)
    princpt = np.array([K[0, 2], K[1, 2]], np.float32)
    return _camera(-R.T @ t, R, focal, princpt, height, width, device)
