"""The PrimX renderer (counterpart of ``topiaxl/render``), plain PyTorch."""

from .camera import Camera, camera_from_rt_k, frontal_camera, orbit_camera
from .raymarch import compute_rays, raymarch, render_primx
from .visualize import (
    colored_box_payload,
    primx_to_payload,
    visualize_primvolume,
    visualize_video_primvolume,
)

__all__ = [
    "Camera",
    "frontal_camera",
    "orbit_camera",
    "camera_from_rt_k",
    "compute_rays",
    "raymarch",
    "render_primx",
    "primx_to_payload",
    "colored_box_payload",
    "visualize_primvolume",
    "visualize_video_primvolume",
]
from . import geom  # noqa: E402,F401  (UV and 3D geometry utilities)
