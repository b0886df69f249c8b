"""Antialiased bicubic image resize with torch semantics (counterpart of
``topiaxl/ops/resize.py``, which builds matrices that emulate exactly
this call)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bicubic(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """img [..., H, W, C] -> [..., out_h, out_w, C] in f32."""
    lead = img.shape[:-3]
    H, W, C = img.shape[-3:]
    x = img.float().reshape(-1, H, W, C).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(out_h, out_w), mode="bicubic",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, C)
