"""Image conditioners (counterparts of
``topiaxl/models/conditioner/image.py``).

* ``DinoV2Wrapper``: preprocessing as the reference, [0, 255] HWC -> /255
  -> antialiased bicubic resize to the encoder's size -> CLIP-stat
  normalisation -> ViT -> cat(cls, patch tokens) = [B, 1 + (518/14)^2,
  768] = [B, 1370, 768] for ViT-B/14-reg.
* ``ImageConditioner``: holds the encoder; inference encodes the user's
  image (``encode_image``). Its training path renders a PrimX batch
  first, which needs the renderer (not ported yet).
* ``DummyImageConditioner``: passes precomputed conditioning through.
"""

from __future__ import annotations

import torch

from ...ops.resize import resize_bicubic
from .dinov2 import DinoViT, dinov2_config

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class DinoV2Wrapper(torch.nn.Module):
    """Frozen DINOv2 encoder; ``vit`` holds the Meta-layout weights."""

    def __init__(self, model_name: str = "dinov2_vitb14_reg",
                 image_size: int = 518, dtype=torch.bfloat16, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        cfg = dinov2_config(model_name)
        if model_name == "dinov2_tiny_test":
            image_size = min(image_size, 28)
            cfg = dict(cfg, pos_embed_size=image_size // cfg["patch_size"])
        self.image_size = image_size
        self.vit = DinoViT(dtype=dtype, device=device, generator=generator,
                           **cfg)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """image [B, H, W, 3] in [0, 255] -> tokens [B, 1 + hw, D] f32."""
        x = resize_bicubic(image.float() / 255.0, self.image_size,
                           self.image_size)
        mean = torch.tensor(CLIP_MEAN, device=x.device)
        std = torch.tensor(CLIP_STD, device=x.device)
        outs = self.vit((x - mean) / std)
        return torch.cat([outs["x_norm_clstoken"][:, None, :],
                          outs["x_norm_patchtokens"]], dim=1)


class ImageConditioner(torch.nn.Module):
    """Render-then-encode conditioner; at inference only ``encoder`` runs
    (``encode_image``, also its ``forward``)."""

    def __init__(self, encoder: torch.nn.Module):
        super().__init__()
        self.encoder = encoder

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        return self.encoder(image)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return self.encode_image(image)

    def render_batch(self, *args, **kwargs):
        raise NotImplementedError(
            "ImageConditioner.render_batch needs the PrimX renderer "
            "(render/raymarch.py), which is not ported yet (ROADMAP queue 1 "
            "#5)")

    def condition_from_primx(self, *args, **kwargs):
        raise NotImplementedError(
            "ImageConditioner.condition_from_primx renders the PrimX batch "
            "with the renderer (render/raymarch.py), which is not ported yet "
            "(ROADMAP queue 1 #5)")


class DummyImageConditioner(torch.nn.Module):
    """Passthrough for precomputed conditioning."""

    def __init__(self, **_):
        super().__init__()

    def encode_image(self, image):
        return image

    def forward(self, image):
        return image
