"""Image conditioners (counterparts of
``topiaxl/models/conditioner/image.py``).

* ``DinoV2Wrapper``: preprocessing as the reference, [0, 255] HWC -> /255
  -> antialiased bicubic resize to the encoder's size -> CLIP-stat
  normalisation -> ViT -> cat(cls, patch tokens) = [B, 1 + (518/14)^2,
  768] = [B, 1370, 768] for ViT-B/14-reg.
* ``ImageConditioner``: holds the encoder; inference encodes the user's
  image (``encode_image``), training renders the PrimX batch with the
  raymarcher and encodes the picture (``condition_from_primx``).
* ``ImageMultiViewConditioner``: the tokens of V orbit views, concatenated.
* ``DummyImageConditioner``: passes precomputed conditioning through.
* ``CLIPImageEncoder``: the CLIP vision tower (``conditioner/clip.py``)
  from a local transformers-layout directory, pooled [B, 1, D] or, with
  ``tokens``, every token [B, 1 + P, D] (the flagship DiT's 768-wide
  cross-attention takes B/32's tokens).
"""

from __future__ import annotations

import math

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
    """Render-then-encode conditioner. Inference encodes the user's image
    (``encode_image``, also its ``forward``); training conditions on the
    PrimX batch itself, raymarched from the frontal camera (or a sampled
    orbit view with ``sample_view``) onto a white background and encoded
    (``condition_from_primx``)."""

    def __init__(self, encoder: torch.nn.Module, num_prims: int = 2048,
                 dim_feat: int = 6, prim_shape: int = 8,
                 sample_view: bool = False, image_height: int = 518,
                 image_width: int = 518):
        super().__init__()
        self.encoder = encoder
        self.num_prims = num_prims
        self.dim_feat = dim_feat
        self.prim_shape = prim_shape
        self.sample_view = sample_view
        self.image_height = image_height
        self.image_width = image_width

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        return self.encoder(image)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return self.encode_image(image)

    def render_batch(self, srt: torch.Tensor, feat: torch.Tensor, cam,
                     bg_color: float = 1.0) -> torch.Tensor:
        """srt [B, N, 4], feat [B, N, C S^3] seen from ``cam`` ->
        [B, H, W, 3] in the encoder's [0, 255] convention: the render's
        rgb (already 0..255) over bg_color * 255 * (1 - alpha)."""
        from ...render import render_primx

        if srt.dim() != 3 or feat.dim() != 3:
            raise ValueError(f"expected batched srt, feat; got {tuple(srt.shape)}"
                             f", {tuple(feat.shape)}")
        imgs = []
        for b in range(srt.shape[0]):
            rgba = render_primx(srt[b], feat[b], cam,
                                prim_shape=self.prim_shape)
            imgs.append(rgba[..., :3] + bg_color * 255.0 * (1.0 - rgba[..., 3:4]))
        return torch.stack(imgs)

    def condition_from_primx(self, srt: torch.Tensor, feat: torch.Tensor,
                             generator: torch.Generator | None = None,
                             bg_color: float = 1.0) -> torch.Tensor:
        """Tokens of the PrimX batch rendered from the frontal camera, or,
        with ``sample_view`` and a ``generator``, from an orbit angle drawn
        uniformly in [0, 2 pi) from it."""
        from ...render import frontal_camera, orbit_camera

        dev = srt.device
        if self.sample_view and generator is not None:
            angle = torch.rand((), generator=generator,
                               device=generator.device) * (2 * math.pi)
            cam = orbit_camera(angle, self.image_height, self.image_width,
                               device=dev)
        else:
            cam = frontal_camera(self.image_height, self.image_width,
                                 device=dev)
        return self.encoder(self.render_batch(srt, feat, cam, bg_color))


class ImageMultiViewConditioner(ImageConditioner):
    """The tokens of ``view_counts`` orbit views (angles 2 pi v / V)
    concatenated along the token axis, in view order."""

    def __init__(self, *args, view_counts: int = 4, **kw):
        super().__init__(*args, **kw)
        self.view_counts = view_counts

    def condition_from_primx(self, srt: torch.Tensor, feat: torch.Tensor,
                             generator: torch.Generator | None = None,
                             bg_color: float = 1.0) -> torch.Tensor:
        from ...render import orbit_camera

        tokens = []
        for vi in range(self.view_counts):
            cam = orbit_camera(2 * math.pi * vi / self.view_counts,
                               self.image_height, self.image_width,
                               device=srt.device)
            tokens.append(self.encoder(self.render_batch(srt, feat, cam,
                                                         bg_color)))
        return torch.cat(tokens, dim=1)


class DummyImageConditioner(torch.nn.Module):
    """Passthrough for precomputed conditioning."""

    def __init__(self, **_):
        super().__init__()

    def encode_image(self, image):
        return image

    def forward(self, image):
        return image


class CLIPImageEncoder(torch.nn.Module):
    """[B, H, W, 3] in [0, 255] -> /255 -> antialiased bicubic resize to
    the tower's size -> CLIP-stat normalisation -> the CLIP vision tower
    (f32) -> pooled [B, 1, D], or ``last_hidden_state`` with ``tokens``.
    The tower comes from ``model_name_or_path`` (a local directory, no
    download) or ``tower``; without either, encoding raises, as in the JAX
    package."""

    def __init__(self, model_name_or_path: str | None = None,
                 tokens: bool = False, tower: torch.nn.Module | None = None,
                 device=None):
        super().__init__()
        from .clip import load_clip_tower

        self.tokens = tokens
        if model_name_or_path:
            tower = load_clip_tower(model_name_or_path, "vision",
                                    device=device)
        self.tower = tower

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        if self.tower is None:
            raise RuntimeError(
                "CLIPImageEncoder needs local CLIP weights "
                "(model_name_or_path or tower); the released 3DTopia-XL "
                "pipeline conditions on DINOv2 instead (DinoV2Wrapper).")
        size = self.tower.image_size
        x = resize_bicubic(images.float() / 255.0, size, size)
        mean = torch.tensor(CLIP_MEAN, device=x.device)
        std = torch.tensor(CLIP_STD, device=x.device)
        out = self.tower((x - mean) / std)
        if self.tokens:
            return out["last_hidden_state"]
        return out["pooled"][:, None, :]
