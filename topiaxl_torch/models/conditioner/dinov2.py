"""DINOv2 vision transformer, the frozen image encoder (counterpart of
``topiaxl/models/conditioner/dinov2.py``).

Patch embed (14x14 conv), cls + register tokens, learned position
embeddings (bicubic-interpolated for off-grid sizes), pre-norm blocks
with LayerScale, exact-GELU MLP, final LayerNorm. Keys follow Meta's
released checkpoints. The residual stream, LayerNorms and patch embed
are f32; attention and MLP matmuls run in the compute dtype. The
flagship ViT-B/14-reg at 518^2 attends over 1 + 4 + 1369 = 1374 tokens
(head_dim 64), which takes the flash kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import META, Mlp, SelfAttention, default_init_, materialize_

_CONFIGS = {
    # name -> (embed_dim, depth, num_heads, patch, num_register_tokens)
    "dinov2_vits14": (384, 12, 6, 14, 0),
    "dinov2_vitb14": (768, 12, 12, 14, 0),
    "dinov2_vitl14": (1024, 24, 16, 14, 0),
    "dinov2_vits14_reg": (384, 12, 6, 14, 4),
    "dinov2_vitb14_reg": (768, 12, 12, 14, 4),
    "dinov2_vitl14_reg": (1024, 24, 16, 14, 4),
    # tiny variant for CPU tests (not a released checkpoint)
    "dinov2_tiny_test": (32, 1, 4, 7, 4),
}


def dinov2_config(name: str) -> dict:
    """Constructor kwargs; the hub builds _reg variants with antialiased
    pos-embed interpolation and offset 0.0, the others with 0.1."""
    if name not in _CONFIGS:
        raise KeyError(f"unknown dinov2 model {name}")
    d, depth, h, p, r = _CONFIGS[name]
    return dict(embed_dim=d, depth=depth, num_heads=h, patch_size=p,
                num_register_tokens=r, interpolate_antialias=r > 0,
                interpolate_offset=0.0 if r > 0 else 0.1)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim, device=META))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch, device=META)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype=torch.bfloat16):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6, device=META)
        self.attn = SelfAttention(dim, num_heads, dtype=dtype)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6, device=META)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype=dtype,
                       approximate="none")
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1.gamma * self.attn(self.norm1(x)).float()
        return x + self.ls2.gamma * self.mlp(self.norm2(x)).float()


class DinoViT(nn.Module):
    def __init__(self, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, patch_size: int = 14,
                 num_register_tokens: int = 4, mlp_ratio: float = 4.0,
                 pos_embed_size: int = 37, interpolate_offset: float = 0.1,
                 interpolate_antialias: bool = False, dtype=torch.bfloat16,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.patch_size = patch_size
        self.num_register_tokens = num_register_tokens
        self.pos_embed_size = pos_embed_size
        self.interpolate_offset = interpolate_offset
        self.interpolate_antialias = interpolate_antialias
        D = embed_dim
        self.patch_embed = PatchEmbed(patch_size, D)
        self.cls_token = nn.Parameter(torch.empty(1, 1, D, device=META))
        self.pos_embed = nn.Parameter(
            torch.empty(1, 1 + pos_embed_size**2, D, device=META))
        if num_register_tokens:
            self.register_tokens = nn.Parameter(
                torch.empty(1, num_register_tokens, D, device=META))
        # in the released checkpoints; masked-image training only
        self.mask_token = nn.Parameter(torch.empty(1, D, device=META))
        self.blocks = nn.ModuleList(
            Block(D, num_heads, mlp_ratio, dtype) for _ in range(depth))
        self.norm = nn.LayerNorm(D, eps=1e-6, device=META)
        materialize_(self, device, generator, DinoViT.init_weights)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        default_init_(self, gen)
        self.pos_embed.normal_(0.0, 0.02, generator=gen)
        self.cls_token.zero_()
        self.mask_token.zero_()
        if self.num_register_tokens:
            self.register_tokens.zero_()
        for blk in self.blocks:
            blk.ls1.gamma.fill_(1e-5)
            blk.ls2.gamma.fill_(1e-5)

    def pos_embed_patch(self, gh: int, gw: int) -> torch.Tensor:
        pos = self.pos_embed[:, 1:]
        S = self.pos_embed_size
        if (gh, gw) == (S, S):
            return pos
        # the reference's interpolation: torch bicubic with
        # scale_factor = (grid + offset) / S
        grid = pos.reshape(1, S, S, -1).permute(0, 3, 1, 2)
        grid = F.interpolate(
            grid, scale_factor=((gh + self.interpolate_offset) / S,
                                (gw + self.interpolate_offset) / S),
            mode="bicubic", align_corners=False,
            antialias=self.interpolate_antialias)
        if tuple(grid.shape[-2:]) != (gh, gw):
            raise ValueError(f"pos-embed interpolated to {tuple(grid.shape)}, "
                             f"expected a {gh}x{gw} grid")
        return grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)

    def forward(self, img: torch.Tensor) -> dict:
        """img [B, H, W, 3] normalised floats -> token groups."""
        B, H, W, _ = img.shape
        p = self.patch_size
        gh, gw = H // p, W // p
        x = self.patch_embed.proj(img.float().permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2) + self.pos_embed_patch(gh, gw)
        cls = self.cls_token.expand(B, -1, -1) + self.pos_embed[:, :1]
        parts = [cls]
        if self.num_register_tokens:
            parts.append(self.register_tokens.expand(B, -1, -1))
        x = torch.cat(parts + [x], dim=1)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        r = self.num_register_tokens
        return {"x_norm_clstoken": x[:, 0],
                "x_norm_regtokens": x[:, 1:1 + r],
                "x_norm_patchtokens": x[:, 1 + r:]}
