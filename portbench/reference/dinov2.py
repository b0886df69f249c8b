"""DINOv2 ViT-B/14 with four registers, as 3DTopia-XL conditions on it, in
plain float32 from Meta's checkpoint names (under ``vit.``).

The image [B, H, W, 3] in 0..255 is scaled to [0, 1], resized (bicubic,
antialiased) to 518², normalised with CLIP's statistics as 3DTopia-XL's
conditioner does, cut into 14² patches, given the class token, the
registers and the learned positions; then pre-norm blocks with
LayerScale and an exact-GELU MLP, a final LayerNorm, and the class token
followed by the 37² patch tokens: [B, 1370, 768].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import ops

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def encode(P: dict, image: torch.Tensor, size: int = 518, heads: int = 12,
           registers: int = 4, patch: int = 14) -> torch.Tensor:
    P = {k[len("vit."):]: v for k, v in P.items() if k.startswith("vit.")}
    x = image.float().permute(0, 3, 1, 2) / 255.0
    x = F.interpolate(x, size=(size, size), mode="bicubic",
                      align_corners=False, antialias=True)
    mean = torch.tensor(CLIP_MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(CLIP_STD, device=x.device)[None, :, None, None]
    x = (x - mean) / std
    w = P["patch_embed.proj.weight"].float()
    B = x.shape[0]
    patches = x.reshape(B, 3, size // patch, patch, size // patch, patch)
    patches = patches.permute(0, 2, 4, 1, 3, 5).reshape(
        B, (size // patch) ** 2, 3 * patch * patch)
    tok = ops.linear(patches, w.reshape(w.shape[0], -1),
                     P["patch_embed.proj.bias"])
    pos = P["pos_embed"].float()
    tok = tok + pos[:, 1:]
    cls = P["cls_token"].float().expand(B, -1, -1) + pos[:, :1]
    parts = [cls]
    if registers:
        parts.append(P["register_tokens"].float().expand(B, -1, -1))
    x = torch.cat(parts + [tok], dim=1)
    D = x.shape[-1]
    hd = D // heads
    i = 0
    while f"blocks.{i}.norm1.weight" in P:
        p = f"blocks.{i}."
        h = ops.layer_norm(x, P[p + "norm1.weight"], P[p + "norm1.bias"])
        q, k, v = ops.linear(h, P[p + "attn.qkv.weight"],
                             P[p + "attn.qkv.bias"]).reshape(
            B, -1, 3, heads, hd).unbind(2)
        att = ops.attention(q, k, v, hd ** -0.5).reshape(B, -1, D)
        att = ops.linear(att, P[p + "attn.proj.weight"], P[p + "attn.proj.bias"])
        x = x + P[p + "ls1.gamma"].float() * att
        h = ops.layer_norm(x, P[p + "norm2.weight"], P[p + "norm2.bias"])
        h = ops.linear(F.gelu(ops.linear(h, P[p + "mlp.fc1.weight"],
                                         P[p + "mlp.fc1.bias"])),
                       P[p + "mlp.fc2.weight"], P[p + "mlp.fc2.bias"])
        x = x + P[p + "ls2.gamma"].float() * h
        i += 1
    x = ops.layer_norm(x, P["norm.weight"], P["norm.bias"])
    return torch.cat([x[:, :1], x[:, 1 + registers:]], dim=1)
