"""The PrimX VAE's decoder in plain float32, from the checkpoint names
(``post_quant_conv``, ``decoder.``), and the payload it decodes to.

A [B, 1, 4, 4, 4] latent goes through the 1x1x1 post-quant conv, conv_in
(3³) to 256 channels, the mid block (ResNet, volume self-attention over
the 64 voxels with 8 heads, ResNet), the up blocks (two ResNets each, a
stride-2 transposed 2³ conv after the first), GroupNorm (32 groups, eps
1e-5) and SiLU, and a 3³ transposed conv to 6 channels: [B, 6, 8, 8, 8].
Every ResNet and attention output is (branch + skip) * sqrt(1/2).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import ops

SKIP = math.sqrt(0.5)


def _gn(P, name, x):
    c = x.shape[1]
    return ops.group_norm(x, min(32, c), P[name + ".weight"], P[name + ".bias"])


def _conv(P, name, x, padding=1):
    return ops.conv3d(x, P[name + ".weight"], P.get(name + ".bias"),
                      padding=padding)


def _resnet(P, p, x):
    h = _conv(P, p + "conv1", F.silu(_gn(P, p + "norm1", x)))
    h = _conv(P, p + "conv2", F.silu(_gn(P, p + "norm2", h)))
    res = _conv(P, p + "shortcut", x, 0) if p + "shortcut.weight" in P else x
    return (h + res) * SKIP


def _attn(P, p, x, heads: int = 8):
    B, C = x.shape[:2]
    h = _gn(P, p + "norm", x).flatten(2).transpose(1, 2)
    q, k, v = ops.linear(h, P[p + "attn.qkv.weight"]).reshape(
        B, -1, 3, heads, C // heads).unbind(2)
    o = ops.attention(q, k, v, (C // heads) ** -0.5).reshape(B, -1, C)
    o = ops.linear(o, P[p + "attn.proj.weight"], P[p + "attn.proj.bias"])
    return (o.transpose(1, 2).reshape(x.shape) + x) * SKIP


def decode(P: dict, z: torch.Tensor) -> torch.Tensor:
    """[B, 1, 4, 4, 4] latent -> [B, 6, 8, 8, 8] payload."""
    x = _conv(P, "post_quant_conv", z.float(), 0)
    x = _conv(P, "decoder.conv_in", x)
    x = _resnet(P, "decoder.mid_block.nets.0.", x)
    i = 1
    while f"decoder.mid_block.nets.{i}.conv1.weight" in P:
        if f"decoder.mid_block.attns.{i - 1}.norm.weight" in P:
            x = _attn(P, f"decoder.mid_block.attns.{i - 1}.", x)
        x = _resnet(P, f"decoder.mid_block.nets.{i}.", x)
        i += 1
    b = 0
    while f"decoder.up_blocks.{b}.nets.0.conv1.weight" in P:
        p = f"decoder.up_blocks.{b}."
        n = 0
        while f"{p}nets.{n}.conv1.weight" in P:
            x = _resnet(P, f"{p}nets.{n}.", x)
            n += 1
        if p + "upsample.weight" in P:
            x = ops.conv_transpose3d(x, P[p + "upsample.weight"],
                                     P[p + "upsample.bias"], stride=2)
        b += 1
    x = F.silu(_gn(P, "decoder.norm_out", x))
    return ops.conv_transpose3d(x, P["decoder.conv_out.weight"],
                                P["decoder.conv_out.bias"], padding=1)


def primx(P: dict, tokens: torch.Tensor, mean, std):
    """Normalised tokens [N, 68] -> (srt [N, 4], feat [N, 6 * 8³]): tokens
    de-normalised by the latent statistics, the 64 latent channels decoded
    as 4³ volumes, the payload's SDF divided by 5 and the rest mapped from
    [-1, 1] to [0, 1]."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=tokens.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=tokens.device)
    recon = tokens.float() * std + mean
    n = recon.shape[0]
    pay = decode(P, recon[:, 4:].reshape(n, 1, 4, 4, 4))
    pay = torch.cat([pay[:, :1] / 5.0, (pay[:, 1:] + 1.0) / 2.0], dim=1)
    return recon[:, :4], pay.reshape(n, -1)
