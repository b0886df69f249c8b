"""The 3DTopia-XL DiT in plain float32, from its checkpoint names.

Per block (``blocks.<i>.``): adaLN-Zero's nine modulations from
``adaLN_modulation.1`` of SiLU(t_emb), in the order shift, scale, gate of
the cross-attention, of the self-attention and of the MLP; affine-free
LayerNorms (eps 1e-6); cross-attention to the conditioning tokens with q
scaled by head_dim^-0.5 on top of the attention's own (1 / head_dim in
all, as the released model was trained); fused-qkv self-attention; a
GELU(tanh) MLP. The timestep embedding is sinusoidal (cos before sin, 256
frequencies) through a two-layer SiLU MLP; the final layer is a two-way
adaLN and a projection to 2 x 68 channels (mean and variance). A dropped
or unconditional sample attends to the learned null embedding repeated
over the conditioning's length.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import ops


def timestep_embedding(t: torch.Tensor, dim: int = 256,
                       max_period: int = 10000) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _lin(P, name, x):
    return ops.linear(x, P[name + ".weight"], P.get(name + ".bias"))


def _modulate(x, shift, scale):
    return ops.layer_norm(x) * (1 + scale[:, None, :]) + shift[:, None, :]


def block(P: dict, i: int, x, c, y, heads: int):
    """One block: x [B, N, D], c = SiLU(t_emb) [B, D], y [B, M, C]."""
    p = f"blocks.{i}."
    B, N, D = x.shape
    hd = D // heads
    (s_ca, sc_ca, g_ca, s_sa, sc_sa, g_sa, s_mlp, sc_mlp,
     g_mlp) = _lin(P, p + "adaLN_modulation.1", c).chunk(9, dim=-1)

    h = _modulate(x, s_ca, sc_ca)
    q = _lin(P, p + "crossattn.to_q", h).reshape(B, N, heads, hd)
    k = _lin(P, p + "crossattn.to_k", y).reshape(B, -1, heads, hd)
    v = _lin(P, p + "crossattn.to_v", y).reshape(B, -1, heads, hd)
    att = ops.attention(q, k, v, 1.0 / hd).reshape(B, N, D)
    x = x + g_ca[:, None, :] * _lin(P, p + "crossattn.proj", att)

    h = _modulate(x, s_sa, sc_sa)
    q, k, v = _lin(P, p + "attn.qkv", h).reshape(B, N, 3, heads, hd).unbind(2)
    att = ops.attention(q, k, v, hd ** -0.5).reshape(B, N, D)
    x = x + g_sa[:, None, :] * _lin(P, p + "attn.proj", att)

    h = _modulate(x, s_mlp, sc_mlp)
    h = _lin(P, p + "mlp.fc2", ops.gelu_tanh(_lin(P, p + "mlp.fc1", h)))
    return x + g_mlp[:, None, :] * h


def depth_of(P: dict) -> int:
    return 1 + max(int(k.split(".")[1]) for k in P if k.startswith("blocks."))


def forward(P: dict, x, t, y, heads: int, drop=None, block_fn=None):
    """x [B, N, 68], t [B] (original timesteps), y [B, M, C] -> [B, N, 136]
    f32; rows where ``drop`` is True attend to the null embedding.
    ``block_fn`` wraps each block's call (checkpointing, for a backward
    that fits)."""
    if drop is not None:
        null = P["null_cond_embedding"].float()[None, None, :]
        y = torch.where(drop[:, None, None], null, y.float())
    y = y.float()
    t_emb = _lin(P, "t_embedder.mlp.2", F.silu(_lin(
        P, "t_embedder.mlp.0", timestep_embedding(t))))
    c = F.silu(t_emb)
    h = _lin(P, "x_embedder", x.float())
    run = block_fn or (lambda f, *a: f(*a))
    for i in range(depth_of(P)):
        h = run(block, P, i, h, c, y, heads)
    shift, scale = _lin(P, "final_layer.adaLN_modulation.1", c).chunk(2, -1)
    return _lin(P, "final_layer.linear", _modulate(h, shift, scale))


def cfg_forward(P: dict, x, t, y, heads: int, cfg_scale: float):
    """Classifier-free guidance: the conditional and the unconditional
    (null-embedding) outputs, ``uncond + s * (cond - uncond)``."""
    B = x.shape[0]
    null = P["null_cond_embedding"].float()[None, None, :].expand_as(y)
    out = forward(P, torch.cat([x, x]), torch.cat([t, t]),
                  torch.cat([y.float(), null]), heads)
    cond, uncond = out[:B], out[B:]
    return uncond + cfg_scale * (cond - uncond)
