"""TRELLIS-image-large's sparse-structure flow transformer in plain float32,
from its checkpoint names, with its rectified-flow loss and gradient.

Written from the published model (github.com/microsoft/TRELLIS,
``trellis/models/sparse_structure_flow.py`` and
``trellis/modules/transformer/modulated.py``; config
``ckpts/ss_flow_img_dit_L_16l8_fp16.json``). A [B, 8, R, R, R] latent
flattened in (x, y, z) order, ``input_layer`` plus a fixed sin/cos
position embedding of the grid's coordinates; the timestep embedding of
1000 t (cos before sin, 256 frequencies) through a two-layer SiLU MLP;
per block (``blocks.<i>.``) a six-way adaLN of SiLU(t_emb) (shift, scale,
gate of the self-attention, then of the MLP); a modulated affine-free LN
into fused-qkv self-attention whose q and k are RMS-normalised per head
(``q_rms_norm.gamma`` times sqrt(head_dim)), gated; an affine LN
(``norm2``) into cross-attention to the conditioning tokens (``to_q``,
``to_kv``: k then v), ungated; a modulated LN into a GELU(tanh) MLP,
gated. Every block LN at eps 1e-6; the final LN affine-free at eps 1e-5
(``F.layer_norm``'s default, as TRELLIS calls it), then ``out_layer``.
Both attentions scale by head_dim^-0.5.

The loss (TRELLIS's flow matching): x_t = (1 - t) x0 + (sigma_min + (1 -
sigma_min) t) eps, the model at 1000 t, the mean squared error against
(1 - sigma_min) eps - x0; a dropped row's conditioning is zeros.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import ops
from .dit import timestep_embedding

SIGMA_MIN = 1e-5


def position_embedding(resolution: int, channels: int, device=None):
    """[R^3, channels]: per token, [sin, cos] of each of its three integer
    coordinates at frequencies 10000^(-i / F), i < F = channels // 6, then
    zeros to ``channels``."""
    nf = channels // 3 // 2
    freqs = torch.tensor([10000.0 ** (-i / nf) for i in range(nf)],
                         device=device)
    r = torch.arange(resolution, device=device, dtype=torch.float32)
    gx, gy, gz = torch.meshgrid(r, r, r, indexing="ij")
    parts = []
    for c in (gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)):
        a = c[:, None] * freqs[None]
        parts += [torch.sin(a), torch.cos(a)]
    emb = torch.cat(parts, dim=1)
    pad = torch.zeros(emb.shape[0], channels - emb.shape[1], device=device)
    return torch.cat([emb, pad], dim=1)


def qk_norm(x, gamma):
    """x [B, N, H, D] over its per-head L2 norm (at least 1e-12), times
    gamma [H, D] and sqrt(D)."""
    x = x.float()
    n = torch.sqrt((x * x).sum(-1, keepdim=True)).clamp_min(1e-12)
    return x / n * gamma.float() * math.sqrt(x.shape[-1])


def _lin(P, name, x):
    return ops.linear(x, P[name + ".weight"], P.get(name + ".bias"))


def _modulate(x, shift, scale):
    return ops.layer_norm(x) * (1 + scale[:, None, :]) + shift[:, None, :]


def block(P: dict, i: int, x, c, y, heads: int):
    """One block: x [B, N, C], c = SiLU(t_emb) [B, C], y [B, M, Cc]."""
    p = f"blocks.{i}."
    B, N, C = x.shape
    hd = C // heads
    s_sa, sc_sa, g_sa, s_mlp, sc_mlp, g_mlp = _lin(
        P, p + "adaLN_modulation.1", c).chunk(6, dim=-1)

    h = _modulate(x, s_sa, sc_sa)
    q, k, v = _lin(P, p + "self_attn.to_qkv", h).reshape(
        B, N, 3, heads, hd).unbind(2)
    q = qk_norm(q, P[p + "self_attn.q_rms_norm.gamma"])
    k = qk_norm(k, P[p + "self_attn.k_rms_norm.gamma"])
    att = ops.attention(q, k, v, hd ** -0.5).reshape(B, N, C)
    x = x + g_sa[:, None, :] * _lin(P, p + "self_attn.to_out", att)

    h = ops.layer_norm(x, P[p + "norm2.weight"], P[p + "norm2.bias"])
    q = _lin(P, p + "cross_attn.to_q", h).reshape(B, N, heads, hd)
    k, v = _lin(P, p + "cross_attn.to_kv", y).reshape(
        B, -1, 2, heads, hd).unbind(2)
    att = ops.attention(q, k, v, hd ** -0.5).reshape(B, N, C)
    x = x + _lin(P, p + "cross_attn.to_out", att)

    h = _modulate(x, s_mlp, sc_mlp)
    h = _lin(P, p + "mlp.mlp.2", ops.gelu_tanh(_lin(P, p + "mlp.mlp.0", h)))
    return x + g_mlp[:, None, :] * h


def depth_of(P: dict) -> int:
    return 1 + max(int(k.split(".")[1]) for k in P if k.startswith("blocks."))


def forward(P: dict, x, t, y, heads: int, block_fn=None):
    """x [B, 8, R, R, R], t [B] (1000 times the flow time), y [B, M, Cc]
    -> [B, 8, R, R, R] f32. ``block_fn`` wraps each block's call."""
    B, cin, R = x.shape[0], x.shape[1], x.shape[2]
    h = _lin(P, "input_layer", x.float().reshape(B, cin, -1).transpose(1, 2))
    h = h + position_embedding(R, h.shape[-1], h.device)[None]
    t_emb = _lin(P, "t_embedder.mlp.2", F.silu(_lin(
        P, "t_embedder.mlp.0", timestep_embedding(t))))
    c = F.silu(t_emb)
    y = y.float()
    run = block_fn or (lambda f, *a: f(*a))
    for i in range(depth_of(P)):
        h = run(block, P, i, h, c, y, heads)
    out = _lin(P, "out_layer", ops.layer_norm(h, eps=1e-5))
    return out.transpose(1, 2).reshape(B, -1, R, R, R)


def training_loss(P: dict, x0, y, t, noise, drop, heads: int,
                  block_fn=None, sigma_min: float = SIGMA_MIN):
    """[B] mean squared error of the velocity at flow times ``t`` [B] in
    (0, 1); rows where ``drop`` is True see zero conditioning."""
    y = torch.where(drop[:, None, None], torch.zeros_like(y.float()),
                    y.float())
    x0, noise = x0.float(), noise.float()
    tb = t.float().reshape(-1, 1, 1, 1, 1)
    x_t = (1 - tb) * x0 + (sigma_min + (1 - sigma_min) * tb) * noise
    pred = forward(P, x_t, t.float() * 1000, y, heads, block_fn)
    err = (pred - ((1 - sigma_min) * noise - x0)) ** 2
    return err.reshape(err.shape[0], -1).mean(dim=1)


def _ckpt(f, *args):
    return checkpoint(f, *args, use_reentrant=False)


_KEYS = ("x", "y", "t", "noise", "drop")


def gradient(P: dict, batch: dict, heads: int):
    """(mean loss, {name: gradient}) of one batch, one sample at a time,
    every block under checkpointing."""
    params = {k: v.detach().float().requires_grad_() for k, v in P.items()}
    B = batch["x"].shape[0]
    total = 0.0
    for b in range(B):
        rows = [batch[k][b:b + 1] for k in _KEYS]
        loss = training_loss(params, *rows, heads, block_fn=_ckpt).sum() / B
        loss.backward()
        total += float(loss.detach())
    return total, {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                   for k, v in params.items()}


@torch.no_grad()
def loss(P: dict, batch: dict, heads: int) -> float:
    """The mean loss of one batch, one sample at a time, no gradient."""
    B = batch["x"].shape[0]
    return sum(float(training_loss(
        P, *(batch[k][b:b + 1] for k in _KEYS), heads).sum())
        for b in range(B)) / B
