"""Hunyuan3D-2's shape DiT in plain float32, from its checkpoint names,
with the rectified-flow loss and gradient the benchmark's cell assumes.

Written from the published module (github.com/Tencent/Hunyuan3D-2,
``hy3dgen/shapegen/models/denoisers/hunyuan3ddit.py``: ``Hunyuan3DDiT``,
``DoubleStreamBlock``, ``SingleStreamBlock``, ``LastLayer``, ``QKNorm``,
``RMSNorm``, ``Modulation``, ``MLPEmbedder``; config
``hunyuan3d-dit-v2-0/config.yaml``). ``latent_in`` on the latent set
[B, N, 64], ``cond_in`` on the image tokens [B, M, 1536], ``vec`` =
``time_in`` (in_layer, SiLU, out_layer) of the 256-frequency embedding of
1000 t, cos before sin. Per double block (``double_blocks.<i>.``), for
each stream s of ``img`` (latents) and ``txt`` (conditioning): a six-way
``<s>_mod.lin`` of SiLU(vec) (shift, scale, gate of the attention, then of
the MLP), ``LN(x) * (1 + scale) + shift`` into ``<s>_attn.qkv``, q and k
each times rsqrt(mean(x^2) + 1e-6) times its ``norm.query_norm.scale`` /
``norm.key_norm.scale``; the two streams' q, k, v joined, conditioning
first, into one attention, split back; each stream adds its gated
``<s>_attn.proj`` and its gated MLP (``<s>_mlp.0``, GELU(tanh),
``<s>_mlp.2``) of its modulated LN. The streams are then joined,
conditioning first; per single block (``single_blocks.<i>.``): a
three-way ``modulation.lin``, ``linear1`` of the modulated LN split into
qkv and the MLP's input, the QK norm, attention, ``linear2`` on the
attention output beside GELU(tanh) of the MLP input, gated. The final
layer on the latent tokens: ``LN * (1 + scale) + shift`` by the two-way
``final_layer.adaLN_modulation.1``, then ``final_layer.linear``. Every LN
affine-free at eps 1e-6; attention at head_dim^-0.5; no position
embedding.

Departures from the published module: everything in float32 (the release
runs fp16); the RMS norm's one rounding after the gain is no rounding
here; ``time_factor`` is outside (the caller passes 1000 t); the loss is
the one the cell assumes (the release ships no trainer): x_t = (1 - t) x0
+ t eps, the model at 1000 t, the mean squared error against eps - x0; a
dropped row's conditioning is zeros (the release's unconditional
embedding).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import ops
from .dit import timestep_embedding


def _lin(P, name, x):
    return ops.linear(x, P[name + ".weight"], P.get(name + ".bias"))


def _modulate(x, shift, scale):
    return ops.layer_norm(x) * (1 + scale[:, None, :]) + shift[:, None, :]


def qk_norm(x, scale):
    """x [B, N, H, D] times rsqrt(mean over D of x^2 + 1e-6), times the
    gain [D] every head shares."""
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * scale.float()


def _heads(P, p, qkv, heads):
    B, N, C3 = qkv.shape
    q, k, v = qkv.reshape(B, N, 3, heads, C3 // 3 // heads).unbind(2)
    return (qk_norm(q, P[p + "norm.query_norm.scale"]),
            qk_norm(k, P[p + "norm.key_norm.scale"]), v)


def double_block(P: dict, i: int, img, txt, c, heads: int):
    """One double block: img [B, N, C], txt [B, M, C], c = SiLU(vec)."""
    p = f"double_blocks.{i}."
    M = txt.shape[1]
    mods, qs, ks, vs = {}, [], [], []
    for s, x in (("txt", txt), ("img", img)):
        mods[s] = _lin(P, f"{p}{s}_mod.lin", c).chunk(6, dim=-1)
        h = _modulate(x, mods[s][0], mods[s][1])
        q, k, v = _heads(P, f"{p}{s}_attn.", _lin(P, f"{p}{s}_attn.qkv", h),
                         heads)
        qs.append(q)
        ks.append(k)
        vs.append(v)
    q, k, v = (torch.cat(t, dim=1) for t in (qs, ks, vs))
    att = ops.attention(q, k, v, q.shape[-1] ** -0.5).flatten(2)
    out = []
    for s, x, a in (("img", img, att[:, M:]), ("txt", txt, att[:, :M])):
        m = mods[s]
        x = x + m[2][:, None, :] * _lin(P, f"{p}{s}_attn.proj", a)
        h = _modulate(x, m[3], m[4])
        h = _lin(P, f"{p}{s}_mlp.2", ops.gelu_tanh(_lin(P, f"{p}{s}_mlp.0", h)))
        out.append(x + m[5][:, None, :] * h)
    return tuple(out)


def single_block(P: dict, i: int, x, c, heads: int):
    """One single block on the joined sequence x [B, M + N, C]."""
    p = f"single_blocks.{i}."
    C = x.shape[-1]
    shift, scale, gate = _lin(P, p + "modulation.lin", c).chunk(3, dim=-1)
    h = _lin(P, p + "linear1", _modulate(x, shift, scale))
    q, k, v = _heads(P, p, h[..., :3 * C], heads)
    att = ops.attention(q, k, v, q.shape[-1] ** -0.5).flatten(2)
    out = _lin(P, p + "linear2",
               torch.cat([att, ops.gelu_tanh(h[..., 3 * C:])], dim=-1))
    return x + gate[:, None, :] * out


def depth_of(P: dict, kind: str) -> int:
    return 1 + max(int(k.split(".")[1]) for k in P if k.startswith(kind + "."))


def forward(P: dict, x, t, y, heads: int, block_fn=None):
    """x [B, N, 64], t [B] (1000 times the flow time), y [B, M, 1536] ->
    [B, N, 64] f32. ``block_fn`` wraps each block's call."""
    run = block_fn or (lambda f, *a: f(*a))
    img = _lin(P, "latent_in", x.float())
    vec = _lin(P, "time_in.out_layer", F.silu(_lin(
        P, "time_in.in_layer", timestep_embedding(t))))
    c = F.silu(vec)
    txt = _lin(P, "cond_in", y.float())
    for i in range(depth_of(P, "double_blocks")):
        img, txt = run(double_block, P, i, img, txt, c, heads)
    h = torch.cat([txt, img], dim=1)
    for i in range(depth_of(P, "single_blocks")):
        h = run(single_block, P, i, h, c, heads)
    shift, scale = _lin(P, "final_layer.adaLN_modulation.1", c).chunk(2, dim=-1)
    return _lin(P, "final_layer.linear",
                _modulate(h[:, txt.shape[1]:], shift, scale))


def training_loss(P: dict, x0, y, t, noise, drop, heads: int, block_fn=None):
    """[B] mean squared error of the velocity at flow times ``t`` [B] in
    (0, 1); rows where ``drop`` is True see zero conditioning."""
    y = torch.where(drop[:, None, None], torch.zeros_like(y.float()),
                    y.float())
    x0, noise = x0.float(), noise.float()
    tb = t.float().reshape(-1, 1, 1)
    x_t = (1 - tb) * x0 + tb * noise
    pred = forward(P, x_t, t.float() * 1000, y, heads, block_fn)
    err = (pred - (noise - x0)) ** 2
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
