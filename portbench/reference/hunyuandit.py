"""Hunyuan3D-2.1's shape DiT in plain float32, from its checkpoint names,
with the rectified-flow loss and gradient the benchmark's cell assumes.

Written from the published module (github.com/Tencent-Hunyuan/Hunyuan3D-2.1,
``hy3dshape/models/denoisers/hunyuandit.py``: ``HunYuanDiTPlain``,
``HunYuanDiTBlock``, ``Attention``, ``CrossAttention``, ``MLP``,
``TimestepEmbedder``, ``FinalLayer``; ``moe_layers.py``: ``MoEBlock``,
``MoEGate``, ``AddAuxiliaryLoss``; config ``hunyuan3d-dit-v2-1/config.yaml``).
``t_embedder``: the sinusoid of t at width C, cos before sin, then
``mlp.0``, exact GELU, ``mlp.2``; its [B, 1, C] output put before
``x_embedder`` of the latents [B, N, 64]. Per block ``blocks.<i>.``, every
LN affine at eps 1e-6: after the middle block ``depth // 2``,
``skip_norm(skip_linear(cat[skip, x]))`` with the skip popped from the
outputs the blocks before the middle pushed; ``x + attn1(norm1(x))``,
``x + attn2(norm2(x), y)``, ``x + FFN(norm3(x))``. The attentions: ``to_q``,
``to_k``, ``to_v`` (no bias at ``qkv_bias`` false), the heads split from
the joined projections as the release splits them (self: ``cat[q, k, v]``
viewed [B, N, H, 3D], each head's three D-wide thirds; cross: ``cat[k,
v]`` viewed [B, M, H, 2D]), q and k times rsqrt(mean(x^2) + 1e-6) times
``q_norm.weight`` / ``k_norm.weight``, softmax at head_dim^-0.5,
``out_proj``. The FFN: ``mlp.fc1``, exact GELU, ``mlp.fc2``; in the last
MoE blocks ``moe``: the gate's softmax over ``moe.gate.weight``, the top
2 by score with their raw scores as weights, each expert
``experts.<e>.net.0.proj``, exact GELU, ``net.2`` run as a loop over its
own token slots (the release's training branch), the weighted sum, plus
``shared_experts``. The final layer: ``final_layer.norm_final``, the time
token dropped, ``final_layer.linear``.

The auxiliary loss (``MoEGate`` in training, alpha 0.01): ``aux = alpha
sum_e P_e f_e`` over a batch's tokens (P_e the mean gate score, f_e E
times the share of the top-2 slots that went to expert e, no gradient),
whose gradient ``AddAuxiliaryLoss`` adds at weight 1 to the backward. It
couples a batch's samples; ``gradient`` runs one sample at a time, so it
takes each layer's f_e from a first pass over the batch without a
gradient (``route_shares``), and each sample adds its own share of P_e
(its tokens' scores over the batch's token count).

Departures from the published module: everything in float32 (the release
runs fp16); the model embeds ``t / 1000`` for the caller's 1000 t (the
release's pipeline hands it the flow time itself); the loss is the one the
cell assumes (the release's trainer is not the port's): x_t = (1 - t) x0
+ t eps, the mean squared error against eps - x0; a dropped row's
conditioning is zeros (the release's unconditional embedding).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import ops
from .dit import timestep_embedding

ALPHA = 0.01        # MoEGate's aux_loss_alpha
TOP_K = 2           # the config's moe_top_k
TIME_SCALE = 1000.0


class AddAuxiliaryLoss(torch.autograd.Function):
    """Returns x; the backward hands ``loss`` a gradient of 1."""

    @staticmethod
    def forward(ctx, x, loss):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        return dx, torch.ones((), dtype=dx.dtype, device=dx.device)


def _lin(P, name, x):
    return ops.linear(x, P[name + ".weight"], P.get(name + ".bias"))


def _ln(P, name, x):
    return ops.layer_norm(x, P[name + ".weight"], P[name + ".bias"])


def qk_norm(P, name, x):
    """x [B, N, H, D] times rsqrt(mean over D of x^2 + 1e-6), times the gain
    [D] every head shares."""
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) \
        * P[name + ".weight"].float()


def attention(P, p, x, heads, y=None):
    """The self-attention (``y`` None) or the cross-attention to y."""
    B, N, C = x.shape
    D = C // heads
    if y is None:
        q, k, v = torch.cat([_lin(P, p + n, x) for n in ("to_q", "to_k", "to_v")],
                            -1).view(B, N, heads, 3 * D).split(D, dim=-1)
    else:
        q = _lin(P, p + "to_q", x).view(B, N, heads, D)
        k, v = torch.cat([_lin(P, p + n, y) for n in ("to_k", "to_v")],
                         -1).view(B, y.shape[1], heads, 2 * D).split(D, dim=-1)
    att = ops.attention(qk_norm(P, p + "q_norm", q), qk_norm(P, p + "k_norm", k),
                        v, D ** -0.5)
    return _lin(P, p + "out_proj", att.reshape(B, N, C))


def ffn(P, p, x):
    """Linear, exact GELU, Linear: ``<p>fc1`` / ``<p>fc2`` or ``<p>net.0.proj``
    / ``<p>net.2``."""
    first, second = (("fc1", "fc2") if p + "fc1.weight" in P
                     else ("net.0.proj", "net.2"))
    return _lin(P, p + second, F.gelu(_lin(P, p + first, x)))


def experts_of(P, p) -> int:
    return P[p + "gate.weight"].shape[0]


def moe(P, p, x, routing: dict | None):
    """The mixture of experts on x [B, L, C]. ``routing``: {"counts": {p:
    slots by expert}} collects the slots (no auxiliary loss); {"shares":
    {p: f_e}, "tokens": the batch's token count} adds this call's share of
    the auxiliary loss's gradient."""
    B, L, C = x.shape
    E, flat = experts_of(P, p), x.reshape(-1, C).float()
    scores = torch.softmax(_lin(P, p + "gate", flat), dim=-1)
    weights, chosen = torch.topk(scores, TOP_K, dim=-1)
    slots = chosen.reshape(-1)
    xr = flat.repeat_interleave(TOP_K, dim=0)
    out = torch.zeros_like(xr)
    for e in range(E):
        mask = slots == e
        if bool(mask.any()):
            out[mask] = ffn(P, f"{p}experts.{e}.", xr[mask])
    y = (out.view(-1, TOP_K, C) * weights[..., None]).sum(1)
    if routing is not None and "counts" in routing:
        seen = routing["counts"].get(p, 0)
        routing["counts"][p] = seen + torch.bincount(slots, minlength=E)
    elif routing is not None and torch.is_grad_enabled():
        aux = ALPHA * (routing["shares"][p] * scores.sum(0)).sum() \
            / routing["tokens"]
        y = AddAuxiliaryLoss.apply(y, aux)
    return (y + ffn(P, p + "shared_experts.", flat)).view(B, L, C)


def block(P: dict, i: int, x, y, skip, heads: int, routing=None):
    """One block on x [B, L, C]; ``skip`` [B, L, C] after the middle."""
    p = f"blocks.{i}."
    if skip is not None:
        x = _ln(P, p + "skip_norm",
                _lin(P, p + "skip_linear", torch.cat([skip, x], dim=-1)))
    x = x + attention(P, p + "attn1.", _ln(P, p + "norm1", x), heads)
    x = x + attention(P, p + "attn2.", _ln(P, p + "norm2", x), heads, y)
    h = _ln(P, p + "norm3", x)
    if p + "moe.gate.weight" in P:
        return x + moe(P, p + "moe.", h, routing)
    return x + ffn(P, p + "mlp.", h)


def depth_of(P: dict) -> int:
    return 1 + max(int(k.split(".")[1]) for k in P if k.startswith("blocks."))


def forward(P: dict, x, t, y, heads: int, block_fn=None, routing=None):
    """x [B, N, 64], t [B] (1000 times the flow time), y [B, M, 1024] ->
    [B, N, 64] f32. ``block_fn`` wraps each block's call."""
    run = block_fn or (lambda f, *a: f(*a))
    C = P["x_embedder.weight"].shape[0]
    c = _lin(P, "t_embedder.mlp.2", F.gelu(_lin(
        P, "t_embedder.mlp.0", timestep_embedding(t.float() / TIME_SCALE, C))))
    h = torch.cat([c[:, None], _lin(P, "x_embedder", x.float())], dim=1)
    y = y.float()
    depth, skips = depth_of(P), []
    for i in range(depth):
        h = run(block, P, i, h, y, skips.pop() if i > depth // 2 else None,
                heads, routing)
        if i < depth // 2:
            skips.append(h)
    return _lin(P, "final_layer.linear",
                _ln(P, "final_layer.norm_final", h)[:, 1:])


def training_loss(P: dict, x0, y, t, noise, drop, heads: int, block_fn=None,
                  routing=None):
    """[B] mean squared error of the velocity at flow times ``t`` [B] in
    (0, 1); rows where ``drop`` is True see zero conditioning."""
    y = torch.where(drop[:, None, None], torch.zeros_like(y.float()),
                    y.float())
    x0, noise = x0.float(), noise.float()
    tb = t.float().reshape(-1, 1, 1)
    x_t = (1 - tb) * x0 + tb * noise
    pred = forward(P, x_t, t.float() * 1000, y, heads, block_fn, routing)
    err = (pred - (noise - x0)) ** 2
    return err.reshape(err.shape[0], -1).mean(dim=1)


def _ckpt(f, *args):
    return checkpoint(f, *args, use_reentrant=False)


_KEYS = ("x", "y", "t", "noise", "drop")


@torch.no_grad()
def route_shares(P: dict, batch: dict, heads: int) -> dict:
    """{MoE prefix: f_e [E]} of a batch: E times the share of the batch's
    top-2 slots that went to each expert, from one pass a sample without
    a gradient."""
    counts: dict = {}
    for b in range(batch["x"].shape[0]):
        training_loss(P, *(batch[k][b:b + 1] for k in _KEYS), heads,
                      routing={"counts": counts})
    return {p: c.float() * (len(c) / c.sum()) for p, c in counts.items()}


def gradient(P: dict, batch: dict, heads: int):
    """(mean loss, {name: gradient}) of one batch with the auxiliary loss's
    gradient, one sample at a time, every block under checkpointing."""
    shares = route_shares(P, batch, heads)
    params = {k: v.detach().float().requires_grad_() for k, v in P.items()}
    B = batch["x"].shape[0]
    routing = {"shares": shares,
               "tokens": B * (batch["x"].shape[1] + 1)}
    total = 0.0
    for b in range(B):
        rows = [batch[k][b:b + 1] for k in _KEYS]
        loss = training_loss(params, *rows, heads, block_fn=_ckpt,
                             routing=routing).sum() / B
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
