"""The yardstick's arithmetic for Hunyuan3D-2.1's shape DiT: the model
FLOPs of its training step, those of its routed experts, and the bytes its
QK norm needs, from the shapes, whatever implements them (``counts.py``
has the peaks and the attention counts; ``counts_flow.qk_norm_bytes`` the
bytes of one QK-norm call)."""

from __future__ import annotations

from .counts_flow import qk_norm_bytes


def expert_flops(batch: int, moe_layers: int, hidden: int, tokens: int,
                 top_k: int = 2, ffn: int | None = None) -> float:
    """FLOPs of the routed experts' two products in the forward: each of
    the ``batch * tokens`` tokens through ``top_k`` experts of
    hidden -> ffn -> hidden, in each of ``moe_layers`` layers."""
    f = ffn or 4 * hidden
    return float(moe_layers * 2 * 2 * batch * tokens * top_k * hidden * f)


def forward_flops(batch: int, depth: int, moe_layers: int, hidden: int,
                  n: int, m: int, cond_dim: int, in_channels: int = 64,
                  experts: int = 8, top_k: int = 2) -> float:
    """FLOPs (2 per multiply-add) of the products of the forward for
    ``batch`` samples of ``n`` latent tokens (L = n + 1 with the time
    token) against ``m`` conditioning tokens: the latent embedding, the
    time embedding's MLP (C -> 4C -> C); per block the self-attention's q,
    k, v and output projections and its attention over L keys, the
    cross-attention's q and output projections, its K/V of every sample's
    conditioning and its attention over ``m`` keys; the long skip's
    ``skip_linear`` (2C -> C) in the ``depth // 2`` blocks after the middle;
    the dense MLP (C -> 4C -> C) in the first ``depth - moe_layers`` blocks,
    in the others the gate (C -> E), the ``top_k`` routed experts and the
    shared expert (each C -> 4C -> C); the final projection of the n
    latent tokens. The QK norm, the LNs and the routing's sort are no
    products. At the configuration's shapes (13 blocks of 2048, 4 of them
    MoE, 4096 + 1 tokens, 1370 keys of 1024): 11.4 TFLOP a sample, of it
    28.9% the MoE FFNs and 20.9% attention."""
    d, b, L = hidden, batch, n + 1
    f = 4 * d
    attn = 2 * b * L * d * 3 * d + 4 * b * L * L * d + 2 * b * L * d * d
    cross = (2 * b * L * d * d + 2 * 2 * b * m * cond_dim * d
             + 4 * b * L * m * d + 2 * b * L * d * d)
    dense = 2 * 2 * b * L * d * f
    moe = (2 * b * L * d * experts + expert_flops(b, 1, d, L, top_k, f)
           + 2 * 2 * b * L * d * f)
    skips = depth // 2 * 2 * b * L * 2 * d * d
    embed = 2 * b * n * in_channels * d + 2 * b * (d * f + f * d)
    final = 2 * b * n * d * in_channels
    return float(depth * (attn + cross) + (depth - moe_layers) * dense
                 + moe_layers * moe + skips + embed + final)


def train_step_flops(*args, **kw) -> float:
    """Model FLOPs of a training step: three times the forward (the
    backward's products are twice the forward's), no recomputation."""
    return 3.0 * forward_flops(*args, **kw)


def step_qk_norm_bytes(batch: int, depth: int, n: int, m: int, heads: int,
                       head_dim: int) -> float:
    """Bytes the QK norm needs in a training step, forward and backward: in
    each block q and k of the self-attention and q of the cross-attention
    over [batch, n + 1] tokens, the cross-attention's k over [batch, m]."""
    def both(tokens):
        return sum(qk_norm_bytes(batch, tokens, heads, head_dim))

    return float(depth * (3 * both(n + 1) + both(m)))
