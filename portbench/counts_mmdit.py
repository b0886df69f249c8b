"""The yardstick's arithmetic for Hunyuan3D-2's shape DiT: the model FLOPs
of its training step and the bytes its QK norm needs, from the shapes,
whatever implements them (``counts.py`` has the peaks and the attention
counts; ``counts_flow.qk_norm_bytes`` the bytes of one QK-norm call)."""

from __future__ import annotations

from .counts_flow import qk_norm_bytes


def forward_flops(batch: int, depth: int, single_depth: int, hidden: int,
                  n: int, m: int, cond_dim: int, in_channels: int = 64,
                  mlp_ratio: float = 4.0, freq_dim: int = 256) -> float:
    """FLOPs (2 per multiply-add) of the products of the forward for
    ``batch`` samples of ``n`` latent tokens and ``m`` conditioning tokens
    (L = n + m joined): the latent and conditioning input layers, the
    timestep MLP; per double block two six-way modulations, both streams'
    qkv, the joint attention over L keys, both output projections and both
    MLPs; per single block the three-way modulation, ``linear1`` (qkv and
    the MLP's input), the attention and ``linear2``; the final layer's
    modulation and projection of the n latent tokens. The QK norm and the
    LNs are no products. At the published shapes (16 double and 32 single
    blocks of 1024, 3072 + 1370 tokens, 1536-wide conditioning): 9.25
    TFLOP a sample, 41.9% of it attention."""
    d, b, L = hidden, batch, n + m
    f = int(mlp_ratio * d)
    attn = 4 * b * L * L * d
    double = (2 * 2 * b * d * 6 * d           # modulations
              + 2 * b * L * d * 3 * d         # qkv
              + attn
              + 2 * b * L * d * d             # output projections
              + 2 * 2 * b * L * d * f)        # MLPs
    single = (2 * b * d * 3 * d               # modulation
              + 2 * b * L * d * (3 * d + f)   # linear1
              + attn
              + 2 * b * L * (d + f) * d)      # linear2
    embed = (2 * b * n * in_channels * d + 2 * b * (freq_dim * d + d * d)
             + 2 * b * m * cond_dim * d)
    final = 2 * b * d * 2 * d + 2 * b * n * d * in_channels
    return float(depth * double + single_depth * single + embed + final)


def train_step_flops(*args, **kw) -> float:
    """Model FLOPs of a training step: three times the forward (the
    backward's products are twice the forward's), no recomputation."""
    return 3.0 * forward_flops(*args, **kw)


def step_qk_norm_bytes(batch: int, depth: int, single_depth: int, n: int,
                       m: int, heads: int, head_dim: int) -> float:
    """Bytes the QK norm needs in a training step, forward and backward: q
    and k of each stream of each double block ([batch, n] and [batch, m]
    tokens) and of each single block ([batch, n + m])."""
    def both(tokens):
        return sum(qk_norm_bytes(batch, tokens, heads, head_dim))

    return 2.0 * (depth * (both(n) + both(m)) + single_depth * both(n + m))
