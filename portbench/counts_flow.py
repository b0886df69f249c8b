"""The yardstick's arithmetic for TRELLIS's sparse-structure flow
transformer: the model FLOPs of its training step and the bytes its QK
norm needs, from the shapes, whatever implements them (``counts.py`` has
the peaks and the attention counts)."""

from __future__ import annotations


def forward_flops(batch: int, depth: int, hidden: int, n: int, m: int,
                  cond_dim: int, in_channels: int = 8, out_channels: int = 8,
                  mlp_ratio: float = 4.0, freq_dim: int = 256) -> float:
    """FLOPs (2 per multiply-add) of the products of the forward for
    ``batch`` samples of ``n`` tokens against ``m`` conditioning tokens:
    the input layer, the timestep MLP, per block the six-way adaLN, fused
    qkv, self-attention, its output projection, the cross-attention's q,
    its K/V of every sample's conditioning (projected every step), the
    attention over ``m`` keys and its output projection, and the MLP; the
    output layer. The QK norm and the LNs are no products. At the
    published shapes (24 x 1024, 4096 tokens, 1374 keys of 1024): 5.23
    TFLOP a sample."""
    d, b = hidden, batch
    block = (2 * b * d * 6 * d                     # adaLN
             + 2 * b * n * d * 3 * d               # qkv
             + 4 * b * n * n * d                   # self-attention
             + 2 * b * n * d * d                   # its output projection
             + 2 * b * n * d * d                   # cross q
             + 2 * 2 * b * m * cond_dim * d        # cross K/V
             + 4 * b * n * m * d                   # cross-attend
             + 2 * b * n * d * d                   # its output projection
             + 2 * 2 * b * n * d * int(mlp_ratio * d))   # MLP
    embed = 2 * b * n * in_channels * d + 2 * b * (freq_dim * d + d * d)
    return float(depth * block + embed + 2 * b * n * d * out_channels)


def train_step_flops(*args, **kw) -> float:
    """Model FLOPs of a training step: three times the forward (the
    backward's products are twice the forward's), no recomputation."""
    return 3.0 * forward_flops(*args, **kw)


def qk_norm_bytes(batch: int, n: int, heads: int, head_dim: int,
                  elem: int = 2) -> tuple[float, float]:
    """(forward, backward) bytes of one QK-norm call on q or k [batch, n,
    heads, head_dim]: the forward reads x and writes y once in
    ``elem``-byte elements and reads the f32 gains; the backward reads x
    and dy and writes dx, reads the gains and writes their f32 gradient."""
    rows = batch * n * heads * head_dim
    gains = 4.0 * heads * head_dim
    return elem * 2.0 * rows + gains, elem * 3.0 * rows + 2 * gains
