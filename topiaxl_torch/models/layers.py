"""Shared building blocks (counterparts of ``topiaxl/models/layers.py``).

Reference torch key layout (``topiaxl/core/convert.py``): every module
here names its parameters the way the released checkpoints do, so a
reference state_dict loads with ``load_state_dict(strict=True)``.

Mixed precision as in the JAX package (flax's ``dtype`` and
``param_dtype``): a matmul layer holds its weights in ``param_dtype`` and
computes in ``dtype``, casting weight, bias and input to it at each call
(explicit casts, not ``torch.autocast``, so the numerics follow the JAX
modules). Serving holds the weights in the compute dtype (bf16), so the
casts are no-ops; training holds f32 master weights. LayerNorm
statistics, softmax and the timestep/adaLN MLPs stay f32.

Models are built on the ``meta`` device and materialised by
``materialize_``: parameters are filled from an explicit
``torch.Generator`` (never the global RNG) or later overwritten by
``load_state_dict``.

Tensor parallelism (``parallel/sharding.py:shard_params``): a split
``SelfAttention``, ``CrossAttention`` or ``Mlp`` holds ``tp_parts``-th of
its heads or hidden units and the ``tp_group`` they are split over. Its
input enters through ``copy_to_tp`` (the gradient summed over the group),
its column-parallel projections (``qkv``, ``to_q``/``to_k``/``to_v``,
``fc1``) make this rank's heads or units, and its row-parallel one
(``proj``, ``fc2``) makes a partial product that ``reduce_from_tp`` sums,
the bias added once after the sum. Attention runs on the local heads.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention
from ..ops.int8 import QuantDense
from ..ops.qk_norm import qk_rms_norm
from ..parallel.collectives import copy_to_tp, reduce_from_tp

META = torch.device("meta")


class Dense(nn.Linear):
    """``nn.Linear`` with weights in ``param_dtype`` computing in
    ``dtype``: weight, bias and input are cast to ``dtype`` at each call
    (no-ops when the two agree), as flax's ``nn.Dense`` does."""

    def __init__(self, in_f: int, out_f: int, bias: bool = True,
                 dtype=torch.float32, param_dtype=None):
        super().__init__(in_f, out_f, bias=bias, device=META,
                         dtype=param_dtype or dtype)
        self.compute_dtype = dtype

    def operands(self, x: torch.Tensor):
        """(x, weight, bias) cast to the compute dtype."""
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return x.to(dt), self.weight.to(dt), bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(*self.operands(x))


@torch.library.custom_op("topiaxl_torch::mlp_fc1", mutates_args=())
def mlp_fc1(x: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor | None) -> torch.Tensor:
    """The MLP's fc1 pre-activation ``F.linear(x, weight, bias)`` as a
    registered op: the name the ``flash_mlp`` and ``dots`` remat policies
    keep (``models/dit.py``), the counterpart of the JAX MLP's
    ``checkpoint_name(x, "mlp_fc1")``. The product is PyTorch's own, as in
    JAX, where it runs outside Pallas."""
    return F.linear(x, weight, bias)


def _mlp_fc1_setup(ctx, inputs, output):
    x, weight, bias = inputs
    ctx.save_for_backward(x, weight)
    ctx.has_bias = bias is not None


def _mlp_fc1_backward(ctx, g):
    x, weight = ctx.saved_tensors
    g2 = g.reshape(-1, g.shape[-1])
    return (g @ weight, g2.t() @ x.reshape(-1, x.shape[-1]),
            g2.sum(0) if ctx.has_bias else None)


mlp_fc1.register_autograd(_mlp_fc1_backward, setup_context=_mlp_fc1_setup)


def linear(in_f: int, out_f: int, bias: bool = True, dtype=torch.float32,
           param_dtype=None) -> Dense:
    return Dense(in_f, out_f, bias=bias, dtype=dtype, param_dtype=param_dtype)


def _dense(quant: bool):
    """The matmul layer: W8A8 ``QuantDense`` when serving int8 (it has no
    ``param_dtype``: serving holds no master weights)."""
    if not quant:
        return linear

    def make(in_f, out_f, bias=True, dtype=torch.float32, param_dtype=None):
        return QuantDense(in_f, out_f, bias=bias, dtype=dtype)
    return make


def row_parallel(dense: nn.Module, x: torch.Tensor, group) -> torch.Tensor:
    """``dense(x)`` where ``dense`` holds this rank's input columns: the
    partial products summed over ``group``, then the bias."""
    if group is None:
        return dense(x)
    dt = dense.compute_dtype
    out = reduce_from_tp(F.linear(x.to(dt), dense.weight.to(dt)), group)
    return out if dense.bias is None else out + dense.bias.to(dt)


def xavier_(w: torch.Tensor, gen: torch.Generator) -> None:
    fan_out, fan_in = w.shape[0], w[0].numel()
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    w.uniform_(-bound, bound, generator=gen)


def lecun_(w: torch.Tensor, gen: torch.Generator) -> None:
    w.normal_(0.0, 1.0 / math.sqrt(w[0].numel()), generator=gen)


@torch.no_grad()
def materialize_(module: nn.Module, device, generator: torch.Generator | None,
                 init) -> None:
    """Allocate a meta-built module on ``device`` and fill it with
    ``init(module, generator)``; the generator defaults to seed 0 on
    ``device``."""
    device = torch.device(device if device is not None else "cpu")
    module.to_empty(device=device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    init(module, generator)


@torch.no_grad()
def default_init_(module: nn.Module, gen: torch.Generator) -> None:
    """Xavier-uniform linear weights, LeCun-normal conv weights, zero
    biases, unit norm gains (the JAX package's initialisers); a
    ``QuantDense`` takes the quantized form of a xavier weight."""
    for m in module.modules():
        if isinstance(m, QuantDense):
            w = torch.empty(m.out_features, m.in_features,
                            device=m.weight_q.device)
            xavier_(w, gen)
            m.set_float_weight_(w, None)
            continue
        if isinstance(m, nn.Linear):
            xavier_(m.weight, gen)
        elif isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
            lecun_(m.weight, gen)
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor):
    """adaLN modulation ``x * (1 + scale) + shift`` over tokens."""
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000):
    """Sinusoidal timestep embedding, cos before sin."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class TimestepEmbedder(nn.Module):
    """freq(256) -> Linear -> SiLU -> Linear, in f32 (keys ``mlp.0``/``mlp.2``)."""

    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.mlp = nn.Sequential(
            linear(frequency_embedding_size, hidden_size), nn.SiLU(),
            linear(hidden_size, hidden_size))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.mlp(timestep_embedding(t, self.frequency_embedding_size))


class Mlp(nn.Module):
    """fc1 -> GELU(tanh) -> fc2 in the compute dtype (both W8A8 when
    ``quant``). Under autograd fc1 runs as the op ``mlp_fc1``; without a
    gradient, as the layer itself."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, dtype=torch.bfloat16,
                 approximate: str = "tanh", param_dtype=None,
                 quant: bool = False):
        super().__init__()
        dense = _dense(quant)
        self.fc1 = dense(in_features, hidden_features, dtype=dtype,
                         param_dtype=param_dtype)
        self.fc2 = dense(hidden_features, out_features, dtype=dtype,
                         param_dtype=param_dtype)
        self.approximate = approximate
        self.tp_group, self.tp_parts = None, 1

    def forward(self, x):
        x = copy_to_tp(x, self.tp_group)
        if isinstance(self.fc1, Dense) and torch.is_grad_enabled() and (
                x.requires_grad or self.fc1.weight.requires_grad):
            h = mlp_fc1(*self.fc1.operands(x))
        else:
            h = self.fc1(x)
        return row_parallel(self.fc2, F.gelu(h, approximate=self.approximate),
                            self.tp_group)


class MultiHeadRMSNorm(nn.Module):
    """Per-head RMS norm of queries or keys [B, N, H, D] (TRELLIS's
    ``MultiHeadRMSNorm``, key ``gamma`` [H, D], ones at init): each head's
    vector over its L2 norm, times ``gamma[h] * sqrt(D)``, in f32
    (``ops/qk_norm.py``)."""

    def __init__(self, head_dim: int, num_heads: int, param_dtype=None,
                 dtype=torch.bfloat16):
        super().__init__()
        self.scale = head_dim ** 0.5
        self.gamma = nn.Parameter(torch.empty(num_heads, head_dim, device=META,
                                              dtype=param_dtype or dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return qk_rms_norm(x, self.gamma.float(), self.scale)


class RMSNorm(nn.Module):
    """RMS norm of each head of queries or keys [B, N, H, D] with one gain
    vector shared by the heads (FLUX's ``RMSNorm`` in its ``QKNorm``, key
    ``scale`` [D], ones at init): ``x * rsqrt(mean(x^2) + 1e-6) * scale``,
    in f32 (``ops/qk_norm.py``'s "rms" form; the gain is handed to it
    expanded over the heads, so its gradient sums over them)."""

    def __init__(self, dim: int, param_dtype=None, dtype=torch.bfloat16):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(dim, device=META,
                                              dtype=param_dtype or dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gain = self.scale.float().expand(x.shape[2], -1).contiguous()
        return qk_rms_norm(x, gain, 1.0, form="rms")


class SelfAttention(nn.Module):
    """Fused-QKV self-attention (keys ``qkv``, ``proj``; both W8A8 when
    ``quant``). ``backend`` and ``group`` go to ``multi_head_attention``:
    ``parallel/context.py`` sets "ring" and the token axis's group.
    ``qk_rms_norm`` normalises q and k per head (``q_rms_norm``,
    ``k_rms_norm``: ``MultiHeadRMSNorm``) between the projection and the
    attention, as TRELLIS's attention does."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 proj_bias: bool = True, dtype=torch.bfloat16,
                 param_dtype=None, quant: bool = False,
                 qk_rms_norm: bool = False):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.backend, self.group = "auto", None
        self.tp_group, self.tp_parts = None, 1
        dense = _dense(quant)
        self.qkv = dense(dim, 3 * dim, bias=qkv_bias, dtype=dtype,
                         param_dtype=param_dtype)
        self.proj = dense(dim, dim, bias=proj_bias, dtype=dtype,
                          param_dtype=param_dtype)
        self.qk_rms_norm = qk_rms_norm
        if qk_rms_norm:
            self.q_rms_norm = MultiHeadRMSNorm(dim // num_heads, num_heads,
                                               param_dtype, dtype)
            self.k_rms_norm = MultiHeadRMSNorm(dim // num_heads, num_heads,
                                               param_dtype, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, _ = x.shape
        hd = self.dim // self.num_heads
        heads = self.num_heads // self.tp_parts
        qkv = self.qkv(copy_to_tp(x, self.tp_group))
        q, k, v = qkv.reshape(B, N, 3, heads, hd).unbind(2)
        if self.qk_rms_norm:
            q, k = self.q_rms_norm(q), self.k_rms_norm(k)
        out = multi_head_attention(q, k, v, scale=hd ** -0.5,
                                   backend=self.backend, group=self.group)
        return row_parallel(self.proj, out.reshape(B, N, heads * hd),
                            self.tp_group)


class CrossAttention(nn.Module):
    """Cross-attention with separate q/k/v projections.

    By default reproduces the reference's double scaling: q is pre-scaled
    by ``head_dim**-0.5`` on top of the attention's own, so the effective
    scale is ``head_dim**-1`` (the released checkpoints were trained so).
    ``scale`` given replaces it (``head_dim**-0.5`` for TRELLIS).

    With ``quant`` the per-step ``to_q`` and ``proj`` run W8A8; ``to_k`` and
    ``to_v`` run once per asset and stay float, as in the JAX package.
    """

    def __init__(self, dim: int, cond_dim: int, num_heads: int,
                 qkv_bias: bool = True, proj_bias: bool = True,
                 dtype=torch.bfloat16, param_dtype=None, quant: bool = False,
                 scale: float | None = None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.scale = (dim // num_heads) ** -1.0 if scale is None else scale
        self.tp_group, self.tp_parts = None, 1
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        dense = _dense(quant)
        self.to_q = dense(dim, dim, bias=qkv_bias, **kw)
        self.to_k = linear(cond_dim, dim, bias=qkv_bias, **kw)
        self.to_v = linear(cond_dim, dim, bias=qkv_bias, **kw)
        self.proj = dense(dim, dim, bias=proj_bias, **kw)

    def kv(self, ctx: torch.Tensor):
        """Per-head K/V [B, M, H, hd] of the conditioning sequence (this
        rank's heads under tp); constant over the denoise chain, so callers
        compute it once per asset."""
        B, M, _ = ctx.shape
        hd = self.dim // self.num_heads
        heads = self.num_heads // self.tp_parts
        ctx = copy_to_tp(ctx.to(self.to_k.compute_dtype), self.tp_group)
        k = self.to_k(ctx).reshape(B, M, heads, hd)
        v = self.to_v(ctx).reshape(B, M, heads, hd)
        return k, v

    def uniform_out(self, v: torch.Tensor) -> torch.Tensor:
        """Output when every kv token is the same (the CFG null branch):
        softmax over equal logits is uniform, so attention returns v for
        every query and the block reduces to proj(v). [B,1,H,hd] -> [B,1,dim]
        (under tp a row-parallel product too: one reduce)."""
        return row_parallel(self.proj, v.reshape(v.shape[0], 1, -1),
                            self.tp_group)

    def attend(self, x, k, v):
        B, N, _ = x.shape
        hd = self.dim // self.num_heads
        heads = self.num_heads // self.tp_parts
        q = self.to_q(copy_to_tp(x, self.tp_group)).reshape(B, N, heads, hd)
        out = multi_head_attention(q, k, v, scale=self.scale)
        return row_parallel(self.proj, out.reshape(B, N, heads * hd),
                            self.tp_group)

    def forward(self, x, ctx):
        return self.attend(x, *self.kv(ctx))
