"""Hunyuan3D-2.1's shape-generation DiT (``HunYuanDiTPlain``,
github.com/Tencent-Hunyuan/Hunyuan3D-2.1,
``hy3dshape/models/denoisers/hunyuandit.py``; its published config
``hunyuan3d-dit-v2-1/config.yaml`` of the release ``tencent/Hunyuan3D-2.1``;
arXiv:2506.15442): a plain DiT over the ShapeVAE's latent set (4096
tokens of 64, no position embedding), conditioned by cross-attention on
DINOv2's image tokens, with U-Net long skips and mixture-of-experts
feed-forwards in its last blocks.

- The time as a token: ``t_embedder`` is the sinusoid of t at width C (cos
  before sin), then ``mlp.0`` (C -> 4C), exact GELU, ``mlp.2`` (4C -> C),
  in f32; its output is put before the latents embedded by ``x_embedder``
  (64 -> C, f32), so every block runs over 1 + 4096 tokens. The port's
  objective hands the model 1000 t (``diffusion/flow.py``); the release's
  flow-matching pipeline hands it t, so the model embeds ``t / 1000``.
- ``depth`` blocks (``HunYuanDiTBlock``), in the compute dtype, each LN an
  affine LayerNorm at eps 1e-6:

  - ``x = skip_norm(skip_linear(cat[skip, x]))`` in the blocks after the
    middle one (``skip_linear`` 2C -> C with bias);
  - ``x += attn1(norm1(x))``: self-attention, q, k and v by ``to_q``,
    ``to_k``, ``to_v`` (no bias: ``qkv_bias`` false), q and k RMS-normed per
    head (``q_norm``, ``k_norm``: ``x * rsqrt(mean(x^2) + 1e-6) *
    weight``, one gain of head_dim, ``models/layers.py:RMSNorm``, the
    "rms" form of ``ops/qk_norm.py``), ``out_proj`` with bias;
  - ``x += attn2(norm2(x), y)``: cross-attention to y [B, M, context_dim],
    q from x, k and v from y, normed the same way;
  - ``x += FFN(norm3(x))``: in the first ``depth - num_moe_layers`` blocks
    ``mlp`` (``fc1`` C -> 4C, exact GELU, ``fc2``), in the last
    ``num_moe_layers`` the mixture of experts ``moe``
    (``models/moe.py:MoEFFN``, top ``moe_top_k`` of ``num_experts`` and a
    shared expert, each 4C wide).

  The release splits heads after joining its projections' channels: the
  self-attention views ``cat[q, k, v]`` [B, N, 3C] as [B, N, H, 3D] and
  takes each head's q, k and v as the three D-wide thirds of its 3D
  channels, the cross-attention views ``cat[k, v]`` as [B, M, H, 2D] the
  same way (so head h's "q" is channels 3hD..3hD+D of the joined tensor,
  which for h >= 1 are not q's channels hD..hD+D). The port follows it:
  one product by the joined weights, the heads read in place. Attention
  scales by head_dim^-0.5 and goes through
  ``ops/attention.py:multi_head_attention`` (flash at these shapes). The
  LNs run on ``ops/fused_ln.py``'s kernels with the gain as ``1 +
  scale``: ``norm1`` (and ``skip_norm``) by ``ln_modulate``, ``norm2``
  and ``norm3`` with the residual add before them by
  ``ln_modulate_residual``.
- U-Net long skips: blocks ``0 .. depth // 2 - 1`` push their output on a
  stack, block ``depth // 2`` is the middle, each block after it pops one
  into its ``skip_linear``.
- The final layer: ``norm_final`` (affine LN), the time token dropped,
  ``linear`` (C -> 64), in f32.

The blocks' forward is the span ``h21.blocks`` (``core/profiling.py``);
each mixture of experts records its own (``models/moe.py``) and counts its
slots under ``blocks.<i>.moe`` in ``moe.expert_tokens``.

Conditioning: ``forward(x, t, y, drop)`` takes y [B, M, context_dim];
rows where ``drop`` is True see zeros (``drop_cond``: the release's
unconditional embedding of the image is ``zeros``).

Parameters follow the release's names but for the QK-norm gains
(``q_norm.scale`` for its ``q_norm.weight``) and the mixtures of experts
(stacked: ``moe.fc1_weight`` [E, 4C, C] for ``moe.experts.<e>.net.0.proj.
weight``, ``moe.shared.fc1`` for ``moe.shared_experts.net.0.proj``, ...);
a release state_dict loads with ``load_state_dict(strict=True)``:
``from_h21`` renames and stacks it on the way in, and ``to_h21`` gives the
port's tensors under the release's names.
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F
from torch import nn

from ..core.profiling import span
from ..ops.attention import multi_head_attention
from ..ops.fused_ln import ln_modulate, ln_modulate_residual
from .dit import DiT
from .layers import (
    META,
    Mlp,
    RMSNorm,
    default_init_,
    linear,
    materialize_,
    timestep_embedding,
)
from .moe import MoEFFN

# the release's flow-matching pipeline divides the scheduler's timestep by
# its num_train_timesteps; the port's objective hands the model 1000 t
TIME_SCALE = 1000.0


class LayerNorm(nn.Module):
    """An affine LayerNorm's parameters (keys ``weight``, ``bias``) at eps
    1e-6, applied by the fused LN kernels as ``1 + scale`` and ``shift``."""

    def __init__(self, dim: int, param_dtype=None):
        super().__init__()
        pd = param_dtype or torch.float32
        self.weight = nn.Parameter(torch.empty(dim, device=META, dtype=pd))
        self.bias = nn.Parameter(torch.empty(dim, device=META, dtype=pd))

    def modulation(self, B: int, dtype):
        """(shift, scale) [B, C] in ``dtype``: the bias and the gain less
        one, as the fused kernels take them."""
        return (self.bias.to(dtype)[None].expand(B, -1),
                (self.weight - 1).to(dtype)[None].expand(B, -1))


class H21Attention(nn.Module):
    """The release's ``Attention`` (``kdim`` None) or ``CrossAttention``:
    separate q, k, v projections, the joined head split (module
    docstring), the RMS QK norm, ``out_proj`` with bias."""

    def __init__(self, dim: int, num_heads: int, kdim: int | None = None,
                 dtype=torch.bfloat16, param_dtype=None):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, dim // num_heads
        self.cross = kdim is not None
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.to_q = linear(dim, dim, bias=False, **kw)
        self.to_k = linear(kdim or dim, dim, bias=False, **kw)
        self.to_v = linear(kdim or dim, dim, bias=False, **kw)
        self.q_norm = RMSNorm(self.head_dim, param_dtype, dtype)
        self.k_norm = RMSNorm(self.head_dim, param_dtype, dtype)
        self.out_proj = linear(dim, dim, **kw)

    def _joined(self, x, layers):
        """x's product by the layers' weights joined along their outputs."""
        dt = layers[0].compute_dtype
        return F.linear(x.to(dt), torch.cat([m.weight for m in layers]).to(dt))

    def forward(self, x, y=None):
        """x [B, N, C]; y [B, M, kdim] for the cross-attention."""
        B, N, C = x.shape
        H, D = self.num_heads, self.head_dim
        if self.cross:
            q = self.to_q(x).view(B, N, H, D)
            k, v = self._joined(y, (self.to_k, self.to_v)).view(
                B, y.shape[1], H, 2 * D).split(D, dim=-1)
        else:
            q, k, v = self._joined(x, (self.to_q, self.to_k, self.to_v)).view(
                B, N, H, 3 * D).split(D, dim=-1)
        out = multi_head_attention(self.q_norm(q), self.k_norm(k), v,
                                   scale=D ** -0.5)
        return self.out_proj(out.reshape(B, N, C))


class HunYuanDiTBlock(nn.Module):
    """The release's ``HunYuanDiTBlock`` (module docstring)."""

    def __init__(self, hidden: int, num_heads: int, context_dim: int,
                 skip: bool, moe: bool, num_experts: int = 8,
                 moe_top_k: int = 2, dtype=torch.bfloat16, param_dtype=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.norm1 = LayerNorm(hidden, param_dtype)
        self.attn1 = H21Attention(hidden, num_heads, **kw)
        self.norm2 = LayerNorm(hidden, param_dtype)
        self.attn2 = H21Attention(hidden, num_heads, kdim=context_dim, **kw)
        self.norm3 = LayerNorm(hidden, param_dtype)
        if skip:
            self.skip_norm = LayerNorm(hidden, param_dtype)
            self.skip_linear = linear(2 * hidden, hidden, **kw)
        else:
            self.skip_linear = None
        if moe:
            self.moe = MoEFFN(hidden, 4 * hidden, num_experts, moe_top_k, **kw)
        else:
            self.mlp = Mlp(hidden, 4 * hidden, hidden, approximate="none", **kw)

    def forward(self, x, y, skip=None):
        """x [B, L, C] in the compute dtype, y [B, M, context_dim], skip
        [B, L, C] in blocks that take one."""
        dt, B = self.dtype, x.shape[0]
        if self.skip_linear is not None:
            x = ln_modulate(self.skip_linear(torch.cat([skip, x], dim=-1)),
                            *self.skip_norm.modulation(B, dt), out_dtype=dt)
        one = torch.ones(x.shape[-1], dtype=dt, device=x.device)[None].expand(
            B, -1)
        h = ln_modulate(x, *self.norm1.modulation(B, dt), out_dtype=dt)
        x, h = ln_modulate_residual(x, self.attn1(h), one,
                                    *self.norm2.modulation(B, dt), out_dtype=dt)
        x, h = ln_modulate_residual(x, self.attn2(h, y), one,
                                    *self.norm3.modulation(B, dt), out_dtype=dt)
        return x + (self.moe if hasattr(self, "moe") else self.mlp)(h)


class TimestepEmbedder(nn.Module):
    """The sinusoid of t at width ``hidden`` (cos before sin), then
    ``mlp.0`` (hidden -> ``mlp_width``), exact GELU, ``mlp.2``, in f32."""

    def __init__(self, hidden: int, mlp_width: int):
        super().__init__()
        self.hidden = hidden
        self.mlp = nn.Sequential(linear(hidden, mlp_width), nn.GELU(),
                                 linear(mlp_width, hidden))

    def forward(self, t):
        return self.mlp(timestep_embedding(t, self.hidden))


class FinalLayer(nn.Module):
    """``norm_final`` (affine LN at eps 1e-6), the time token dropped,
    ``linear``, in f32."""

    def __init__(self, hidden: int, out_channels: int):
        super().__init__()
        self.norm_final = nn.LayerNorm(hidden, eps=1e-6, device=META)
        self.linear = linear(hidden, out_channels)

    def forward(self, x):
        return self.linear(self.norm_final(x[:, 1:].float()))


class HunYuanDiTPlain(nn.Module):
    """Keys as the module tree; the release's own through ``from_h21``
    (module docstring). ``input_size`` is the latent count (one sample's x
    is [input_size, in_channels]); ``cond_drop_prob`` the share of rows
    whose conditioning the trainer zeroes (``cond_drop_mask``)."""

    def __init__(self, input_size: int = 4096, in_channels: int = 64,
                 hidden_size: int = 2048, context_dim: int = 1024,
                 depth: int = 21, num_heads: int = 16, num_moe_layers: int = 6,
                 num_experts: int = 8, moe_top_k: int = 2,
                 cond_drop_prob: float = 0.0, dtype=torch.bfloat16,
                 param_dtype=None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.in_channels = self.out_channels = in_channels
        self.condition_channels = context_dim
        self.hidden_size, self.depth = hidden_size, depth
        self.seq_length = input_size
        self.input_shape = (input_size, in_channels)   # one sample's x
        self.cond_drop_prob = cond_drop_prob
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.x_embedder = linear(in_channels, hidden_size)
        self.t_embedder = TimestepEmbedder(hidden_size, 4 * hidden_size)
        self.blocks = nn.ModuleList(
            HunYuanDiTBlock(hidden_size, num_heads, context_dim,
                            skip=i > depth // 2,
                            moe=depth - i <= num_moe_layers,
                            num_experts=num_experts, moe_top_k=moe_top_k,
                            **kw)
            for i in range(depth))
        for i, blk in enumerate(self.blocks):
            if hasattr(blk, "moe"):
                blk.moe.counter = f"blocks.{i}.moe"
        self.final_layer = FinalLayer(hidden_size, in_channels)
        materialize_(self, device, generator, HunYuanDiTPlain.init_weights)
        self._register_load_state_dict_pre_hook(self._from_h21_hook)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """The release ships no initialiser of its own; the port's init:
        xavier-uniform linears with zero biases (each expert's too), unit
        LN and QK-norm gains, zero LN biases."""
        default_init_(self, gen)
        for m in self.modules():
            if isinstance(m, MoEFFN):
                m.init_weights(gen)
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, RMSNorm):
                m.scale.fill_(1.0)

    # the DiT's draw of the rows whose conditioning drops
    cond_drop_mask = DiT.cond_drop_mask

    def drop_cond(self, y, drop: torch.Tensor | None):
        """y [B, M, context_dim], zero where ``drop`` ([B] bool or None) is
        True."""
        if drop is None:
            return y
        return torch.where(drop.to(y.device)[:, None, None],
                           torch.zeros((), dtype=y.dtype, device=y.device), y)

    def forward(self, x, t, y, drop: torch.Tensor | None = None):
        """x [B, input_size, in_channels], t [B] (flow time x 1000), y [B, M,
        context_dim] -> [B, input_size, in_channels] f32; the rows where
        ``drop`` is True see ``drop_cond``'s zeros."""
        dt = self.dtype
        c = self.t_embedder(t.float() / TIME_SCALE)
        h = torch.cat([c[:, None].to(dt), self.x_embedder(x.float()).to(dt)],
                      dim=1)
        y = self.drop_cond(y, drop).to(dt)
        skips = []
        with span("h21.blocks"):
            for i, blk in enumerate(self.blocks):
                h = blk(h, y, skips.pop() if blk.skip_linear is not None
                        else None)
                if i < self.depth // 2:
                    skips.append(h)
        return self.final_layer(h)

    @torch.no_grad()
    def _from_h21_hook(self, state_dict, prefix, *args) -> None:
        ours = [k for k in state_dict if k.startswith(prefix)]
        converted = from_h21({k[len(prefix):]: state_dict[k] for k in ours})
        for k in ours:
            del state_dict[k]
        state_dict.update({prefix + k: v for k, v in converted.items()})


# the port's name -> the release's, inside a block (substrings)
_RENAMES = ((".q_norm.scale", ".q_norm.weight"),
            (".k_norm.scale", ".k_norm.weight"),
            (".moe.shared.fc1.", ".moe.shared_experts.net.0.proj."),
            (".moe.shared.fc2.", ".moe.shared_experts.net.2."))
# a stacked expert tensor's last name -> the release's per-expert name
_STACKED = {"fc1_weight": "net.0.proj.weight", "fc1_bias": "net.0.proj.bias",
            "fc2_weight": "net.2.weight", "fc2_bias": "net.2.bias"}
_EXPERT = re.compile(r"^(.*\.moe\.)experts\.(\d+)\.(.*)$")


def from_h21(sd: dict) -> dict:
    """A release ``HunYuanDiTPlain`` state_dict (or any dict keyed by its
    parameter names, such as gradients) under the port's names: renamed,
    each routed expert's tensors stacked in expert order. Keys already in
    the port's names pass through."""
    out, experts = {}, {}
    theirs = {v: k for k, v in _STACKED.items()}
    for k, v in sd.items():
        m = _EXPERT.match(k)
        if m and m.group(3) in theirs:
            key = m.group(1) + theirs[m.group(3)]
            out.setdefault(key, None)       # the stack's place
            experts.setdefault(key, {})[int(m.group(2))] = v
            continue
        for ours, release in _RENAMES:
            k = k.replace(release, ours)
        out[k] = v
    for k, parts in experts.items():
        out[k] = torch.stack([parts[e] for e in range(len(parts))])
    return out


def to_h21(sd: dict) -> dict:
    """The port's tensors (a state_dict, or any dict keyed by parameter
    name such as gradients) under the release's names: the inverse of
    ``from_h21``, each stacked expert tensor split into its experts'."""
    out = {}
    for k, v in sd.items():
        head, _, last = k.rpartition(".")
        if head.endswith(".moe") and last in _STACKED:
            for e, part in enumerate(v.unbind(0)):
                out[f"{head}.experts.{e}.{_STACKED[last]}"] = part
            continue
        for ours, release in _RENAMES:
            k = k.replace(ours, release)
        out[k] = v
    return out
