"""Hunyuan3D-2's shape-generation DiT (``Hunyuan3DDiT``,
github.com/Tencent/Hunyuan3D-2,
``hy3dgen/shapegen/models/denoisers/hunyuan3ddit.py``; its published
config ``hunyuan3d-dit-v2-0/config.yaml`` of the release
``tencent/Hunyuan3D-2``; arXiv:2501.12202): a FLUX-style MMDiT over the
ShapeVAE's latent set (3072 tokens of 64, an unordered set: no position
embedding), conditioned on DINOv2-giant's image tokens.

``latent_in`` (Linear 64 -> C) in f32; the conditioning through
``cond_in`` (Linear 1536 -> C) in the compute dtype; ``vec``, the
timestep embedding of ``t`` through the port's ``TimestepEmbedder`` (256
frequencies, cos before sin, then Linear, SiLU, Linear), in f32. The
port's objective hands the model ``1000 t`` (``diffusion/flow.py``), so
the model does not multiply by Hunyuan3D-2's ``time_factor`` (1000)
again. Every LN is affine-free at eps 1e-6; every modulation is
``Linear(SiLU(vec))`` in f32, cast to the compute dtype; every MLP is
Linear -> GELU(tanh) -> Linear. Then, in the compute dtype:

- ``depth`` double-stream blocks (``DoubleStreamBlock``): the latent
  stream ("img", the latent tokens) and the conditioning stream ("txt")
  each have their own weights: a six-way modulation (shift, scale, gate
  of the attention, then of the MLP); ``LN(x) * (1 + scale) + shift``;
  a fused qkv with bias; q and k normalised per head by ``RMSNorm``
  (``x * rsqrt(mean(x^2) + 1e-6) * scale``, one gain vector shared by
  the heads: ``models/layers.py:RMSNorm``, ``ops/qk_norm.py``'s "rms"
  form). The two streams' q, k and v are joined (conditioning first)
  into one attention over M + N tokens, split back, then each stream
  adds its gated output projection and its gated MLP;
- ``depth_single_blocks`` single-stream blocks (``SingleStreamBlock``)
  over the joined sequence (conditioning first): a three-way modulation,
  ``linear1`` (C -> 3C + 4C) gives qkv and the MLP's input in one
  product, attention (with the RMS QK norm) beside GELU(tanh) of the MLP
  part, ``linear2`` on both concatenated (5C -> C), gated;
- the final layer on the latent tokens only: LN, a two-way modulation
  (shift, scale), ``linear`` (C -> 64), in f32.

Attention scales by head_dim^-0.5 and goes through
``ops/attention.py:multi_head_attention`` (flash at these shapes). The
LN + modulate boundaries run on ``ops/fused_ln.py``'s kernels: before
each stream's attention and each single block (``ln_modulate``), and
after each stream's attention into its MLP (``ln_modulate_residual``).
The double blocks' forward is the span ``mmdit.double``, the single
blocks' ``mmdit.single`` (``core/profiling.py``).

Conditioning: ``forward(x, t, y, drop)`` takes y [B, M, 1536]; rows
where ``drop`` is True see zeros (``drop_cond``: Hunyuan3D-2's
unconditional embedding of the image is ``zeros``).

Parameters follow the port's layer names; a Hunyuan3D-2 state_dict
(FLUX's names: ``time_in.in_layer`` / ``.out_layer``, ``<s>_mod.lin``,
``<s>_attn.norm.query_norm.scale``, ``<s>_mlp.0`` / ``.2``,
``modulation.lin``, ``norm.key_norm.scale``, ...) loads with
``load_state_dict(strict=True)``: ``from_hunyuan`` renames it on the way
in, and ``to_hunyuan`` gives the port's tensors under Hunyuan3D-2's
names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.profiling import span
from ..ops.attention import multi_head_attention
from ..ops.fused_ln import ln_modulate, ln_modulate_residual
from .dit import DiT
from .layers import (
    Mlp,
    RMSNorm,
    TimestepEmbedder,
    default_init_,
    linear,
    materialize_,
)

# the port's name -> Hunyuan3D-2's, inside the model (substrings; none of
# them is a part of another's match)
_RENAMES = (("t_embedder.mlp.0.", "time_in.in_layer."),
            ("t_embedder.mlp.2.", "time_in.out_layer."),
            ("_mod.", "_mod.lin."),
            (".modulation.", ".modulation.lin."),
            ("q_norm.scale", "norm.query_norm.scale"),
            ("k_norm.scale", "norm.key_norm.scale"),
            ("_mlp.fc1.", "_mlp.0."), ("_mlp.fc2.", "_mlp.2."))


class StreamAttention(nn.Module):
    """One stream's attention weights in a double block: the fused ``qkv``,
    the q and k RMS norms, the output ``proj``."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 dtype=torch.bfloat16, param_dtype=None):
        super().__init__()
        self.num_heads = num_heads
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.qkv = linear(dim, 3 * dim, bias=qkv_bias, **kw)
        self.q_norm = RMSNorm(dim // num_heads, param_dtype, dtype)
        self.k_norm = RMSNorm(dim // num_heads, param_dtype, dtype)
        self.proj = linear(dim, dim, **kw)

    def heads(self, h: torch.Tensor):
        """(q, k, v) [B, N, H, D] of the modulated stream h [B, N, C], q and
        k normalised."""
        B, N, C = h.shape
        q, k, v = self.qkv(h).reshape(B, N, 3, self.num_heads,
                                      C // self.num_heads).unbind(2)
        return self.q_norm(q), self.k_norm(k), v


class DoubleStreamBlock(nn.Module):
    """FLUX's ``DoubleStreamBlock``: two streams with their own weights that
    meet in one attention."""

    def __init__(self, hidden: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, dtype=torch.bfloat16,
                 param_dtype=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        mlp = int(hidden * mlp_ratio)
        for s in ("img", "txt"):
            setattr(self, f"{s}_mod", linear(hidden, 6 * hidden))
            setattr(self, f"{s}_attn", StreamAttention(hidden, num_heads,
                                                       qkv_bias, **kw))
            setattr(self, f"{s}_mlp", Mlp(hidden, mlp, hidden, **kw))

    def forward(self, img, txt, c):
        """img [B, N, C] latent stream, txt [B, M, C] conditioning stream,
        both in the compute dtype; c = SiLU(vec) [B, C] f32."""
        dt, M = self.dtype, txt.shape[1]
        mi = self.img_mod(c).to(dt).chunk(6, dim=-1)
        mt = self.txt_mod(c).to(dt).chunk(6, dim=-1)
        qi, ki, vi = self.img_attn.heads(ln_modulate(img, mi[0], mi[1],
                                                     out_dtype=dt))
        qt, kt, vt = self.txt_attn.heads(ln_modulate(txt, mt[0], mt[1],
                                                     out_dtype=dt))
        attn = multi_head_attention(
            torch.cat([qt, qi], dim=1), torch.cat([kt, ki], dim=1),
            torch.cat([vt, vi], dim=1), scale=qi.shape[-1] ** -0.5).flatten(2)
        img, h = ln_modulate_residual(img, self.img_attn.proj(attn[:, M:]),
                                      mi[2], mi[3], mi[4], out_dtype=dt)
        img = img + mi[5][:, None, :] * self.img_mlp(h)
        txt, h = ln_modulate_residual(txt, self.txt_attn.proj(attn[:, :M]),
                                      mt[2], mt[3], mt[4], out_dtype=dt)
        return img, txt + mt[5][:, None, :] * self.txt_mlp(h)


class SingleStreamBlock(nn.Module):
    """FLUX's ``SingleStreamBlock``: attention and MLP in parallel off one
    product."""

    def __init__(self, hidden: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype=torch.bfloat16, param_dtype=None):
        super().__init__()
        self.dtype, self.num_heads = dtype, num_heads
        self.mlp_hidden = int(hidden * mlp_ratio)
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.linear1 = linear(hidden, 3 * hidden + self.mlp_hidden, **kw)
        self.linear2 = linear(hidden + self.mlp_hidden, hidden, **kw)
        self.q_norm = RMSNorm(hidden // num_heads, param_dtype, dtype)
        self.k_norm = RMSNorm(hidden // num_heads, param_dtype, dtype)
        self.modulation = linear(hidden, 3 * hidden)

    def forward(self, x, c):
        """x [B, L, C] the joined sequence in the compute dtype, c as the
        double block's."""
        dt = self.dtype
        B, L, C = x.shape
        shift, scale, gate = self.modulation(c).to(dt).chunk(3, dim=-1)
        qkv, mlp = self.linear1(ln_modulate(x, shift, scale, out_dtype=dt)
                                ).split([3 * C, self.mlp_hidden], dim=-1)
        # q and k are read in place from linear1's rows
        q, k, v = qkv.unflatten(-1, (3, self.num_heads, -1)).unbind(2)
        attn = multi_head_attention(self.q_norm(q), self.k_norm(k), v,
                                    scale=q.shape[-1] ** -0.5)
        out = self.linear2(torch.cat(
            [attn.flatten(2), F.gelu(mlp, approximate="tanh")], dim=-1))
        return x + gate[:, None, :] * out


class FinalLayer(nn.Module):
    """FLUX's ``LastLayer`` at patch size 1, in f32."""

    def __init__(self, hidden: int, out_channels: int):
        super().__init__()
        self.adaLN_modulation = nn.Sequential(nn.SiLU(),
                                              linear(hidden, 2 * hidden))
        self.linear = linear(hidden, out_channels)

    def forward(self, x, vec):
        shift, scale = self.adaLN_modulation(vec).chunk(2, dim=-1)
        h = F.layer_norm(x.float(), x.shape[-1:], eps=1e-6)
        return self.linear(h * (1 + scale[:, None, :]) + shift[:, None, :])


class Hunyuan3DDiT(nn.Module):
    """Keys as the module tree; Hunyuan3D-2's own load through
    ``from_hunyuan`` (module docstring). ``num_latents`` is the ShapeVAE's
    latent count (one sample's x is [num_latents, in_channels]);
    ``cond_drop_prob`` is the share of rows whose conditioning the trainer
    zeroes (``cond_drop_mask``)."""

    def __init__(self, in_channels: int = 64, context_in_dim: int = 1536,
                 hidden_size: int = 1024, mlp_ratio: float = 4.0,
                 num_heads: int = 16, depth: int = 16,
                 depth_single_blocks: int = 32, qkv_bias: bool = True,
                 num_latents: int = 3072, cond_drop_prob: float = 0.0,
                 dtype=torch.bfloat16, param_dtype=None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.in_channels = self.out_channels = in_channels
        self.condition_channels = context_in_dim
        self.hidden_size = hidden_size
        self.seq_length = num_latents
        self.input_shape = (num_latents, in_channels)   # one sample's x
        self.cond_drop_prob = cond_drop_prob
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.latent_in = linear(in_channels, hidden_size)
        self.t_embedder = TimestepEmbedder(hidden_size)
        self.cond_in = linear(context_in_dim, hidden_size, **kw)
        self.double_blocks = nn.ModuleList(
            DoubleStreamBlock(hidden_size, num_heads, mlp_ratio, qkv_bias,
                              **kw) for _ in range(depth))
        self.single_blocks = nn.ModuleList(
            SingleStreamBlock(hidden_size, num_heads, mlp_ratio, **kw)
            for _ in range(depth_single_blocks))
        self.final_layer = FinalLayer(hidden_size, in_channels)
        materialize_(self, device, generator, Hunyuan3DDiT.init_weights)
        self._register_load_state_dict_pre_hook(self._from_hunyuan_hook)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """No trainer is published with the model; the port's init is the
        DiT's: xavier-uniform linears with zero biases, N(0, 0.02)
        timestep MLP, zero modulations and output layer (every block the
        identity at step 0), QK-norm gains of one."""
        default_init_(self, gen)
        for lin in (self.t_embedder.mlp[0], self.t_embedder.mlp[2]):
            lin.weight.normal_(0.0, 0.02, generator=gen)
        zeroed = [self.final_layer.adaLN_modulation[1], self.final_layer.linear]
        for b in self.double_blocks:
            zeroed += [b.img_mod, b.txt_mod]
        zeroed += [b.modulation for b in self.single_blocks]
        for m in zeroed:
            m.weight.zero_()
            m.bias.zero_()
        for m in self.modules():
            if isinstance(m, RMSNorm):
                m.scale.fill_(1.0)

    # the DiT's draw of the rows whose conditioning drops
    cond_drop_mask = DiT.cond_drop_mask

    def drop_cond(self, y, drop: torch.Tensor | None):
        """y [B, M, context_in_dim], zero where ``drop`` ([B] bool or
        None) is True."""
        if drop is None:
            return y
        return torch.where(drop.to(y.device)[:, None, None],
                           torch.zeros((), dtype=y.dtype, device=y.device), y)

    def forward(self, x, t, y, drop: torch.Tensor | None = None):
        """x [B, num_latents, in_channels], t [B] (flow time x 1000), y [B,
        M, context_in_dim] -> [B, num_latents, in_channels] f32; the rows
        where ``drop`` is True see ``drop_cond``'s zeros."""
        vec = self.t_embedder(t)
        c = F.silu(vec)
        img = self.latent_in(x.float()).to(self.dtype)
        txt = self.cond_in(self.drop_cond(y, drop))
        with span("mmdit.double"):
            for blk in self.double_blocks:
                img, txt = blk(img, txt, c)
        M = txt.shape[1]
        h = torch.cat([txt, img], dim=1)
        with span("mmdit.single"):
            for blk in self.single_blocks:
                h = blk(h, c)
        return self.final_layer(h[:, M:], vec)

    @torch.no_grad()
    def _from_hunyuan_hook(self, state_dict, prefix, *args) -> None:
        ours = [k for k in state_dict if k.startswith(prefix)]
        converted = from_hunyuan({k[len(prefix):]: state_dict[k]
                                  for k in ours})
        for k in ours:
            del state_dict[k]
        state_dict.update({prefix + k: v for k, v in converted.items()})


def from_hunyuan(sd: dict) -> dict:
    """A Hunyuan3D-2 ``Hunyuan3DDiT`` state_dict under the port's names
    (the renames of ``_RENAMES``). Keys already in the port's names pass
    through."""
    out = {}
    for k, v in sd.items():
        for ours, theirs in _RENAMES:
            k = k.replace(theirs, ours)
        out[k] = v
    return out


def to_hunyuan(sd: dict) -> dict:
    """The port's tensors (a state_dict, or any dict keyed by parameter
    name such as gradients) under Hunyuan3D-2's names: the inverse of
    ``from_hunyuan``."""
    out = {}
    for k, v in sd.items():
        for ours, theirs in _RENAMES:
            k = k.replace(ours, theirs)
        out[k] = v
    return out
