"""TRELLIS's sparse-structure flow transformer (TRELLIS-image-large, stage
1: ``SparseStructureFlowModel``, github.com/microsoft/TRELLIS,
``trellis/models/sparse_structure_flow.py``; Xiang et al.,
arXiv:2412.01506).

A dense [B, 8, R, R, R] latent (R = 16: 4096 tokens, patch 1) flattened
in (x, y, z) "ij" order, ``input_layer`` (Linear 8 -> C) in f32, plus a
fixed 3-D sin/cos position embedding (``pos_emb``); the timestep
embedding of ``t`` (the flow time times 1000) through the port's
``TimestepEmbedder``; ``num_blocks`` blocks in the compute dtype, each:

- adaLN: SiLU(t_emb) -> Linear(C, 6C), f32, cast to the compute dtype:
  shift, scale, gate of the self-attention, then of the MLP;
- ``h = LN(x) * (1 + scale_msa) + shift_msa``; ``x += gate_msa *
  SelfAttn(h)``, the self-attention's q and k normalised per head
  (``qk_rms_norm``, ``ops/qk_norm.py``) with the standard head_dim^-0.5;
- ``x += CrossAttn(LN_affine(x), cond)``: ``norm2`` is an affine LN, no
  modulation and no gate, the standard head_dim^-0.5 scale, no QK norm;
- ``h = LN(x) * (1 + scale_mlp) + shift_mlp``; ``x += gate_mlp *
  MLP(h)``, MLP = Linear(C, 4C) -> GELU(tanh) -> Linear(4C, C);

every LN at eps 1e-6. Then, in f32, a non-affine LN (``F.layer_norm`` at
its default eps 1e-5, as TRELLIS calls it) and ``out_layer`` (Linear C ->
8), reshaped back to [B, 8, R, R, R].

The block's three LN boundaries go through the fused kernels of
``ops/fused_ln.py``, as the DiT's do: ``ln_modulate`` before the
self-attention; ``ln_modulate_residual`` after it with the affine LN as
shift ``norm2.bias`` and scale ``norm2.weight - 1``; and after the
cross-attention with gate 1 and the MLP's modulation.

Conditioning: ``forward(x, t, y, drop)`` takes y [B, M, cond_channels];
rows where ``drop`` is True see zeros (``drop_cond``; TRELLIS's image
conditioning has no null embedding: its negative is ``zeros_like(cond)``).

Parameters follow the port's layer names (``self_attn.qkv`` / ``.proj``,
``cross_attn.to_q`` / ``.to_k`` / ``.to_v`` / ``.proj``, ``mlp.fc1`` /
``.fc2``); a TRELLIS state_dict (``to_qkv``, ``to_out``, one ``to_kv``
whose rows are k then v, ``mlp.mlp.0`` / ``.2``, the ``pos_emb`` buffer)
loads with ``load_state_dict(strict=True)``: ``from_trellis`` renames and
splits it on the way in, and ``to_trellis`` gives the port's tensors
under TRELLIS's names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_ln import ln_modulate, ln_modulate_residual
from .dit import DiT
from .layers import (
    META,
    CrossAttention,
    Mlp,
    SelfAttention,
    TimestepEmbedder,
    default_init_,
    linear,
    materialize_,
)

# TRELLIS's name -> the port's, inside a block
_RENAMES = (("self_attn.to_qkv.", "self_attn.qkv."),
            ("self_attn.to_out.", "self_attn.proj."),
            ("cross_attn.to_out.", "cross_attn.proj."),
            ("mlp.mlp.0.", "mlp.fc1."), ("mlp.mlp.2.", "mlp.fc2."))
_KV = "cross_attn.to_kv."


def position_embedding(resolution: int, channels: int) -> torch.Tensor:
    """[R^3, channels] f32 (TRELLIS's ``AbsolutePositionEmbedder`` over the
    grid's integer coordinates in "ij" order): for each coordinate,
    ``[sin(c * f), cos(c * f)]`` at ``f = 10000^(-i / F)``, i < F =
    channels // 3 // 2, the three concatenated and zero-padded to
    ``channels``."""
    n_freq = channels // 3 // 2
    freqs = 1.0 / 10000 ** (torch.arange(n_freq, dtype=torch.float32) / n_freq)
    axis = torch.arange(resolution)
    coords = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"),
                         dim=-1).reshape(-1, 3)
    out = torch.outer(coords.reshape(-1).float(), freqs)
    emb = torch.cat([out.sin(), out.cos()], dim=-1).reshape(len(coords), -1)
    return F.pad(emb, (0, channels - emb.shape[1]))


class SSFlowBlock(nn.Module):
    """TRELLIS's ``ModulatedTransformerCrossBlock`` (``share_mod`` false)."""

    def __init__(self, channels: int, cond_channels: int, num_heads: int,
                 mlp_ratio: float = 4.0, qk_rms_norm: bool = True,
                 dtype=torch.bfloat16, param_dtype=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.self_attn = SelfAttention(channels, num_heads,
                                       qk_rms_norm=qk_rms_norm, **kw)
        self.norm2 = nn.LayerNorm(channels, eps=1e-6, device=META,
                                  dtype=param_dtype or dtype)
        self.cross_attn = CrossAttention(channels, cond_channels, num_heads,
                                         scale=(channels // num_heads) ** -0.5,
                                         **kw)
        self.mlp = Mlp(channels, int(channels * mlp_ratio), channels, **kw)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), linear(channels, 6 * channels))

    def forward(self, x, y, t_emb):
        """x [B, N, C] residual stream in the compute dtype, y [B, M, Cc]
        conditioning, t_emb [B, C] f32."""
        dt, B = self.dtype, x.shape[0]
        mods = self.adaLN_modulation(t_emb).to(dt)
        s_msa, sc_msa, g_msa, s_mlp, sc_mlp, g_mlp = mods.chunk(6, dim=-1)
        shift2 = self.norm2.bias.to(dt)[None].expand(B, -1)
        scale2 = (self.norm2.weight - 1).to(dt)[None].expand(B, -1)
        h = ln_modulate(x, s_msa, sc_msa, out_dtype=dt)
        x, h = ln_modulate_residual(x, self.self_attn(h), g_msa, shift2,
                                    scale2, out_dtype=dt)
        one = torch.ones(x.shape[-1], dtype=dt, device=x.device)[None].expand(
            B, -1)
        x, h = ln_modulate_residual(x, self.cross_attn(h, y), one, s_mlp,
                                    sc_mlp, out_dtype=dt)
        return x + g_mlp[:, None, :] * self.mlp(h)


class SparseStructureFlowModel(nn.Module):
    """Keys as the module tree; TRELLIS's own load through ``from_trellis``
    (module docstring). ``cond_drop_prob`` is the share of rows whose
    conditioning the trainer zeroes (``cond_drop_mask``)."""

    def __init__(self, resolution: int = 16, in_channels: int = 8,
                 model_channels: int = 1024, cond_channels: int = 1024,
                 out_channels: int = 8, num_blocks: int = 24,
                 num_heads: int = 16, mlp_ratio: float = 4.0,
                 qk_rms_norm: bool = True, cond_drop_prob: float = 0.0,
                 dtype=torch.bfloat16, param_dtype=None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.resolution = resolution
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.condition_channels = cond_channels
        self.hidden_size = model_channels
        self.seq_length = resolution ** 3
        self.input_shape = (in_channels,) + (resolution,) * 3  # one sample's x
        self.cond_drop_prob = cond_drop_prob
        self.dtype = dtype
        self.input_layer = linear(in_channels, model_channels)
        self.t_embedder = TimestepEmbedder(model_channels)
        self.blocks = nn.ModuleList(
            SSFlowBlock(model_channels, cond_channels, num_heads, mlp_ratio,
                        qk_rms_norm, dtype, param_dtype)
            for _ in range(num_blocks))
        self.out_layer = linear(model_channels, out_channels)
        self.register_buffer("pos_emb", torch.empty(
            self.seq_length, model_channels, device=META), persistent=False)
        materialize_(self, device, generator,
                     SparseStructureFlowModel.init_weights)
        self._register_load_state_dict_pre_hook(self._from_trellis_hook)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """TRELLIS's init: xavier-uniform linears with zero biases, N(0,
        0.02) timestep MLP, zero adaLN and output layer, unit norm gains,
        QK-norm gains of one; and the position embedding."""
        default_init_(self, gen)
        for lin in (self.t_embedder.mlp[0], self.t_embedder.mlp[2]):
            lin.weight.normal_(0.0, 0.02, generator=gen)
        zeroed = [b.adaLN_modulation[1] for b in self.blocks]
        for m in zeroed + [self.out_layer]:
            m.weight.zero_()
            m.bias.zero_()
        for name, p in self.named_parameters():
            if name.endswith("_rms_norm.gamma"):
                p.fill_(1.0)
        self.pos_emb.copy_(position_embedding(self.resolution,
                                              self.hidden_size))

    # the DiT's draw of the rows whose conditioning drops
    cond_drop_mask = DiT.cond_drop_mask

    def drop_cond(self, y, drop: torch.Tensor | None):
        """y [B, M, cond_channels], zero where ``drop`` ([B] bool or None)."""
        if drop is None:
            return y
        return torch.where(drop.to(y.device)[:, None, None],
                           torch.zeros((), dtype=y.dtype, device=y.device), y)

    def forward(self, x, t, y, drop: torch.Tensor | None = None):
        """x [B, in_channels, R, R, R], t [B] (flow time x 1000), y [B, M,
        cond_channels] -> [B, out_channels, R, R, R] f32; the rows where
        ``drop`` is True see ``drop_cond``'s zeros."""
        B = x.shape[0]
        y = self.drop_cond(y, drop)
        h = x.float().reshape(B, self.in_channels, -1).transpose(1, 2)
        h = self.input_layer(h) + self.pos_emb[None]
        t_emb = self.t_embedder(t)
        h = h.to(self.dtype)
        for blk in self.blocks:
            h = blk(h, y, t_emb)
        h = F.layer_norm(h.float(), h.shape[-1:])
        h = self.out_layer(h)
        return h.transpose(1, 2).reshape(B, self.out_channels,
                                         *(self.resolution,) * 3)

    @torch.no_grad()
    def _from_trellis_hook(self, state_dict, prefix, *args) -> None:
        converted = from_trellis({k[len(prefix):]: state_dict[k]
                                  for k in list(state_dict)
                                  if k.startswith(prefix)},
                                 self.pos_emb, self.resolution)
        for k in [k for k in state_dict if k.startswith(prefix)]:
            del state_dict[k]
        state_dict.update({prefix + k: v for k, v in converted.items()})


def from_trellis(sd: dict, pos_emb: torch.Tensor | None = None,
                 resolution: int | None = None) -> dict:
    """A TRELLIS ``SparseStructureFlowModel`` state_dict under the port's
    names: the renames of ``_RENAMES``, each ``cross_attn.to_kv`` split
    into ``to_k`` (first half of its rows) and ``to_v``, the ``pos_emb``
    buffer dropped once it is found equal to ``pos_emb`` (a given buffer
    that differs raises). Keys already in the port's names pass through."""
    out = {}
    for k, v in sd.items():
        if k == "pos_emb":
            if pos_emb is not None and not torch.allclose(
                    v.float().cpu(), pos_emb.float().cpu(), atol=1e-5):
                raise ValueError(f"pos_emb is not the {resolution}^3 grid's "
                                 f"position embedding")
            continue
        if _KV in k:
            head, _, leaf = k.partition(_KV)
            k_part, v_part = v.chunk(2, dim=0)
            out[f"{head}cross_attn.to_k.{leaf}"] = k_part
            out[f"{head}cross_attn.to_v.{leaf}"] = v_part
            continue
        for old, new in _RENAMES:
            k = k.replace(old, new)
        out[k] = v
    return out


def to_trellis(sd: dict) -> dict:
    """The port's tensors (a state_dict, or any dict keyed by parameter
    name such as gradients) under TRELLIS's names: the inverse of
    ``from_trellis``, ``to_k`` and ``to_v`` stacked into ``to_kv``."""
    out = {}
    for k, v in sd.items():
        if ".cross_attn.to_v." in k:
            continue
        if ".cross_attn.to_k." in k:
            head, _, leaf = k.partition("cross_attn.to_k.")
            out[f"{head}{_KV}{leaf}"] = torch.cat(
                [v, sd[f"{head}cross_attn.to_v.{leaf}"]], dim=0)
            continue
        for old, new in _RENAMES:
            k = k.replace(new, old)
        out[k] = v
    return out
