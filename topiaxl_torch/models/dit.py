"""PrimX Diffusion Transformer (counterpart of ``topiaxl/models/dit.py``).

2048 prim tokens x 68 channels, Linear token embedding, sinusoidal
t-embedding, ``depth`` blocks of [adaLN-Zero 9-way modulation ->
cross-attention to the image tokens -> self-attention -> GELU-tanh MLP],
adaLN final layer, ``learn_sigma`` doubling the output channels, and a
learned null-conditioning embedding for CFG.

Serving path: ``precompute_kv`` projects the per-block cross-attention
K/V once per asset; ``precompute_null_out`` collapses the CFG null
branch's cross-attention to one vector per block;
``forward_with_cfg_fast`` runs self-attention at batch 2 (cond + uncond)
and cross-attention on the cond half only. Every block's three
LN+modulate boundaries go through the fused kernels in
``ops/fused_ln.py``.

W8A8 serving: ``quant=True`` builds ``QuantDense`` (``ops/int8.py``) where
the JAX package does (the MLP, self-attention's qkv and proj,
cross-attention's to_q and proj); ``quantize_dit_state_dict`` maps a
float state_dict onto it. ``forward_with_cfg_kv`` is the CFG step
against K/V stacked as [cond; null].

Training path: ``forward(x, t, y, drop)`` (``topiaxl/models/dit.py:
424-453``) replaces the dropped samples' conditioning by the null
embedding (``drop_cond``), then runs each block on its own cross-attention
K/V with gradients; ``cond_drop_mask`` draws the mask from a generator.
Train with ``param_dtype=torch.float32`` (f32 master weights, bf16
compute). ``remat=True`` (the JAX package's ``remat=True``, the
reference's ``gradient_checkpointing``) runs each block, its
cross-attention K/V included, under ``torch.utils.checkpoint``: the
backward recomputes it instead of keeping its activations. A remat
policy by name (``REMAT_POLICIES``: ``dots``, ``dots_plus``, ``flash``,
``flash_mlp``, ``topiaxl/models/dit.py:_remat_policy``) checkpoints the
same blocks selectively: the outputs of the ops it names are kept from
the forward, and the backward's recompute takes them instead of running
those ops again (``remat_context``).

Tensor parallelism (``parallel/sharding.py:shard_params``) splits each
block's attention heads and MLP units over the ``tp`` ranks
(``models/layers.py``): every path above runs on the local heads,
``precompute_kv`` projects this rank's heads' K/V and the null branch's
``uniform_out`` is a row-parallel product with its one reduce.
``embed_t`` and ``apply_final`` are the pipeline's replicated entry and
exit (``parallel/pipeline.py``).

``DiTAdditivePosEmb`` adds a Fourier embedding of the prim centres
(token channels 1:4, ``PointEmbed``) to the token embedding on every
path (``topiaxl/models/dit.py:162-182,548-560``).
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from ..ops.fused_ln import ln_modulate, ln_modulate_residual
from ..ops.int8 import quantize_state_dict_like
from ..parallel.collectives import full
from .layers import (
    CrossAttention,
    Mlp,
    SelfAttention,
    TimestepEmbedder,
    default_init_,
    linear,
    materialize_,
)

_OPS = torch.ops.topiaxl_torch
_FLASH = (_OPS.flash_fwd.default,)
# every product without batch dimensions (``dots_with_no_batch_dims_
# saveable``): the linear layers' mm / addmm, and fc1's, which runs inside
# its op; not bmm
_DOTS = (*_FLASH, _OPS.mlp_fc1.default, torch.ops.aten.mm.default,
         torch.ops.aten.addmm.default)
# the ops a policy keeps the outputs of: the JAX policies' names
# (flash_out, flash_lse, mlp_fc1, ln_h, resid) as the ops that make them
REMAT_POLICIES = {
    "dots": _DOTS,
    "dots_plus": (*_DOTS, _OPS.ln_modulate.default,
                  _OPS.ln_modulate_residual.default),
    "flash": _FLASH,
    "flash_mlp": (*_FLASH, _OPS.mlp_fc1.default),
}


def check_remat(remat, policies=tuple(REMAT_POLICIES)) -> None:
    """Raise unless ``remat`` is a bool or one of ``policies``, naming the
    accepted modes as the JAX package does."""
    if not isinstance(remat, bool) and remat not in policies:
        raise ValueError(f"remat={remat!r}: expected False, True, "
                         + ", ".join(repr(p) for p in policies[:-1])
                         + f", or {policies[-1]!r}")


def remat_context(remat):
    """``torch.utils.checkpoint``'s ``context_fn`` for a remat mode:
    ``True`` recomputes every op of the block; a policy by name keeps the
    outputs of its ops (``MUST_SAVE``) and recomputes the rest."""
    if remat is True:
        return noop_context_fn
    return functools.partial(create_selective_checkpoint_contexts,
                             list(REMAT_POLICIES[remat]))


class DiTBlock(nn.Module):
    def __init__(self, hidden_size: int, cond_dim: int, num_heads: int,
                 mlp_ratio: float = 4.0, proj_bias: bool = True,
                 dtype=torch.bfloat16, param_dtype=None, quant: bool = False):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype, quant=quant)
        self.crossattn = CrossAttention(hidden_size, cond_dim, num_heads,
                                        qkv_bias=True, proj_bias=proj_bias,
                                        **kw)
        self.attn = SelfAttention(hidden_size, num_heads, qkv_bias=True,
                                  proj_bias=proj_bias, **kw)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio), hidden_size,
                       **kw)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), linear(hidden_size, 9 * hidden_size))

    def cond_kv(self, y):
        return self.crossattn.kv(y)

    def cond_null_out(self, y_null):
        """[1, 1, C] null token -> [1, 1, D] cross-attention output."""
        _, v = self.crossattn.kv(y_null)
        return self.crossattn.uniform_out(v)

    def forward(self, x, kv, t_emb, null_out=None, y=None):
        """x [B, N, D] residual stream in the compute dtype; kv precomputed,
        or None to project it here from the conditioning ``y`` (inside the
        block's call, where FSDP has gathered its weights); t_emb [B, D]
        f32; ``null_out`` selects the CFG fast path, where x is [cond;
        uncond] and the uncond half's cross-attention is null_out."""
        if kv is None:
            kv = self.cond_kv(y)
        mods = self.adaLN_modulation(t_emb).to(self.dtype)
        (s_mca, sc_mca, g_mca, s_msa, sc_msa, g_msa,
         s_mlp, sc_mlp, g_mlp) = mods.chunk(9, dim=-1)
        h = ln_modulate(x, s_mca, sc_mca, out_dtype=self.dtype)
        if null_out is None:
            att = self.crossattn.attend(h, *kv)
        else:
            B = x.shape[0] // 2
            att_c = self.crossattn.attend(h[:B], *kv)
            att = torch.cat(
                [att_c, null_out.to(att_c.dtype).expand_as(att_c)], dim=0)
        x, h = ln_modulate_residual(x, att, g_mca, s_msa, sc_msa,
                                    out_dtype=self.dtype)
        x, h = ln_modulate_residual(x, self.attn(h), g_msa, s_mlp, sc_mlp,
                                    out_dtype=self.dtype)
        return x + g_mlp[:, None, :] * self.mlp(h)


class FinalLayer(nn.Module):
    """adaLN (2-way) + projection; the result is returned in f32."""

    def __init__(self, hidden_size: int, out_channels: int,
                 dtype=torch.bfloat16, param_dtype=None):
        super().__init__()
        self.dtype = dtype
        self.linear = linear(hidden_size, out_channels, dtype=dtype,
                             param_dtype=param_dtype)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), linear(hidden_size, 2 * hidden_size))

    def forward(self, x, t_emb):
        shift, scale = self.adaLN_modulation(t_emb).to(self.dtype).chunk(2, -1)
        x = ln_modulate(x, shift, scale, out_dtype=self.dtype)
        return self.linear(x).float()


class PointEmbed(nn.Module):
    """Fourier embedding of points [B, N, 3] (f32): sin and cos of each
    axis at ``hidden_dim / 6`` power-of-2 frequencies times pi, and the
    raw xyz, through one Linear (``mlp``) to ``dim``."""

    def __init__(self, hidden_dim: int = 48, dim: int = 128):
        super().__init__()
        if hidden_dim % 6:
            raise ValueError(f"hidden_dim={hidden_dim} must be a multiple of 6")
        self.hidden_dim = hidden_dim
        self.mlp = linear(hidden_dim + 3, dim)

    def basis(self, device) -> torch.Tensor:
        """[3, hidden_dim / 2]: axis a's frequencies in columns a * f to
        (a + 1) * f, f = hidden_dim / 6."""
        f = self.hidden_dim // 6
        e = 2.0 ** torch.arange(f, dtype=torch.float32, device=device) * math.pi
        return torch.block_diag(e[None], e[None], e[None])

    def forward(self, pts: torch.Tensor) -> torch.Tensor:
        proj = pts @ self.basis(pts.device)
        return self.mlp(torch.cat([proj.sin(), proj.cos(), pts], dim=-1))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # the reference keeps the frequencies as a buffer; a state_dict that
        # carries them loads if they are these
        given = state_dict.pop(prefix + "basis", None)
        if given is not None and not torch.allclose(
                given.float().cpu(), self.basis("cpu")):
            raise ValueError(f"{prefix}basis is not PointEmbed's frequencies")
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def _block_with_kv(blk: DiTBlock, h, y, t_emb):
    return blk(h, None, t_emb, y=y)


class DiT(nn.Module):
    """Flagship generator; keys follow the reference's DiT state_dict."""

    def __init__(self, seq_length: int = 2048, in_channels: int = 68,
                 condition_channels: int = 768, hidden_size: int = 1152,
                 depth: int = 28, num_heads: int = 16, mlp_ratio: float = 4.0,
                 cond_drop_prob: float = 0.0, attn_proj_bias: bool = True,
                 learn_sigma: bool = True, dtype=torch.bfloat16,
                 param_dtype=None, quant: bool = False,
                 remat: bool | str = False, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if quant and param_dtype not in (None, dtype):
            raise ValueError("quant serves W8A8: no master weights")
        check_remat(remat)
        self.quant = quant
        self.remat = remat
        self.seq_length = seq_length
        self.in_channels = in_channels
        self.input_shape = (seq_length, in_channels)   # one sample's x
        self.condition_channels = condition_channels
        self.hidden_size = hidden_size
        self.depth = depth
        self.cond_drop_prob = cond_drop_prob
        self.dtype = dtype
        self.out_channels = in_channels * 2 if learn_sigma else in_channels
        self.x_embedder = linear(in_channels, hidden_size, dtype=dtype,
                                 param_dtype=param_dtype)
        self.t_embedder = TimestepEmbedder(hidden_size)
        self.blocks = nn.ModuleList(
            DiTBlock(hidden_size, condition_channels, num_heads, mlp_ratio,
                     attn_proj_bias, dtype, param_dtype, quant)
            for _ in range(depth))
        self.final_layer = FinalLayer(hidden_size, self.out_channels, dtype,
                                      param_dtype)
        self.null_cond_embedding = nn.Parameter(
            torch.empty(condition_channels, device="meta"))
        self.add_token_modules()
        materialize_(self, device, generator, DiT.init_weights)

    def add_token_modules(self) -> None:
        """Modules that ``embed_tokens`` adds to the token embedding, built
        before the weights are materialised; the plain DiT has none."""

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """The JAX package's init: xavier linears, N(0, 0.02) timestep MLP,
        zero adaLN and final projection (each block starts as the
        identity), N(0, 1) null embedding."""
        default_init_(self, gen)
        for lin in (self.t_embedder.mlp[0], self.t_embedder.mlp[2]):
            lin.weight.normal_(0.0, 0.02, generator=gen)
        for m in [b.adaLN_modulation[1] for b in self.blocks] + [
                self.final_layer.adaLN_modulation[1], self.final_layer.linear]:
            m.weight.zero_()
            m.bias.zero_()
        self.null_cond_embedding.normal_(0.0, 1.0, generator=gen)

    # ---- conditioning helpers -------------------------------------------

    def precompute_kv(self, y: torch.Tensor):
        """Per-block cross-attention K/V of conditioning tokens [B, M, C]."""
        return [blk.cond_kv(y) for blk in self.blocks]

    def precompute_null_out(self):
        """Per-block [1, 1, D] cross-attention outputs of the null branch."""
        y_null = self.null_cond_embedding[None, None, :]
        return [blk.cond_null_out(y_null) for blk in self.blocks]

    # ---- forward passes ---------------------------------------------------

    def embed_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """[B, N, C_in] tokens -> [B, N, D] in the compute dtype."""
        return self.x_embedder(x.to(self.dtype))

    def embed_t(self, t: torch.Tensor) -> torch.Tensor:
        """[B] timesteps -> [B, D] f32: the pipeline's replicated entry
        (``parallel/pipeline.py``) beside ``embed_tokens``."""
        return self.t_embedder(t)

    def apply_final(self, h: torch.Tensor, t_emb: torch.Tensor):
        """The final layer: the pipeline's replicated exit."""
        return self.final_layer(h, t_emb)

    def forward_kv(self, x, t, kvs):
        """Denoise step against precomputed per-block K/V; x [B, N, C_in],
        t [B] -> [B, N, C_out] f32."""
        h = self.embed_tokens(x)
        t_emb = self.t_embedder(t)
        for blk, kv in zip(self.blocks, kvs):
            h = blk(h, kv, t_emb)
        return self.final_layer(h, t_emb)

    def cond_drop_mask(self, batch: int, generator: torch.Generator,
                       device=None) -> torch.Tensor | None:
        """[batch] bool, True where a sample's conditioning is dropped
        (probability ``cond_drop_prob``); None when nothing is dropped."""
        if self.cond_drop_prob <= 0:
            return None
        u = torch.rand(batch, generator=generator, device=device)
        return u < self.cond_drop_prob

    def drop_cond(self, y, drop: torch.Tensor | None):
        """y [B, M, C_cond], the rows where ``drop`` ([B] bool or None) is
        True the null embedding (reference dit_crossattn.py:193-196), read
        whole where FSDP2 shards it."""
        if drop is None:
            return y
        null = full(self.null_cond_embedding).to(y.dtype)[None, None, :]
        return torch.where(drop.to(y.device)[:, None, None], null, y)

    def forward(self, x, t, y, drop: torch.Tensor | None = None):
        """Training forward: x [B, N, C_in], t [B], y [B, M, C_cond] ->
        [B, N, C_out] f32; the rows where ``drop`` is True see
        ``drop_cond``'s null conditioning."""
        y = self.drop_cond(y, drop)
        remat = self.remat and self.training and torch.is_grad_enabled()
        h = self.embed_tokens(x)
        t_emb = self.t_embedder(t)
        for blk in self.blocks:
            h = (checkpoint(_block_with_kv, blk, h, y, t_emb,
                            use_reentrant=False,
                            context_fn=remat_context(self.remat))
                 if remat else _block_with_kv(blk, h, y, t_emb))
        return self.final_layer(h, t_emb)

    def forward_with_cfg(self, x, t, y, cfg_scale: float):
        """Classifier-free guidance by batch doubling: the conditioning
        stacked on the null embedding broadcast to its shape
        (``topiaxl/models/dit.py:455-468``)."""
        null = self.null_cond_embedding.to(y.dtype)[None, None, :].expand_as(y)
        out = self(torch.cat([x, x], dim=0), torch.cat([t, t], dim=0),
                   torch.cat([y, null], dim=0))
        cond, uncond = out.chunk(2, dim=0)
        return uncond + cfg_scale * (cond - uncond)

    def forward_with_cfg_kv(self, x, t, kvs_pair, cfg_scale: float):
        """Classifier-free guidance against precomputed K/V whose batch is
        [cond; null] (``precompute_kv`` of the conditioning stacked on the
        null embedding broadcast to its shape)."""
        out = self.forward_kv(torch.cat([x, x], dim=0),
                              torch.cat([t, t], dim=0), kvs_pair)
        cond, uncond = out.chunk(2, dim=0)
        return uncond + cfg_scale * (cond - uncond)

    def forward_with_cfg_fast(self, x, t, kvs_cond, null_outs,
                              cfg_scale: float):
        """Classifier-free guidance: ``uncond + s * (cond - uncond)`` with
        cond-only K/V and the per-block null vectors."""
        h = self.embed_tokens(torch.cat([x, x], dim=0))
        t_emb = self.t_embedder(torch.cat([t, t], dim=0))
        for blk, kv, no in zip(self.blocks, kvs_cond, null_outs):
            h = blk(h, kv, t_emb, null_out=no)
        cond, uncond = self.final_layer(h, t_emb).chunk(2, dim=0)
        return uncond + cfg_scale * (cond - uncond)


class DiTAdditivePosEmb(DiT):
    """DiT whose token embedding adds ``point_emb`` of the prim centres
    (token channels 1:4), computed in f32 and cast to the compute dtype."""

    def add_token_modules(self) -> None:
        self.point_emb = PointEmbed(48, self.hidden_size)

    def embed_tokens(self, x: torch.Tensor) -> torch.Tensor:
        pts = x[:, :, 1:4].float()
        return super().embed_tokens(x) + self.point_emb(pts).to(self.dtype)


def quantize_dit_state_dict(qdit: DiT, float_sd) -> dict:
    """A float DiT state_dict as the state_dict of ``qdit`` (a DiT built
    with ``quant=True``): the block matmuls quantized, the rest passed
    through (``topiaxl/models/dit.py:quantize_dit_params``)."""
    if not qdit.quant:
        raise ValueError("quantize_dit_state_dict needs a DiT(quant=True)")
    return quantize_state_dict_like(float_sd, qdit)
