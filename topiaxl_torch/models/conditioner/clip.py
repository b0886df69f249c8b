"""CLIP text and vision towers (counterparts of
``topiaxl/models/conditioner/clip.py``).

Standard CLIP: token or patch embeddings plus learned positions, pre-LN
transformer layers (LN -> attention -> residual, LN -> MLP with
``quick_gelu`` -> residual), LayerNorms at eps 1e-5. The text tower
attends causally and pools at the first EOS token of each row (a row
without one pools at ``argmax(input_ids)``, as the JAX tower does); the
vision tower prepends a class embedding, applies a pre-LayerNorm and
pools the class token through a post-LayerNorm. Both return
``{"last_hidden_state", "pooled"}``.

Module names follow transformers' ``CLIPTextModel`` / ``CLIPVisionModel``
below their ``text_model.`` / ``vision_model.`` prefixes, so a local
checkpoint loads strictly (``core/weights.py:load_clip_dir``).

Precision as in the JAX towers: f32 weights; the residual stream,
embeddings and LayerNorms in f32, the matmuls in ``dtype`` (default f32).

Attention. The causal text tower keeps the JAX tower's masked f32
softmax (logits at -1e30 above the diagonal, no kernel: the port's flash
kernel has no causal mask). The vision tower goes through
``ops/attention.multi_head_attention``, so the flash kernel serves it
where that module's shape rule says (at least 512 keys, head_dim >= 64,
bf16 on a CUDA device). At 224² neither published tower reaches 512
tokens (B/32: 50, L/14: 257), so there both run the plain form, on the
card as on the CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import multi_head_attention
from ..layers import META, default_init_, linear, materialize_


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _ClipAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, causal: bool, dtype):
        super().__init__()
        self.dim, self.num_heads, self.causal = dim, num_heads, causal
        kw = dict(dtype=dtype, param_dtype=torch.float32)
        self.q_proj = linear(dim, dim, **kw)
        self.k_proj = linear(dim, dim, **kw)
        self.v_proj = linear(dim, dim, **kw)
        self.out_proj = linear(dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, _ = x.shape
        hd = self.dim // self.num_heads
        q, k, v = (p(x).reshape(B, N, self.num_heads, hd)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        if self.causal:
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                                  k.float()) * hd ** -0.5
            mask = torch.ones(N, N, dtype=torch.bool, device=x.device).tril()
            logits = torch.where(mask, logits, -1e30)
            probs = torch.softmax(logits, dim=-1).to(x.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(x.dtype))
        else:
            out = multi_head_attention(q, k, v, scale=hd ** -0.5)
        return self.out_proj(out.reshape(B, N, self.dim))


class _ClipMlp(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, dtype):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=torch.float32)
        self.fc1 = linear(dim, mlp_dim, **kw)
        self.fc2 = linear(mlp_dim, dim, **kw)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class _ClipLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int, causal: bool,
                 dtype):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(dim, eps=1e-5, device=META)
        self.self_attn = _ClipAttention(dim, num_heads, causal, dtype)
        self.layer_norm2 = nn.LayerNorm(dim, eps=1e-5, device=META)
        self.mlp = _ClipMlp(dim, mlp_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x)).float()
        return x + self.mlp(self.layer_norm2(x)).float()


class _Encoder(nn.Module):
    def __init__(self, n: int, *args):
        super().__init__()
        self.layers = nn.ModuleList(_ClipLayer(*args) for _ in range(n))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class _TextEmbeddings(nn.Module):
    def __init__(self, vocab_size: int, dim: int, max_positions: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, dim, device=META)
        self.position_embedding = nn.Embedding(max_positions, dim, device=META)


class _VisionEmbeddings(nn.Module):
    def __init__(self, dim: int, patch_size: int, num_positions: int):
        super().__init__()
        self.patch_embedding = nn.Conv2d(3, dim, patch_size, patch_size,
                                         bias=False, device=META)
        self.class_embedding = nn.Parameter(torch.empty(dim, device=META))
        self.position_embedding = nn.Embedding(num_positions, dim,
                                               device=META)


def _init_(module: nn.Module, gen: torch.Generator) -> None:
    """Xavier linears, LeCun conv, unit LayerNorms (``default_init_``),
    N(0, 0.02) embeddings."""
    default_init_(module, gen)
    for m in module.modules():
        if isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 0.02, generator=gen)
        elif isinstance(m, _VisionEmbeddings):
            m.class_embedding.normal_(0.0, 0.02, generator=gen)


class CLIPTextTower(nn.Module):
    """``forward(input_ids [B, N])`` -> ``last_hidden_state`` [B, N, D] and
    ``pooled`` [B, D] (the hidden state at each row's first EOS)."""

    def __init__(self, vocab_size: int = 49408, hidden_size: int = 512,
                 num_layers: int = 12, num_heads: int = 8, mlp_dim: int = 2048,
                 max_positions: int = 77, eos_token_id: int = 49407,
                 dtype=torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.eos_token_id = eos_token_id
        self.embeddings = _TextEmbeddings(vocab_size, hidden_size,
                                          max_positions)
        self.encoder = _Encoder(num_layers, hidden_size, num_heads, mlp_dim,
                                True, dtype)
        self.final_layer_norm = nn.LayerNorm(hidden_size, eps=1e-5,
                                             device=META)
        materialize_(self, device, generator, _init_)

    def forward(self, input_ids: torch.Tensor) -> dict:
        B, N = input_ids.shape
        emb = self.embeddings
        x = (emb.token_embedding(input_ids)
             + emb.position_embedding.weight[None, :N])
        x = self.final_layer_norm(self.encoder(x))
        is_eos = input_ids == self.eos_token_id
        eos_pos = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1),
                              input_ids.argmax(dim=1))
        pooled = x[torch.arange(B, device=x.device), eos_pos]
        return {"last_hidden_state": x, "pooled": pooled}


class CLIPVisionTower(nn.Module):
    """``forward(pixels [B, H, W, 3])`` (normalised) -> ``last_hidden_state``
    [B, 1 + P, D] and ``pooled`` [B, D] (the post-LN class token)."""

    def __init__(self, hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, mlp_dim: int = 3072,
                 patch_size: int = 32, image_size: int = 224,
                 dtype=torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.image_size = image_size
        self.embeddings = _VisionEmbeddings(
            hidden_size, patch_size, 1 + (image_size // patch_size) ** 2)
        self.pre_layrnorm = nn.LayerNorm(hidden_size, eps=1e-5, device=META)
        self.encoder = _Encoder(num_layers, hidden_size, num_heads, mlp_dim,
                                False, dtype)
        self.post_layernorm = nn.LayerNorm(hidden_size, eps=1e-5, device=META)
        materialize_(self, device, generator, _init_)

    def forward(self, pixels: torch.Tensor) -> dict:
        emb = self.embeddings
        conv = emb.patch_embedding
        x = F.conv2d(pixels.float().permute(0, 3, 1, 2), conv.weight,
                     stride=conv.stride)
        x = x.flatten(2).transpose(1, 2)
        cls = emb.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
        x = x + emb.position_embedding.weight[None, :x.shape[1]]
        x = self.encoder(self.pre_layrnorm(x))
        return {"last_hidden_state": x, "pooled": self.post_layernorm(x[:, 0])}


def load_clip_tower(path: str, tower: str, dtype=torch.float32,
                    device=None) -> nn.Module:
    """The ``tower`` ("text" or "vision") of a local transformers-layout
    CLIP directory (``core/weights.py:load_clip_dir``), built from its
    config (transformers' defaults where a key is absent) and loaded
    strictly, in eval mode."""
    from ...core.weights import load_clip_dir

    cfg, sd = load_clip_dir(path, tower)
    if tower == "text":
        model = CLIPTextTower(
            vocab_size=cfg.get("vocab_size", 49408),
            hidden_size=cfg.get("hidden_size", 512),
            num_layers=cfg.get("num_hidden_layers", 12),
            num_heads=cfg.get("num_attention_heads", 8),
            mlp_dim=cfg.get("intermediate_size", 2048),
            max_positions=cfg.get("max_position_embeddings", 77),
            eos_token_id=cfg.get("eos_token_id", 49407), dtype=dtype,
            device=device)
    else:
        model = CLIPVisionTower(
            hidden_size=cfg.get("hidden_size", 768),
            num_layers=cfg.get("num_hidden_layers", 12),
            num_heads=cfg.get("num_attention_heads", 12),
            mlp_dim=cfg.get("intermediate_size", 3072),
            patch_size=cfg.get("patch_size", 32),
            image_size=cfg.get("image_size", 224), dtype=dtype, device=device)
    model.load_state_dict(sd)
    return model.eval()
