"""Factory registrations: a config's ``class_name`` -> the port's classes.

The counterpart of the JAX package's ``topiaxl/registry.py``, under the
same names: its ``topiaxl.*`` names and the reference's dotted class
paths (the names are strings; nothing of the JAX package is imported).
``core.config.build(cfg, device=..., generator=...)`` instantiates one;
``device`` and ``generator`` reach the models' constructors (the
generator fills their random init), and the DiT and VAE factories also
take ``param_dtype`` (f32 master weights for training).

Keys as the JAX factories read them, with the same defaults;
``gradient_checkpointing: true`` maps to the DiT's ``remat=True``, a
remat policy by name (``remat: flash``, ...) passes through, and
``precision`` is dropped (``dtype`` sets the compute type).
TRELLIS's ``SparseStructureFlowModel`` (``topiaxl.SparseStructureFlowModel``)
takes the keys of its published JSON (``resolution``, ``model_channels``,
``num_blocks``, ...); ``use_fp16`` computes in bf16 (the port's compute
dtype), and the options the port does not implement (a patch size other
than 1, ``pe_mode`` other than ``ape``, ``share_mod``,
``qk_rms_norm_cross``) raise. ``cond_drop_prob`` is the trainer's
``p_uncond``.
Hunyuan3D-2's shape DiT (``Hunyuan3DDiT``, also under its config's
``target`` path and ``topiaxl.Hunyuan3DDiT``) takes the keys of its
published ``config.yaml`` (``in_channels``, ``context_in_dim``,
``hidden_size``, ``depth``, ``depth_single_blocks``, ...) and the port's
``num_latents`` (the ShapeVAE's latent count), ``cond_drop_prob`` and
``dtype``; ``axes_dim`` and ``theta`` are accepted and unused, as in the
published model (its latents take no position embedding), and
``guidance_embed: true`` or a ``time_factor`` other than 1000 (the port's
objective hands the model 1000 t) raise.
Hunyuan3D-2.1's shape DiT (``HunYuanDiTPlain``, also under its config's
``target`` path and ``topiaxl.HunYuanDiTPlain``) takes the keys of its
published ``config.yaml`` (``input_size``, ``in_channels``,
``hidden_size``, ``context_dim``, ``depth``, ``num_heads``,
``num_moe_layers``, ``num_experts``, ``moe_top_k``, ...) and the port's
``cond_drop_prob`` and ``dtype``; ``text_len`` is accepted and unused (it
sizes only the attention pooling), and what the published model does not
use raises: decoupled cross-attention, attention pooling, position
embeddings, ``guidance_cond_proj_dim``, ``timested_modulate``, an RMS
``norm_type``, a LayerNorm ``qk_norm_type``, ``qk_norm`` false,
``qkv_bias`` true, an ``mlp_ratio`` other than 4 (the release's blocks are
4C wide whatever it says).
``scan_blocks: true`` builds the unrolled DiT: JAX's scan over the blocks
is the same math in a layout that compiles faster on the TPU, and the
port has no stacked layout (``core/weights.py`` reads JAX's stacked
trees into the unrolled names). The text and
CLIP encoders read their weights from a local ``model_name_or_path``
(no download); ``TextConditioner`` without one needs ``stub: true``.
"""

from __future__ import annotations

import torch

from .core.config import build, register

_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "fp32": torch.float32, "float32": torch.float32}


def _dtype(kw: dict) -> torch.dtype:
    name = kw.get("dtype", "bf16")
    if name not in _DTYPES:
        raise ValueError(f"dtype={name!r}: expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


def _dit_kwargs(kw: dict) -> dict:
    """The DiT's constructor arguments from a ``model.generator`` node
    (``topiaxl/registry.py:make_dit``)."""
    kw = dict(kw)
    if kw.pop("gradient_checkpointing", False):
        kw.setdefault("remat", True)
    kw.pop("precision", None)
    remat = kw.get("remat", False)
    return dict(seq_length=kw.get("seq_length", 2048),
                in_channels=kw.get("in_channels", 68),
                condition_channels=kw.get("condition_channels", 768),
                hidden_size=kw.get("hidden_size", 1152),
                depth=kw.get("depth", 28), num_heads=kw.get("num_heads", 16),
                mlp_ratio=kw.get("mlp_ratio", 4.0),
                cond_drop_prob=kw.get("cond_drop_prob", 0.0),
                attn_proj_bias=kw.get("attn_proj_bias", False),
                learn_sigma=kw.get("learn_sigma", True), dtype=_dtype(kw),
                remat=remat if isinstance(remat, str) else bool(remat),
                quant=bool(kw.get("quant", False)))


@register("topiaxl.DiT", "models.dit_crossattn.DiT")
def make_dit(device=None, generator=None, param_dtype=None, **kw):
    from .models.dit import DiT

    return DiT(**_dit_kwargs(kw), param_dtype=param_dtype, device=device,
               generator=generator)


@register("topiaxl.DiTAdditivePosEmb", "models.dit_crossattn.DiTAdditivePosEmb")
def make_dit_additive(device=None, generator=None, param_dtype=None, **kw):
    from .models.dit import DiTAdditivePosEmb

    return DiTAdditivePosEmb(**_dit_kwargs(kw), param_dtype=param_dtype,
                             device=device, generator=generator)


@register("topiaxl.SparseStructureFlowModel", "SparseStructureFlowModel")
def make_ss_flow(device=None, generator=None, param_dtype=None, **kw):
    from .models.ss_flow import SparseStructureFlowModel

    unsupported = {"patch_size": 1, "pe_mode": "ape", "share_mod": False,
                   "qk_rms_norm_cross": False}
    for key, only in unsupported.items():
        if kw.get(key, only) != only:
            raise ValueError(f"SparseStructureFlowModel: {key}={kw[key]!r} is "
                             f"not implemented (only {only!r})")
    kw.pop("use_checkpoint", None)
    kw.setdefault("dtype", "bf16" if kw.pop("use_fp16", True) else "fp32")
    channels = kw.get("model_channels", 1024)
    heads = kw.get("num_heads") or channels // kw.get("num_head_channels", 64)
    return SparseStructureFlowModel(
        resolution=kw.get("resolution", 16),
        in_channels=kw.get("in_channels", 8), model_channels=channels,
        cond_channels=kw.get("cond_channels", 1024),
        out_channels=kw.get("out_channels", 8),
        num_blocks=kw.get("num_blocks", 24), num_heads=heads,
        mlp_ratio=kw.get("mlp_ratio", 4.0),
        qk_rms_norm=bool(kw.get("qk_rms_norm", False)),
        cond_drop_prob=kw.get("cond_drop_prob", 0.0), dtype=_dtype(kw),
        param_dtype=param_dtype, device=device, generator=generator)


@register("topiaxl.Hunyuan3DDiT", "Hunyuan3DDiT",
          "hy3dgen.shapegen.models.Hunyuan3DDiT")
def make_hunyuan3d_dit(device=None, generator=None, param_dtype=None, **kw):
    from .models.mmdit import Hunyuan3DDiT

    unsupported = {"guidance_embed": False, "time_factor": 1000}
    for key, only in unsupported.items():
        if kw.get(key, only) != only:
            raise ValueError(f"Hunyuan3DDiT: {key}={kw[key]!r} is not "
                             f"implemented (only {only!r})")
    return Hunyuan3DDiT(
        in_channels=kw.get("in_channels", 64),
        context_in_dim=kw.get("context_in_dim", 1536),
        hidden_size=kw.get("hidden_size", 1024),
        mlp_ratio=kw.get("mlp_ratio", 4.0), num_heads=kw.get("num_heads", 16),
        depth=kw.get("depth", 16),
        depth_single_blocks=kw.get("depth_single_blocks", 32),
        qkv_bias=bool(kw.get("qkv_bias", True)),
        num_latents=kw.get("num_latents", 3072),
        cond_drop_prob=kw.get("cond_drop_prob", 0.0), dtype=_dtype(kw),
        param_dtype=param_dtype, device=device, generator=generator)


@register("topiaxl.HunYuanDiTPlain", "HunYuanDiTPlain",
          "hy3dshape.models.denoisers.hunyuandit.HunYuanDiTPlain")
def make_hunyuan3d21_dit(device=None, generator=None, param_dtype=None, **kw):
    from .models.hunyuandit import HunYuanDiTPlain

    unsupported = {"norm_type": "layer", "qk_norm_type": "rms",
                   "with_decoupled_ca": False, "use_attention_pooling": False,
                   "use_pos_emb": False, "guidance_cond_proj_dim": None,
                   "timested_modulate": False, "mlp_ratio": 4.0,
                   "qk_norm": True, "qkv_bias": False}
    for key, only in unsupported.items():
        if kw.get(key, only) != only:
            raise ValueError(f"HunYuanDiTPlain: {key}={kw[key]!r} is not "
                             f"implemented (only {only!r})")
    return HunYuanDiTPlain(
        input_size=kw.get("input_size", 4096),
        in_channels=kw.get("in_channels", 64),
        hidden_size=kw.get("hidden_size", 2048),
        context_dim=kw.get("context_dim", 1024), depth=kw.get("depth", 21),
        num_heads=kw.get("num_heads", 16),
        num_moe_layers=kw.get("num_moe_layers", 6),
        num_experts=kw.get("num_experts", 8), moe_top_k=kw.get("moe_top_k", 2),
        cond_drop_prob=kw.get("cond_drop_prob", 0.0), dtype=_dtype(kw),
        param_dtype=param_dtype, device=device, generator=generator)


@register("topiaxl.VAE3D", "models.vae3d_dib.VAE")
def make_vae(device=None, generator=None, param_dtype=None, **kw):
    from .models.vae3d import VAE3D

    kw.pop("gradient_checkpointing", None)
    return VAE3D(in_channels=kw.get("in_channels", 6),
                 latent_channels=kw.get("latent_channels", 1),
                 out_channels=kw.get("out_channels", 6),
                 down_channels=tuple(kw.get("down_channels", (32, 256))),
                 mid_attention=kw.get("mid_attention", True),
                 up_channels=tuple(kw.get("up_channels", (256, 32))),
                 layers_per_block=kw.get("layers_per_block", 2),
                 dtype=_dtype(kw), param_dtype=param_dtype, device=device,
                 generator=generator)


@register("topiaxl.PrimX", "models.primsdf.PrimSDF")
def make_primx(device=None, generator=None, **kw):
    from .models.primx import PrimX

    return PrimX(**{k: kw[k] for k in (
        "num_prims", "dim_feat", "prim_shape", "init_scale", "sdf2alpha_var",
        "auto_scale_init", "init_sampling") if k in kw})


@register("topiaxl.DinoV2Wrapper",
          "models.conditioner.image_dinov2.Dinov2Wrapper")
def make_dinov2(device=None, generator=None, **kw):
    from .models.conditioner.image import DinoV2Wrapper

    return DinoV2Wrapper(model_name=kw.get("model_name", "dinov2_vitb14_reg"),
                         dtype=_dtype(kw), device=device, generator=generator)


def _renderer_kwargs(kw: dict) -> dict:
    """The render-then-encode settings as the JAX factories pass them."""
    return dict(num_prims=kw.get("num_prims", 2048),
                dim_feat=kw.get("dim_feat", 6),
                prim_shape=kw.get("prim_shape", 8),
                sample_view=kw.get("sample_view", False))


def _encoder(kw: dict, device, generator):
    from .models.conditioner.image import DinoV2Wrapper

    enc = kw.get("encoder_config")
    return (build(enc, device=device, generator=generator) if enc
            else DinoV2Wrapper(device=device, generator=generator))


@register("topiaxl.ImageConditioner",
          "models.conditioner.image.ImageConditioner")
def make_image_conditioner(device=None, generator=None, **kw):
    from .models.conditioner.image import ImageConditioner

    return ImageConditioner(_encoder(kw, device, generator),
                            **_renderer_kwargs(kw))


@register("topiaxl.ImageMultiViewConditioner",
          "models.conditioner.image.ImageMultiViewConditioner")
def make_image_multiview_conditioner(device=None, generator=None, **kw):
    from .models.conditioner.image import ImageMultiViewConditioner

    return ImageMultiViewConditioner(_encoder(kw, device, generator),
                                     **_renderer_kwargs(kw),
                                     view_counts=kw.get("view_counts", 4))


@register("topiaxl.DummyImageConditioner",
          "models.conditioner.image.DummyImageConditioner")
def make_dummy_conditioner(device=None, generator=None, **kw):
    from .models.conditioner.image import DummyImageConditioner

    return DummyImageConditioner(**kw)


@register("topiaxl.TextConditioner", "models.conditioner.text.TextConditioner")
def make_text_conditioner(device=None, generator=None, **kw):
    from .models.conditioner.text import CLIPTextEncoder, TextConditioner

    encoder = None
    if kw.get("model_name_or_path"):
        encoder = CLIPTextEncoder(model_name_or_path=kw["model_name_or_path"],
                                  device=device)
    return TextConditioner(encoder=encoder, dim=kw.get("dim", 768),
                           stub=bool(kw.get("stub", False)), device=device)


@register("topiaxl.CLIPImageEncoder",
          "models.conditioner.image.CLIPImageEncoder")
def make_clip_image_encoder(device=None, generator=None, **kw):
    from .models.conditioner.image import CLIPImageEncoder

    return CLIPImageEncoder(model_name_or_path=kw.get("model_name_or_path"),
                            tokens=bool(kw.get("tokens", False)),
                            device=device)


@register("topiaxl.CLIPTextEncoder",
          "models.conditioner.text.CLIPTextEncoder")
def make_clip_text_encoder(device=None, generator=None, **kw):
    from .models.conditioner.text import CLIPTextEncoder

    return CLIPTextEncoder(model_name_or_path=kw.get("model_name_or_path"),
                           device=device)
