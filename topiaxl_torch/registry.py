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
