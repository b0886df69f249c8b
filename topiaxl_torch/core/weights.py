"""JAX parameter trees -> the port's state_dicts.

The exact inverses of ``topiaxl/core/convert.py``'s ``convert_dit``,
``convert_vae`` and ``convert_dinov2``: each takes the JAX package's
parameter tree (``{"params": ...}`` or its inner dict) as numpy arrays
and returns a state_dict in the released reference's key layout, which
the port's modules load with ``load_state_dict(strict=True)``.

Layouts (inverse of the converter's rules):
* Dense kernel [in, out]            -> Linear weight [out, in]
* Conv kernel [kd, kh, kw, in, out] -> Conv3d weight [out, in, kd, kh, kw]
* ConvTranspose kernel [k..., in, out] with spatially flipped taps
  -> ConvTranspose3d weight [in, out, k...] (flip undone)
* norm scale/bias                   -> weight/bias

The maps are linear in the leaves, so any tree shaped like the
parameters maps the same way: a gradient tree or an Adam moment tree
(optax's ``mu`` / ``nu``) comes back under the port's parameter names.
``dit_from_jax`` also takes ``DiTAdditivePosEmb``'s tree (its
``point_emb.mlp`` Dense), the ``scan_blocks`` layout (``blocks.block.*``
stacked on a leading depth axis, ``topiaxl/models/dit.py:502-530``) and
the quantized tree of ``quantize_dit_params`` (``kernel_q`` int8 [in,
out] and ``kernel_scale`` f32 [out] -> ``weight_q`` [out, in] and
``weight_scale``, the buffers of ``ops/int8.py:QuantDense``).

``clip_text_from_jax`` and ``clip_vision_from_jax`` invert
``convert_clip_text`` / ``convert_clip_vision`` into the port's CLIP
towers (transformers' names below ``text_model.`` / ``vision_model.``);
``load_clip_dir`` reads those names from a local transformers-layout
directory.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _inner(tree: Mapping) -> Mapping:
    return tree["params"] if "params" in tree else tree


def _linear(sd, prefix, p):
    if "kernel_q" in p:
        # a QuantDense: int8 codes [in, out] and f32 scales [out]
        sd[f"{prefix}.weight_q"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(p["kernel_q"], np.int8).T))
        sd[f"{prefix}.weight_scale"] = _t(p["kernel_scale"])
    else:
        sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv3d(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(4, 3, 0, 1, 2))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv_transpose3d(sd, prefix, p):
    w = np.asarray(p["kernel"]).transpose(3, 4, 0, 1, 2)[:, :, ::-1, ::-1, ::-1]
    sd[f"{prefix}.weight"] = _t(w)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _norm(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _count(p: Mapping, stem: str) -> int:
    return sum(1 for k in p if k.startswith(stem) and k[len(stem):].isdigit())


def _unstack_blocks(p: Mapping) -> dict:
    """The scan layout's ``blocks.block`` subtree, stacked on a leading
    depth axis, as ``blocks_<i>`` entries (unstack_block_params, numpy)."""
    p = dict(p)
    stacked = p.pop("blocks")["block"]

    def take(t, i):
        if isinstance(t, Mapping):
            return {k: take(v, i) for k, v in t.items()}
        return np.asarray(t)[i]

    def depth(t):
        return depth(next(iter(t.values()))) if isinstance(t, Mapping) \
            else np.asarray(t).shape[0]

    for i in range(depth(stacked)):
        p[f"blocks_{i}"] = take(stacked, i)
    return p


def dit_from_jax(tree: Mapping) -> dict:
    """A DiT parameter tree (unrolled ``blocks_<i>`` or the scan layout),
    or a gradient / moment tree of the same shape, as a state_dict."""
    p = _inner(tree)
    if "blocks" in p:
        p = _unstack_blocks(p)
    sd: dict = {}
    _linear(sd, "x_embedder", p["x_embedder"])
    _linear(sd, "t_embedder.mlp.0", p["t_embedder"]["fc1"])
    _linear(sd, "t_embedder.mlp.2", p["t_embedder"]["fc2"])
    if "null_cond_embedding" in p:
        sd["null_cond_embedding"] = _t(p["null_cond_embedding"])
    if "point_emb" in p:   # DiTAdditivePosEmb
        _linear(sd, "point_emb.mlp", p["point_emb"]["mlp"])
    for i in range(_count(p, "blocks_")):
        b, q = f"blocks.{i}", p[f"blocks_{i}"]
        _linear(sd, f"{b}.adaLN_modulation.1", q["adaLN_modulation"])
        for name in ("to_q", "to_k", "to_v", "proj"):
            _linear(sd, f"{b}.crossattn.{name}", q["crossattn"][name])
        _linear(sd, f"{b}.attn.qkv", q["attn"]["qkv"])
        _linear(sd, f"{b}.attn.proj", q["attn"]["proj"])
        _linear(sd, f"{b}.mlp.fc1", q["mlp"]["fc1"])
        _linear(sd, f"{b}.mlp.fc2", q["mlp"]["fc2"])
    _linear(sd, "final_layer.adaLN_modulation.1",
            p["final_layer"]["adaLN_modulation"])
    _linear(sd, "final_layer.linear", p["final_layer"]["linear"])
    return sd


def _resblock(sd, prefix, p):
    _norm(sd, f"{prefix}.norm1", p["norm1"]["GroupNorm_0"])
    _conv3d(sd, f"{prefix}.conv1", p["conv1"])
    _norm(sd, f"{prefix}.norm2", p["norm2"]["GroupNorm_0"])
    _conv3d(sd, f"{prefix}.conv2", p["conv2"])
    if "shortcut" in p:
        _conv3d(sd, f"{prefix}.shortcut", p["shortcut"])


def _midblock(sd, prefix, p):
    for i in range(_count(p, "res")):
        _resblock(sd, f"{prefix}.nets.{i}", p[f"res{i}"])
    for i in range(_count(p, "attn")):
        a = p[f"attn{i}"]
        _norm(sd, f"{prefix}.attns.{i}.norm", a["GroupNorm32_0"]["GroupNorm_0"])
        _linear(sd, f"{prefix}.attns.{i}.attn.qkv", a["attn"]["qkv"])
        _linear(sd, f"{prefix}.attns.{i}.attn.proj", a["attn"]["proj"])


def vae_from_jax(tree: Mapping) -> dict:
    p = _inner(tree)
    sd: dict = {}
    enc, dec = p["encoder"], p["decoder"]
    _conv3d(sd, "encoder.conv_in", enc["conv_in"])
    for i in range(_count(enc, "down")):
        blk = enc[f"down{i}"]
        for j in range(_count(blk, "res")):
            _resblock(sd, f"encoder.down_blocks.{i}.nets.{j}", blk[f"res{j}"])
        if "down" in blk:
            _conv3d(sd, f"encoder.down_blocks.{i}.downsample", blk["down"])
    _midblock(sd, "encoder.mid_block", enc["mid"])
    _norm(sd, "encoder.norm_out", enc["GroupNorm32_0"]["GroupNorm_0"])
    _conv3d(sd, "encoder.conv_out", enc["conv_out"])

    _conv3d(sd, "decoder.conv_in", dec["conv_in"])
    _midblock(sd, "decoder.mid_block", dec["mid"])
    for i in range(_count(dec, "up")):
        blk = dec[f"up{i}"]
        for j in range(_count(blk, "res")):
            _resblock(sd, f"decoder.up_blocks.{i}.nets.{j}", blk[f"res{j}"])
        if "up" in blk:
            _conv_transpose3d(sd, f"decoder.up_blocks.{i}.upsample", blk["up"])
    _norm(sd, "decoder.norm_out", dec["GroupNorm32_0"]["GroupNorm_0"])
    _conv_transpose3d(sd, "decoder.conv_out", dec["conv_out"])
    _conv3d(sd, "quant_conv", p["quant_conv"])
    _conv3d(sd, "post_quant_conv", p["post_quant_conv"])
    return sd


def dinov2_from_jax(tree: Mapping) -> dict:
    """The JAX tree has no ``mask_token`` (unused at inference); it comes
    back as zeros so the state_dict still loads strictly."""
    p = _inner(tree)
    sd: dict = {}
    sd["patch_embed.proj.weight"] = _t(
        np.asarray(p["patch_embed"]["kernel"]).transpose(3, 2, 0, 1))
    sd["patch_embed.proj.bias"] = _t(p["patch_embed"]["bias"])
    sd["cls_token"] = _t(p["cls_token"])
    sd["pos_embed"] = _t(p["pos_embed"])
    if "register_tokens" in p:
        sd["register_tokens"] = _t(p["register_tokens"])
    sd["mask_token"] = torch.zeros(1, np.asarray(p["cls_token"]).shape[-1])
    for i in range(_count(p, "block")):
        b, q = f"blocks.{i}", p[f"block{i}"]
        _norm(sd, f"{b}.norm1", q["norm1"])
        _norm(sd, f"{b}.norm2", q["norm2"])
        _linear(sd, f"{b}.attn.qkv", q["attn"]["qkv"])
        _linear(sd, f"{b}.attn.proj", q["attn"]["proj"])
        _linear(sd, f"{b}.mlp.fc1", q["fc1"])
        _linear(sd, f"{b}.mlp.fc2", q["fc2"])
        sd[f"{b}.ls1.gamma"] = _t(q["ls1_gamma"])
        sd[f"{b}.ls2.gamma"] = _t(q["ls2_gamma"])
    _norm(sd, "norm", p["norm"])
    return sd


def _clip_layers(sd, p):
    for i in range(_count(p, "layer")):
        b, q = f"encoder.layers.{i}", p[f"layer{i}"]
        _norm(sd, f"{b}.layer_norm1", q["layer_norm1"])
        _norm(sd, f"{b}.layer_norm2", q["layer_norm2"])
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(sd, f"{b}.self_attn.{name}", q["self_attn"][name])
        _linear(sd, f"{b}.mlp.fc1", q["fc1"])
        _linear(sd, f"{b}.mlp.fc2", q["fc2"])


def clip_text_from_jax(tree: Mapping) -> dict:
    """A ``CLIPTextTower`` tree (``convert_clip_text``'s output) as the
    port's ``CLIPTextTower`` state_dict (transformers' names without the
    ``text_model.`` prefix)."""
    p = _inner(tree)
    sd = {"embeddings.token_embedding.weight":
          _t(p["token_embedding"]["embedding"]),
          "embeddings.position_embedding.weight": _t(p["position_embedding"])}
    _clip_layers(sd, p)
    _norm(sd, "final_layer_norm", p["final_layer_norm"])
    return sd


def clip_vision_from_jax(tree: Mapping) -> dict:
    """A ``CLIPVisionTower`` tree as the port's ``CLIPVisionTower``
    state_dict (patch kernel [p, p, 3, D] -> conv weight [D, 3, p, p])."""
    p = _inner(tree)
    sd = {"embeddings.patch_embedding.weight": _t(
        np.asarray(p["patch_embedding"]["kernel"]).transpose(3, 2, 0, 1)),
        "embeddings.class_embedding": _t(p["class_embedding"]),
        "embeddings.position_embedding.weight": _t(p["position_embedding"])}
    _norm(sd, "pre_layrnorm", p["pre_layrnorm"])
    _clip_layers(sd, p)
    _norm(sd, "post_layernorm", p["post_layernorm"])
    return sd


def load_clip_dir(path: str, tower: str) -> tuple[dict, dict]:
    """(config, state_dict) of the ``tower`` ("text" or "vision") of a
    local transformers-layout CLIP directory: ``config.json`` (a
    ``CLIPConfig``, whose ``text_config`` / ``vision_config`` is taken, or
    the tower's own config) and ``pytorch_model.bin``, or
    ``model.safetensors`` where the ``safetensors`` package imports. The
    state_dict holds the ``text_model.*`` / ``vision_model.*`` entries
    with that prefix removed (the keys ``convert_clip_text`` and
    ``convert_clip_vision`` read); nothing of ``transformers`` is
    imported."""
    import json
    import os

    if tower not in ("text", "vision"):
        raise ValueError(f"tower={tower!r}: expected 'text' or 'vision'")
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    cfg = cfg.get(f"{tower}_config", cfg)
    bin_path = os.path.join(path, "pytorch_model.bin")
    st_path = os.path.join(path, "model.safetensors")
    if os.path.exists(bin_path):
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
    elif os.path.exists(st_path):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise RuntimeError(f"{st_path}: reading it needs the safetensors "
                               f"package ({e}); give pytorch_model.bin") from e
        sd = load_file(st_path)
    else:
        raise FileNotFoundError(f"{path}: no pytorch_model.bin or "
                                f"model.safetensors")
    prefix = f"{tower}_model."
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)
          and not k.endswith("position_ids")}
    if not sd:
        raise KeyError(f"{path}: no {prefix}* weights")
    return cfg, sd
