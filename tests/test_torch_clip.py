"""The CLIP towers, text conditioning and ``CLIPImageEncoder`` of
topiaxl_torch against the JAX package, and the towers against
transformers' ``CLIPTextModel`` / ``CLIPVisionModel`` at random init,
on the CPU in f32 at small widths (hidden 32, 2 layers, 4 heads).

Bars: every output within 1e-5 of its largest entry against JAX (the same
f32 graph in another summation order; they read ~1e-7 apart), and against
transformers (the JAX package's own test holds it at 2e-4 absolute / 1e-3
relative; these are f32 PyTorch on both sides); ``CLIPImageEncoder``
within 1e-4 (the bicubic resize emulated by matrices in JAX, as
``test_torch_conditioner.py``'s DINOv2 bar); the stub embedding exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import randomize_, torch_threads  # noqa: F401

REL = 1e-5
ENC_ABS = 1e-4
TEXT = dict(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4,
            mlp_dim=64, max_positions=16, eos_token_id=99)
VISION = dict(hidden_size=32, num_layers=2, num_heads=4, mlp_dim=64,
              patch_size=7, image_size=28)
# row 0 ends at its EOS; row 1 has none, so it pools at argmax(ids)
IDS = np.array([[5, 7, 23, 99, 0, 0], [1, 2, 3, 98, 5, 6]], np.int64)
# transformers pools an EOS-less row at position 0, the JAX tower at
# argmax(ids): against transformers every row has its EOS
IDS_EOS = np.array([[5, 7, 23, 99, 0, 0], [1, 2, 3, 4, 5, 99]], np.int64)


def _close(got, ref, rel=REL, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max(), err_msg=name)


def _prefixed(sd, tower):
    return {f"{tower}_model.{k}": v for k, v in sd.items()}


def _text_pair(seed=0):
    """(port tower, JAX tower, JAX params) on one randomised state_dict."""
    from topiaxl.models.conditioner import clip as jclip
    from topiaxl_torch.models.conditioner.clip import CLIPTextTower

    tower = CLIPTextTower(**TEXT)
    sd = randomize_(tower, seed)
    params = jax.tree.map(jnp.asarray, jclip.convert_clip_text(
        _prefixed(sd, "text"), num_layers=2))
    return tower, jclip.CLIPTextTower(**TEXT), params


def _vision_pair(seed=1):
    from topiaxl.models.conditioner import clip as jclip
    from topiaxl_torch.models.conditioner.clip import CLIPVisionTower

    tower = CLIPVisionTower(**VISION)
    sd = randomize_(tower, seed)
    params = jax.tree.map(jnp.asarray, jclip.convert_clip_vision(
        _prefixed(sd, "vision"), num_layers=2))
    return tower, jclip.CLIPVisionTower(**VISION), params


def test_clip_text_tower_matches_jax():
    """Hidden states and the EOS pooling, the EOS-less row pooled at
    argmax(ids); ``clip_text_from_jax`` inverts ``convert_clip_text``."""
    from topiaxl_torch.core import weights

    tower, jt, params = _text_pair()
    ref = jt.apply(params, jnp.asarray(IDS.astype(np.int32)))
    with torch.no_grad():
        got = tower(torch.from_numpy(IDS))
    for name in ("last_hidden_state", "pooled"):
        _close(got[name], ref[name], name=name)
    _close(got["pooled"][1], np.asarray(ref["last_hidden_state"])[1, 3])
    back = weights.clip_text_from_jax(jax.tree.map(np.asarray, params))
    sd = tower.state_dict()
    assert sorted(back) == sorted(sd)
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0, msg=k)


def test_clip_vision_tower_matches_jax():
    from topiaxl_torch.core import weights

    tower, jt, params = _vision_pair()
    img = np.random.default_rng(4).standard_normal((2, 28, 28, 3)).astype(
        np.float32)
    ref = jt.apply(params, jnp.asarray(img))
    with torch.no_grad():
        got = tower(torch.from_numpy(img))
    for name in ("last_hidden_state", "pooled"):
        _close(got[name], ref[name], name=name)
    back = weights.clip_vision_from_jax(jax.tree.map(np.asarray, params))
    sd = tower.state_dict()
    assert sorted(back) == sorted(sd)
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0, msg=k)


def _transformers():
    os.environ.setdefault("USE_TF", "0")   # the torch side only
    import transformers

    return transformers


@pytest.mark.parametrize("tower_kind", ["text", "vision"])
def test_clip_towers_load_transformers_checkpoints(tmp_path, tower_kind):
    """A random-init transformers model saved with ``save_pretrained``
    (``pytorch_model.bin``; for the text tower also as a whole
    ``CLIPModel`` in ``model.safetensors``) loads through
    ``load_clip_tower`` and computes what transformers computes."""
    tf = _transformers()
    from topiaxl_torch.models.conditioner.clip import load_clip_tower

    torch.manual_seed(3)
    if tower_kind == "text":
        cfg = tf.CLIPTextConfig(vocab_size=100, hidden_size=32,
                                intermediate_size=64, num_hidden_layers=2,
                                num_attention_heads=4,
                                max_position_embeddings=16, eos_token_id=99)
        model = tf.CLIPTextModel(cfg).eval()
        x = torch.from_numpy(IDS_EOS)
        call = dict(input_ids=x)
    else:
        cfg = tf.CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                                  num_hidden_layers=2, num_attention_heads=4,
                                  image_size=28, patch_size=7)
        model = tf.CLIPVisionModel(cfg).eval()
        x = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (2, 28, 28, 3)).astype(np.float32))
        call = dict(pixel_values=x.permute(0, 3, 1, 2))
    model.save_pretrained(tmp_path / "bin", safe_serialization=False)
    with torch.no_grad():
        ref = model(**call)
        got = load_clip_tower(str(tmp_path / "bin"), tower_kind)(x)
    _close(got["last_hidden_state"], ref.last_hidden_state.numpy())
    _close(got["pooled"], ref.pooler_output.numpy())
    if tower_kind == "text":
        whole = tf.CLIPModel(tf.CLIPConfig(
            text_config=cfg.to_dict(),
            vision_config=dict(hidden_size=32, intermediate_size=64,
                               num_hidden_layers=1, num_attention_heads=4,
                               image_size=28, patch_size=7)))
        whole.text_model.load_state_dict(model.text_model.state_dict())
        whole.save_pretrained(tmp_path / "st", safe_serialization=True)
        assert (tmp_path / "st" / "model.safetensors").exists()
        with torch.no_grad():
            got = load_clip_tower(str(tmp_path / "st"), "text")(x)
        _close(got["pooled"], ref.pooler_output.numpy())


def test_clip_text_encoder_and_conditioner_match_jax():
    """``encode_ids`` and a tokenised call ([B, 1, D] pooled), the refusal
    without a tokenizer, and ``TextConditioner`` over the encoder, the
    exact hash stub and the refusal without either, against JAX."""
    from topiaxl.models.conditioner import text as jtext
    from topiaxl_torch.models.conditioner import text

    tower, jt, params = _text_pair(2)

    def tokenizer(texts, **kw):
        assert kw == dict(padding="max_length", truncation=True,
                          return_tensors="np")
        return {"input_ids": IDS[:len(texts)]}

    jenc = jtext.CLIPTextEncoder(tower=jt, params=params, tokenizer=tokenizer)
    enc = text.CLIPTextEncoder(tower=tower, tokenizer=tokenizer)
    with torch.no_grad():
        got = enc.encode_ids(IDS)
        _close(got, jenc.encode_ids(IDS))
        assert got.shape == (2, 1, 32)
        _close(enc(["a", "b"]), jenc(["a", "b"]))
        _close(text.TextConditioner(enc, dim=32)(["a", "b"]),
               jtext.TextConditioner(jenc, dim=32)(["a", "b"]))
    for bare in (text.CLIPTextEncoder(tower=tower),
                 jtext.CLIPTextEncoder(tower=jt, params=params)):
        with pytest.raises(RuntimeError, match="needs a tokenizer"):
            bare(["a"])
    caps = ["a red chair", "a blue lamp", "a red chair"]
    stub = text.TextConditioner(dim=24, stub=True)(caps)
    ref = jtext.TextConditioner(dim=24, stub=True)(caps)
    assert stub.dtype == torch.float32 and stub.shape == (3, 1, 24)
    np.testing.assert_array_equal(stub.numpy(), ref)
    np.testing.assert_array_equal(stub[0].numpy(), stub[2].numpy())
    for cls in (text.TextConditioner, jtext.TextConditioner):
        with pytest.raises(ValueError, match="stub=True"):
            cls(dim=24)


@pytest.mark.parametrize("tokens", [False, True])
def test_clip_image_encoder_matches_jax(tokens):
    """[0, 255] images at 40² -> bicubic to 28² -> CLIP stats -> the tower:
    pooled [B, 1, D], or every token [B, 1 + 16, D] with ``tokens``; no
    tower raises in both packages."""
    from topiaxl.models.conditioner import image as jimage
    from topiaxl_torch.models.conditioner import image

    tower, jt, params = _vision_pair(6)
    imgs = np.random.default_rng(7).uniform(0, 255, (2, 40, 40, 3)).astype(
        np.float32)
    ref = jimage.CLIPImageEncoder(tokens=tokens, tower=jt, params=params)(
        jnp.asarray(imgs))
    with torch.no_grad():
        got = image.CLIPImageEncoder(tokens=tokens, tower=tower)(
            torch.from_numpy(imgs))
    assert got.shape == ((2, 17, 32) if tokens else (2, 1, 32))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ENC_ABS)
    for enc in (image.CLIPImageEncoder(), jimage.CLIPImageEncoder()):
        with pytest.raises(RuntimeError, match="needs local CLIP weights"):
            enc(imgs if isinstance(enc, jimage.CLIPImageEncoder)
                else torch.from_numpy(imgs))


def clip_dir(path, hidden: int = 32) -> str:
    """A local transformers-layout CLIP directory at random init (seeded):
    ``config.json``, ``pytorch_model.bin`` (text and vision towers, hidden
    ``hidden``, two layers; vision 28² in 7² patches) and a tiny BPE
    tokenizer of single letters (vocab 54, EOS 53, 16 positions)."""
    import json

    tf = _transformers()
    os.makedirs(path, exist_ok=True)
    vocab = {c: i for i, c in enumerate("abcdefghijklmnopqrstuvwxyz")}
    vocab.update({c + "</w>": 26 + i
                  for i, c in enumerate("abcdefghijklmnopqrstuvwxyz")})
    vocab.update({"<|startoftext|>": 52, "<|endoftext|>": 53})
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    tf.CLIPTokenizer(os.path.join(path, "vocab.json"),
                     os.path.join(path, "merges.txt"),
                     model_max_length=16).save_pretrained(path)
    torch.manual_seed(11)
    width = dict(hidden_size=hidden, intermediate_size=2 * hidden,
                 num_hidden_layers=2, num_attention_heads=4)
    model = tf.CLIPModel(tf.CLIPConfig(
        text_config=dict(vocab_size=54, max_position_embeddings=16,
                         bos_token_id=52, eos_token_id=53, pad_token_id=53,
                         **width),
        vision_config=dict(image_size=28, patch_size=7, **width)))
    model.save_pretrained(path, safe_serialization=False)
    return str(path)


def test_clip_encoders_from_a_local_directory_match_jax(tmp_path):
    """``CLIPTextEncoder(model_name_or_path=)`` (tower and tokenizer from
    the directory) on captions, and ``CLIPImageEncoder`` pooled and tokens
    on images, against the JAX encoders reading the same directory through
    transformers."""
    from topiaxl.models.conditioner import image as jimage
    from topiaxl.models.conditioner import text as jtext
    from topiaxl_torch.models.conditioner import image, text

    path = clip_dir(tmp_path / "clip")
    caps = ["a red chair", "lamp"]
    with torch.no_grad():
        got = text.CLIPTextEncoder(model_name_or_path=path)(caps)
    _close(got, jtext.CLIPTextEncoder(model_name_or_path=path)(caps))
    imgs = np.random.default_rng(8).uniform(0, 255, (1, 36, 36, 3)).astype(
        np.float32)
    for tokens in (False, True):
        with torch.no_grad():
            got = image.CLIPImageEncoder(path, tokens=tokens)(
                torch.from_numpy(imgs))
        ref = jimage.CLIPImageEncoder(path, tokens=tokens)(jnp.asarray(imgs))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=ENC_ABS)
