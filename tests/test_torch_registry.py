"""The port builds what a config names (``topiaxl_torch/registry.py``),
against the JAX package on the CPU, f32, inputs and weights from numpy
seeds.

Bars: ``PointEmbed`` and the DiT paths (``forward``, ``forward_with_cfg``,
``forward_with_cfg_kv``, ``forward_with_cfg_fast``), plain and with the
point embedding, within 1e-4 of JAX on weights carried across by
``core/weights.py:dit_from_jax`` (the DiT's bar in
``test_torch_models.py``); the W8A8 ``DiTAdditivePosEmb`` within rel RMS
1e-3 of JAX's quantized forward (``test_torch_int8.py``'s bar). The CLI
runs at ``test_torch_pipeline.py``'s tiny config."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_int8 import rel_rms
from test_torch_models import torch_threads  # noqa: F401
from test_torch_pipeline import _tiny_config
from topiaxl_torch.core import weights

TOL = 1e-4
KW = dict(seq_length=64, in_channels=68, condition_channels=32,
          hidden_size=48, depth=2, num_heads=4)


def _jax_params(model, seed: int):
    """``model``'s parameters with every leaf drawn from numpy: matrices
    N(0, 1/fan_in), vectors N(0, 0.1) (so the zero-initialised adaLN and
    final layer are live)."""
    x = jnp.zeros((1, KW["seq_length"], KW["in_channels"]))
    params = model.init(jax.random.PRNGKey(0), x, jnp.zeros((1,), jnp.int32),
                        jnp.zeros((1, 3, KW["condition_channels"])))
    rng = np.random.default_rng(seed)

    def draw(leaf):
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        return a / np.sqrt(leaf.shape[0]) if leaf.ndim >= 2 else 0.1 * a

    return jax.tree.map(draw, params)


def _pair(cls_name: str, seed: int):
    """(JAX model, its params, the port's model with the same weights)."""
    from topiaxl.models import dit as jdit
    from topiaxl_torch.models import dit

    jd = getattr(jdit, cls_name)(attn_proj_bias=True, dtype=jnp.float32, **KW)
    params = _jax_params(jd, seed)
    port = getattr(dit, cls_name)(dtype=torch.float32, **KW).eval()
    port.load_state_dict(weights.dit_from_jax(jax.tree.map(np.asarray,
                                                           params)))
    return jd, params, port


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 64, 68)).astype(np.float32)
    y = rng.standard_normal((2, 10, 32)).astype(np.float32)
    return x, y, np.array([3, 611], np.int32)


def test_point_embed_matches_jax():
    """``point_emb`` of the DiT, its Dense carried across by
    ``dit_from_jax``, on points at the tokens' scale."""
    jd, params, port = _pair("DiTAdditivePosEmb", seed=1)
    pts = np.random.default_rng(2).standard_normal((2, 50, 3)).astype(
        np.float32)
    ref = np.asarray(jd.apply(params, jnp.asarray(pts),
                              method=lambda m, p: m.point_emb(p)))
    with torch.no_grad():
        got = port.point_emb(torch.from_numpy(pts)).numpy()
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    # a state_dict that carries the frequencies (the reference's buffer)
    # loads when they are these, and is refused otherwise
    pe = port.point_emb
    sd = dict(pe.state_dict(), basis=pe.basis("cpu"))
    pe.load_state_dict(sd)
    with pytest.raises(ValueError, match="basis"):
        pe.load_state_dict(dict(sd, basis=2 * sd["basis"]))


@pytest.mark.parametrize("cls_name", ["DiT", "DiTAdditivePosEmb"])
def test_dit_paths_match_jax(cls_name):
    """Every path that embeds tokens, and the batch-doubled CFG."""
    from topiaxl.models.dit import DiT as JaxDiT

    jd, params, port = _pair(cls_name, seed=3)
    x, y, t = _inputs(4)
    jx, jy, jt = map(jnp.asarray, (x, y, t))
    tx, ty, tt = torch.from_numpy(x), torch.from_numpy(y), \
        torch.from_numpy(t).long()
    null = params["params"]["null_cond_embedding"]
    y_pair = jnp.concatenate([jy, jnp.broadcast_to(null[None, None, :],
                                                   jy.shape)], 0)
    ref = {
        "forward": jd.apply(params, jx, jt, jy),
        "forward_with_cfg": jd.apply(params, jx, jt, jy, 4.0,
                                     method=JaxDiT.forward_with_cfg),
        "forward_with_cfg_kv": jd.apply(
            params, jx, jt, jd.apply(params, y_pair,
                                     method=JaxDiT.precompute_kv), 4.0,
            method=JaxDiT.forward_with_cfg_kv),
        "forward_with_cfg_fast": jd.apply(
            params, jx, jt, jd.apply(params, jy, method=JaxDiT.precompute_kv),
            jd.apply(params, method=JaxDiT.precompute_null_out), 4.0,
            method=JaxDiT.forward_with_cfg_fast)}
    t_null = port.null_cond_embedding[None, None, :].expand_as(ty)
    with torch.no_grad():
        got = {
            "forward": port(tx, tt, ty),
            "forward_with_cfg": port.forward_with_cfg(tx, tt, ty, 4.0),
            "forward_with_cfg_kv": port.forward_with_cfg_kv(
                tx, tt, port.precompute_kv(torch.cat([ty, t_null])), 4.0),
            "forward_with_cfg_fast": port.forward_with_cfg_fast(
                tx, tt, port.precompute_kv(ty), port.precompute_null_out(),
                4.0)}
    for name, r in ref.items():
        r = np.asarray(r)
        assert np.abs(r).max() > 0.1, name
        np.testing.assert_allclose(got[name].numpy(), r, atol=TOL, rtol=0,
                                   err_msg=name)


def test_point_embedding_changes_the_step():
    """The same weights without ``point_emb`` give another step (so the
    comparison above sees the embedding), and the plain DiT refuses the
    point-embedding state_dict."""
    from topiaxl_torch.models.dit import DiT

    _, _, port = _pair("DiTAdditivePosEmb", seed=5)
    x, y, t = _inputs(6)
    plain = DiT(dtype=torch.float32, **KW).eval()
    sd = port.state_dict()
    with pytest.raises(RuntimeError, match="point_emb"):
        plain.load_state_dict(sd)
    plain.load_state_dict({k: v for k, v in sd.items()
                           if not k.startswith("point_emb.")})
    args = (torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(y))
    with torch.no_grad():
        assert (port(*args) - plain(*args)).abs().max() > 1e-2


def test_quantized_dit_additive_pos_emb_matches_jax():
    from topiaxl.models import quantize_dit_params
    from topiaxl_torch.models.dit import DiTAdditivePosEmb

    jd, params, _ = _pair("DiTAdditivePosEmb", seed=7)
    qp = quantize_dit_params(jd, params)
    x, y, t = _inputs(8)
    ref = np.asarray(jd.clone(quant=True).apply(qp, *map(jnp.asarray,
                                                         (x, t, y))))
    qdit = DiTAdditivePosEmb(quant=True, dtype=torch.float32, **KW).eval()
    qdit.load_state_dict(weights.dit_from_jax(jax.tree.map(np.asarray, qp)))
    with torch.no_grad():
        got = qdit(torch.from_numpy(x), torch.from_numpy(t).long(),
                   torch.from_numpy(y)).numpy()
    assert rel_rms(got, ref) < 1e-3


def test_dummy_conditioner_passes_through():
    from topiaxl_torch import registry  # noqa: F401
    from topiaxl_torch.core.attrdict import AttrDict
    from topiaxl_torch.core.config import build

    dummy = build(AttrDict(class_name="topiaxl.DummyImageConditioner",
                           num_prims=8))
    y = torch.randn(1, 5, 7)
    assert dummy.encode_image(y) is y and dummy(y) is y


def test_registry_has_the_jax_package_names():
    """Every name the JAX package registers is registered in the port; the
    classes the port does not have yet raise, naming them."""
    import topiaxl.registry  # noqa: F401
    from topiaxl.core import config as jconfig

    from topiaxl_torch import registry  # noqa: F401
    from topiaxl_torch.core.attrdict import AttrDict
    from topiaxl_torch.core.config import build, registry_names

    # (other tests may register their own names in the JAX table)
    jax_names = {n for n in jconfig.registry_names()
                 if n.startswith(("topiaxl.", "models."))}
    assert "topiaxl.DiTAdditivePosEmb" in jax_names
    assert jax_names <= set(registry_names())
    for name in ("topiaxl.CLIPTextEncoder",
                 "models.conditioner.image.CLIPImageEncoder",
                 "models.conditioner.text.TextConditioner",
                 "topiaxl.TextConditioner", "topiaxl.CLIPImageEncoder",
                 "models.conditioner.text.CLIPTextEncoder"):
        cls = name.rsplit(".", 1)[1]
        with pytest.raises(NotImplementedError,
                           match=f"{cls} is not ported.*queue 1 #8"):
            build(AttrDict(class_name=name))


def _image_dir(tmp_path):
    import cv2

    img_dir = tmp_path / "imgs"
    os.makedirs(img_dir)
    img = np.zeros((64, 64, 3), np.uint8)
    cv2.circle(img, (32, 32), 20, (200, 180, 160), -1)
    cv2.imwrite(str(img_dir / "blob.png"), img)
    return img_dir


@pytest.mark.parametrize("overrides,dit_cls", [
    ([], "DiT"),                     # configs/inference_dit.yml's names
    (["model.generator.class_name=models.dit_crossattn.DiT",
      "model.vae.class_name=models.vae3d_dib.VAE",
      "model.conditioner.class_name=models.conditioner.image.ImageConditioner",
      "model.conditioner.encoder_config.class_name="
      "models.conditioner.image_dinov2.Dinov2Wrapper"], "DiT"),
    (["model.generator.class_name=topiaxl.DiTAdditivePosEmb"],
     "DiTAdditivePosEmb"),
])
def test_cli_builds_what_the_config_names(tmp_path, overrides, dit_cls):
    from topiaxl_torch.cli.infer import build_models, main
    from topiaxl_torch.core.config import load_config
    from topiaxl_torch.models.conditioner.image import (
        DinoV2Wrapper, ImageConditioner)
    from topiaxl_torch.models.vae3d import VAE3D

    cfg_path = str(_tiny_config(tmp_path, _image_dir(tmp_path)))
    dit, vae, cond = build_models(load_config(cfg_path, overrides),
                                  torch.device("cpu"), torch.Generator())
    assert type(dit).__name__ == dit_cls and isinstance(vae, VAE3D)
    assert isinstance(cond, ImageConditioner)
    assert isinstance(cond.encoder, DinoV2Wrapper)
    assert main([cfg_path, "inference.export_glb=false", *overrides]) == 0
    z = np.load(tmp_path / "runs" / "tiny" / "inference_folder" / "blob"
                / "denoised.npz")
    assert z["srt"].shape == (64, 4) and np.isfinite(z["feat"]).all()


@pytest.mark.parametrize("quant", [False, True])
def test_cli_serves_dit_additive_pos_emb(tmp_path, quant):
    """``class_name=topiaxl.DiTAdditivePosEmb`` with a checkpoint of JAX's
    weights: the CLI's tokens are ``generate_primx``'s on the model it
    builds, and that model's CFG step is JAX's (bf16 float or W8A8)."""
    from topiaxl.models import quantize_dit_params
    from topiaxl.models.dit import DiTAdditivePosEmb as JaxDiT
    from topiaxl_torch.cli.infer import build_models, main, prepare_image
    from topiaxl_torch.core.config import load_config
    from topiaxl_torch.diffusion import create_diffusion
    from topiaxl_torch.models.latent_stats import resolve_latent_stats
    from topiaxl_torch.pipelines import infer as P

    img_dir = _image_dir(tmp_path)
    cfg_path = str(_tiny_config(tmp_path, img_dir))
    cfg_kw = dict(seq_length=64, in_channels=68, condition_channels=32,
                  hidden_size=32, depth=1, num_heads=4)
    jd = JaxDiT(attn_proj_bias=True, dtype=jnp.float32, **cfg_kw)
    x0 = jnp.zeros((1, 64, 68))
    params = jd.init(jax.random.PRNGKey(0), x0, jnp.zeros((1,), jnp.int32),
                     jnp.zeros((1, 3, 32)))
    rng = np.random.default_rng(9)
    params = jax.tree.map(lambda a: (rng.standard_normal(a.shape) / np.sqrt(
        a.shape[0] if a.ndim > 1 else 100)).astype(np.float32), params)
    ckpt = tmp_path / "dit.pt"
    torch.save({"ema": weights.dit_from_jax(params)}, ckpt)
    overrides = ["inference.export_glb=false", f"checkpoint_path={ckpt}",
                 "model.generator.class_name=topiaxl.DiTAdditivePosEmb",
                 f"model.generator.quant={str(quant).lower()}"]
    assert main([cfg_path] + overrides) == 0
    z = np.load(tmp_path / "runs" / "tiny" / "inference_folder" / "blob"
                / "denoised.npz")

    cfg = load_config(cfg_path, overrides=overrides)
    gen = torch.Generator().manual_seed(int(cfg.inference.seed))
    dit, vae, cond = build_models(cfg, torch.device("cpu"), gen)
    assert dit.quant == quant and hasattr(dit, "point_emb")
    with torch.no_grad():
        y = cond.encode_image(torch.from_numpy(
            prepare_image(str(img_dir / "blob.png"))[None]))
    mean, std = resolve_latent_stats(cfg.model)
    out = P.generate_primx(
        dit, vae, create_diffusion("ddim3", noise_schedule="squaredcos_cap_v2",
                                   parameterization="v", diffusion_steps=50),
        y, mean, std, cfg_scale=2.0, generator=gen)
    np.testing.assert_allclose(z["srt"], out.srt.numpy(), atol=1e-6)
    np.testing.assert_allclose(z["feat"], out.feat.numpy(), atol=1e-6)

    x, _, t = _inputs(10)
    yj = y.numpy()[:, :10]
    if quant:
        params, jd = quantize_dit_params(jd, params), jd.clone(quant=True)
    kvs = jd.apply(params, jnp.asarray(yj), method=JaxDiT.precompute_kv)
    nulls = jd.apply(params, method=JaxDiT.precompute_null_out)
    ref = np.asarray(jd.apply(params, jnp.asarray(x[:1]), jnp.asarray(t[:1]),
                              kvs, nulls, 2.0,
                              method=JaxDiT.forward_with_cfg_fast))
    with torch.no_grad():
        yt = torch.from_numpy(yj)
        got = dit.forward_with_cfg_fast(
            torch.from_numpy(x[:1]), torch.from_numpy(t[:1]).long(),
            dit.precompute_kv(yt), dit.precompute_null_out(), 2.0).numpy()
    if quant:
        assert rel_rms(got, ref) < 1e-3
    else:
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_cli_refuses_what_it_cannot_build(tmp_path):
    """A registered name whose class is not ported raises naming it; an
    unknown name raises listing the known ones."""
    from topiaxl_torch.cli.infer import main

    cfg_path = str(_tiny_config(tmp_path, _image_dir(tmp_path)))
    for node, name in (("conditioner", "topiaxl.TextConditioner"),
                       ("generator", "topiaxl.CLIPTextEncoder"),
                       ("conditioner.encoder_config",
                        "topiaxl.CLIPImageEncoder")):
        with pytest.raises(NotImplementedError, match=name.split(".")[1]):
            main([cfg_path, f"model.{node}.class_name={name}"])
    with pytest.raises(KeyError, match="not registered"):
        main([cfg_path, "model.vae.class_name=topiaxl.NoSuchVAE"])


def test_cli_refuses_checkpoints_it_cannot_read(tmp_path):
    """An existing ``model.native_checkpoint_dir`` (orbax) raises before any
    model is built; an ``inference.u2net_checkpoint`` that is a directory
    (a converted orbax tree) raises too. The same keys naming nothing on
    disk are ignored, as the JAX CLI ignores them."""
    from topiaxl_torch.cli.infer import main, refuse_unported_checkpoints
    from topiaxl_torch.core.config import load_config

    cfg_path = str(_tiny_config(tmp_path, _image_dir(tmp_path)))
    native = tmp_path / "native"
    os.makedirs(native / "dit")
    u2net = tmp_path / "u2net_orbax"
    os.makedirs(u2net)
    with pytest.raises(ValueError, match="orbax.*checkpoint_path"):
        main([cfg_path, f"model.native_checkpoint_dir={native}"])
    with pytest.raises(ValueError, match="directory.*\\.pth"):
        main([cfg_path, f"inference.u2net_checkpoint={u2net}"])
    refuse_unported_checkpoints(load_config(cfg_path, [
        f"model.native_checkpoint_dir={tmp_path / 'none'}",
        f"inference.u2net_checkpoint={tmp_path / 'none.pth'}"]))
    assert main([cfg_path, "inference.export_glb=false",
                 f"inference.u2net_checkpoint={tmp_path / 'none.pth'}"]) == 0


def test_cli_mattes_with_the_u2net_checkpoint(tmp_path):
    """``inference.u2net_checkpoint`` naming a torch ``.pth`` (a randomised
    u2netp state_dict) with ``inference.matting=u2net``: the CLI's PrimX is
    the one made from the U^2-Net-matted image, which differs from the
    GrabCut-matted one."""
    from test_torch_matting import randomized_u2net
    from topiaxl_torch.cli.infer import build_models, main, prepare_image
    from topiaxl_torch.core.config import load_config
    from topiaxl_torch.diffusion import create_diffusion
    from topiaxl_torch.models.latent_stats import resolve_latent_stats
    from topiaxl_torch.ops.matting import load_u2net
    from topiaxl_torch.pipelines import infer as P

    img_dir = _image_dir(tmp_path)
    pth = tmp_path / "u2netp.pth"
    torch.save(randomized_u2net("u2netp", seed=11).state_dict(), pth)
    cfg_path = str(_tiny_config(tmp_path, img_dir))
    overrides = ["inference.export_glb=false", "inference.matting=u2net",
                 f"inference.u2net_checkpoint={pth}"]
    assert main([cfg_path] + overrides) == 0
    z = np.load(tmp_path / "runs" / "tiny" / "inference_folder" / "blob"
                / "denoised.npz")

    matter = load_u2net(str(pth), device="cpu")
    assert matter.model.arch == "u2netp"
    image = prepare_image(str(img_dir / "blob.png"), matting="u2net",
                          matter=matter)
    assert not np.array_equal(image, prepare_image(str(img_dir / "blob.png"),
                                                   matting="grabcut"))
    cfg = load_config(cfg_path, overrides=overrides)
    gen = torch.Generator().manual_seed(int(cfg.inference.seed))
    dit, vae, cond = build_models(cfg, torch.device("cpu"), gen)
    with torch.no_grad():
        y = cond.encode_image(torch.from_numpy(image[None]))
    mean, std = resolve_latent_stats(cfg.model)
    out = P.generate_primx(
        dit, vae, create_diffusion("ddim3", noise_schedule="squaredcos_cap_v2",
                                   parameterization="v", diffusion_steps=50),
        y, mean, std, cfg_scale=2.0, generator=gen)
    np.testing.assert_allclose(z["srt"], out.srt.numpy(), atol=1e-6)
    np.testing.assert_allclose(z["feat"], out.feat.numpy(), atol=1e-6)


def test_registry_builds_the_render_then_encode_conditioners():
    """The renderer's settings reach the conditioners, as the JAX
    registry passes them; the multi-view class is built."""
    from topiaxl_torch import registry  # noqa: F401
    from topiaxl_torch.core.attrdict import AttrDict
    from topiaxl_torch.core.config import build
    from topiaxl_torch.models.conditioner.image import (
        DinoV2Wrapper, ImageMultiViewConditioner)

    enc = AttrDict(class_name="topiaxl.DinoV2Wrapper",
                   model_name="dinov2_tiny_test", dtype="fp32")
    for name, views in (("topiaxl.ImageMultiViewConditioner", 3),
                        ("models.conditioner.image.ImageMultiViewConditioner",
                         4)):
        kw = dict(class_name=name, num_prims=16, prim_shape=4,
                  sample_view=True, encoder_config=enc)
        if views == 3:
            kw["view_counts"] = 3
        cond = build(AttrDict(kw), device=torch.device("cpu"))
        assert isinstance(cond, ImageMultiViewConditioner)
        assert isinstance(cond.encoder, DinoV2Wrapper)
        assert (cond.num_prims, cond.prim_shape, cond.dim_feat,
                cond.sample_view, cond.view_counts) == (16, 4, 6, True, views)
    cond = build(AttrDict(class_name="topiaxl.ImageConditioner",
                          encoder_config=enc), device=torch.device("cpu"))
    assert (cond.num_prims, cond.prim_shape, cond.sample_view) == (2048, 8,
                                                                   False)


@pytest.mark.parametrize("name", ["topiaxl.PrimX", "models.primsdf.PrimSDF"])
def test_registry_builds_primx(name):
    """Both names build the PrimX descriptor with the JAX factory's keys
    (the config's ``model`` node, its other keys ignored), equal to the
    JAX package's."""
    import topiaxl.registry  # noqa: F401
    from topiaxl.core import config as jconfig

    from topiaxl_torch import registry  # noqa: F401
    from topiaxl_torch.core.attrdict import AttrDict
    from topiaxl_torch.core.config import build
    from topiaxl_torch.models.primx import PrimX

    node = dict(class_name=name, num_prims=64, dim_feat=6, prim_shape=4,
                init_scale=0.1, auto_scale_init=False,
                init_sampling="surface", vae={"class_name": "topiaxl.VAE3D"})
    got = build(AttrDict(node), device="cpu",
                generator=torch.Generator().manual_seed(0))
    ref = jconfig.build(AttrDict(node))
    assert isinstance(got, PrimX) and tuple(got) == tuple(ref)
    assert got.init_params().feat.shape == (64, 6 * 64)
