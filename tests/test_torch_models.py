"""topiaxl_torch models against the JAX package on the CPU, f32 on both
sides, at small widths. One random state_dict in the reference's torch
key layout feeds both: the port loads it with ``strict=True``, the JAX
side goes through ``topiaxl.core.convert``. Every parameter is
randomised, including the zero-initialised adaLN, final layer and null
embedding, so no comparison is vacuous."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topiaxl.core import convert
from topiaxl_torch.core import weights

# torch's CPU threads while a port test module runs (the modules that run
# torch import ``torch_threads``). Tier 1 runs six pytest workers on one
# host: at torch's default of one thread per core in each, their OpenMP
# teams oversubscribe the cores and every torch test slows several-fold.
TORCH_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)


def randomize_(model: torch.nn.Module, seed: int = 0) -> dict:
    """Fill every parameter from numpy: norm/LayerScale gains 1 + N(0, .1),
    matrices N(0, 1/fan_in), vectors N(0, .1), the null embedding N(0, 1).
    Returns the state_dict."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            r = rng.standard_normal(tuple(p.shape)).astype(np.float32)
            if name.endswith("gamma") or ("norm" in name
                                          and name.endswith("weight")):
                r = 1.0 + 0.1 * r
            elif name == "null_cond_embedding":
                pass
            elif p.dim() >= 2 and not name.endswith(("_token", "pos_embed",
                                                     "register_tokens")):
                r = r / np.sqrt(p[0].numel())
            else:
                r = 0.1 * r
            p.copy_(torch.from_numpy(r))
    return {k: v.clone() for k, v in model.state_dict().items()}


def tree(params):
    return jax.tree.map(jnp.asarray, params)


def tiny_dit(seed=0, depth=2, hidden=144, heads=2, seq=64, cond=32):
    """A randomised port DiT (f32) and the same weights as JAX params."""
    from topiaxl_torch.models.dit import DiT

    dit = DiT(seq_length=seq, in_channels=68, condition_channels=cond,
              hidden_size=hidden, depth=depth, num_heads=heads,
              dtype=torch.float32)
    sd = randomize_(dit, seed)
    return dit, tree(convert.convert_dit(sd, depth=depth))


def tiny_vae(seed=0):
    from topiaxl_torch.models.vae3d import VAE3D

    vae = VAE3D(down_channels=(8, 16), up_channels=(16, 8),
                dtype=torch.float32)
    sd = randomize_(vae, seed)
    return vae, tree(convert.convert_vae(sd, (8, 16), (16, 8)))


def test_dit_cfg_fast_matches_jax():
    from topiaxl.models import DiT as JaxDiT

    dit, params = tiny_dit()
    jd = JaxDiT(seq_length=64, in_channels=68, condition_channels=32,
                hidden_size=144, depth=2, num_heads=2, attn_proj_bias=True,
                dtype=jnp.float32)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 64, 68)).astype(np.float32)
    y = rng.standard_normal((1, 10, 32)).astype(np.float32)
    t = np.array([537], np.int32)
    kvs = jd.apply(params, jnp.asarray(y), method=JaxDiT.precompute_kv)
    nulls = jd.apply(params, method=JaxDiT.precompute_null_out)
    ref = np.asarray(jd.apply(params, jnp.asarray(x), jnp.asarray(t), kvs,
                              nulls, 4.0,
                              method=JaxDiT.forward_with_cfg_fast))
    with torch.no_grad():
        got = dit.forward_with_cfg_fast(
            torch.from_numpy(x), torch.from_numpy(t).long(),
            dit.precompute_kv(torch.from_numpy(y)),
            dit.precompute_null_out(), 4.0).numpy()
    assert np.abs(ref).max() > 0.1   # randomised: not the zero-init identity
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_vae_decode_and_encode_match_jax():
    from topiaxl.models import VAE3D as JaxVAE

    vae, params = tiny_vae()
    jv = JaxVAE(down_channels=(8, 16), up_channels=(16, 8), dtype=jnp.float32)
    rng = np.random.default_rng(2)
    z = rng.standard_normal((3, 4, 4, 4, 1)).astype(np.float32)   # NDHWC
    ref = np.asarray(jv.apply(params, jnp.asarray(z), method=JaxVAE.decode))
    with torch.no_grad():
        got = vae.decode(torch.from_numpy(z).permute(0, 4, 1, 2, 3))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), ref,
                               atol=1e-4, rtol=0)
    x = rng.standard_normal((2, 8, 8, 8, 6)).astype(np.float32)
    ref = np.asarray(jv.apply(params, jnp.asarray(x),
                              method=JaxVAE.encode).parameters)
    with torch.no_grad():
        got = vae.encode(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).parameters
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), ref,
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("size", [28, 42])   # 42: pos-embed interpolation
def test_dinov2_tiny_matches_jax(size):
    from topiaxl.models.conditioner.dinov2 import DinoViT as JaxViT
    from topiaxl.models.conditioner.dinov2 import dinov2_config as jax_cfg
    from topiaxl_torch.models.conditioner.dinov2 import DinoViT, dinov2_config

    cfg = dict(dinov2_config("dinov2_tiny_test"), pos_embed_size=4)
    assert dinov2_config("dinov2_tiny_test") == jax_cfg("dinov2_tiny_test")
    vit = DinoViT(dtype=torch.float32, **cfg)
    sd = randomize_(vit, 3)
    params = tree(convert.convert_dinov2(sd, depth=cfg["depth"]))
    img = np.random.default_rng(4).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    ref = JaxViT(dtype=jnp.float32, **cfg).apply(params, jnp.asarray(img))
    with torch.no_grad():
        got = vit(torch.from_numpy(img))
    for k in ("x_norm_clstoken", "x_norm_patchtokens"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-4, rtol=0, err_msg=k)


def test_resize_matches_jax():
    """F.interpolate(bicubic, antialias) against the JAX package's matrix
    emulation of it, at the bar the JAX package holds that emulation to."""
    from topiaxl.ops.resize import resize_bicubic as jax_resize
    from topiaxl_torch.ops.resize import resize_bicubic

    img = np.random.default_rng(5).uniform(0, 1, (1, 64, 50, 3)).astype(
        np.float32)
    for h, w in ((28, 28), (90, 70)):
        ref = np.asarray(jax_resize(jnp.asarray(img), h, w))
        got = resize_bicubic(torch.from_numpy(img), h, w).numpy()
        np.testing.assert_allclose(got, ref, atol=2e-3, rtol=0)


def _prims(rng, n=24, S=8):
    srt = np.concatenate([rng.uniform(0.15, 0.4, (n, 1)),
                          rng.uniform(-0.6, 0.6, (n, 3))], 1).astype(np.float32)
    feat = rng.standard_normal((n, 6 * S**3)).astype(np.float32)
    return srt, feat


@pytest.mark.parametrize("outputs,fallback", [
    (None, True), (("sdf",), True), (("tex", "mat"), False)])
def test_query_matches_jax(outputs, fallback):
    from topiaxl.models import primx as jprimx
    from topiaxl_torch.models import primx

    rng = np.random.default_rng(6)
    srt, feat = _prims(rng)
    # inside, on the edge of and far outside the prims (fallback)
    x = np.concatenate([rng.uniform(-0.8, 0.8, (300, 3)),
                        rng.uniform(-1.0, 1.0, (50, 3)) * 3]).astype(np.float32)
    kw = dict(top_k=8, with_fallback=fallback, outputs=outputs)
    ref = jprimx.query(jprimx.PrimXParams(jnp.asarray(srt), jnp.asarray(feat)),
                       jnp.asarray(x), **kw)
    got = primx.query(primx.PrimXParams(torch.from_numpy(srt),
                                        torch.from_numpy(feat)),
                      torch.from_numpy(x), **kw)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_noise_filter_matches_jax():
    from topiaxl.models.primx import PrimXParams as JP
    from topiaxl.pipelines.infer import noise_filter as jax_nf
    from topiaxl_torch.models.primx import PrimXParams
    from topiaxl_torch.pipelines.infer import noise_filter

    rng = np.random.default_rng(7)
    srt, feat = _prims(rng, n=40)
    srt[:5, 1:4] += 5.0 * np.arange(1, 6)[:, None]   # isolated prims
    ref = jax_nf(JP(jnp.asarray(srt), jnp.asarray(feat)))
    got = noise_filter(PrimXParams(torch.from_numpy(srt),
                                   torch.from_numpy(feat)))
    np.testing.assert_array_equal(got.srt.numpy(), np.asarray(ref.srt))
    assert (got.srt[:5, 0] == np.float32(1e-6)).all()


def test_weight_round_trips_are_exact():
    """*_from_jax inverts convert_*: sd -> JAX tree -> sd is the identity,
    and the port loads the result strictly."""
    from topiaxl_torch.models.conditioner.dinov2 import DinoViT, dinov2_config

    dit, _ = tiny_dit(depth=3)
    vae, _ = tiny_vae()
    vit = DinoViT(dtype=torch.float32, **dinov2_config("dinov2_tiny_test"),
                  pos_embed_size=4)
    cases = [
        (dit, lambda sd: weights.dit_from_jax(convert.convert_dit(sd, 3))),
        (vae, lambda sd: weights.vae_from_jax(
            convert.convert_vae(sd, (8, 16), (16, 8)))),
        (vit, lambda sd: weights.dinov2_from_jax(convert.convert_dinov2(sd, 1))),
    ]
    for model, round_trip in cases:
        sd = randomize_(model, 8)
        if "mask_token" in sd:
            sd["mask_token"].zero_()   # not in the JAX tree
        back = round_trip(sd)
        assert set(back) == set(sd)
        for k in sd:
            assert torch.equal(back[k], sd[k]), k
        model.load_state_dict(back, strict=True)


def test_reference_state_dicts_load_strictly():
    """The reference's own DiT and VAE state_dicts (committed fixture)
    load into the port with strict=True and nothing else."""
    import os

    from topiaxl_torch.models.dit import DiT
    from topiaxl_torch.models.vae3d import VAE3D

    fx = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                              "reference_chain_v1.npz"))

    def sd(which):
        pre = f"sd.{which}."
        return {k[len(pre):]: torch.from_numpy(fx[k]) for k in fx.files
                if k.startswith(pre)}

    DiT(seq_length=16, in_channels=68, condition_channels=32, hidden_size=64,
        depth=2, num_heads=2, dtype=torch.float32).load_state_dict(sd("dit"))
    VAE3D(down_channels=(32, 64), up_channels=(64, 32),
          dtype=torch.float32).load_state_dict(sd("vae"))


def test_latent_stats_and_matting_equal_jax_package():
    import cv2

    from topiaxl.core.attrdict import AttrDict
    from topiaxl.models import latent_stats as jls
    from topiaxl.ops.matting import remove_background as jax_rb
    from topiaxl_torch.models import latent_stats as tls
    from topiaxl_torch.ops.matting import remove_background

    for name, (m, s) in jls.STATS.items():
        np.testing.assert_array_equal(tls.STATS[name][0], m)
        np.testing.assert_array_equal(tls.STATS[name][1], s)
    cfg = AttrDict({"latent_stats": "primx_v1"})
    for a, b in zip(tls.resolve_latent_stats(cfg), jls.resolve_latent_stats(cfg)):
        np.testing.assert_array_equal(a, b)

    img = np.full((96, 96, 3), 235, np.uint8)
    cv2.circle(img, (48, 50), 25, (180, 60, 40), -1)
    cv2.rectangle(img, (30, 20), (60, 40), (40, 90, 200), -1)
    got, ref = remove_background(img), jax_rb(img)
    assert ref is not None
    np.testing.assert_array_equal(got, ref)
