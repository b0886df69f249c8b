"""topiaxl_torch ops against the JAX package on the CPU: the plain flash
attention against the Pallas flash kernel (interpret mode), the plain
LN+modulate pair against the Pallas LN kernels (interpret mode), the
attention dispatch rule and the cross-attention scale. Inputs come from
numpy and are handed to both frameworks; f32 throughout, tolerance 1e-5
(the two differ only in summation order and in where the softmax scale
is applied)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topiaxl.ops.attention import multi_head_attention as jax_mha
from topiaxl.ops.flash_attention import flash_attention as jax_flash
from topiaxl.ops.fused_ln import ln_modulate as jax_ln
from topiaxl.ops.fused_ln import ln_modulate_residual as jax_ln_res
from topiaxl_torch.ops import _cuda
from topiaxl_torch.ops.attention import multi_head_attention, use_flash
from topiaxl_torch.ops.flash_attention import (
    KEY_TILE,
    flash_attention,
    flash_attention_plain,
    flash_attention_unmasked,
)
from topiaxl_torch.ops.fused_ln import ln_modulate, ln_modulate_residual

TOL = 1e-5


def _qkv(rng, B, Sq, Sk, H, D):
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, H, D)).astype(np.float32))


@pytest.mark.parametrize("B,Sq,Sk,H,D,scale", [
    (2, 40, 37, 2, 72, 72 ** -0.5),      # ragged Sk, the DiT's head_dim
    (1, 24, 40, 3, 72, 1.0 / 72),        # the cross-attention scale
    (1, 33, 33, 2, 64, 64 ** -0.5),      # DINOv2's head_dim
])
def test_plain_flash_matches_jax_flash_kernel(B, Sq, Sk, H, D, scale):
    q, k, v = _qkv(np.random.default_rng(0), B, Sq, Sk, H, D)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               scale))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), scale).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_unmasked_padding_fault_is_plain_on_full_tiles_only():
    """The planted fault of the kernel checks: with no padded keys it is
    the plain version; with padded keys it shrinks the output."""
    rng = np.random.default_rng(9)
    for Sk, same in ((2 * KEY_TILE, True), (KEY_TILE + 3, False)):
        q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 5, Sk, 2, 64))
        fault = flash_attention_unmasked(q, k, v, 0.125)
        plain = flash_attention_plain(q, k, v, 0.125)
        assert fault.shape == plain.shape
        assert torch.equal(fault, plain) == same


def test_ln_modulate_matches_jax_kernel():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 128)).astype(np.float32) * 3 + 1
    sh = rng.standard_normal((2, 128)).astype(np.float32)
    sc = rng.standard_normal((2, 128)).astype(np.float32)
    ref = np.asarray(jax_ln(jnp.asarray(x), jnp.asarray(sh), jnp.asarray(sc),
                            interpret=True))
    got = ln_modulate(torch.from_numpy(x), torch.from_numpy(sh),
                      torch.from_numpy(sc)).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_ln_modulate_residual_matches_jax_kernel():
    rng = np.random.default_rng(2)
    x, d = (rng.standard_normal((2, 8, 256)).astype(np.float32) for _ in "xd")
    g, sh, sc = (rng.standard_normal((2, 256)).astype(np.float32)
                 for _ in "gsc")
    xr, hr = jax_ln_res(*map(jnp.asarray, (x, d, g, sh, sc)), interpret=True)
    xg, hg = ln_modulate_residual(*map(torch.from_numpy, (x, d, g, sh, sc)))
    np.testing.assert_allclose(xg.numpy(), np.asarray(xr), atol=TOL, rtol=0)
    np.testing.assert_allclose(hg.numpy(), np.asarray(hr), atol=TOL, rtol=0)


def test_dispatch_is_a_shape_rule():
    # the DiT's self/cross-attention and DINOv2 take the kernel ...
    assert use_flash(2048, 72) and use_flash(1370, 72) and use_flash(1374, 64)
    assert use_flash(512, 64)
    # ... the VAE's 64-voxel volume attention and narrow heads do not
    assert not use_flash(64, 32)
    assert not use_flash(511, 72)
    assert not use_flash(2048, 32)


@pytest.mark.parametrize("Sk,D", [(520, 64), (48, 32)])
def test_multi_head_attention_matches_jax(Sk, D):
    q, k, v = _qkv(np.random.default_rng(3), 1, 20, Sk, 2, D)
    for scale in (None, 1.0 / D):
        ref = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), scale=scale))
        got = multi_head_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), scale=scale).numpy()
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_cross_attention_uses_head_dim_inverse_scale():
    """CrossAttention.attend applies head_dim**-1, as the JAX module does."""
    import jax

    from topiaxl.models.layers import CrossAttention as JaxCross
    from topiaxl_torch.models.layers import CrossAttention

    rng = np.random.default_rng(4)
    dim, cond, heads = 144, 32, 2
    x = rng.standard_normal((1, 10, dim)).astype(np.float32)
    ctx = rng.standard_normal((1, 7, cond)).astype(np.float32)
    mod = CrossAttention(dim, cond, heads, dtype=torch.float32).to_empty(
        device="cpu")
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.from_numpy(
                rng.standard_normal(tuple(p.shape)).astype(np.float32) * 0.2))
    sd = {k: v.numpy() for k, v in mod.state_dict().items()}
    params = {"params": {n: {"kernel": sd[f"{n}.weight"].T,
                             "bias": sd[f"{n}.bias"]}
                         for n in ("to_q", "to_k", "to_v", "proj")}}
    jm = JaxCross(dim=dim, num_heads=heads, dtype=jnp.float32)
    ref = np.asarray(jm.apply(jax.tree.map(jnp.asarray, params),
                              jnp.asarray(x), jnp.asarray(ctx)))
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(ctx)).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    # the scale is head_dim**-1, not head_dim**-0.5
    q = mod.to_q(torch.from_numpy(x)).reshape(1, 10, heads, dim // heads)
    k, v = mod.kv(torch.from_numpy(ctx))
    expect = mod.proj(flash_attention_plain(q, k, v, 1.0 / (dim // heads))
                      .reshape(1, 10, dim))
    np.testing.assert_allclose(got, expect.detach().numpy(), atol=TOL, rtol=0)


def test_wrappers_raise_on_devices_without_a_kernel():
    """A tensor that is neither on the CPU nor on a CUDA card has no path:
    the wrappers raise instead of falling back, and count nothing."""
    before = dict(_cuda.launches)
    q = torch.empty(1, 8, 1, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(q, q, q, 0.125)
    x = torch.empty(1, 8, 64, device="meta")
    m = torch.empty(1, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ln_modulate(x, m, m)
    with pytest.raises(ValueError, match="no kernel"):
        ln_modulate_residual(x, x, m, m, m)
    assert _cuda.launches == before


def test_kernel_sources_build_key():
    """The build is keyed on the sources: both .cu files are found, and
    editing nothing gives the same directory."""
    names = [p.name for p in _cuda.sources()]
    assert names == ["flash_attn_fwd.cu", "ln_modulate.cu"]
    assert _cuda.build_dir() == _cuda.build_dir()
    assert _cuda.build_dir().parent.name == "topiaxl_torch_kernels"


def test_kernel_build_root_outside_checkout(tmp_path, monkeypatch):
    """In a checkout the build lands in its build/; an installed copy (no
    pyproject.toml two levels up) builds under the user's cache."""
    assert _cuda.build_root() == (
        Path(_cuda.__file__).resolve().parents[2] / "build" / "topiaxl_torch_kernels")
    site = tmp_path / "site-packages" / "topiaxl_torch" / "ops"
    site.mkdir(parents=True)
    monkeypatch.setattr(_cuda, "__file__", str(site / "_cuda.py"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _cuda.build_root() == tmp_path / "cache" / "topiaxl_torch" / "kernels"
    assert _cuda.build_dir().parent == _cuda.build_root()


def test_modulate_and_timestep_embedding_match_jax():
    from topiaxl.models import layers as jl
    from topiaxl_torch.models import layers as tl

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    sh, sc = (rng.standard_normal((2, 32)).astype(np.float32) for _ in "ab")
    np.testing.assert_allclose(
        tl.modulate(*map(torch.from_numpy, (x, sh, sc))).numpy(),
        np.asarray(jl.modulate(*map(jnp.asarray, (x, sh, sc)))),
        atol=TOL, rtol=0)
    # cos before sin; odd dims pad one zero. An ulp of difference in the
    # two frameworks' f32 exp moves cos(t * freq) by ~t * 6e-8 at t = 999.
    t = np.array([0, 7, 999], np.int32)
    for dim in (256, 33):
        np.testing.assert_allclose(
            tl.timestep_embedding(torch.from_numpy(t), dim).numpy(),
            np.asarray(jl.timestep_embedding(jnp.asarray(t), dim)),
            atol=1e-4, rtol=0)
