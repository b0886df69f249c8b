"""topiaxl_torch ops against the JAX package on the CPU: the plain flash
attention against the Pallas flash kernel (interpret mode), the plain
LN+modulate pair against the Pallas LN kernels (interpret mode), the
attention dispatch rule and the cross-attention scale. Inputs come from
numpy and are handed to both frameworks; f32 throughout, tolerance 1e-5
(the two differ only in summation order and in where the softmax scale
is applied). Gradients: the port's attention backward against
``jax.vjp`` through the Pallas backward kernels (interpret mode) at 5e-5,
the JAX tests' own bar for them; the LN backward against ``jax.vjp`` of
the Pallas LN functions at 1e-5."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import torch_threads  # noqa: F401
from topiaxl.ops.attention import multi_head_attention as jax_mha
from topiaxl.ops.flash_attention import flash_attention as jax_flash
from topiaxl.ops.fused_ln import ln_modulate as jax_ln
from topiaxl.ops.fused_ln import ln_modulate_residual as jax_ln_res
from topiaxl_torch.ops import _cuda
from topiaxl_torch.ops.attention import multi_head_attention, use_flash
from topiaxl_torch.ops.flash_attention import (
    FUSED_BWD_MAX_KEYS,
    KEY_TILE,
    bwd_form,
    bwd_loop,
    flash_attention,
    flash_attention_backward,
    flash_attention_bwd_delta,
    flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq_plain,
    flash_attention_bwd_plain,
    flash_attention_bwd_unmasked,
    flash_attention_plain,
    flash_attention_unmasked,
    fwd_loop,
    fwd_tile_layout,
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
    lse = torch.empty(1, 1, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention_backward(q, q, q, q, lse, q, 0.125)
    x = torch.empty(1, 8, 64, device="meta")
    m = torch.empty(1, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ln_modulate(x, m, m)
    with pytest.raises(ValueError, match="no kernel"):
        ln_modulate_residual(x, x, m, m, m)
    assert _cuda.launches == before


def test_forward_layout_counter_on_the_cpu_path():
    """The per-layout count of flash forwards: the CPU path launches nothing
    and counts nothing; a launch counted with its layout adds to
    ``launches`` and ``fwd_layouts``; a capture's tally holds the layout
    under ``"<kernel>.<layout>"``, which ``add_launches`` takes back and
    adds again as a graph replay does; ``reset_launch_counts`` zeroes it."""
    saved = dict(_cuda.launches), dict(_cuda.fwd_layouts)
    try:
        before = dict(_cuda.launches), dict(_cuda.fwd_layouts)
        q, k, v = (torch.from_numpy(t) for t in
                   _qkv(np.random.default_rng(3), 1, 9, 11, 2, 72))
        flash_attention(q, k, v, 72 ** -0.5)
        assert (dict(_cuda.launches), dict(_cuda.fwd_layouts)) == before
        _cuda.reset_launch_counts()
        assert set(_cuda.fwd_layouts.values()) == {0}
        with _cuda.tally() as counts:
            _cuda.count_launch("flash_attn_fwd", "split")
            _cuda.count_launch("flash_attn_fwd", "swizzled")
            _cuda.count_launch("ln_modulate")
        assert counts == {"flash_attn_fwd": 2, "flash_attn_fwd.split": 1,
                          "flash_attn_fwd.swizzled": 1, "ln_modulate": 1}
        assert _cuda.fwd_layouts == {"split": 1, "swizzled": 1}
        _cuda.add_launches({key: -n for key, n in counts.items()})
        assert set(_cuda.fwd_layouts.values()) == {0}
        assert set(_cuda.launches.values()) == {0}
        for _ in range(3):
            _cuda.add_launches(counts)
        assert _cuda.fwd_layouts == {"split": 3, "swizzled": 3}
        assert _cuda.launches["flash_attn_fwd"] == 6
    finally:
        _cuda.launches.update(saved[0])
        _cuda.fwd_layouts.update(saved[1])


def test_backward_loop_counter_on_the_cpu_path():
    """The single-pass backward's launches by loop: the CPU path launches
    and counts nothing; ``bwd_loop`` names the overlapped loop at the 64
    and 72 instances (the head dims zero-padded to them too) and the
    serial one at 80-256; a launch counted with its loop adds to
    ``launches`` and ``bwd_loops`` and leaves ``fwd_layouts`` alone; a
    capture's tally holds it under ``"flash_attn_bwd.<loop>"``, which
    ``add_launches`` takes back and adds again as a graph replay does;
    ``reset_launch_counts`` zeroes it."""
    saved = (dict(_cuda.launches), dict(_cuda.fwd_layouts),
             dict(_cuda.bwd_loops))
    try:
        rng = np.random.default_rng(4)
        q, k, v = map(torch.from_numpy, _qkv(rng, 1, 9, 11, 2, 72))
        o, lse = flash_attention_plain(q, k, v, 0.2, return_lse=True)
        before = (dict(_cuda.launches), dict(_cuda.bwd_loops))
        flash_attention_backward(q, k, v, o, lse, torch.ones_like(q), 0.2)
        assert (dict(_cuda.launches), dict(_cuda.bwd_loops)) == before
        for d in range(1, 257):
            want = "overlapped" if d <= 72 else "serial"
            assert bwd_loop(d) == want, d
        _cuda.reset_launch_counts()
        assert set(_cuda.bwd_loops.values()) == {0}
        with _cuda.tally() as counts:
            _cuda.count_launch("flash_attn_bwd", bwd_loop(72))
            _cuda.count_launch("flash_attn_bwd", bwd_loop(64))
            _cuda.count_launch("flash_attn_bwd", bwd_loop(128))
            _cuda.count_launch("flash_attn_bwd_dq")
        assert counts == {"flash_attn_bwd": 3, "flash_attn_bwd.overlapped": 2,
                          "flash_attn_bwd.serial": 1, "flash_attn_bwd_dq": 1}
        assert _cuda.bwd_loops == {"overlapped": 2, "serial": 1}
        assert set(_cuda.fwd_layouts.values()) == {0}
        _cuda.add_launches({key: -n for key, n in counts.items()})
        assert set(_cuda.bwd_loops.values()) == {0}
        assert set(_cuda.launches.values()) == {0}
        for _ in range(2):
            _cuda.add_launches(counts)
        assert _cuda.bwd_loops == {"overlapped": 4, "serial": 2}
        assert _cuda.launches["flash_attn_bwd"] == 6
        _cuda.reset_launch_counts()
        assert set(_cuda.bwd_loops.values()) == {0}
    finally:
        _cuda.launches.update(saved[0])
        _cuda.fwd_layouts.update(saved[1])
        _cuda.bwd_loops.update(saved[2])


def test_forward_loop_counter_on_the_cpu_path():
    """The flash forward's launches by loop: the CPU path launches and counts
    nothing; ``fwd_loop`` names the overlapped loop at the 64 and 72
    instances (the head dims zero-padded to them too) and the ping-pong one
    at 80-256; a launch counted with its layout and its loop adds to
    ``launches``, ``fwd_layouts`` and ``fwd_loops`` and leaves ``bwd_loops``
    alone; a capture's tally holds both tags under
    ``"flash_attn_fwd.<tag>"``, which ``add_launches`` takes back and adds
    again as a graph replay does, each to its own table;
    ``reset_launch_counts`` zeroes it."""
    saved = (dict(_cuda.launches), dict(_cuda.fwd_layouts),
             dict(_cuda.fwd_loops), dict(_cuda.bwd_loops))
    try:
        q, k, v = (torch.from_numpy(t) for t in
                   _qkv(np.random.default_rng(5), 1, 9, 11, 2, 64))
        before = dict(_cuda.launches), dict(_cuda.fwd_loops)
        flash_attention(q, k, v, 64 ** -0.5)
        assert (dict(_cuda.launches), dict(_cuda.fwd_loops)) == before
        for d in range(1, 257):
            want = "overlapped" if d <= 72 else "pingpong"
            assert fwd_loop(d) == want, d
        _cuda.reset_launch_counts()
        assert set(_cuda.fwd_loops.values()) == {0}
        with _cuda.tally() as counts:
            for d in (72, 64, 72, 128, 256):
                _cuda.count_launch("flash_attn_fwd", fwd_tile_layout(d),
                                   fwd_loop(d))
        assert counts == {"flash_attn_fwd": 5, "flash_attn_fwd.split": 2,
                          "flash_attn_fwd.swizzled": 3,
                          "flash_attn_fwd.overlapped": 3,
                          "flash_attn_fwd.pingpong": 2}
        assert _cuda.fwd_loops == {"overlapped": 3, "pingpong": 2}
        assert _cuda.fwd_layouts == {"split": 2, "swizzled": 3}
        assert set(_cuda.bwd_loops.values()) == {0}
        _cuda.add_launches({key: -n for key, n in counts.items()})
        assert set(_cuda.fwd_loops.values()) == {0}
        assert set(_cuda.fwd_layouts.values()) == {0}
        assert set(_cuda.launches.values()) == {0}
        for _ in range(2):
            _cuda.add_launches(counts)
        assert _cuda.fwd_loops == {"overlapped": 6, "pingpong": 4}
        assert _cuda.fwd_layouts == {"split": 4, "swizzled": 6}
        assert _cuda.launches["flash_attn_fwd"] == 10
        _cuda.reset_launch_counts()
        assert set(_cuda.fwd_loops.values()) == {0}
    finally:
        _cuda.launches.update(saved[0])
        _cuda.fwd_layouts.update(saved[1])
        _cuda.fwd_loops.update(saved[2])
        _cuda.bwd_loops.update(saved[3])


def test_kernel_sources_build_key():
    """The build is keyed on the sources: every .cu file and shared header
    is found, and editing nothing gives the same directory."""
    names = [p.name for p in _cuda.sources()]
    assert names == ["adamw_ema.cu", "flash_attn_bwd.cu",
                     "flash_attn_bwd_sm90.cu", "flash_attn_fwd.cu",
                     "ln_modulate.cu", "mma_probe.cu", "qk_rmsnorm.cu"]
    assert [p.name for p in _cuda.headers()] == ["flash_fwd_layout.cuh",
                                                 "sm90.cuh"]
    assert _cuda.build_dir() == _cuda.build_dir()
    assert _cuda.build_dir().parent.name == "topiaxl_torch_kernels"


def test_kernel_build_key_covers_shared_header(tmp_path, monkeypatch):
    """Editing the header the kernels share gives a new build directory,
    so the next launch rebuilds them."""
    for src in _cuda.sources() + _cuda.headers():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    before = _cuda.build_dir()
    with open(tmp_path / "sm90.cuh", "a") as f:
        f.write("// edited\n")
    assert _cuda.build_dir() != before


_FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
if any(a.endswith("{fail}") for a in args):
    print("error: {fail} does not compile")
    sys.exit(2)
print("ptxas info    : Used 8 registers")
open(args[args.index("-o") + 1], "w").write("obj")
"""


@pytest.mark.parametrize("fail", ["", "flash_attn_bwd.cu"])
def test_kernel_build_compiles_each_source_then_links(tmp_path, monkeypatch,
                                                      fail):
    """One nvcc per source, each with ``-c``, then one link of the objects
    into the library; a failing source raises with its output and leaves
    no library and no objects behind."""
    import sys

    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, log=str(log),
                                      fail=fail or "never"))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_cuda, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_cuda, "build_root", lambda: tmp_path / "build")
    if fail:
        with pytest.raises(RuntimeError, match=f"{fail} does not compile"):
            _cuda.build()
        assert not list((tmp_path / "build").rglob("*.so"))
    else:
        lib = _cuda.build()
        assert lib == _cuda.build_dir() / _cuda.LIB_NAME and lib.exists()
        assert "Used 8 registers" in (lib.parent / "build.log").read_text()
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in c]
    assert sorted(c.split()[-1] for c in compiles) == sorted(
        str(p) for p in _cuda.sources())
    links = [c for c in calls if c.startswith("-shared")]
    assert len(links) == (0 if fail else 1)
    assert not list((tmp_path / "build").rglob("*.o"))


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


BWD_TOL = 5e-5


def _port_vjp(q, k, v, g, scale):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*ts, scale)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("B,Sq,Sk,H,D,scale", [
    (2, 40, 37, 2, 72, 72 ** -0.5),      # ragged Sk
    (1, 24, 40, 3, 72, 1.0 / 72),        # the cross-attention scale
    (1, 48, 21, 2, 64, 64 ** -0.5),      # Sk < Sq
])
def test_flash_backward_matches_jax_vjp(B, Sq, Sk, H, D, scale):
    """The autograd backward against jax.vjp of the JAX flash attention,
    whose custom_vjp runs the single-pass Pallas backward (#4)."""
    import jax

    rng = np.random.default_rng(20)
    q, k, v = _qkv(rng, B, Sq, Sk, H, D)
    g = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    ref_out, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, scale),
                           *map(jnp.asarray, (q, k, v)))
    out, grads = _port_vjp(q, k, v, g, scale)
    np.testing.assert_allclose(out, np.asarray(ref_out), atol=TOL, rtol=0)
    for got, ref, name in zip(grads, vjp(jnp.asarray(g)), "qkv"):
        np.testing.assert_allclose(got, np.asarray(ref), atol=BWD_TOL,
                                   rtol=0, err_msg=f"d{name}")


def test_flash_backward_matches_jax_two_pass():
    """The plain backward against the JAX two-pass Pallas pair (#5, #6),
    reached with 128-key blocks, and the port's lse against the Pallas
    forward's."""
    from topiaxl.ops import flash_attention as fa

    rng = np.random.default_rng(21)
    B, Sq, Sk, H, D, scale = 1, 96, 300, 2, 72, 72 ** -0.5
    q, k, v = _qkv(rng, B, Sq, Sk, H, D)
    g = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    out, lse = fa._flash_forward(jq, jk, jv, scale, block_q=128,
                                 block_k=128, return_lse=True)
    ref = fa._flash_backward(jq, jk, jv, out, lse, jg, scale, block_q=128,
                             block_k=128, dkv_block_q=128, dkv_block_k=128)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, t_lse = flash_attention_plain(tq, tk, tv, scale, return_lse=True)
    ref_lse = np.asarray(lse)[:, 0, :Sq].reshape(B, H, Sq)
    np.testing.assert_allclose(t_lse.numpy(), ref_lse, atol=TOL, rtol=0)
    got = flash_attention_backward(tq, tk, tv, o, t_lse, torch.from_numpy(g),
                                   scale)
    for a, b, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=BWD_TOL,
                                   rtol=0, err_msg=f"d{name}")


def _jax_two_pass(B, Sq, Sk, H, D, scale, block_q, block_k, seed):
    """Inputs from numpy, the JAX forward's folded lse and the JAX wrapper's
    delta ([B*H, 1, sq_p]), and the two Pallas passes run on them in
    interpret mode as ``_flash_backward`` launches them (dq pass over
    ``block_k``-key blocks, dk/dv pass over ``block_q``-row chunks)."""
    import functools

    import jax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from topiaxl.ops import flash_attention as fa

    rng = np.random.default_rng(seed)
    q, k, v = _qkv(rng, B, Sq, Sk, H, D)
    g = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    out, lse = fa._flash_forward(jq, jk, jv, scale, block_q=block_q,
                                 block_k=block_k, return_lse=True)
    bq, bk, _, sk_p, d_p = fa._fold_sizes(jq, jk, block_q, block_k)
    sq_p = lse.shape[2]
    BH = B * H
    qs = jq * jnp.asarray(scale, jq.dtype)
    qp, qtp = fa._fold(qs, sq_p, d_p), fa._fold_t(qs, sq_p, d_p)
    kp, ktp = fa._fold(jk, sk_p, d_p), fa._fold_t(jk, sk_p, d_p)
    vp = fa._fold(jv, sk_p, d_p)
    dop, dotp = fa._fold(jg, sq_p, d_p), fa._fold_t(jg, sq_p, d_p)
    op = fa._fold(out, sq_p, d_p)
    delta = jnp.sum(dop * op, axis=-1)[:, None, :]           # [BH, 1, sq_p]

    def spec(shape, index):
        return pl.BlockSpec(shape, index, memory_space=pltpu.VMEM)

    dqt = pl.pallas_call(
        functools.partial(fa._flash_bwd_dq_kernel, scale=scale, kv_len=Sk,
                          block_k=bk),
        out_shape=jax.ShapeDtypeStruct((BH, d_p, sq_p), jq.dtype),
        grid=(BH, sq_p // bq),
        in_specs=[spec((1, bq, d_p), lambda b, i: (b, i, 0)),
                  spec((1, sk_p, d_p), lambda b, i: (b, 0, 0)),
                  spec((1, d_p, sk_p), lambda b, i: (b, 0, 0)),
                  spec((1, sk_p, d_p), lambda b, i: (b, 0, 0)),
                  spec((1, bq, d_p), lambda b, i: (b, i, 0)),
                  spec((1, 1, bq), lambda b, i: (b, 0, i)),
                  spec((1, 1, bq), lambda b, i: (b, 0, i))],
        out_specs=spec((1, d_p, bq), lambda b, i: (b, 0, i)),
        interpret=True,
    )(qp, kp, ktp, vp, dop, lse, delta)
    dkt, dvt = pl.pallas_call(
        functools.partial(fa._flash_bwd_dkv_kernel, q_len=Sq, block_q=bq),
        out_shape=[jax.ShapeDtypeStruct((BH, d_p, sk_p), jk.dtype)] * 2,
        grid=(BH, sk_p // bk),
        in_specs=[spec((1, sq_p, d_p), lambda b, j: (b, 0, 0)),
                  spec((1, d_p, sq_p), lambda b, j: (b, 0, 0)),
                  spec((1, bk, d_p), lambda b, j: (b, j, 0)),
                  spec((1, bk, d_p), lambda b, j: (b, j, 0)),
                  spec((1, sq_p, d_p), lambda b, j: (b, 0, 0)),
                  spec((1, d_p, sq_p), lambda b, j: (b, 0, 0)),
                  spec((1, 1, sq_p), lambda b, j: (b, 0, 0)),
                  spec((1, 1, sq_p), lambda b, j: (b, 0, 0))],
        out_specs=[spec((1, d_p, bk), lambda b, j: (b, 0, j))] * 2,
        interpret=True,
    )(qp, qtp, kp, vp, dop, dotp, lse, delta)

    def unfold_rows(x):   # [B*H, 1, sq_p] -> [B, H, Sq]
        return torch.from_numpy(np.array(x)[:, 0, :Sq].reshape(B, H, Sq))

    port = dict(q=torch.from_numpy(q), k=torch.from_numpy(k),
                v=torch.from_numpy(v), do=torch.from_numpy(g),
                o=torch.from_numpy(np.array(out)), lse=unfold_rows(lse),
                delta=unfold_rows(delta))
    ref = {"dq": fa._unfold_t(dqt, B, H, Sq, D),
           "dk": fa._unfold_t(dkt, B, H, Sk, D),
           "dv": fa._unfold_t(dvt, B, H, Sk, D)}
    return port, {n: np.asarray(a) for n, a in ref.items()}


# (B, Sq, Sk, H, D, scale, block_q, block_k): several q and key blocks
# with ragged Sq and Sk at D 72 and 64, and one key block (the dq
# kernel's single-block path)
_TWO_PASS_CASES = [
    (1, 300, 300, 2, 72, 72 ** -0.5, 128, 128),
    (2, 100, 200, 2, 64, 64 ** -0.5, 128, 128),
    (1, 70, 37, 3, 72, 1.0 / 72, 128, 128),
]


@pytest.mark.parametrize("B,Sq,Sk,H,D,scale,block_q,block_k",
                         _TWO_PASS_CASES)
def test_flash_bwd_dq_plain_matches_jax_dq_kernel(B, Sq, Sk, H, D, scale,
                                                  block_q, block_k):
    """The dq pass's plain twin against ``_flash_bwd_dq_kernel`` (Pallas,
    interpret mode) on the same lse and delta."""
    t, ref = _jax_two_pass(B, Sq, Sk, H, D, scale, block_q, block_k, 27)
    got = flash_attention_bwd_dq_plain(t["q"], t["k"], t["v"], t["do"],
                                       t["lse"], t["delta"], scale)
    assert got.shape == (B, Sq, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref["dq"], atol=BWD_TOL, rtol=0)


@pytest.mark.parametrize("B,Sq,Sk,H,D,scale,block_q,block_k",
                         _TWO_PASS_CASES)
def test_flash_bwd_dkv_plain_matches_jax_dkv_kernel(B, Sq, Sk, H, D, scale,
                                                    block_q, block_k):
    """The dk/dv pass's plain twin against ``_flash_bwd_dkv_kernel``
    (Pallas, interpret mode) on the same lse and delta."""
    t, ref = _jax_two_pass(B, Sq, Sk, H, D, scale, block_q, block_k, 28)
    dk, dv = flash_attention_bwd_dkv_plain(t["q"], t["k"], t["v"], t["do"],
                                           t["lse"], t["delta"], scale)
    assert dk.shape == dv.shape == (B, Sk, H, D)
    np.testing.assert_allclose(dk.numpy(), ref["dk"], atol=BWD_TOL, rtol=0)
    np.testing.assert_allclose(dv.numpy(), ref["dv"], atol=BWD_TOL, rtol=0)


def test_flash_bwd_delta_matches_jax_and_composes():
    """delta = rowsum(dO * o) as the JAX wrapper computes it, and the two
    passes together give the plain backward."""
    B, Sq, Sk, H, D, scale = 1, 300, 300, 2, 72, 72 ** -0.5
    t, _ = _jax_two_pass(B, Sq, Sk, H, D, scale, 128, 128, 29)
    delta = flash_attention_bwd_delta(t["o"], t["do"])
    assert delta.shape == (B, H, Sq) and delta.dtype == torch.float32
    np.testing.assert_allclose(delta.numpy(), t["delta"].numpy(), atol=TOL,
                               rtol=0)
    args = (t["q"], t["k"], t["v"], t["do"], t["lse"], delta, scale)
    whole = flash_attention_bwd_plain(t["q"], t["k"], t["v"], t["o"],
                                      t["lse"], t["do"], scale)
    for a, b in zip((flash_attention_bwd_dq_plain(*args),
                     *flash_attention_bwd_dkv_plain(*args)), whole):
        assert torch.equal(a, b)


def test_flash_lse_matches_jax_kernel():
    from topiaxl.ops import flash_attention as fa

    rng = np.random.default_rng(22)
    B, Sq, Sk, H, D = 2, 33, 45, 2, 72
    q, k, v = _qkv(rng, B, Sq, Sk, H, D)
    _, lse = fa._flash_forward(*map(jnp.asarray, (q, k, v)), 0.2,
                               return_lse=True)
    _, got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), 0.2,
                                   return_lse=True)
    assert got.shape == (B, H, Sq) and got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(lse)[:, 0, :Sq].reshape(B, H, Sq),
        atol=TOL, rtol=0)


def test_backward_form_is_a_shape_rule():
    """The single pass while the whole KV is one block of at most 2048
    keys (the DiT's self- and cross-attention) at every head dim; above
    2048 keys the single pass at 64 and 72 (its overlapped loop, measured
    faster than the pair there), the two-pass pair at 80-128 (JAX's
    rule)."""
    for d in (64, 72, 80, 128):
        assert (bwd_form(2048, d) == bwd_form(1370, d) == bwd_form(1, d)
                == "fused")
        want = "fused" if d <= 72 else "two_pass"
        assert (bwd_form(FUSED_BWD_MAX_KEYS + 1, d) == bwd_form(4096, d)
                == want), d


def test_backward_without_delta_fault():
    """The planted fault of the backward checks moves dq and dk, not dv."""
    rng = np.random.default_rng(23)
    q, k, v = map(torch.from_numpy, _qkv(rng, 1, 12, 20, 2, 64))
    g = torch.from_numpy(rng.standard_normal((1, 12, 2, 64)).astype("f"))
    o, lse = flash_attention_plain(q, k, v, 0.125, return_lse=True)
    good = flash_attention_bwd_plain(q, k, v, o, lse, g, 0.125)
    bad = flash_attention_bwd_plain(q, k, v, o, lse, g, 0.125,
                                    with_delta=False)
    assert not torch.allclose(good[0], bad[0], atol=1e-3)
    assert not torch.allclose(good[1], bad[1], atol=1e-3)
    assert torch.equal(good[2], bad[2])


def test_backward_unmasked_padding_fault():
    """The planted fault that moves dv: with no padded keys it is the
    plain backward; with padded keys every gradient moves, dv included."""
    rng = np.random.default_rng(26)
    for Sk, same in ((KEY_TILE, True), (KEY_TILE + 5, False)):
        q, k, v = map(torch.from_numpy, _qkv(rng, 1, 12, Sk, 2, 64))
        g = torch.from_numpy(rng.standard_normal((1, 12, 2, 64)).astype("f"))
        o, lse = flash_attention_plain(q, k, v, 0.125, return_lse=True)
        good = flash_attention_bwd_plain(q, k, v, o, lse, g, 0.125)
        bad = flash_attention_bwd_unmasked(q, k, v, g, 0.125)
        for a, b in zip(good, bad):
            assert a.shape == b.shape
            assert torch.equal(a, b) == same


def test_no_grad_forward_saves_nothing():
    """Serving (no input needs a gradient) keeps the plain forward: no
    autograd node, the same values as under autograd."""
    q, k, v = map(torch.from_numpy, _qkv(np.random.default_rng(24),
                                         1, 9, 11, 2, 64))
    out = flash_attention(q, k, v, 0.1)
    assert out.grad_fn is None
    qg = q.clone().requires_grad_()
    out_g = flash_attention(qg, k, v, 0.1)
    assert out_g.grad_fn is not None
    assert torch.equal(out, out_g.detach())


def test_ln_modulate_backward_matches_jax_vjp():
    import jax

    rng = np.random.default_rng(25)
    x = rng.standard_normal((2, 16, 128)).astype(np.float32) * 3 + 1
    sh, sc = (rng.standard_normal((2, 128)).astype(np.float32) for _ in "ab")
    g = rng.standard_normal((2, 16, 128)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jax_ln(a, b, c, interpret=True),
                     *map(jnp.asarray, (x, sh, sc)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, sh, sc)]
    ln_modulate(*ts).backward(torch.from_numpy(g))
    for t, ref, name in zip(ts, vjp(jnp.asarray(g)), ("x", "shift", "scale")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=0, err_msg=name)


def test_ln_modulate_residual_backward_matches_jax_vjp():
    import jax

    rng = np.random.default_rng(26)
    x, d, gx, gh = (rng.standard_normal((2, 8, 256)).astype(np.float32)
                    for _ in range(4))
    gate, sh, sc = (rng.standard_normal((2, 256)).astype(np.float32)
                    for _ in "gsc")
    _, vjp = jax.vjp(lambda *a: jax_ln_res(*a, interpret=True),
                     *map(jnp.asarray, (x, d, gate, sh, sc)))
    refs = vjp((jnp.asarray(gx), jnp.asarray(gh)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, d, gate, sh, sc)]
    xn, h = ln_modulate_residual(*ts)
    torch.autograd.backward((xn, h), (torch.from_numpy(gx),
                                      torch.from_numpy(gh)))
    for t, ref, name in zip(ts, refs, ("x", "delta", "gate", "shift",
                                       "scale")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=0, err_msg=name)
