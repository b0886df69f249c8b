"""The flash launchers' head dims on the CPU: the shape rule sends a head
to the kernels exactly where JAX's rule sends it to its Pallas kernel
(``Sk >= 512`` and ``D >= 64``) up to the widest instance, 256; the
zero-padding of the head dim that the launchers do on the card leaves
every output of the plain versions as it was (the identities they rely
on); at head dims 160, 200 and 256 the plain forward and its gradients
match JAX's flash attention and its custom VJP (the Pallas kernels in
interpret mode); and a DiT with 80-wide heads, whose attention takes the
flash route, matches JAX's.

Bars: the padded plain forward's o and lse and the padded plain
backward's dq, dk and dv, sliced back, within 1e-6 of the largest value
of the unpadded ones (f32; the padding adds exact zeros, the summation
order over D may change); a scale computed from the padded head dim (a
planted fault) moves o by more than 1e-2 of it. Against JAX: o within
1e-5 and the gradients within 5e-5 (``tests/test_torch_ops.py``'s bars).
The DiT's CFG step within 1e-4 of JAX's (``tests/test_torch_models.py``'s
bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_models import randomize_, torch_threads  # noqa: F401
from topiaxl_torch.ops import flash_attention as fa
from topiaxl_torch.ops.attention import use_flash

REL = 1e-6


def test_kernel_head_dim_is_the_next_instance():
    for d in range(1, 257):
        inst = fa.kernel_head_dim(d)
        if d > max(fa.HEAD_DIMS):
            assert inst is None
        else:
            assert inst in fa.HEAD_DIMS and inst >= d
            assert all(h < d for h in fa.HEAD_DIMS if h < inst)
    assert [fa.kernel_head_dim(d) for d in (36, 64, 72, 80, 88, 96, 100,
                                            128)] == [64, 64, 72, 80, 96,
                                                      96, 128, 128]


@pytest.mark.parametrize("sk", [512, 1370, 2048, 4096])
def test_use_flash_sends_only_what_the_launcher_takes(sk):
    """JAX's rule (``topiaxl/ops/attention.py``: ``Sk >= 512`` and ``D >=
    64``) for every head dim up to 256; none above, where no launcher
    takes the head."""
    for d in range(8, 300):
        assert use_flash(sk, d) == (d >= 64 and d <= 256), d
        if use_flash(sk, d):
            assert fa.kernel_head_dim(d) is not None
    assert not use_flash(511, 80) and not use_flash(511, 256)


def test_kernel_head_dim_takes_129_to_256_to_the_256_instance():
    assert [fa.kernel_head_dim(d) for d in range(129, 257)] == [256] * 128
    assert all(fa.kernel_head_dim(d) is None for d in range(257, 520))


def _qkv(d, seed=0, sq=37, sk=53):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((2, sq, 3, d), generator=g),
            torch.randn((2, sk, 3, d), generator=g),
            torch.randn((2, sk, 3, d), generator=g),
            torch.randn((2, sq, 3, d), generator=g))


def _close(got, ref):
    err = (got - ref).abs().max().item()
    assert err <= REL * ref.abs().max().item(), err


@pytest.mark.parametrize("d", [16, 36, 88, 100, 120, 160, 200])
def test_zero_padding_the_head_dim_changes_no_output(d):
    """What the launchers do on the card, on the plain versions: q, k, v,
    o and dO padded with zeros to the instance, the caller's scale, and
    the outputs sliced back."""
    inst = fa.kernel_head_dim(d)
    q, k, v, do = _qkv(d)
    scale = d ** -0.5
    pad = lambda t: F.pad(t, (0, inst - d))   # noqa: E731
    o, lse = fa.flash_attention_plain(q, k, v, scale, return_lse=True)
    po, plse = fa.flash_attention_plain(pad(q), pad(k), pad(v), scale,
                                        return_lse=True)
    assert po[..., d:].abs().max().item() == 0.0
    _close(po[..., :d], o)
    _close(plse, lse)
    grads = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    pgrads = fa.flash_attention_bwd_plain(pad(q), pad(k), pad(v), po, plse,
                                          pad(do), scale)
    for g, pg in zip(grads, pgrads):
        assert pg[..., d:].abs().max().item() == 0.0
        _close(pg[..., :d], g)
    # the two passes of the pair, with delta from the padded o and dO
    delta = fa.flash_attention_bwd_delta(po, pad(do))
    _close(delta, fa.flash_attention_bwd_delta(o, do))
    _close(fa.flash_attention_bwd_dq_plain(pad(q), pad(k), pad(v), pad(do),
                                           plse, delta, scale)[..., :d],
           grads[0])
    for g, pg in zip(grads[1:], fa.flash_attention_bwd_dkv_plain(
            pad(q), pad(k), pad(v), pad(do), plse, delta, scale)):
        _close(pg[..., :d], g)
    # the planted fault: the scale recomputed from the padded head dim
    fault = fa.flash_attention_plain(pad(q), pad(k), pad(v), inst ** -0.5)
    rel = ((fault[..., :d] - o).abs().max() / o.abs().max()).item()
    assert rel > 1e-2, rel


def test_launchers_refuse_a_head_dim_above_128_on_a_card_only():
    """The CPU takes the plain version at any head dim; the launchers'
    refusal of a head above the widest instance (256 since the wide
    instances) is checked before anything reaches a card, and names D."""
    q = torch.randn(1, 4, 1, 264)
    assert fa.flash_attention(q, q, q, 0.1).shape == q.shape
    assert fa._instance(136) == 256
    with pytest.raises(ValueError, match="head_dim 264"):
        fa._instance(264)


@pytest.mark.parametrize("d", [160, 200, 256])
def test_wide_heads_plain_matches_jax_flash(d):
    """The plain twin of the launchers at head dims 160 and 200 (padded to
    256 on the card) and 256, forward and gradients, against JAX's
    ``flash_attention`` and its custom VJP (the Pallas forward and
    single-pass backward in interpret mode), 2 x 80 x 130 x 2 x D."""
    import jax

    from topiaxl.ops.flash_attention import flash_attention as jax_flash

    rng = np.random.default_rng(40 + d)
    q = rng.standard_normal((2, 80, 2, d)).astype(np.float32)
    k, v = (rng.standard_normal((2, 130, 2, d)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal((2, 80, 2, d)).astype(np.float32)
    scale = d ** -0.5
    ref_out, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, scale),
                           *map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa.flash_attention(*ts, scale)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               atol=1e-5, rtol=0)
    for t, ref, name in zip(ts, vjp(jnp.asarray(g)), "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   atol=5e-5, rtol=0, err_msg=f"d{name}")


def test_dit_with_80_wide_heads_matches_jax():
    """hidden 320, 4 heads of 80, 2 blocks; 512 tokens and 512 conditioning
    tokens, so both attentions take the flash route (its plain version on
    the CPU) in the port, the einsum path in JAX."""
    from topiaxl.core import convert
    from topiaxl.models import DiT as JaxDiT
    from topiaxl_torch.models.dit import DiT

    n, m = 512, 512
    assert use_flash(m, 80) and use_flash(n, 80)
    dit = DiT(seq_length=n, in_channels=68, condition_channels=32,
              hidden_size=320, depth=2, num_heads=4, dtype=torch.float32)
    sd = randomize_(dit, 7)
    params = jax.tree.map(jnp.asarray, convert.convert_dit(sd, depth=2))
    jd = JaxDiT(seq_length=n, in_channels=68, condition_channels=32,
                hidden_size=320, depth=2, num_heads=4, attn_proj_bias=True,
                dtype=jnp.float32)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, n, 68)).astype(np.float32)
    y = rng.standard_normal((1, m, 32)).astype(np.float32)
    t = np.array([421], np.int32)
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
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
