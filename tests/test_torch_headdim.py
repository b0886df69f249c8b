"""The flash launchers' head dims on the CPU: the shape rule sends a head
to the kernels exactly where JAX's rule sends it to its Pallas kernel
(``Sk >= 512`` and ``D >= 64``) up to the widest instance, 256; the
zero-padding of the head dim that the launchers do on the card leaves
every output of the plain versions as it was (the identities they rely
on); the kernels' designs above head dim 80 rely on three more
identities (dq summed over 64-key blocks, dk and dv from P^T and dS^T
split by query halves, o in two column halves under one online
softmax), each with its planted fault; the backward form is the one
measured faster at the 256 instance and JAX's rule elsewhere; at head
dims 160, 200 and 256 the plain forward and its gradients match JAX's
flash attention and its custom VJP (the Pallas kernels in interpret
mode), and at 320, above every instance, so does the port's einsum form;
and a DiT with 80-wide heads, whose attention takes the flash route,
matches JAX's.

Bars: the padded plain forward's o and lse and the padded plain
backward's dq, dk and dv, sliced back, within 1e-6 of the largest value
of the unpadded ones (f32; the padding adds exact zeros, the summation
order over D may change); a scale computed from the padded head dim (a
planted fault) moves o by more than 1e-2 of it. The design identities
within 1e-6 of the largest value (f32, only the summation order
changes), each planted fault above 1e-2. Against JAX: o within
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


def test_forward_tile_layout_by_head_dim():
    """72 and 80 take the split layout (one swizzled 64-column box and the
    columns past it as 8-column chunks); 64, 96, 128 and 256 whole
    swizzled boxes; a padded head dim its instance's layout."""
    assert {d: fa.fwd_tile_layout(d) for d in fa.HEAD_DIMS} == {
        64: "swizzled", 72: "split", 80: "split", 96: "swizzled",
        128: "swizzled", 256: "swizzled"}
    for d in range(1, 257):
        assert fa.fwd_tile_layout(d) == fa.fwd_tile_layout(
            fa.kernel_head_dim(d)), d
    assert fa.fwd_tile_layout(68) == "split" and fa.fwd_tile_layout(36) == "swizzled"
    with pytest.raises(ValueError, match="257"):
        fa.fwd_tile_layout(257)


def _forward_rule(tmp_path, fields: list) -> list:
    """Rows ``d, *fields`` for every instance ``d`` of ``fa.HEAD_DIMS``, as
    the forward's rule (``csrc/flash_fwd_layout.cuh``, plain C++) computes
    them, built and run here by the host compiler; ``fields`` are C++
    expressions in ``d``, each printed as an int."""
    import shutil
    import subprocess

    from topiaxl_torch.ops import _cuda

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.fail("no host C++ compiler (g++) to read the kernel's rule")
    main = tmp_path / "rule.cpp"
    main.write_text(
        '#include <cstdio>\n#include "flash_fwd_layout.cuh"\n'
        f"const int dims[] = {{{', '.join(map(str, fa.HEAD_DIMS))}}};\n"
        "int main() {\n"
        "  for (int d : dims)\n"
        f'    std::printf("%d{" %d" * len(fields)}\\n", d, '
        f'{", ".join(fields)});\n}}\n')
    exe = tmp_path / "rule"
    subprocess.run([cxx, "-std=c++17", "-I", str(_cuda.CSRC), str(main), "-o",
                    str(exe)], check=True, capture_output=True)
    rows = [tuple(map(int, line.split())) for line in
            subprocess.run([str(exe)], check=True, capture_output=True,
                           text=True).stdout.splitlines()]
    assert [r[0] for r in rows] == list(fa.HEAD_DIMS)
    return rows


def test_forward_tile_layout_mirrors_the_kernel_rule(tmp_path):
    """``fwd_tile_layout`` against the rule the kernel is compiled with
    (``csrc/flash_fwd_layout.cuh``, plain C++ built here by the host
    compiler): split exactly where the rule leaves columns past the whole
    boxes, and those at most one k16 step of 8-column chunks."""
    rows = _forward_rule(tmp_path, ["fwd_box_cols(d)", "fwd_tail_cols(d)",
                                    "fwd_block_n(d)"])
    for d, box, tail, block_n in rows:
        assert fa.fwd_tile_layout(d) == ("split" if tail else "swizzled"), d
        assert box in (32, 64) and (d - tail) % box == 0 and tail in (0, 8, 16)
        assert block_n == fa.fwd_key_tile(d)


def test_forward_loop_mirrors_the_kernel_rule(tmp_path):
    """``fwd_loop`` against the loop rule the kernel is compiled with
    (``csrc/flash_fwd_layout.cuh:fwd_overlapped``, built here by the host
    compiler): the overlapped loop exactly on the instances the rule picks,
    the same as the backward's (``bwd_loop``), and every head dim up to 256
    on its instance's loop; the block's consumer warpgroups
    (``fwd_consumers``) at the cells' launches."""
    # (batch x heads, Sq) of the cells' launches on a 132-SM card: the
    # chain's self- and cross-attention, the xl trainer's, DINOv2's, the
    # flow trainer's; then no SM count read
    launches = ((32, 2048), (16, 2048), (128, 2048), (12, 1374), (128, 4096))
    rows = _forward_rule(tmp_path, [
        "fwd_overlapped(d)",
        *(f"fwd_consumers(d, {n}, {sq}, 132)" for n, sq in launches),
        "fwd_consumers(d, 128, 4096, 0)", "fwd_block_m(3)"])
    rule = {d: bool(r[0]) for d, *r in rows}
    assert sorted(d for d, over in rule.items() if over) == list(
        fa.OVERLAPPED_HEAD_DIMS)
    # three consumer warpgroups (192-row blocks) in the overlapped loop
    # where they take fewer of the card's waves; two elsewhere
    consumers = {d: tuple(r[1:7]) for d, *r in rows}
    assert consumers == {d: (3, 2, 3, 2, 3, 2) if rule[d] else (2,) * 6
                         for d in fa.HEAD_DIMS}
    assert all(r[-1] == 192 for r in rows)
    for d in range(1, 257):
        inst = fa.kernel_head_dim(d)
        assert fa.fwd_loop(d) == ("overlapped" if rule[inst] else "pingpong"), d
        assert (fa.fwd_loop(d) == "overlapped") == (
            fa.bwd_loop(d) == "overlapped"), d
    with pytest.raises(ValueError, match="257"):
        fa.fwd_loop(257)


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


def test_backward_form_is_measured_at_the_256_instance():
    """Head dims 129-256 take the single pass at every key length: on the
    card it beat the pair there at 2048, 1370 and 4096 keys (head dims
    160, 200 and 256). So do head dims 1-72 (the 64 and 72 instances,
    whose overlapped loop beat the pair at 4096 keys). Head dims 73-128
    keep JAX's rule, the single pass up to 2048 keys and the pair
    above."""
    for d, sk in ((256, 4096), (160, 4096), (200, 4096), (256, 2048),
                  (256, 1370), (64, 4096), (72, 4096), (36, 8192)):
        assert fa.bwd_form(sk, d) == "fused", (sk, d)
    assert fa.bwd_form(4096, 128) == "two_pass"
    assert fa.bwd_form(4096, 80) == "two_pass"
    for d in range(1, 300):
        single = d <= 72 or 128 < d <= 256
        for sk in (1, 700, 1370, fa.FUSED_BWD_MAX_KEYS):
            assert fa.bwd_form(sk, d) == "fused", (sk, d)
        for sk in (fa.FUSED_BWD_MAX_KEYS + 1, 4096, 8192):
            want = "fused" if single else "two_pass"
            assert fa.bwd_form(sk, d) == want, (sk, d)


def _design_inputs(d, sq=150, sk=200):
    """f32 q, k, v, dO [2, sq, 2, d] / [2, sk, 2, d] (ragged against the
    64-row q tiles and 64-key blocks), o and lse of the plain forward."""
    g = torch.Generator().manual_seed(d)
    q, do = (torch.randn((2, sq, 2, d), generator=g) for _ in range(2))
    k, v = (torch.randn((2, sk, 2, d), generator=g) for _ in range(2))
    scale = d ** -0.5
    o, lse = fa.flash_attention_plain(q, k, v, scale, return_lse=True)
    return q, k, v, do, o, lse, scale


def _rel(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("identity,d", [("dq_by_key_blocks", 256),
                                        ("dkdv_by_query_halves", 256),
                                        ("o_by_column_halves", 96),
                                        ("o_by_column_halves", 128),
                                        ("o_by_column_halves", 256)])
def test_wide_kernel_designs_rely_on_identities(identity, d):
    """What the redesigned kernels compute, on the plain versions in f32:
    the 256 backward adds dq over 64-key blocks (one block of the grid
    each) and splits S^T and dP^T by query halves of each 64-row q tile,
    the two halves recombined through P^T and dS^T in shared memory; the
    forward above 80 keeps O in two column halves under one running max
    and denominator over key tiles of ``fwd_key_tile(d)`` keys. Each
    equals the plain result; its planted fault (a block left out, a half
    dropped, the second O half never rescaled) lands above 1e-2."""
    q, k, v, do, o, lse, scale = _design_inputs(d)
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    if identity == "dq_by_key_blocks":
        got = fa.flash_attention_bwd_dq_blocks(q, k, v, o, lse, do, scale)
        assert _rel(got, dq) <= REL
        fault = fa.flash_attention_bwd_dq_blocks(q, k, v, o, lse, do, scale,
                                                 drop=0)
        assert _rel(fault, dq) > 1e-2
    elif identity == "dkdv_by_query_halves":
        p, ds = fa._bwd_p_ds(q, k, v, lse, fa.flash_attention_bwd_delta(
            o, do), do, scale)
        parts = []   # (dk, dv) of each 32-query half of each q tile
        for r0 in range(0, q.shape[1], 32):
            rows = slice(r0, r0 + 32)
            parts.append((
                torch.einsum("bhqk,bqhd->bkhd", ds[:, :, rows], q[:, rows]),
                torch.einsum("bhqk,bqhd->bkhd", p[:, :, rows], do[:, rows])))
        got_dk = sum(a for a, _ in parts) * scale
        got_dv = sum(b for _, b in parts)
        assert _rel(got_dk, dk) <= REL and _rel(got_dv, dv) <= REL
        one_half = sum(b for i, (_, b) in enumerate(parts) if i % 2 == 0)
        assert _rel(one_half, dv) > 1e-2
    else:
        ref = fa.flash_attention_plain(q, k, v, scale)
        tile = fa.fwd_key_tile(d)
        assert tile == (64 if d == 256 else 128)
        got = fa.flash_attention_online(q, k, v, scale, tile)
        assert _rel(got, ref) <= REL
        fault = fa.flash_attention_online(q, k, v, scale, tile,
                                          stale_half=True)
        assert _rel(fault, ref) > 1e-2


def test_launchers_refuse_a_head_dim_above_128_on_a_card_only():
    """The CPU takes the plain version at any head dim; the launchers'
    refusal of a head above the widest instance (256 since the wide
    instances) is checked before anything reaches a card, and names D."""
    q = torch.randn(1, 4, 1, 264)
    assert fa.flash_attention(q, q, q, 0.1).shape == q.shape
    assert fa._instance(136) == 256
    with pytest.raises(ValueError, match="head_dim 264"):
        fa._instance(264)


@pytest.mark.parametrize("d", [160, 200, 256, 320])
def test_wide_heads_plain_matches_jax_flash(d):
    """The plain twin of the launchers at head dims 160 and 200 (padded to
    256 on the card) and 256, forward and gradients, against JAX's
    ``flash_attention`` and its custom VJP (the Pallas forward and
    single-pass backward in interpret mode), 2 x 80 x 130 x 2 x D. At 320,
    above every instance, the port's attention takes its einsum form at
    any key length (``use_flash``) and still agrees with JAX's kernels:
    the head has no kernel yet, but its result is JAX's."""
    import jax

    from topiaxl.ops.flash_attention import flash_attention as jax_flash
    from topiaxl_torch.ops.attention import multi_head_attention

    rng = np.random.default_rng(40 + d)
    q = rng.standard_normal((2, 80, 2, d)).astype(np.float32)
    k, v = (rng.standard_normal((2, 130, 2, d)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal((2, 80, 2, d)).astype(np.float32)
    scale = d ** -0.5
    ref_out, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, scale),
                           *map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    if fa.kernel_head_dim(d) is None:
        assert not use_flash(4096, d)
        out = multi_head_attention(*ts, scale)
    else:
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
