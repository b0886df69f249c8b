"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These need a CUDA card (the kernels have no CPU mode) and skip
without one. The file imports no JAX, so it also runs where only the
port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

Bars: attention within 1e-2 of the plain f32-softmax version, relative
to max|out| (bf16 output, P rounded to bf16 on both sides); a planted
fault, the plain version with the kernel's zero-padded keys unmasked,
must land above that bar on inputs built to expose it. The backward
kernels (single pass and the two-pass pair) within 1.2e-2 of the plain
backward per output on the same o and lse, relative to max|grad| (bf16
P and dS on both sides; dq summed by f32 reductions in the single pass), and
the plain backward without delta (dq, dk) and the pair with padded keys
unmasked (dq, dk, dv) must land above that bar; the pair repeats its
gradients bit for bit. The forward's
lse within 1e-4 of the plain logsumexp. LN
outputs within one bf16 ulp of the plain f32 chain plus 1e-5 for the
f32 summation order. The probe kernel (``csrc/mma_probe.cu``): int8
exact, bf16 within 1e-3 of max|plain| (f32 sums in another order), with
planted faults (coefficients +1, one product fewer, a pad of ones) above,
also where several blocks share an output tile (their partial sums
reduced in a fixed order, so two launches give the same bits).
Every head dim up to 128 (80, 96 and 128 on their own instances, the
others zero-padded by the launchers) at the same bars, with a scale
computed from the padded head dim (a planted fault) above the forward's.
Ring attention (``ops/ring_attention.py``) over P token blocks held in
one process, against one forward and backward launch over the whole
sequence at the same bars; the backward on each block's own o and lse
(a planted fault) must land above the backward's.
"""

import pytest
import torch

from topiaxl_torch import benchmarks
from topiaxl_torch.benchmarks import exp_dot_forms as edf
from topiaxl_torch.benchmarks import microbench_int8 as mbi
from topiaxl_torch.ops import _cuda
from topiaxl_torch.ops.flash_attention import (
    KEY_TILE,
    bwd_form,
    flash_attention,
    flash_attention_backward,
    flash_attention_bwd_plain,
    flash_attention_bwd_unmasked,
    flash_attention_plain,
    flash_attention_unmasked,
)
from topiaxl_torch.ops.fused_ln import (
    ln_modulate,
    ln_modulate_plain,
    ln_modulate_residual,
    ln_modulate_residual_plain,
)

pytestmark = pytest.mark.cuda

ATTN_REL_BAR = 1e-2
ATTN_BWD_REL_BAR = 1.2e-2
LSE_ABS_BAR = 1e-4
PROBE_REL_BAR = 1e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(dev, *shape, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).bfloat16()


def _rel_err(got, ref):
    ref = ref.float()
    return ((got.float() - ref).abs().max() / ref.abs().max()).item()


def _ulp_excess(got, ref):
    ref = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    return ((got.float() - ref).abs() - ulp).max().item()


@pytest.mark.parametrize("B,Sq,Sk,H,D,scale", [
    (1, 1, 1, 1, 64, 0.125),
    (2, 65, 63, 3, 72, 72 ** -0.5),
    (1, 130, 700, 2, 64, 64 ** -0.5),
    (3, 17, 1025, 1, 72, 1.0 / 72),
    (1, 200, 64, 2, 72, 2.0),
])
def test_flash_matches_plain(dev, B, Sq, Sk, H, D, scale):
    q, _, _ = _randn(dev, B, Sq, 3, H, D, seed=1).unbind(2)   # strided view
    kv = _randn(dev, B, Sk + 5, 2, H, D, seed=2)[:, 5:]        # offset view
    k, v = kv[:, :, 0], kv[:, :, 1]
    before = _cuda.launches["flash_attn_fwd"]
    got = flash_attention(q, k, v, scale)
    assert _cuda.launches["flash_attn_fwd"] == before + 1
    ref = flash_attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert _rel_err(got, ref) <= ATTN_REL_BAR


@pytest.mark.parametrize("Sk,D", [(63, 72), (700, 64), (1025, 72), (1370, 72),
                                  (1374, 64)])
def test_flash_masks_ragged_keys(dev, Sk, D):
    """Every real logit is well below 0, so zero-padded keys left unmasked
    (logit 0) would take most of the softmax mass."""
    assert Sk % KEY_TILE
    q = _randn(dev, 1, 96, 2, D, seed=6).abs()
    k = -_randn(dev, 1, Sk, 2, D, seed=7).abs()
    v = _randn(dev, 1, Sk, 2, D, seed=8)
    scale = D ** -0.5
    ref = flash_attention_plain(q, k, v, scale)
    got = flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert _rel_err(got, ref) <= ATTN_REL_BAR
    assert _rel_err(flash_attention_unmasked(q, k, v, scale), ref) > ATTN_REL_BAR


@pytest.mark.parametrize("B,Sq,Sk,H,D,scale", [
    (2, 65, 63, 3, 72, 72 ** -0.5),      # ragged both, fused
    (1, 200, 1370, 2, 72, 1.0 / 72),     # cross-attention-like, fused
    (1, 130, 2100, 2, 72, 72 ** -0.5),   # two-pass, ragged
    (2, 64, 2048, 1, 64, 64 ** -0.5),    # the last fused length
    (1, 130, 700, 2, 64, 64 ** -0.5),    # fused, D 64, ragged both
    (1, 2048, 2048, 2, 72, 72 ** -0.5),  # fused, many q tiles per block
    (2, 300, 1374, 3, 64, 64 ** -0.5),   # fused, D 64, ragged keys
    (1, 130, 2100, 2, 64, 64 ** -0.5),   # two-pass, D 64
    (1, 200, 2177, 2, 72, 72 ** -0.5),   # two-pass, Sq % 128, Sk % 128
    (3, 100, 2300, 2, 72, 72 ** -0.5),   # two-pass, B 3
])
def test_flash_backward_matches_plain(dev, B, Sq, Sk, H, D, scale):
    qkv = _randn(dev, B, Sq, 3, H, D, seed=11)
    q = qkv[:, :, 0].requires_grad_()
    kv = _randn(dev, B, Sk, 2, H, D, seed=12)
    k, v = (t.requires_grad_() for t in kv.unbind(2))
    do = _randn(dev, B, Sq, H, D, seed=13)
    before = dict(_cuda.launches)
    o = flash_attention(q, k, v, scale)
    lse = o.grad_fn.saved_tensors[4]
    o.backward(do)
    names = (["flash_attn_bwd"] if bwd_form(Sk) == "fused"
             else ["flash_attn_bwd_dq", "flash_attn_bwd_dkv"])
    for name in ("flash_attn_bwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        assert _cuda.launches[name] == before[name] + (name in names)
    args = (q.detach(), k.detach(), v.detach(), o.detach(), lse, do, scale)
    ref = flash_attention_bwd_plain(*args)
    fault = flash_attention_bwd_plain(*args, with_delta=False)
    torch.cuda.synchronize()
    for got, r, f, name in zip((q.grad, k.grad, v.grad), ref, fault, "qkv"):
        assert got.dtype == torch.bfloat16 and got.shape == r.shape
        assert _rel_err(got, r) <= ATTN_BWD_REL_BAR, name
        if name != "v":   # delta does not enter dv
            assert _rel_err(f, r) > ATTN_BWD_REL_BAR, name


@pytest.mark.parametrize("Sk", [700, 2100])      # single pass; the pair
@pytest.mark.parametrize("D", [16, 36, 80, 88, 96, 120, 128])
def test_flash_head_dims_match_plain(dev, D, Sk):
    """Every head dim up to 128: 80, 96 and 128 on their own instances, the
    others zero-padded to the next one by the launchers, with the caller's
    scale; one launch of each kernel as at 72. A scale recomputed from the
    padded head dim (a planted fault) lands above the forward's bar."""
    from topiaxl_torch.ops.flash_attention import kernel_head_dim

    q = _randn(dev, 1, 300, 3, 2, D, seed=51)[:, :, 0].requires_grad_()
    k, v = (t.requires_grad_() for t in _randn(
        dev, 1, Sk, 2, 2, D, seed=52).unbind(2))
    do = _randn(dev, 1, 300, 2, D, seed=53)
    scale = D ** -0.5
    before = dict(_cuda.launches)
    o = flash_attention(q, k, v, scale)
    lse = o.grad_fn.saved_tensors[4]
    o.backward(do)
    names = (["flash_attn_bwd"] if bwd_form(Sk) == "fused"
             else ["flash_attn_bwd_dq", "flash_attn_bwd_dkv"])
    for name in ("flash_attn_fwd", "flash_attn_bwd", "flash_attn_bwd_dq",
                 "flash_attn_bwd_dkv"):
        assert _cuda.launches[name] == before[name] + (
            name == "flash_attn_fwd" or name in names), name
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    o_ref, lse_ref = flash_attention_plain(qd, kd, vd, scale, return_lse=True)
    ref = flash_attention_bwd_plain(qd, kd, vd, o.detach(), lse, do, scale)
    torch.cuda.synchronize()
    assert o.shape == o_ref.shape and o.is_contiguous()
    assert _rel_err(o, o_ref) <= ATTN_REL_BAR
    assert (lse - lse_ref).abs().max().item() <= LSE_ABS_BAR
    for got, r, name in zip((q.grad, k.grad, v.grad), ref, "qkv"):
        assert got.shape == r.shape and got.dtype == torch.bfloat16
        assert _rel_err(got, r) <= ATTN_BWD_REL_BAR, name
    inst = kernel_head_dim(D)
    if inst != D:
        fault = flash_attention_plain(qd, kd, vd, inst ** -0.5)
        assert _rel_err(fault, o_ref) > ATTN_REL_BAR


@pytest.mark.parametrize("D", [36, 80, 128])
def test_ring_takes_every_head_dim(dev, D):
    """The ring's per-block forward and backward launches take the head
    dims the launchers take: P = 2 blocks of 1100 keys against one launch."""
    from topiaxl_torch.ops import flash_attention as fa
    from topiaxl_torch.ops.ring_attention import (LocalRing, ring_backward,
                                                  ring_forward)

    q, k, v, do = (_randn(dev, 1, 2200, 2, D, seed=60 + i) for i in range(4))
    scale = D ** -0.5
    o, lse = fa._forward(q, k, v, scale, return_lse=True)
    ref = flash_attention_backward(q, k, v, o, lse, do, scale)
    qs, ks, vs, dos = ([c.contiguous() for c in t.chunk(2, dim=1)]
                       for t in (q, k, v, do))
    outs, lses = ring_forward(LocalRing(2), qs, ks, vs, scale)
    grads = ring_backward(LocalRing(2), qs, ks, vs, outs, lses, dos, scale)
    torch.cuda.synchronize()
    assert _rel_err(torch.cat(outs, 1), o) <= ATTN_REL_BAR
    assert (torch.cat(lses, 2) - lse).abs().max().item() <= LSE_ABS_BAR
    for got, r in zip(grads, ref):
        assert _rel_err(torch.cat(got, 1), r) <= ATTN_BWD_REL_BAR


@pytest.mark.parametrize("P,N", [(2, 512), (4, 1024), (2, 4400)])
def test_ring_over_local_blocks_matches_one_launch(dev, P, N):
    """P blocks of N / P tokens (the last case 2200 keys a block, ragged:
    the two-pass pair): P * P forward and P * P backward launches."""
    from topiaxl_torch.ops import flash_attention as fa
    from topiaxl_torch.ops.ring_attention import (LocalRing, ring_backward,
                                                  ring_forward)

    q, k, v, do = (_randn(dev, 1, N, 2, 72, seed=40 + i) for i in range(4))
    scale = 72 ** -0.5
    o, lse = fa._forward(q, k, v, scale, return_lse=True)
    ref = flash_attention_backward(q, k, v, o, lse, do, scale)
    qs, ks, vs, dos = ([c.contiguous() for c in t.chunk(P, dim=1)]
                       for t in (q, k, v, do))
    ring = LocalRing(P)
    before = dict(_cuda.launches)
    outs, lses = ring_forward(ring, qs, ks, vs, scale)
    grads = ring_backward(ring, qs, ks, vs, outs, lses, dos, scale)
    torch.cuda.synchronize()
    names = (["flash_attn_bwd"] if bwd_form(N // P) == "fused"
             else ["flash_attn_bwd_dq", "flash_attn_bwd_dkv"])
    assert _cuda.launches["flash_attn_fwd"] == before["flash_attn_fwd"] + P * P
    for name in names:
        assert _cuda.launches[name] == before[name] + P * P
    assert _rel_err(torch.cat(outs, 1), o) <= ATTN_REL_BAR
    assert (torch.cat(lses, 2) - lse).abs().max().item() <= LSE_ABS_BAR
    for got, r in zip(grads, ref):
        assert _rel_err(torch.cat(got, 1), r) <= ATTN_BWD_REL_BAR
    fault = torch.zeros_like(q, dtype=torch.float32)
    for i in range(P):
        for j in range(P):
            o_b, l_b = fa._forward(qs[i], ks[j], vs[j], scale, True)
            fault[:, i * (N // P):(i + 1) * (N // P)] += flash_attention_backward(
                qs[i], ks[j], vs[j], o_b, l_b, dos[i], scale)[0].float()
    assert _rel_err(fault, ref[0]) > ATTN_BWD_REL_BAR


def test_two_pass_backward_repeats_bit_for_bit(dev):
    """The pair writes each gradient once, with no atomics: two launches
    of each pass on the same inputs give bitwise-equal dq, dk and dv."""
    B, Sq, Sk, H, D, scale = 2, 300, 2300, 3, 72, 72 ** -0.5
    q = _randn(dev, B, Sq, 3, H, D, seed=34)[:, :, 0]
    k, v = _randn(dev, B, Sk, 2, H, D, seed=35).unbind(2)
    do = _randn(dev, B, Sq, H, D, seed=36)
    o = flash_attention(q.requires_grad_(), k, v, scale)
    lse = o.grad_fn.saved_tensors[4]
    args = (q.detach(), k, v, o.detach(), lse, do, scale)
    assert bwd_form(Sk) == "two_pass"
    before = dict(_cuda.launches)
    first = flash_attention_backward(*args)
    second = flash_attention_backward(*args)
    torch.cuda.synchronize()
    assert _cuda.launches["flash_attn_bwd_dq"] == before["flash_attn_bwd_dq"] + 2
    assert (_cuda.launches["flash_attn_bwd_dkv"]
            == before["flash_attn_bwd_dkv"] + 2)
    assert _cuda.launches["flash_attn_bwd"] == before["flash_attn_bwd"]
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    ref = flash_attention_bwd_plain(*args)
    for a, r in zip(first, ref):
        assert _rel_err(a, r) <= ATTN_BWD_REL_BAR


@pytest.mark.parametrize("Sq,Sk", [(65, 63), (100, 1370), (70, 2100)])
def test_flash_backward_masks_ragged_keys(dev, Sq, Sk):
    """Every real logit is well below 0, so zero-padded keys left unmasked
    would take most of the softmax mass and shrink every gradient, dv
    included: the single pass and the two-pass pair must mask them (and
    the ragged q rows)."""
    assert Sk % KEY_TILE and Sq % 64
    q = _randn(dev, 1, Sq, 2, 72, seed=30).abs().requires_grad_()
    k = (-_randn(dev, 1, Sk, 2, 72, seed=31).abs()).requires_grad_()
    v = _randn(dev, 1, Sk, 2, 72, seed=32).requires_grad_()
    do = _randn(dev, 1, Sq, 2, 72, seed=33)
    scale = 72 ** -0.5
    o = flash_attention(q, k, v, scale)
    lse = o.grad_fn.saved_tensors[4]
    o.backward(do)
    args = (q.detach(), k.detach(), v.detach(), o.detach(), lse, do, scale)
    ref = flash_attention_bwd_plain(*args)
    fault = flash_attention_bwd_unmasked(*args[:3], do, scale)
    torch.cuda.synchronize()
    for got, r, f, name in zip((q.grad, k.grad, v.grad), ref, fault, "qkv"):
        assert _rel_err(got, r) <= ATTN_BWD_REL_BAR, name
        assert _rel_err(f, r) > ATTN_BWD_REL_BAR, name


@pytest.mark.parametrize("Sq,Sk,D", [(65, 63, 72), (100, 1370, 72),
                                    (64, 2100, 72), (130, 1374, 64)])
def test_flash_forward_lse_matches_plain(dev, Sq, Sk, D):
    q = _randn(dev, 2, Sq, 3, D, seed=14)
    k, v = _randn(dev, 2, Sk, 2, 3, D, seed=15).unbind(2)
    o = flash_attention(q.requires_grad_(), k, v, D ** -0.5)
    lse = o.grad_fn.saved_tensors[4]
    _, ref = flash_attention_plain(q.detach(), k, v, D ** -0.5,
                                   return_lse=True)
    torch.cuda.synchronize()
    assert lse.shape == (2, 3, Sq) and lse.dtype == torch.float32
    assert (lse - ref).abs().max().item() <= LSE_ABS_BAR


def test_flash_backward_direct_call(dev):
    """flash_attention_backward on its own, with o and lse from the
    kernel, agrees with the autograd path's gradients."""
    q, k, v = _randn(dev, 1, 96, 3, 2, 72, seed=16).unbind(2)
    do = _randn(dev, 1, 96, 2, 72, seed=17)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    o = flash_attention(qr, kr, vr, 0.1)
    lse = o.grad_fn.saved_tensors[4]
    o.backward(do)
    got = flash_attention_backward(q, k, v, o.detach(), lse, do, 0.1)
    for a, b in zip(got, (qr.grad, kr.grad, vr.grad)):
        assert _rel_err(a, b) <= ATTN_BWD_REL_BAR


def test_flash_backward_refuses_what_it_cannot_run(dev):
    q, k, v = _randn(dev, 1, 64, 3, 2, 72, seed=18).unbind(2)
    o, do = _randn(dev, 1, 64, 2, 72, seed=19), _randn(dev, 1, 64, 2, 72)
    lse = torch.zeros(1, 2, 64, device=dev)
    before = dict(_cuda.launches)
    for bad_lse in (lse.cpu(), lse.double(), lse[:, :, :32],
                    lse.transpose(1, 2).contiguous().transpose(1, 2)):
        with pytest.raises(ValueError, match="lse"):
            flash_attention_backward(q, k, v, o, bad_lse, do, 0.1)
    with pytest.raises(ValueError, match="do"):
        flash_attention_backward(q, k, v, o, lse, do.float(), 0.1)
    assert _cuda.launches == before


def test_flash_refuses_what_it_cannot_run(dev):
    q = _randn(dev, 1, 8, 2, 72)
    with pytest.raises(TypeError):
        flash_attention(q.float(), q.float(), q.float(), 0.1)
    w = _randn(dev, 1, 8, 2, 136)    # above the widest instance, 128
    with pytest.raises(ValueError, match="head_dim 136"):
        flash_attention(w, w, w, 0.1)
    odd = _randn(dev, 1, 8, 2, 76)[..., :72]     # strides not multiples of 8
    with pytest.raises(ValueError, match="strides"):
        flash_attention(odd, odd, odd, 0.1)


def test_flash_refuses_what_tma_cannot_load(dev):
    """The TMA loads of the forward and of the single-pass backward need
    16-byte-aligned bases and strides that are multiples of 16 bytes:
    both kernels refuse other views before launching."""
    base = _randn(dev, 2 * 8 * 2 * 72 + 8).flatten()
    shifted = torch.as_strided(base, (1, 8, 2, 72), (8 * 2 * 72, 2 * 72, 72, 1),
                               storage_offset=1)     # 2-byte-aligned base
    good = _randn(dev, 1, 8, 2, 72)
    odd = _randn(dev, 1, 8, 2, 76)[..., :72]
    lse = torch.zeros(1, 2, 8, device=dev)
    before = dict(_cuda.launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(shifted, good, good, 0.1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(good, good, shifted, 0.1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_backward(good, good, good, good, lse, shifted, 0.1)
    with pytest.raises(ValueError, match="strides"):
        flash_attention_backward(good, good, good, odd, lse, good, 0.1)
    assert _cuda.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("m,k,n,iters", [(128, 64, 128, 7), (256, 1024, 256, 5),
                                         (128, 400, 384, 2)])
def test_mma_rate_loop_matches_plain(dev, dtype, m, k, n, iters):
    """int8 exact; bf16 within 1e-3 of max|plain| (f32 sums in another
    order: the kernel stages 256 bytes of K at a time). The plain version
    with every coefficient +1 lands far above."""
    if dtype == torch.int8:
        g = torch.Generator(dev).manual_seed(40)
        a = torch.randint(-127, 127, (m, k), generator=g, device=dev,
                          dtype=torch.int8)
        b = torch.randint(-127, 127, (k, n), generator=g, device=dev,
                          dtype=torch.int8)
    else:
        a, b = _randn(dev, m, k, seed=41), _randn(dev, k, n, seed=42)
    before = _cuda.launches["mma_rate_loop"]
    got = mbi.mma_rate_loop(a, b, iters)
    assert _cuda.launches["mma_rate_loop"] == before + 1
    ref = mbi.mma_rate_loop_plain(a, b, iters)
    fault = mbi.mma_rate_loop_plain(a, b, iters, coef=lambda i: 1)
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if dtype == torch.int8:
        assert torch.equal(got, ref)
    else:
        assert _rel_err(got, ref) <= PROBE_REL_BAR
    assert _rel_err(fault.double(), ref.double()) > PROBE_REL_BAR


@pytest.mark.parametrize("form", [
    ((128, 128), (256, 128), (1, 1)),   # q k^T, both K-major
    ((80, 128), (80, 256), (0, 0)),     # contraction on rows, both MN-major
    ((128, 384), (384, 256), (1, 0)),   # standard: B MN-major, three chunks
    ((80, 256), (128, 256), (1, 1)),    # 80-row output: computed transposed
    ((128, 72), (256, 72), (1, 1)),     # contraction 72 padded to 80
    ((72, 128), (72, 256), (0, 0)),
    ((128, 256), (256, 72), (1, 0)),    # n72 output
    ((72, 256), (128, 256), (1, 1)),    # 72-row output: n72, transposed
])
def test_dot_forms_match_plain(dev, form):
    a_shape, b_shape, dn = form
    a, b = _randn(dev, *a_shape, seed=43), _randn(dev, *b_shape, seed=44)
    before = dict(_cuda.launches)
    chain = edf.dot_form_chain(a, b, dn, 5)
    accum = edf.dot_form_accum(a, b, dn, 3)
    assert _cuda.launches["dot_form_chain"] == before["dot_form_chain"] + 1
    assert _cuda.launches["dot_form_accum"] == before["dot_form_accum"] + 1
    ref_chain = edf.dot_form_chain_plain(a, b, dn, 5)
    ref_accum = edf.dot_form_accum_plain(a, b, dn, 3)
    fewer = edf.dot_form_accum_plain(a, b, dn, 2)
    torch.cuda.synchronize()
    assert chain.shape == ref_chain.shape and chain.dtype == torch.float32
    assert _rel_err(chain, ref_chain) <= PROBE_REL_BAR
    assert _rel_err(accum, ref_accum) <= PROBE_REL_BAR
    assert _rel_err(fewer, ref_accum) > PROBE_REL_BAR


def test_dot_form_pad_is_zero(dev):
    """A contraction of 72 pads to 80 with zeros: the plain product with
    ones in the pad lands far above the bar."""
    a, b = _randn(dev, 128, 72, seed=45), _randn(dev, 256, 72, seed=46)
    got = edf.dot_form_accum(a, b, (1, 1), 2)
    ref = edf.dot_form_accum_plain(a, b, (1, 1), 2)
    ones = torch.ones(128, 8, device=dev, dtype=torch.bfloat16)
    padded = edf.dot_form_accum_plain(
        torch.cat([a, ones], 1), torch.cat([b, ones[:1].expand(256, 8)], 1),
        (1, 1), 2)
    torch.cuda.synchronize()
    assert _rel_err(got, ref) <= PROBE_REL_BAR
    assert _rel_err(padded, ref) > PROBE_REL_BAR


def test_probe_refuses_what_it_cannot_run(dev):
    a = _randn(dev, 100, 64)
    before = dict(_cuda.launches)
    with pytest.raises(ValueError, match="multiple of 128"):
        mbi.mma_rate_loop(a, _randn(dev, 64, 128), 2)
    with pytest.raises(ValueError, match="bf16 or int8"):
        mbi.mma_rate_loop(a.float()[:0], a.float()[:0], 2)
    with pytest.raises(ValueError, match="N=96"):
        edf.dot_form_chain(_randn(dev, 128, 64), _randn(dev, 96, 64), (1, 1), 2)
    assert _cuda.launches == before


def _int8(dev, *shape, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    return torch.randint(-127, 127, shape, generator=g, device=dev,
                         dtype=torch.int8)


# (what, m, k, n, iters, splits) for the rate loop: S blocks share each
# output tile, over the contraction's chunks first, then the product index
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("m,k,n,iters,splits", [
    (128, 1024, 128, 7, 3),     # odd product count, splits across chunks
    (256, 1024, 128, 10, 8),    # splits inside chunks too
    (128, 400, 256, 5, 4),      # a K tail shorter than a chunk
    (128, 64, 128, 2, 11),      # fewer products than splits: empty blocks
])
def test_rate_loop_splits_match_plain(dev, dtype, m, k, n, iters, splits,
                                      monkeypatch):
    """(No product count is a multiple of 3: the coefficients would cancel.)"""
    monkeypatch.setattr(benchmarks, "pick_splits", lambda *_: splits)
    if dtype == torch.int8:
        a, b = _int8(dev, m, k, seed=47), _int8(dev, k, n, seed=48)
    else:
        a, b = _randn(dev, m, k, seed=47), _randn(dev, k, n, seed=48)
    before = _cuda.launches["mma_rate_loop"]
    got = mbi.mma_rate_loop(a, b, iters)
    assert _cuda.launches["mma_rate_loop"] == before + 1
    assert benchmarks.plans["mma_rate_loop"]["splits"] == splits
    ref = mbi.mma_rate_loop_plain(a, b, iters)
    fault = mbi.mma_rate_loop_plain(a, b, iters, coef=lambda i: 1)
    torch.cuda.synchronize()
    if dtype == torch.int8:
        assert torch.equal(got, ref)
    else:
        assert _rel_err(got, ref) <= PROBE_REL_BAR
    assert _rel_err(fault.double(), ref.double()) > PROBE_REL_BAR


@pytest.mark.parametrize("form,iters,splits", [
    (((128, 384), (384, 256), (1, 0)), 9, 5),   # n128, B MN-major
    (((80, 256), (128, 256), (1, 1)), 7, 6),    # n80, stored transposed
    (((72, 256), (128, 256), (1, 1)), 5, 3),    # n72, stored transposed
    (((128, 256), (256, 72), (1, 0)), 6, 4),    # n72
    (((72, 128), (72, 256), (0, 0)), 3, 2),     # contraction 72, A MN-major
])
def test_dot_form_splits_match_plain(dev, form, iters, splits, monkeypatch):
    monkeypatch.setattr(benchmarks, "pick_splits", lambda *_: splits)
    a_shape, b_shape, dn = form
    a, b = _randn(dev, *a_shape, seed=49), _randn(dev, *b_shape, seed=50)
    before = dict(_cuda.launches)
    chain = edf.dot_form_chain(a, b, dn, iters)
    accum = edf.dot_form_accum(a, b, dn, iters)
    assert _cuda.launches["dot_form_chain"] == before["dot_form_chain"] + 1
    assert _cuda.launches["dot_form_accum"] == before["dot_form_accum"] + 1
    assert benchmarks.plans["dot_form_accum"]["splits"] == splits
    ref_chain = edf.dot_form_chain_plain(a, b, dn, iters)
    ref = edf.dot_form_accum_plain(a, b, dn, iters)
    fewer = edf.dot_form_accum_plain(a, b, dn, iters - 1)
    torch.cuda.synchronize()
    assert accum.shape == ref.shape and accum.dtype == torch.float32
    assert _rel_err(chain, ref_chain) <= PROBE_REL_BAR
    assert _rel_err(accum, ref) <= PROBE_REL_BAR
    assert _rel_err(fewer, ref) > PROBE_REL_BAR


def test_probe_splits_repeat_bit_for_bit(dev):
    """The partial sums are reduced in slice order: two launches give the
    same bits, for the dot forms and the rate loop."""
    a, b = _randn(dev, 512, 2048, seed=51), _randn(dev, 2048, 72, seed=52)
    first = edf.dot_form_accum(a, b, (1, 0), 40)
    assert benchmarks.plans["dot_form_accum"]["splits"] > 1
    assert torch.equal(first, edf.dot_form_accum(a, b, (1, 0), 40))
    a, b = _randn(dev, 128, 1024, seed=53), _randn(dev, 1024, 128, seed=54)
    first = mbi.mma_rate_loop(a, b, 64)
    assert benchmarks.plans["mma_rate_loop"]["splits"] > 1
    assert torch.equal(first, mbi.mma_rate_loop(a, b, 64))


def test_probe_default_splits_fill_the_card(dev):
    """A 4-tile form runs on most of the card's block slots; the rate loop
    at M = 4224 (264 tiles, two per SM) keeps one block a tile."""
    a, b = _randn(dev, 512, 2048, seed=55), _randn(dev, 2048, 128, seed=56)
    edf.dot_form_accum(a, b, (1, 0), edf.G_LO)
    plan = benchmarks.plans["dot_form_accum"]
    assert plan["tiles"] == 4 and plan["blocks"] >= 0.9 * plan["slots"]
    a, b = mbi.operands(mbi.M_FULL, torch.int8, dev)
    mbi.mma_rate_loop(a, b, 4)
    assert benchmarks.plans["mma_rate_loop"]["splits"] == 1


@pytest.mark.parametrize("B,N,D", [(2, 2048, 1152), (3, 37, 8), (1, 5, 200),
                                   (2, 9, 4096)])
def test_ln_kernels_match_plain(dev, B, N, D):
    x, delta = _randn(dev, B, N, D, seed=3), _randn(dev, B, N, D, seed=4)
    mods = _randn(dev, B, 5 * D, seed=5) * 0.5       # strided row views
    sh, sc, gate = mods[:, :D], mods[:, 2 * D:3 * D], mods[:, 4 * D:]
    before = dict(_cuda.launches)
    h = ln_modulate(x, sh, sc)
    xn, h2 = ln_modulate_residual(x, delta, gate, sh, sc)
    assert _cuda.launches["ln_modulate"] == before["ln_modulate"] + 1
    assert (_cuda.launches["ln_modulate_residual"]
            == before["ln_modulate_residual"] + 1)
    xr, h2r = ln_modulate_residual_plain(x, delta, gate, sh, sc)
    for got, ref in ((h, ln_modulate_plain(x, sh, sc)), (xn, xr), (h2, h2r)):
        assert got.dtype == torch.bfloat16
        assert _ulp_excess(got, ref) <= 1e-5


def test_ln_refuses_what_it_cannot_run(dev):
    x = _randn(dev, 2, 16, 64)
    m = _randn(dev, 2, 64)
    with pytest.raises(ValueError, match="bf16"):
        ln_modulate(x.float(), m, m)
    with pytest.raises(ValueError, match="kernel writes"):
        ln_modulate(x, m, m, out_dtype=torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ln_modulate(x.transpose(0, 1), m, m)
    with pytest.raises(ValueError, match="multiple of 8"):
        ln_modulate(_randn(dev, 2, 16, 60), m[:, :60], m[:, :60])
    big = _randn(dev, 1, 2, 4104)
    with pytest.raises(ValueError, match="multiple of 8"):
        ln_modulate(big, big[:, 0], big[:, 1])
