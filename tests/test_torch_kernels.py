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
P and dS on both sides; dq summed by atomics in the single pass), and
the plain backward without delta (dq, dk) and the pair with padded keys
unmasked (dq, dk, dv) must land above that bar. The forward's
lse within 1e-4 of the plain logsumexp. LN
outputs within one bf16 ulp of the plain f32 chain plus 1e-5 for the
f32 summation order.
"""

import pytest
import torch

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


@pytest.mark.parametrize("Sq,Sk", [(65, 63), (100, 1370), (64, 2100)])
def test_flash_forward_lse_matches_plain(dev, Sq, Sk):
    q = _randn(dev, 2, Sq, 3, 72, seed=14)
    k, v = _randn(dev, 2, Sk, 2, 3, 72, seed=15).unbind(2)
    o = flash_attention(q.requires_grad_(), k, v, 72 ** -0.5)
    lse = o.grad_fn.saved_tensors[4]
    _, ref = flash_attention_plain(q.detach(), k, v, 72 ** -0.5,
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
    w = _randn(dev, 1, 8, 2, 80)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(w, w, w, 0.1)
    odd = _randn(dev, 1, 8, 2, 76)[..., :72]     # strides not multiples of 8
    with pytest.raises(ValueError, match="strides"):
        flash_attention(odd, odd, odd, 0.1)


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
