"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These need a CUDA card (the kernels have no CPU mode) and skip
without one. The file imports no JAX, so it also runs where only the
port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

Bars: attention within 1e-2 of the plain f32-softmax version, relative
to max|out| (bf16 output, P rounded to bf16 on both sides); a planted
fault, the plain version with the kernel's zero-padded keys unmasked,
must land above that bar on inputs built to expose it. LN
outputs within one bf16 ulp of the plain f32 chain plus 1e-5 for the
f32 summation order.
"""

import pytest
import torch

from topiaxl_torch.ops import _cuda
from topiaxl_torch.ops.flash_attention import (
    KEY_TILE,
    flash_attention,
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
