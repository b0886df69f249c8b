"""The yardstick's counts against ``torch.utils.flop_counter`` on the plain
reference at tiny sizes."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts
from portbench.reference import dit as rdit
from portbench.reference import ops

DEPTH, D, HEADS, N, M, C = 2, 64, 4, 48, 16, 32


@pytest.fixture(autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _weights(seed: int = 0) -> dict:
    """A tiny DiT's weights under its checkpoint names."""
    g = torch.Generator().manual_seed(seed)
    P = {"x_embedder.weight": (D, 68), "x_embedder.bias": (D,),
         "t_embedder.mlp.0.weight": (D, 256), "t_embedder.mlp.0.bias": (D,),
         "t_embedder.mlp.2.weight": (D, D), "t_embedder.mlp.2.bias": (D,),
         "final_layer.adaLN_modulation.1.weight": (2 * D, D),
         "final_layer.adaLN_modulation.1.bias": (2 * D,),
         "final_layer.linear.weight": (136, D),
         "final_layer.linear.bias": (136,), "null_cond_embedding": (C,)}
    for i in range(DEPTH):
        p = f"blocks.{i}."
        P.update({p + "adaLN_modulation.1.weight": (9 * D, D),
                  p + "adaLN_modulation.1.bias": (9 * D,),
                  p + "crossattn.to_q.weight": (D, D), p + "crossattn.to_q.bias": (D,),
                  p + "crossattn.to_k.weight": (D, C), p + "crossattn.to_k.bias": (D,),
                  p + "crossattn.to_v.weight": (D, C), p + "crossattn.to_v.bias": (D,),
                  p + "crossattn.proj.weight": (D, D), p + "crossattn.proj.bias": (D,),
                  p + "attn.qkv.weight": (3 * D, D), p + "attn.qkv.bias": (3 * D,),
                  p + "attn.proj.weight": (D, D), p + "attn.proj.bias": (D,),
                  p + "mlp.fc1.weight": (4 * D, D), p + "mlp.fc1.bias": (4 * D,),
                  p + "mlp.fc2.weight": (D, 4 * D), p + "mlp.fc2.bias": (D,)})
    return {k: torch.randn(s, generator=g) * 0.1 for k, s in P.items()}


def test_cfg_step_flops_count_the_reference_step():
    """The copied count (both halves through the cross-attention) equals
    the products of the reference's CFG step; the served step leaves out
    the null half's cross-attention."""
    P, g = _weights(), torch.Generator().manual_seed(1)
    x, y = torch.randn((1, N, 68), generator=g), torch.randn((1, M, C), generator=g)
    with FlopCounterMode(display=False) as fc:
        rdit.cfg_forward(P, x, torch.full((1,), 500), y, HEADS, 6.0)
    kv = 2 * DEPTH * 2 * 2 * M * C * D      # both halves' K/V projections
    full = counts.cfg_step_flops(DEPTH, D, HEADS, N, M, cfg_fast=False)
    assert fc.get_total_flops() == pytest.approx(full + kv, rel=1e-9)
    fast = counts.cfg_step_flops(DEPTH, D, HEADS, N, M)
    assert full - fast == DEPTH * (2 * N * D * D * 2 + 4 * N * M * D)


def test_cfg_step_flops_at_the_flagship():
    assert counts.cfg_step_flops(28, 1152, 16, 2048, 1370) == pytest.approx(
        5.40e12, rel=5e-3)


def test_train_step_flops_count_the_reference_forward_and_backward():
    """The forward's count equals the reference's products; forward and
    backward together are three forwards but for the products no gradient
    needs (the inputs' own gradients: tokens, timesteps, conditioning)."""
    P, g = _weights(), torch.Generator().manual_seed(2)
    B = 2
    x, y = torch.randn((B, N, 68), generator=g), torch.randn((B, M, C), generator=g)
    t = torch.tensor([10, 900])
    params = {k: v.clone().requires_grad_() for k, v in P.items()}
    with FlopCounterMode(display=False) as fwd:
        out = rdit.forward(params, x, t, y, HEADS)
    assert fwd.get_total_flops() == pytest.approx(
        counts.dit_forward_flops(B, DEPTH, D, N, M, C), rel=1e-9)
    with FlopCounterMode(display=False) as both:
        rdit.forward(params, x, t, y, HEADS).square().mean().backward()
    no_input_grad = 2 * B * (N * 68 * D + 256 * D + DEPTH * 2 * M * C * D)
    assert both.get_total_flops() == pytest.approx(
        counts.train_step_flops(B, DEPTH, D, N, M, C) - no_input_grad, rel=1e-9)
    del out


@pytest.mark.parametrize("shape", [(2, 40, 24, 4, 16), (1, 33, 65, 2, 72)])
def test_attention_counts_match_the_reference_attention(shape):
    B, Sq, Sk, H, Dh = shape
    g = torch.Generator().manual_seed(3)
    q = torch.randn((B, Sq, H, Dh), generator=g, requires_grad=True)
    k = torch.randn((B, Sk, H, Dh), generator=g, requires_grad=True)
    v = torch.randn((B, Sk, H, Dh), generator=g, requires_grad=True)
    with FlopCounterMode(display=False) as fwd:
        o = ops.attention(q, k, v, Dh ** -0.5)
    assert fwd.get_total_flops() == counts.attention_fwd(*shape)[0]
    with FlopCounterMode(display=False) as bwd:
        o.backward(torch.ones_like(o))
    assert bwd.get_total_flops() == counts.attention_bwd(*shape)[0]


def test_attention_bytes_read_and_write_each_tensor_once():
    B, Sq, Sk, H, Dh = 2, 2048, 1370, 16, 72
    elems = B * H * Dh
    assert counts.attention_fwd(B, Sq, Sk, H, Dh)[1] == \
        2 * elems * (2 * Sq + 2 * Sk) + 4 * B * H * Sq
    assert counts.attention_bwd(B, Sq, Sk, H, Dh)[1] == \
        2 * elems * (4 * Sq + 4 * Sk) + 4 * B * H * Sq


def test_least_seconds_take_the_larger_bound():
    card = "NVIDIA H100 80GB HBM3"
    assert counts.least_seconds(989.4e12, 1.0, card) == pytest.approx(1.0)
    assert counts.least_seconds(1.0, 3.35e12, card) == pytest.approx(1.0)


def test_a_card_without_a_peak_fails():
    with pytest.raises(ValueError, match="no bf16 peak"):
        counts.peaks("NVIDIA A100-SXM4-80GB")
