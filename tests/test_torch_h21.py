"""Hunyuan3D-2.1's shape DiT in the port (``models/hunyuandit.py``,
``models/moe.py``) against the benchmark's plain reference
(``portbench/reference/hunyuandit.py``) and hand-written formulas, on the
CPU at a small size (hidden 128, 2 heads of 64, 5 blocks: 2, the middle, 2
skip blocks of which the last 2 are MoE with 4 experts, 40 latent tokens
and the time token, 23 conditioning tokens) on seeded random weights; the
kernels at the published widths, the grouped expert products and one MoE
block on the card (marked ``cuda``; skip without a card). The file imports
no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_h21.py

Tolerances, each for a reason:

- f32 on both sides on the CPU: the port runs its plain twins in f32, the
  reference its own f32 chain; they sum in other orders (the joined
  projections, the LN's variance, the grouped products against the
  reference's masked loop): outputs and the loss within 2e-5 relative,
  each gradient within 1e-4 of its leaf's largest entry (the backward
  doubles the depth).
- the same arithmetic grouped otherwise (the dispatch against a loop, the
  grouped product's gradients against autograd, the auxiliary gradient
  against autograd of the formula): 1e-5 of the largest entry.
- two AdamW steps: each leaf's change within 1e-3 of its norm (as the
  other trainers' tests: Adam carries an element's f32 round-off into a
  step of up to a few percent of the rate).
- on the card, bf16 against f32: the QK norm within one bf16 rounding of
  its output (2^-8), dx within 2^-7 of its largest entry; flash within the
  chip_smoke bars (``ATTN_REL_BAR``, ``ATTN_BWD_REL_BAR``); the LN kernels
  within its bar of one bf16 ulp (``LN_ABS_SLACK``); the grouped
  products within 2^-7 of the largest entry (bf16 operands, f32 sums in
  another order, one rounding).
"""

from __future__ import annotations

import math

import pytest
import torch
import torch.nn.functional as F

from portbench.reference import hunyuandit as rh
from portbench.reference import ops
from portbench.reference import train as rtrain
from topiaxl_torch.diffusion.flow import RectifiedFlow
from topiaxl_torch.models import hunyuandit as H
from topiaxl_torch.models import moe as MOE

TINY = dict(input_size=40, in_channels=64, hidden_size=128, context_dim=48,
            depth=5, num_heads=2, num_moe_layers=2, num_experts=4)
M = 23                     # conditioning tokens
HEADS = TINY["num_heads"]
FLOW = RectifiedFlow(sigma_min=0.0, t_mean=0.0, t_std=1.0)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _counter():
    MOE.reset_expert_tokens()
    yield
    MOE.reset_expert_tokens()


def _fill_(module, seed: int) -> None:
    """Every parameter drawn from ``seed``: gains around one, biases small,
    matrices at unit fan-in variance."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            r = torch.randn(p.shape, generator=g)
            gain = name.endswith(("norm.scale", "norm1.weight", "norm2.weight",
                                  "norm3.weight", "skip_norm.weight",
                                  "norm_final.weight"))
            if gain:
                r = 1.0 + 0.1 * r
            elif p.dim() >= 2:
                r = r / math.sqrt(p.shape[-1])
            else:
                r = 0.1 * r
            p.copy_(r.to(p.device))


def _model(seed: int = 0, dtype=torch.float32, device=None, **kw):
    m = H.HunYuanDiTPlain(**dict(TINY, **kw), dtype=dtype,
                          param_dtype=torch.float32, device=device)
    _fill_(m, seed)
    return m


def _release(model) -> dict:
    """The model's weights under the release's names, written out here
    (not through ``to_h21``): each expert's tensors its own."""
    out = {}
    for k, v in model.state_dict().items():
        v = v.detach().float().cpu().clone()
        head, _, last = k.rpartition(".")
        parts = {"fc1_weight": "net.0.proj.weight", "fc1_bias": "net.0.proj.bias",
                 "fc2_weight": "net.2.weight", "fc2_bias": "net.2.bias"}
        if last in parts:
            for e in range(v.shape[0]):
                out[f"{head}.experts.{e}.{parts[last]}"] = v[e].clone()
            continue
        k = (k.replace("q_norm.scale", "q_norm.weight")
             .replace("k_norm.scale", "k_norm.weight")
             .replace("moe.shared.fc1.", "moe.shared_experts.net.0.proj.")
             .replace("moe.shared.fc2.", "moe.shared_experts.net.2."))
        out[k] = v
    return out


def _inputs(seed: int = 1, B: int = 2):
    g = torch.Generator().manual_seed(seed)
    N, C = TINY["input_size"], TINY["in_channels"]
    return {"x": torch.randn((B, N, C), generator=g),
            "y": torch.randn((B, M, TINY["context_dim"]), generator=g),
            "t": torch.tensor([0.3, 0.85])[:B],
            "drop": torch.tensor([False, True])[:B],
            "noise": torch.randn((B, N, C), generator=g)}


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _max_rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def test_the_cut_model_keeps_the_published_layout():
    """depth 13 with 4 MoE layers: skip blocks 7-12, the middle 6, MoE in
    9-12; depth 21 with 6: skip blocks 11-20, MoE in 15-20. The counter
    names its layers by block."""
    for depth, moe, skips, moes in ((13, 4, range(7, 13), range(9, 13)),
                                    (21, 6, range(11, 21), range(15, 21))):
        m = H.HunYuanDiTPlain(depth=depth, num_moe_layers=moe, hidden_size=64,
                              num_heads=1, context_dim=16, input_size=8)
        assert [i for i, b in enumerate(m.blocks)
                if b.skip_linear is not None] == list(skips)
        assert [i for i, b in enumerate(m.blocks) if hasattr(b, "moe")] == \
            list(moes)
        assert [b.moe.counter for b in m.blocks if hasattr(b, "moe")] == \
            [f"blocks.{i}.moe" for i in moes]


def test_forward_and_loss_match_the_reference():
    m = _model()
    P = _release(m)
    b = _inputs()
    with torch.no_grad():
        got = m(b["x"], b["t"] * 1000, b["y"], b["drop"])
        y = torch.where(b["drop"][:, None, None], 0.0, b["y"])
        want = rh.forward(P, b["x"], b["t"] * 1000, y, HEADS)
        assert got.shape == b["x"].shape
        assert _max_rel(got, want) < 1e-4 and _rel(got, want) < 2e-5
        loss = FLOW.training_losses(
            lambda x_t, t: m(x_t, t, b["y"], b["drop"]), b["x"], b["t"],
            b["noise"])
        ref = rh.training_loss(P, b["x"], b["y"], b["t"], b["noise"],
                               b["drop"], HEADS)
    assert _rel(loss["loss_total"], ref) < 2e-5


def test_the_head_split_follows_the_release():
    """The release views cat[q, k, v] as [B, N, H, 3D]: with two heads, head
    1's q is channels 192..255 of the joined projections, which are k's
    64..127; the plain split (q's channels 64..127) gives another
    output."""
    m = _model()
    P = _release(m)
    x = torch.randn((1, 9, 128), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = m.blocks[0].attn1(x)
        want = rh.attention(P, "blocks.0.attn1.", x, HEADS)
        q, k, v = (rh._lin(P, f"blocks.0.attn1.{n}", x).view(1, 9, 2, 64)
                   for n in ("to_q", "to_k", "to_v"))
        other = rh._lin(P, "blocks.0.attn1.out_proj", ops.attention(
            rh.qk_norm(P, "blocks.0.attn1.q_norm", q),
            rh.qk_norm(P, "blocks.0.attn1.k_norm", k), v,
            64 ** -0.5).reshape(1, 9, 128))
    assert _max_rel(got, want) < 1e-5
    assert _max_rel(other, want) > 0.1


def test_every_gradient_matches_the_reference():
    """Loss and every leaf's gradient, the gates' (which the auxiliary
    loss reaches) included, against the reference's one-sample-at-a-time
    gradient with the batch's routing shares."""
    m = _model().train()
    P = _release(m)
    b = _inputs()
    loss = FLOW.training_losses(
        lambda x_t, t: m(x_t, t, b["y"], b["drop"]), b["x"], b["t"],
        b["noise"])["loss_total"].mean()
    loss.backward()
    total, grads = rh.gradient(P, b, HEADS)
    assert abs(total - float(loss.detach())) < 2e-5 * abs(total)
    ref = H.from_h21(grads)
    got = {k: p.grad for k, p in m.named_parameters()}
    assert set(got) == set(ref)
    for k, g in got.items():
        scale = float(ref[k].abs().max())
        assert scale > 0, k
        assert float((g - ref[k]).abs().max()) < 1e-4 * scale, k


def test_two_train_steps_match_the_reference_trainer():
    """``make_train_step`` with the flow objective at sigma_min 0, AdamW
    at a constant rate and clip 1, against the reference's gradient and
    AdamW, on the same batches (t, drop and noise given)."""
    from topiaxl_torch.pipelines import train as T

    m = _model().train()
    P = _release(m)
    P0 = {k: v.clone() for k, v in P.items()}
    p0 = {k: v.detach().clone() for k, v in m.named_parameters()}
    lr = 1e-4
    state = T.create_train_state(m)
    step = T.make_train_step(m, FLOW, T.make_optimizer(
        lr=lr, grad_clip=1.0, schedule="constant"))
    adam = rtrain.AdamW(lr, 0, 2 ** 62, clip=1.0)
    for s in range(2):
        b = _inputs(seed=10 + s)
        metrics = step(state, b, 0)
        loss, grads = rh.gradient(P, b, HEADS)
        adam.step(P, grads)
        assert abs(float(metrics["loss"]) - loss) < 2e-5 * loss
    ref = H.from_h21({k: P[k] - P0[k] for k in P})
    for k, p in m.named_parameters():
        moved = p.detach() - p0[k]
        assert _rel(moved, ref[k]) < 1e-3, k
        assert float(moved.abs().max()) > 0.5 * lr, k
    assert state.step == 2 and state.opt_state.count == 2


def _layer(seed: int = 5, experts: int = 4, aux: bool = True):
    """A small layer in training (with its auxiliary loss) or, ``aux``
    False, in eval mode, where the release's gate adds none."""
    layer = MOE.MoEFFN(32, 48, experts, 2, dtype=torch.float32,
                       param_dtype=torch.float32).to_empty(device="cpu")
    _fill_(layer, seed)
    return layer.train(aux)


def _loop_moe(layer, x):
    """The release's training branch written out: each token repeated top_k
    times, each expert on its own slots, the weighted sum, the shared
    expert."""
    flat = x.reshape(-1, x.shape[-1])
    scores = torch.softmax(flat @ layer.gate.weight.t(), -1)
    w, idx = torch.topk(scores, layer.top_k, dim=-1)
    rep = flat.repeat_interleave(layer.top_k, 0)
    out = torch.zeros_like(rep)
    slots = idx.reshape(-1)
    for e in range(layer.num_experts):
        sel = slots == e
        h = F.gelu(rep[sel] @ layer.fc1_weight[e].t() + layer.fc1_bias[e])
        out[sel] = h @ layer.fc2_weight[e].t() + layer.fc2_bias[e]
    y = (out.view(-1, layer.top_k, flat.shape[1]) * w[..., None]).sum(1)
    return (y + layer.shared(flat)).view(x.shape), scores, idx


@pytest.mark.parametrize("starved", [False, True])
def test_the_dropless_dispatch_equals_a_per_expert_loop(starved):
    """Every slot computed, whatever the load: the layer against the loop,
    one expert starved of tokens (its gate row far below the others) or
    not; the plan puts each slot in its expert's group, groups start on
    ``ALIGN`` rows, the gaps and the tail are zero rows."""
    layer = _layer()
    x = torch.randn((2, 37, 32), generator=torch.Generator().manual_seed(6))
    if starved:
        # every token's logit for expert 1 some 50 below the others'
        x = x + 2.0
        with torch.no_grad():
            layer.gate.weight[1] = -5.0 / math.sqrt(32)
    with torch.no_grad():
        got = layer(x)
        want, _, idx = _loop_moe(layer, x)
    assert _max_rel(got, want) < 1e-5
    slots = idx.reshape(-1)
    dest, offs, row_expert, counts = MOE.dispatch_plan(slots, 4)
    assert counts.tolist() == [int((slots == e).sum()) for e in range(4)]
    assert (counts[1] == 0) == starved
    R = MOE.rows(slots.numel(), 4)
    assert int(offs[-1]) == R and len(set(dest.tolist())) == slots.numel()
    assert torch.equal(row_expert.index_select(0, dest), slots)
    starts = [0] + offs.tolist()[:-1]
    assert all(s % MOE.ALIGN == 0 for s in starts)
    assert all(int(offs[e]) - starts[e] >= int(counts[e]) for e in range(4))


def test_top2_weights_are_not_renormalised():
    """The weights are the raw softmax scores of the chosen experts (their
    sum below one); dividing them by their sum (the release's
    ``norm_topk_prob``) moves the output."""
    layer = _layer()
    x = torch.randn((1, 20, 32), generator=torch.Generator().manual_seed(7))
    experts, weights, scores = layer.route(x.reshape(-1, 32))
    assert torch.equal(weights, scores.gather(1, experts))
    assert float(weights.sum(-1).max()) < 1.0
    assert torch.equal(experts, torch.topk(scores, 2, dim=-1).indices)
    route = layer.route

    def renormalised(flat):
        experts, weights, scores = route(flat)
        return experts, weights / weights.sum(-1, keepdim=True), scores

    with torch.no_grad():
        raw = layer(x)
        layer.route = renormalised
        _, w_norm, _ = layer.route(x.reshape(-1, 32))
        renorm = layer(x)
    assert torch.allclose(w_norm.sum(-1), torch.ones(20))
    assert _max_rel(renorm, raw) > 1e-2


def test_the_auxiliary_gradient_equals_autograd_of_the_explicit_aux():
    """The layer's backward (aux at alpha 0.01, injected at weight 1) equals
    autograd of the loss plus ``alpha sum_e P_e f_e`` written out (f_e from
    the counts, no gradient) through a layer without it; the forward is
    unchanged; without it (eval mode) the gate's gradient differs."""
    x0 = torch.randn((2, 25, 32), generator=torch.Generator().manual_seed(8))
    # a loss the size of a training loss's, so that the gate's gradient
    # from the auxiliary loss is no rounding of the rest
    w = 1e-4 * torch.randn((2, 25, 32),
                           generator=torch.Generator().manual_seed(9))
    grads, outs = [], []
    for aux in (True, False):
        layer = _layer(aux=aux)
        x = x0.clone().requires_grad_()
        y = layer(x)
        total = (y * w).sum()
        if not aux:
            _, scores, idx = _loop_moe(layer, x)
            f = torch.bincount(idx.reshape(-1), minlength=4).float() \
                * (4 / idx.numel())
            total = total + 0.01 * (scores.mean(0) * f).sum()
        total.backward()
        outs.append(y.detach())
        grads.append({"x": x.grad, **{k: p.grad for k, p
                                      in layer.named_parameters()}})
    assert torch.equal(outs[0], outs[1])
    for k in grads[0]:
        assert _max_rel(grads[0][k], grads[1][k]) < 1e-5, k
    plain = _layer(aux=False)
    (plain(x0) * w).sum().backward()
    assert _max_rel(plain.gate.weight.grad, grads[0]["gate.weight"]) > 0.02


def test_the_grouped_products_gradients_match_autograd_of_a_loop():
    """``grouped_linear``'s three gradients (grouped products, the bias's
    through a ones operand) against autograd of each group's own
    product, with an empty group; the plain grouped product against
    ``torch._grouped_mm`` where this PyTorch runs it on the CPU."""
    g = torch.Generator().manual_seed(10)
    offs = torch.tensor([16, 16, 48, 72], dtype=torch.int32)
    row_expert = torch.tensor([0] * 16 + [2] * 32 + [3] * 24)
    x, w, b = (torch.randn(s, generator=g) for s in ((72, 24), (4, 40, 24),
                                                      (4, 40)))
    dy = torch.randn((72, 40), generator=g)
    xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
    MOE.grouped_linear(xs, ws, bs, offs, row_expert).backward(dy)
    xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
    ref = torch.cat([xr[0:16] @ wr[0].t() + br[0], xr[16:48] @ wr[2].t() + br[2],
                     xr[48:72] @ wr[3].t() + br[3]])
    ref.backward(dy)
    for got, want in ((xs.grad, xr.grad), (ws.grad, wr.grad), (bs.grad, br.grad)):
        assert _max_rel(got, want) < 1e-5
    assert float(ws.grad[1].abs().max()) == 0 == float(bs.grad[1].abs().max())
    try:
        lib = torch._grouped_mm(x, w.transpose(1, 2), offs=offs)
    except (AttributeError, RuntimeError, NotImplementedError):
        return
    assert _max_rel(MOE.grouped_mm_plain(x, w.transpose(1, 2), offs), lib) < 1e-6
    assert _max_rel(MOE.grouped_mm_plain(dy.t().contiguous(), x, offs),
                    torch._grouped_mm(dy.t().contiguous(), x, offs=offs)) < 1e-6


def test_the_expert_slot_counter_counts_each_forward():
    """``expert_tokens`` counts top-k slots by layer and expert, k times
    the tokens a forward, adding over forwards until reset; a layer
    without a name counts nothing."""
    m = _model()
    b = _inputs()
    with torch.no_grad():
        for _ in range(2):
            m(b["x"], b["t"], b["y"])
    got = MOE.read_expert_tokens()
    assert set(got) == {"blocks.3.moe", "blocks.4.moe"}
    tokens = 2 * (TINY["input_size"] + 1)
    assert all(sum(c) == 2 * 2 * tokens and len(c) == 4 for c in got.values())
    MOE.reset_expert_tokens()
    assert MOE.read_expert_tokens() == {}
    _layer()(torch.zeros((1, 3, 32)))
    assert MOE.read_expert_tokens() == {}


def test_drop_cond_gives_zeros_and_the_mask_its_rate():
    m = _model(cond_drop_prob=0.1)
    b = _inputs()
    assert torch.equal(m.drop_cond(b["y"], torch.tensor([True, False]))[0],
                       torch.zeros_like(b["y"][0]))
    assert torch.equal(m.drop_cond(b["y"], None), b["y"])
    with torch.no_grad():
        dropped = m(b["x"], b["t"], b["y"], torch.tensor([True, True]))
        zeros = m(b["x"], b["t"], torch.zeros_like(b["y"]))
    assert torch.equal(dropped, zeros)
    mask = m.cond_drop_mask(100_000, torch.Generator().manual_seed(2))
    assert abs(float(mask.float().mean()) - 0.1) < 0.005
    assert m.input_shape == (TINY["input_size"], TINY["in_channels"])
    assert m.condition_channels == TINY["context_dim"]


def test_loads_release_names_strictly():
    """A release state_dict (each expert's tensors under its own names)
    loads with ``strict=True`` into a fresh model and gives the same
    tensors; ``to_h21`` writes it back, and ``from_h21`` after ``to_h21``
    is the identity; a missing expert raises."""
    src = _model(seed=4)
    sd = _release(src)
    for name in ("t_embedder.mlp.0.weight", "t_embedder.mlp.2.bias",
                 "x_embedder.weight", "blocks.0.attn1.to_q.weight",
                 "blocks.0.attn1.q_norm.weight", "blocks.1.attn2.k_norm.weight",
                 "blocks.1.attn2.to_v.weight", "blocks.0.attn1.out_proj.bias",
                 "blocks.2.mlp.fc1.weight", "blocks.3.skip_linear.weight",
                 "blocks.3.skip_norm.bias", "blocks.3.moe.gate.weight",
                 "blocks.4.moe.experts.3.net.0.proj.weight",
                 "blocks.4.moe.experts.0.net.2.bias",
                 "blocks.4.moe.shared_experts.net.0.proj.bias",
                 "blocks.4.moe.shared_experts.net.2.weight",
                 "final_layer.norm_final.weight", "final_layer.linear.bias"):
        assert name in sd, name
    assert "blocks.0.attn1.to_q.bias" not in sd
    assert sd["blocks.3.skip_linear.weight"].shape == (128, 256)
    dst = _model(seed=5)
    dst.load_state_dict(sd, strict=True)
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    back = H.to_h21(dst.state_dict())
    assert set(back) == set(sd)
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k
    ours = src.state_dict()
    again = H.from_h21(H.to_h21(ours))
    assert list(again) == list(ours)
    assert all(torch.equal(again[k], v) for k, v in ours.items())
    with pytest.raises(RuntimeError, match="Missing key"):
        dst.load_state_dict({k: v for k, v in sd.items()
                             if not k.endswith("moe.gate.weight")})


NODE = dict(class_name="hy3dshape.models.denoisers.hunyuandit.HunYuanDiTPlain",
            input_size=40, in_channels=64, hidden_size=128, context_dim=48,
            depth=5, num_heads=2, qk_norm=True, qk_norm_type="rms",
            text_len=23, with_decoupled_ca=False, use_attention_pooling=False,
            qkv_bias=False, use_pos_emb=False, num_moe_layers=2,
            num_experts=4, moe_top_k=2)


def test_registry_builds_from_the_config_keys():
    from topiaxl_torch import registry  # noqa: F401
    from topiaxl_torch.core.config import build

    m = build(NODE, param_dtype=torch.float32)
    assert m.dtype == torch.bfloat16 and len(m.blocks) == 5
    blk = m.blocks[4]
    assert blk.moe.fc1_weight.shape == (4, 512, 128)
    assert blk.moe.gate.weight.shape == (4, 128)
    assert blk.attn1.to_q.bias is None
    assert torch.equal(blk.attn1.q_norm.scale, torch.ones(64))
    assert blk.skip_linear.weight.shape == (128, 256)
    assert m.input_shape == (40, 64) and m.condition_channels == 48


@pytest.mark.parametrize("key,bad", [
    ("with_decoupled_ca", True), ("use_attention_pooling", True),
    ("use_pos_emb", True), ("guidance_cond_proj_dim", 8),
    ("timested_modulate", True), ("norm_type", "rms"),
    ("qk_norm_type", "layer"), ("mlp_ratio", 2.0), ("qk_norm", False),
    ("qkv_bias", True)])
def test_registry_refuses_what_is_not_implemented(key, bad):
    from topiaxl_torch import registry  # noqa: F401
    from topiaxl_torch.core.config import build

    with pytest.raises(ValueError, match=key):
        build(dict(NODE, **{key: bad}))


def test_the_forward_records_its_spans():
    """Under a profiler the blocks' forward is one ``h21.blocks`` span,
    each MoE layer's forward an ``h21.moe`` inside it with its grouped
    products in ``h21.moe.experts``; without one, none records."""
    from topiaxl_torch.core import profiling as prof

    m = _model()
    b = _inputs()
    prof.clear_spans()
    with torch.no_grad():
        m(b["x"], b["t"], b["y"])
    assert prof.spans() == []
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]), torch.no_grad():
        with prof.span("outer"):
            m(b["x"], b["t"], b["y"])
    found = prof.spans()
    prof.clear_spans()
    names = [s.name for s in found]
    assert sorted(names) == sorted(["outer", "h21.blocks"]
                                   + ["h21.moe", "h21.moe.experts"] * 2)
    by_id = {s.id: s for s in found}
    for s in found:
        up = by_id.get(s.parent)
        want = {"outer": None, "h21.blocks": "outer", "h21.moe": "h21.blocks",
                "h21.moe.experts": "h21.moe"}[s.name]
        assert (up.name if up else None) == want, s.name


def test_cli_trains_the_h21(tmp_path):
    """``cli.train`` on the shipped config at a tiny size: two steps on the
    synthetic stream, the flow objective at sigma_min 0 and a constant
    rate."""
    from topiaxl_torch.cli import train as cli

    out: list = []
    rc = cli.main(["configs/hunyuan3d21_dit.yml", "train.device=cpu",
                   "train.synthetic=true", "train.max_steps=2",
                   "train.batch_size=2", f"train.cond_seq={M}",
                   "train.log_every_n_steps=1", "train.ckpt_every_n_steps=100",
                   f"root_data_dir={tmp_path}"]
                  + [f"model.generator.{k}={v}" for k, v in TINY.items()],
                  metrics_out=out)
    assert rc == 0 and [r["step"] for r in out] == [1, 2]
    assert all(math.isfinite(r["loss"]) for r in out)
    assert set(out[0]) >= {"loss", "loss_mse", "grad_norm"}


# -- on the card ----------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash and QK-norm kernels and "
                    "torch._grouped_mm's CUDA path have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("keys", [4097, 1370])
def test_flash_at_head_dim_128_matches_plain_on_the_card(keys):
    """#1 (its ping-pong loop) and the backward the rule takes (the pair
    past 2048 keys, the single pass at 1370) at 2 x 4097 x keys x 16 x 128,
    a ragged last q tile (4097 = 32 x 128 + 1) and, over 4097 keys, a
    ragged last key tile, against the plain versions on the first row."""
    import chip_smoke as c
    from topiaxl_torch.ops import _cuda
    from topiaxl_torch.ops import flash_attention as fa

    dev = _card()
    g = torch.Generator(dev).manual_seed(11)
    q, k, v = (torch.randn((2, n, 16, 128), generator=g, device=dev).bfloat16()
               for n in (4097, keys, keys))
    do = torch.randn((2, 4097, 16, 128), generator=g, device=dev).bfloat16()
    sc = 128 ** -0.5
    before = dict(_cuda.launches), dict(_cuda.fwd_loops)
    o, lse = fa._forward(q, k, v, sc, return_lse=True)
    grads = fa.flash_attention_backward(q, k, v, o, lse, do, sc)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_attention_plain(q[:1], k[:1], v[:1], sc,
                                              return_lse=True)
    assert c.rel_err(o[:1], o_ref) <= c.ATTN_REL_BAR
    assert float((lse[:1] - lse_ref).abs().max()) <= c.LSE_ABS_BAR
    ref = fa.flash_attention_bwd_plain(q[:1], k[:1], v[:1], o[:1], lse[:1],
                                       do[:1], sc)
    for got, want in zip(grads, ref):
        assert c.rel_err(got[:1], want) <= c.ATTN_BWD_REL_BAR
    pair = keys > fa.FUSED_BWD_MAX_KEYS
    launched = {n: _cuda.launches[n] - before[0][n] for n in (
        "flash_attn_fwd", "flash_attn_bwd", "flash_attn_bwd_dq",
        "flash_attn_bwd_dkv")}
    assert launched == {"flash_attn_fwd": 1, "flash_attn_bwd": int(not pair),
                        "flash_attn_bwd_dq": int(pair),
                        "flash_attn_bwd_dkv": int(pair)}
    assert _cuda.fwd_loops["pingpong"] - before[1]["pingpong"] == 1


@pytest.mark.cuda
def test_qk_rms_norm_at_head_dim_128_matches_the_twin_on_the_card():
    """The rms form on q read in place from the joined heads [2, 4097, 16,
    384] at D 128 (16 lanes a row): the forward within one bf16 rounding,
    dx within 2^-7 of its largest entry, dgamma within 1e-4 relative."""
    from topiaxl_torch.ops import qk_norm as Q

    dev = _card()
    g = torch.Generator(dev).manual_seed(12)
    joined = torch.randn((2, 4097, 16, 384), generator=g, device=dev).bfloat16()
    q = joined[..., :128]
    gamma = (1 + 0.1 * torch.randn((128,), generator=g, device=dev)).expand(
        16, 128).contiguous()
    dy = torch.randn((2, 4097, 16, 128), generator=g, device=dev).bfloat16()
    y = Q._forward(q, gamma, 1.0, "rms")
    dx, dgamma = Q._backward(q, dy, gamma, 1.0, "rms")
    y_ref = Q.qk_rms_norm_plain(q, gamma, 1.0, "rms")
    dx_ref, dg_ref = Q.qk_rms_norm_bwd_plain(q, dy, gamma, 1.0, "rms")
    assert float((y.float() - y_ref.float()).abs().max()) <= \
        2 ** -8 * float(y_ref.float().abs().max())
    assert float((dx.float() - dx_ref.float()).abs().max()) <= \
        2 ** -7 * float(dx_ref.float().abs().max())
    assert _rel(dgamma, dg_ref) < 1e-4


def _card_layer(dev):
    layer = MOE.MoEFFN(2048, 8192, 8, 2, param_dtype=torch.float32)
    layer.to_empty(device=dev)
    g = torch.Generator(dev).manual_seed(13)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            if name.endswith("bias"):
                p.normal_(0, 0.02, generator=g)
            else:
                p.normal_(0, p.shape[-1] ** -0.5, generator=g)
    layer.counter = "card"
    return layer.train()


@pytest.mark.cuda
def test_the_grouped_experts_match_the_per_expert_loop_on_the_card():
    """The layer at the published widths on [2, 4097, 2048] in bf16 against
    the loop of the release's training branch in f32 on the same routing
    (the program's own), within 2^-7 of the largest entry; every input's
    and parameter's gradient through ``torch._grouped_mm`` against
    autograd of the loop."""
    dev = _card()
    layer = _card_layer(dev)
    x = torch.randn((2, 4097, 2048), generator=torch.Generator(dev).manual_seed(
        14), device=dev).bfloat16().requires_grad_()
    w = torch.randn(x.shape, device=dev)
    y = layer(x)
    (y.float() * w).sum().backward()
    got = {"x": x.grad.float(), **{k: p.grad.float() for k, p
                                   in layer.named_parameters()}}
    ref_layer = MOE.MoEFFN(2048, 8192, 8, 2, dtype=torch.float32,
                           param_dtype=torch.float32)
    ref_layer.to_empty(device=dev)
    ref_layer.load_state_dict(layer.state_dict())
    xr = x.detach().float().requires_grad_()
    ref, scores, idx = _loop_moe(ref_layer, xr)
    f = torch.bincount(idx.reshape(-1), minlength=8).float() * (8 / idx.numel())
    ((ref * w).sum() + MOE.AUX_LOSS_ALPHA * (scores.mean(0) * f).sum()
     ).backward()
    assert c_rel(y.detach(), ref.detach()) <= 2 ** -7
    want = {"x": xr.grad, **{k: p.grad for k, p in ref_layer.named_parameters()}}
    for k in want:
        assert c_rel(got[k], want[k]) <= 2 ** -7, k


def c_rel(got, ref):
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


@pytest.mark.cuda
def test_an_moe_block_runs_without_a_host_sync_and_counts_its_slots():
    """One forward and backward of an MoE block at the published widths
    under ``torch.cuda.set_sync_debug_mode("error")``: nothing in the
    routing, dispatch, grouped products, combine or auxiliary loss reads
    the card; the counter then holds 2 x 8194 slots."""
    dev = _card()
    blk = H.HunYuanDiTBlock(2048, 16, 1024, skip=True, moe=True,
                            param_dtype=torch.float32)
    blk.to_empty(device=dev)
    _fill_(blk, 15)
    blk.moe.counter = "blocks.12.moe"
    blk.train()
    g = torch.Generator(dev).manual_seed(16)
    x, skip = (torch.randn((2, 4097, 2048), generator=g, device=dev)
               .bfloat16().requires_grad_() for _ in range(2))
    y = torch.nn.functional.layer_norm(torch.randn(
        (2, 1370, 1024), generator=g, device=dev), (1024,)).bfloat16()
    blk(x, y, skip).float().square().mean().backward()   # builds the kernels
    torch.cuda.synchronize()
    MOE.reset_expert_tokens()
    torch.cuda.set_sync_debug_mode("error")
    try:
        blk(x, y, skip).float().square().mean().backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    got = MOE.read_expert_tokens()
    assert list(got) == ["blocks.12.moe"] and sum(got["blocks.12.moe"]) == \
        2 * 2 * 4097
    assert torch.isfinite(x.grad).all() and torch.isfinite(skip.grad).all()


@pytest.mark.cuda
def test_the_ln_kernels_at_width_2048_match_plain_on_the_card():
    """``ln_modulate`` and ``ln_modulate_residual`` at 2 x 4097 x 2048 (the
    launcher's instance for the widest rows) with the operands the blocks
    pass (the shift the LN's bias, the scale its gain less one, one row
    for the batch; a gate of ones) within chip_smoke's bar of one bf16 ulp
    of the plain result plus ``LN_ABS_SLACK``."""
    import chip_smoke as c
    from topiaxl_torch.ops.fused_ln import (
        ln_modulate, ln_modulate_plain, ln_modulate_residual,
        ln_modulate_residual_plain)

    dev = _card()
    g = torch.Generator(dev).manual_seed(17)
    x, delta = (torch.randn((2, 4097, 2048), generator=g, device=dev)
                .bfloat16() for _ in range(2))
    norm = H.LayerNorm(2048, torch.float32).to_empty(device=dev)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn((2048,), generator=g,
                                                device=dev))
        norm.bias.copy_(0.1 * torch.randn((2048,), generator=g, device=dev))
    sh, sc = norm.modulation(2, torch.bfloat16)
    one = torch.ones(2048, dtype=torch.bfloat16, device=dev)[None].expand(2, -1)
    pairs = [((ln_modulate(x, sh, sc),), (ln_modulate_plain(x, sh, sc),)),
             (ln_modulate_residual(x, delta, one, sh, sc),
              ln_modulate_residual_plain(x, delta, one, sh, sc))]
    for got, ref in pairs:
        for a, b in zip(got, ref):
            assert c.bf16_ulp_excess(a, b) <= c.LN_ABS_SLACK
