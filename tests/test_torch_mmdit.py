"""Hunyuan3D-2's shape DiT in the port (``models/mmdit.py``, the "rms" form
of ``ops/qk_norm.py``) against the benchmark's plain reference
(``portbench/reference/mmdit.py``) and hand-written formulas, on the CPU
at a small size (hidden 128, 2 heads of 64, 2 double and 2 single blocks,
40 latent tokens and 23 conditioning tokens, so that the joined length
63 is no multiple of a tile) on seeded random weights; the QK-norm
kernels, one block of each kind and one step's launches on the card at
the published widths (marked ``cuda``; skip without a card). The file
imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_mmdit.py

Tolerances, each for a reason:

- f32 on both sides on the CPU: the port runs its plain twins in f32, the
  reference its own f32 chain; they sum in other orders (the LN's
  variance, the joined q, k, v, einsum against matmul), some 300 ops
  deep: outputs and the loss within 2e-5 relative, each gradient within
  1e-4 of its leaf's largest entry (the backward doubles the depth).
- the QK-norm twin against autograd on the formula: 1e-6 relative (the
  same f32 arithmetic, grouped otherwise).
- two AdamW steps: each leaf's change within 1e-3 of its norm (Adam
  divides each element's gradient by its own root mean square, so an
  element whose gradient is small carries its f32 round-off into a step of
  up to a few percent of the rate; over a leaf that averages out).
- on the card, bf16 against f32: the QK norm within one bf16 rounding of
  its output (2^-8 relative), dx within 2^-7 of its largest entry, the
  gain's gradient within 1e-4 relative (f32 sums in another order); a
  block's output and gradients within 2e-2 of their largest entry (the
  DiT's kernels' bars for bf16 products and P).
"""

from __future__ import annotations

import math

import pytest
import torch

from portbench.reference import mmdit as rmm
from portbench.reference import train as rtrain
from topiaxl_torch.diffusion.flow import RectifiedFlow
from topiaxl_torch.models import mmdit as MM
from topiaxl_torch.ops import qk_norm as Q

TINY = dict(in_channels=64, context_in_dim=48, hidden_size=128, num_heads=2,
            depth=2, depth_single_blocks=2, num_latents=40)
M = 23                     # conditioning tokens
HEADS = TINY["num_heads"]
# the published widths (hunyuan3d-dit-v2-0/config.yaml)
FULL = dict(in_channels=64, context_in_dim=1536, hidden_size=1024,
            num_heads=16, depth=16, depth_single_blocks=32, num_latents=3072)
FULL_M = 1370
FLOW = RectifiedFlow(sigma_min=0.0, t_mean=0.0, t_std=1.0)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _model(seed: int = 0, dtype=torch.float32, device=None, **kw):
    """A model with every parameter drawn from ``seed`` (QK gains around
    one, gates around one, so that no sublayer is the identity)."""
    m = MM.Hunyuan3DDiT(**dict(TINY, **kw), dtype=dtype,
                        param_dtype=torch.float32, device=device)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in m.named_parameters():
            r = torch.randn(p.shape, generator=g)
            if name.endswith("norm.scale"):
                r = 1.0 + 0.1 * r
            elif p.dim() >= 2:
                r = r / math.sqrt(p.shape[1])
            else:
                r = 0.1 * r
            if name.endswith("_mod.bias"):
                r.view(6, -1)[2::3] += 1.0
            elif name.endswith(".modulation.bias"):
                r.view(3, -1)[2] += 1.0
            p.copy_(r.to(p.device))
    return m


def _hunyuan(model) -> dict:
    """The model's weights under Hunyuan3D-2's names, written out here
    (not through ``to_hunyuan``)."""
    out = {}
    for k, v in model.state_dict().items():
        k = (k.replace("t_embedder.mlp.0.", "time_in.in_layer.")
             .replace("t_embedder.mlp.2.", "time_in.out_layer.")
             .replace("img_mod.", "img_mod.lin.")
             .replace("txt_mod.", "txt_mod.lin.")
             .replace("q_norm.scale", "norm.query_norm.scale")
             .replace("k_norm.scale", "norm.key_norm.scale")
             .replace("_mlp.fc1.", "_mlp.0.").replace("_mlp.fc2.", "_mlp.2."))
        if k.startswith("single_blocks.") and ".modulation." in k:
            k = k.replace(".modulation.", ".modulation.lin.")
        out[k] = v.detach().float().cpu().clone()
    return out


def _inputs(seed: int = 1, B: int = 2):
    g = torch.Generator().manual_seed(seed)
    N, C = TINY["num_latents"], TINY["in_channels"]
    return {"x": torch.randn((B, N, C), generator=g),
            "y": torch.randn((B, M, TINY["context_in_dim"]), generator=g),
            "t": torch.tensor([0.3, 0.85])[:B],
            "drop": torch.tensor([False, True])[:B],
            "noise": torch.randn((B, N, C), generator=g)}


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _rms_formula(x, gain):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) * gain


@pytest.mark.parametrize("zero_row", [False, True])
def test_rms_qk_norm_twin_forward_and_backward_match_autograd(zero_row):
    """The "rms" form's plain twin (what the CPU runs; the kernels'
    contract) against autograd through FLUX's ``x * rsqrt(mean(x^2) +
    1e-6) * scale``, on q read in place from a linear1-like row (qkv then
    an MLP part) with one gain shared by the heads; a row of zeros is
    finite."""
    g = torch.Generator().manual_seed(3)
    row = torch.randn((2, 5, 3 * 4 * 64 + 96), generator=g,
                      dtype=torch.float64)
    if zero_row:
        row[1, 2, 64:128] = 0.0
    gain = 1 + 0.1 * torch.randn((64,), generator=g, dtype=torch.float64)
    dy = torch.randn((2, 5, 4, 64), generator=g, dtype=torch.float64)
    q = row[..., :768].unflatten(-1, (3, 4, 64)).unbind(2)[0]
    assert q.stride() == (5 * 864, 864, 64, 1)
    y = Q.qk_rms_norm_plain(q.float(), gain.float().expand(4, 64), 1.0, "rms")
    assert y.is_contiguous() and y.shape == (2, 5, 4, 64)
    xr, gr = q.clone().requires_grad_(), gain.clone().requires_grad_()
    ref = _rms_formula(xr, gr)
    ref.backward(dy)
    assert _rel(y, ref.detach()) < 1e-6
    dx, dgamma = Q.qk_rms_norm_bwd_plain(q.float(), dy.float(),
                                        gain.float().expand(4, 64), 1.0, "rms")
    assert _rel(dx, xr.grad) < 1e-6 and _rel(dgamma.sum(0), gr.grad) < 1e-6
    if zero_row:
        assert torch.isfinite(dx).all() and float(y[1, 2, 1].abs().max()) == 0
    # and through the layer the model uses: the gain's gradient summed over
    # the heads by autograd
    from topiaxl_torch.models.layers import RMSNorm

    norm = RMSNorm(64, param_dtype=torch.float32).to_empty(device="cpu")
    with torch.no_grad():
        norm.scale.copy_(gain.float())
    xa = q.float().clone().requires_grad_()
    norm(xa).backward(dy.float())
    assert _rel(xa.grad, xr.grad) < 1e-6
    assert _rel(norm.scale.grad, gr.grad) < 1e-6


def test_the_qk_norm_form_is_an_argument():
    """The l2 form stays the default and TRELLIS's formula. The rms form's
    epsilon sits inside the mean: on rows of unit scale it reads within
    1e-6 of the l2 form at scale sqrt(D), on rows whose mean square is the
    epsilon's own size it reads 1 / sqrt(2) of it. An unknown form
    raises."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, 3, 4, 64), generator=g)
    gamma = 1 + 0.1 * torch.randn((4, 64), generator=g)
    for s in (1.0, 1e-3):
        l2 = torch.nn.functional.normalize(s * x, dim=-1) * gamma * 8.0
        assert _rel(Q.qk_rms_norm(s * x, gamma, 8.0), l2) < 1e-6
        assert _rel(Q.qk_rms_norm(s * x, gamma, 8.0, "l2"), l2) < 1e-6
        rms = Q.qk_rms_norm(s * x, gamma, 1.0, "rms")
        assert _rel(rms, _rms_formula(s * x, gamma)) < 1e-6
        ratio = float(rms.norm() / l2.norm())
        want = 1.0 if s == 1.0 else 2 ** -0.5
        assert abs(ratio - want) < 2e-2 * want, (s, ratio)
    with pytest.raises(ValueError, match="form"):
        Q.qk_rms_norm(x, gamma, 1.0, "layer")


def test_forward_and_loss_match_the_reference():
    m = _model()
    P = _hunyuan(m)
    b = _inputs()
    with torch.no_grad():
        got = m(b["x"], b["t"] * 1000, b["y"], b["drop"])
        y = torch.where(b["drop"][:, None, None], 0.0, b["y"])
        want = rmm.forward(P, b["x"], b["t"] * 1000, y, HEADS)
        assert got.shape == b["x"].shape
        assert _rel(got, want) < 2e-5
        loss = FLOW.training_losses(
            lambda x_t, t: m(x_t, t, b["y"], b["drop"]), b["x"], b["t"],
            b["noise"])
        ref = rmm.training_loss(P, b["x"], b["y"], b["t"], b["noise"],
                                b["drop"], HEADS)
    assert _rel(loss["loss_total"], ref) < 2e-5
    assert torch.equal(loss["loss_total"], loss["loss_mse"])


def test_every_gradient_matches_the_reference():
    m = _model()
    P = _hunyuan(m)
    b = _inputs()
    loss = FLOW.training_losses(
        lambda x_t, t: m(x_t, t, b["y"], b["drop"]), b["x"], b["t"],
        b["noise"])["loss_total"].mean()
    loss.backward()
    total, grads = rmm.gradient(P, b, HEADS)
    assert abs(total - float(loss.detach())) < 2e-5 * abs(total)
    ref = MM.from_hunyuan(grads)
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
    P = _hunyuan(m)
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
        loss, grads = rmm.gradient(P, b, HEADS)
        adam.step(P, grads)
        assert abs(float(metrics["loss"]) - loss) < 2e-5 * loss
    ref = MM.from_hunyuan({k: P[k] - P0[k] for k in P})
    for k, p in m.named_parameters():
        moved = p.detach() - p0[k]
        assert _rel(moved, ref[k]) < 1e-3, k
        assert float(moved.abs().max()) > 0.5 * lr, k
    assert state.step == 2 and state.opt_state.count == 2


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
    assert m.input_shape == (TINY["num_latents"], TINY["in_channels"])
    assert m.condition_channels == TINY["context_in_dim"]


def test_loads_hunyuan_names_strictly():
    """A Hunyuan3D-2 state_dict (FLUX's names) loads with ``strict=True``
    into a fresh model and gives the same tensors; ``to_hunyuan`` writes
    it back, and ``from_hunyuan`` after ``to_hunyuan`` is the identity; a
    missing key raises."""
    src = _model(seed=4)
    sd = _hunyuan(src)
    for name in ("time_in.in_layer.weight", "cond_in.bias",
                 "double_blocks.1.txt_mod.lin.weight",
                 "double_blocks.0.img_attn.norm.query_norm.scale",
                 "double_blocks.0.img_attn.norm.key_norm.scale",
                 "double_blocks.1.img_mlp.2.bias",
                 "single_blocks.1.modulation.lin.bias",
                 "single_blocks.0.norm.key_norm.scale",
                 "single_blocks.0.linear1.weight",
                 "final_layer.adaLN_modulation.1.weight",
                 "final_layer.linear.bias"):
        assert name in sd, name
    dst = _model(seed=5)
    dst.load_state_dict(sd, strict=True)
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    back = MM.to_hunyuan(dst.state_dict())
    assert set(back) == set(sd)
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k
    ours = src.state_dict()
    assert list(MM.from_hunyuan(MM.to_hunyuan(ours))) == list(ours)
    assert list(MM.to_hunyuan(MM.from_hunyuan(sd))) == list(sd)
    with pytest.raises(RuntimeError, match="Missing key"):
        dst.load_state_dict({k: v for k, v in sd.items()
                             if not k.endswith("query_norm.scale")})


def test_registry_builds_from_the_config_keys():
    from topiaxl_torch import registry  # noqa: F401
    from topiaxl_torch.core.config import build

    node = dict(class_name="hy3dgen.shapegen.models.Hunyuan3DDiT",
                in_channels=64, context_in_dim=48, hidden_size=128,
                mlp_ratio=4.0, num_heads=2, depth=2, depth_single_blocks=3,
                axes_dim=[64], theta=10000, qkv_bias=True,
                guidance_embed=False, num_latents=40)
    m = build(node, param_dtype=torch.float32)
    assert m.dtype == torch.bfloat16
    assert len(m.double_blocks) == 2 and len(m.single_blocks) == 3
    blk = m.single_blocks[0]
    assert blk.linear1.weight.shape == (3 * 128 + 512, 128)
    assert blk.linear2.weight.shape == (128, 128 + 512)
    assert torch.equal(blk.q_norm.scale, torch.ones(64))
    assert m.double_blocks[0].img_attn.qkv.bias is not None
    assert float(m.double_blocks[0].img_mod.weight.detach().abs().max()) == 0
    assert m.input_shape == (40, 64)
    for key, bad in (("guidance_embed", True), ("time_factor", 1.0)):
        with pytest.raises(ValueError, match=key):
            build(dict(node, **{key: bad}))


def test_the_forward_records_its_two_spans():
    """Under a profiler the double blocks' forward is one ``mmdit.double``
    span and the single blocks' one ``mmdit.single``, inside the caller's
    span; without one, neither records."""
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
    found = {s.name: s for s in prof.spans()}
    prof.clear_spans()
    assert set(found) == {"outer", "mmdit.double", "mmdit.single"}
    assert found["mmdit.double"].parent == found["outer"].id
    assert found["mmdit.single"].parent == found["outer"].id
    assert found["mmdit.double"].end_ns <= found["mmdit.single"].start_ns


def test_cli_trains_the_mmdit(tmp_path):
    """``cli.train`` on the shipped config at a tiny size: two steps on the
    synthetic stream, the flow objective at sigma_min 0 and a constant
    rate."""
    from topiaxl_torch.cli import train as cli

    out: list = []
    rc = cli.main(["configs/hunyuan3d_dit.yml", "train.device=cpu",
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
        pytest.skip("needs a CUDA card: the QK-norm and flash kernels have "
                    "no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["l2", "rms"])
def test_qk_norm_kernels_match_the_twin_on_the_card(form):
    """At [4, 4442, 16, 64], q read in place from a single block's linear1
    rows (7168 wide): each form's kernels against its twin, the forward
    within one bf16 rounding, dx within 2^-7 of its largest entry and
    dgamma within 1e-4 relative; a planted fault (the gains left out of dx)
    lands above the bar; each form counts under its own keys."""
    from topiaxl_torch.ops import _cuda

    dev = _card()
    g = torch.Generator(dev).manual_seed(0)
    rows = torch.randn((4, 4442, 7168), generator=g, device=dev).to(
        torch.bfloat16)
    q = rows[..., :3072].unflatten(-1, (3, 16, 64)).unbind(2)[0]
    gamma = 1 + 0.1 * torch.randn((16, 64), generator=g, device=dev)
    dy = torch.randn((4, 4442, 16, 64), generator=g, device=dev).to(
        torch.bfloat16)
    scale = 8.0 if form == "l2" else 1.0
    fwd, bwd = Q._NAMES[form]
    before = dict(_cuda.launches)
    y = Q._forward(q, gamma, scale, form)
    dx, dgamma = Q._backward(q, dy, gamma, scale, form)
    torch.cuda.synchronize()
    diff = {k: _cuda.launches[k] - before[k] for k in before}
    assert diff == dict({k: 0 for k in before}, **{fwd: 1, bwd: 1})
    y_ref = Q.qk_rms_norm_plain(q, gamma, scale, form)
    dx_ref, dg_ref = Q.qk_rms_norm_bwd_plain(q, dy, gamma, scale, form)
    assert float((y.float() - y_ref.float()).abs().max()) <= \
        2 ** -8 * float(y_ref.float().abs().max())
    bar = 2 ** -7 * float(dx_ref.float().abs().max())
    assert float((dx.float() - dx_ref.float()).abs().max()) <= bar
    assert _rel(dgamma, dg_ref) < 1e-4
    fault, _ = Q.qk_rms_norm_bwd_plain(q, dy, torch.ones_like(gamma), scale,
                                       form)
    assert float((fault.float() - dx_ref.float()).abs().max()) > bar


def _full_block_model(dev):
    return _model(seed=7, dtype=torch.bfloat16, device=dev,
                  **dict(FULL, depth=1, depth_single_blocks=1))


@pytest.mark.cuda
def test_one_block_of_each_kind_matches_the_reference_on_the_card():
    """One double and one single block at the published widths (1024, 16
    heads of 64) on 3072 latent and 1370 conditioning tokens, batch 2,
    bf16 with f32 masters, against the reference's blocks in f32 (TF32
    off): outputs, the inputs' gradients and every parameter's."""
    from portbench.reference import ops

    dev = _card()
    ops.no_tf32()
    m = _full_block_model(dev)
    P = {k: v.to(dev) for k, v in _hunyuan(m).items()}
    g = torch.Generator(dev).manual_seed(8)
    img = torch.randn((2, 3072, 1024), generator=g, device=dev)
    txt = torch.randn((2, FULL_M, 1024), generator=g, device=dev)
    c = torch.nn.functional.silu(torch.randn((2, 1024), generator=g,
                                             device=dev))
    ib = img.to(torch.bfloat16).requires_grad_()
    tb = txt.to(torch.bfloat16).requires_grad_()
    oi, ot = m.double_blocks[0](ib, tb, c)
    joined = torch.cat([ot, oi], dim=1)
    out = m.single_blocks[0](joined, c)
    w = torch.randn(out.shape, generator=g, device=dev)
    (out.float() * w).sum().backward()
    Pr = {k: v.clone().requires_grad_() for k, v in P.items()}
    ir = ib.detach().float().requires_grad_()
    tr = tb.detach().float().requires_grad_()
    ri, rt = rmm.double_block(Pr, 0, ir, tr, c, 16)
    ref = rmm.single_block(Pr, 0, torch.cat([rt, ri], dim=1), c, 16)
    (ref * w).sum().backward()
    top = float(ref.detach().abs().max())
    assert float((out.float() - ref.detach()).abs().max()) < 2e-2 * top
    for got, want in ((ib.grad, ir.grad), (tb.grad, tr.grad)):
        assert float((got.float() - want).abs().max()) < \
            2e-2 * float(want.abs().max())
    grads = MM.to_hunyuan({k: p.grad for k, p in m.named_parameters()
                           if k.startswith(("double_blocks.", "single_blocks."))})
    assert len(grads) == sum(k.startswith(("double_blocks.", "single_blocks."))
                             for k in Pr)
    for k, gr in grads.items():
        r = Pr[k].grad
        assert float((gr.float() - r).abs().max()) < \
            2e-2 * float(r.abs().max()) + 1e-6, k


@pytest.mark.cuda
def test_one_step_launches_at_the_published_widths():
    """One training step of the published model at batch 4: flash forward
    48 (16 joint over 4442 keys in the double blocks, 32 in the single
    blocks), the single-pass backward 48, the RMS QK norm on q and k of
    each stream of each double block and of each single block (128 + 128),
    none of TRELLIS's form, LN+modulate 64 and 32, one AdamW + EMA
    update."""
    from topiaxl_torch.ops import _cuda
    from topiaxl_torch.pipelines import train as T

    dev = _card()
    m = MM.Hunyuan3DDiT(**FULL, param_dtype=torch.float32, device=dev,
                        cond_drop_prob=0.1).train()
    g = torch.Generator(dev).manual_seed(9)
    batch = {"x": torch.randn((4, 3072, 64), generator=g, device=dev),
             "y": torch.randn((4, FULL_M, 1536), generator=g, device=dev)}
    step = T.make_train_step(m, FLOW, T.make_optimizer(schedule="constant"))
    state = T.create_train_state(m)
    before = dict(_cuda.launches)
    metrics = step(state, batch, 0)
    torch.cuda.synchronize()
    assert math.isfinite(float(metrics["loss"]))
    diff = {k: _cuda.launches[k] - before[k] for k in before}
    assert diff == dict(
        {k: 0 for k in before}, flash_attn_fwd=48, flash_attn_bwd=48,
        qk_rmsnorm_rms=128, qk_rmsnorm_rms_bwd=128, ln_modulate=64,
        ln_modulate_residual=32, adamw_ema=1)
