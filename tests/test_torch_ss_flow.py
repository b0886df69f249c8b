"""TRELLIS's sparse-structure flow transformer in the port
(``models/ss_flow.py``, ``ops/qk_norm.py``, ``diffusion/flow.py``) against
the benchmark's plain reference (``portbench/reference/ss_flow.py``) and
hand-written formulas, on the CPU at a small size (2 blocks of 256, 4
heads of 64, a 4^3 grid, 8 conditioning tokens) on seeded random weights;
the QK-norm kernels, one block and one step's launches on the card at the
published widths (marked ``cuda``; skip without a card). The file imports
no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_ss_flow.py

Tolerances, each for a reason:

- f32 on both sides on the CPU: the port runs its plain twins in f32, the
  reference its own f32 chain; they sum in other orders (fused qkv against
  TRELLIS's q, k, v slices, the LN's two-pass variance, einsum against
  matmul), some 200 ops deep: outputs and the loss within 2e-5 relative,
  each gradient within 1e-4 of its leaf's largest entry (the backward
  doubles the depth), the cross-attention's key bias (zero in exact
  arithmetic: softmax ignores a shift shared by every key) within 1e-7 of
  the largest gradient of all.
- the QK-norm twin against autograd on the formula: 1e-6 relative (the
  same f32 arithmetic, grouped otherwise).
- two AdamW steps: each leaf's change within 1e-3 of its norm (the norm
  of the difference; measured 5e-5 at most). Adam divides each element's
  gradient by its own root mean square, so an element whose gradient is
  small carries its f32 round-off into a step of up to 1.5% of the rate;
  over a leaf that averages out. The key bias is left out (its gradient
  is round-off, which Adam scales up to full steps on both sides).
- on the card, bf16 against f32: the QK norm within one bf16 rounding of
  its output (2^-8 relative) plus the f32 sums' order; a block's output
  and gradients within 2e-2 of their largest entry (the DiT's kernels' bars
  for bf16 products and P).
"""

from __future__ import annotations

import math

import pytest
import torch

from portbench.reference import ss_flow as rflow
from portbench.reference import train as rtrain
from topiaxl_torch.diffusion.flow import RectifiedFlow, from_config
from topiaxl_torch.models import ss_flow as S
from topiaxl_torch.ops import qk_norm as Q

TINY = dict(resolution=4, in_channels=8, out_channels=8, model_channels=256,
            cond_channels=32, num_blocks=2, num_heads=4)
M = 8                      # conditioning tokens
HEADS = TINY["num_heads"]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _model(seed: int = 0, dtype=torch.float32, device=None, **kw):
    """A model with every parameter drawn from ``seed`` (gains and gates
    around one, so that no sublayer is the identity)."""
    cfg = dict(TINY, **kw)
    m = S.SparseStructureFlowModel(**cfg, dtype=dtype,
                                   param_dtype=torch.float32, device=device)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in m.named_parameters():
            r = torch.randn(p.shape, generator=g)
            if name.endswith(("gamma", "norm2.weight")):
                r = 1.0 + 0.1 * r
            elif p.dim() >= 2:
                r = r / math.sqrt(p.shape[1])
            else:
                r = 0.1 * r
            if name.endswith("adaLN_modulation.1.bias"):
                r.view(6, -1)[2::3] += 1.0
            p.copy_(r.to(p.device))
    return m


def _trellis(model) -> dict:
    """The model's weights under TRELLIS's names, written out here (not
    through ``to_trellis``), with its ``pos_emb`` buffer."""
    out = {}
    for k, v in model.state_dict().items():
        if ".cross_attn.to_v." in k:
            continue
        if ".cross_attn.to_k." in k:
            other = model.state_dict()[k.replace(".to_k.", ".to_v.")]
            out[k.replace(".to_k.", ".to_kv.")] = torch.cat([v, other])
            continue
        k = (k.replace("self_attn.qkv.", "self_attn.to_qkv.")
             .replace("self_attn.proj.", "self_attn.to_out.")
             .replace("cross_attn.proj.", "cross_attn.to_out.")
             .replace("mlp.fc1.", "mlp.mlp.0.").replace("mlp.fc2.", "mlp.mlp.2."))
        out[k] = v.clone()
    out["pos_emb"] = model.pos_emb.clone()
    return {k: v.detach().float().cpu() for k, v in out.items()}


def _inputs(seed: int = 1, B: int = 2):
    g = torch.Generator().manual_seed(seed)
    R, C = TINY["resolution"], TINY["in_channels"]
    return {"x": torch.randn((B, C, R, R, R), generator=g),
            "y": torch.randn((B, M, TINY["cond_channels"]), generator=g),
            "t": torch.tensor([0.3, 0.85])[:B],
            "drop": torch.tensor([False, True])[:B],
            "noise": torch.randn((B, C, R, R, R), generator=g)}


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_position_embedding_is_trellis_formula():
    """Token (x, y, z) of the grid in "ij" order: for each coordinate,
    sin then cos at 10000^(-i/F), F = C // 6, then zeros."""
    R, C = 4, 256
    pe = S.position_embedding(R, C)
    F_ = C // 3 // 2
    assert pe.shape == (R ** 3, C) and F_ == 42
    for tok in (0, 1, 5, 37, 63):
        x, y, z = tok // 16, (tok // 4) % 4, tok % 4
        want = []
        for c in (x, y, z):
            want += [math.sin(c * 10000 ** (-i / F_)) for i in range(F_)]
            want += [math.cos(c * 10000 ** (-i / F_)) for i in range(F_)]
        want += [0.0] * (C - 6 * F_)
        assert torch.allclose(pe[tok], torch.tensor(want), atol=1e-6), tok
    assert torch.allclose(pe, rflow.position_embedding(R, C), atol=1e-6)


def _qk_formula(x, gamma):
    return torch.nn.functional.normalize(x, dim=-1) * gamma * x.shape[-1] ** 0.5


@pytest.mark.parametrize("zero_row", [False, True])
def test_qk_norm_twin_forward_and_backward_match_autograd(zero_row):
    """The plain twin (what the CPU runs; the kernels' contract) against
    autograd through TRELLIS's ``F.normalize(x) * gamma * sqrt(D)``, on q
    read in place from a fused qkv tensor; a row of zeros takes the
    clamp."""
    g = torch.Generator().manual_seed(3)
    qkv = torch.randn((2, 5, 3, 4, 64), generator=g, dtype=torch.float64)
    if zero_row:
        qkv[1, 2, 0, 3] = 0.0
    gamma = 1 + 0.1 * torch.randn((4, 64), generator=g, dtype=torch.float64)
    dy = torch.randn((2, 5, 4, 64), generator=g, dtype=torch.float64)
    q = qkv.unbind(2)[0]
    y = Q.qk_rms_norm_plain(q.float(), gamma.float(), 8.0)
    assert y.is_contiguous() and y.shape == (2, 5, 4, 64)
    xr, gr = q.clone().requires_grad_(), gamma.clone().requires_grad_()
    ref = _qk_formula(xr, gr)
    ref.backward(dy)
    assert _rel(y, ref.detach()) < 1e-6
    dx, dgamma = Q.qk_rms_norm_bwd_plain(q.float(), dy.float(), gamma.float(),
                                        8.0)
    assert _rel(dx, xr.grad) < 1e-6 and _rel(dgamma, gr.grad) < 1e-6
    # and through the autograd function the model uses
    xa = q.float().clone().requires_grad_()
    ga = gamma.float().clone().requires_grad_()
    Q.qk_rms_norm(xa, ga, 8.0).backward(dy.float())
    assert _rel(xa.grad, xr.grad) < 1e-6 and _rel(ga.grad, gr.grad) < 1e-6


def test_attention_layers_unchanged_without_their_keys():
    """The DiT's layers as before: no QK-norm parameters, the
    cross-attention's doubled scale (1 / head_dim)."""
    from topiaxl_torch.models.layers import CrossAttention, SelfAttention

    sa = SelfAttention(144, 2)
    assert not sa.qk_rms_norm and not hasattr(sa, "q_rms_norm")
    assert {n for n, _ in sa.named_parameters()} == {
        "qkv.weight", "qkv.bias", "proj.weight", "proj.bias"}
    assert CrossAttention(144, 32, 2).scale == 72 ** -1.0
    assert CrossAttention(1024, 1024, 16, scale=64 ** -0.5).scale == 0.125


def test_forward_and_loss_match_the_reference():
    m = _model()
    P = _trellis(m)
    b = _inputs()
    with torch.no_grad():
        got = m(b["x"], b["t"] * 1000, b["y"], b["drop"])
        y = torch.where(b["drop"][:, None, None], 0.0, b["y"])
        want = rflow.forward(P, b["x"], b["t"] * 1000, y, HEADS)
        assert got.shape == b["x"].shape
        assert _rel(got, want) < 2e-5
        loss = RectifiedFlow().training_losses(
            lambda x_t, t: m(x_t, t, b["y"], b["drop"]), b["x"], b["t"],
            b["noise"])
        ref = rflow.training_loss(P, b["x"], b["y"], b["t"], b["noise"],
                                  b["drop"], HEADS)
    assert _rel(loss["loss_total"], ref) < 2e-5
    assert torch.equal(loss["loss_total"], loss["loss_mse"])


def test_every_gradient_matches_the_reference():
    m = _model()
    P = _trellis(m)
    b = _inputs()
    loss = RectifiedFlow().training_losses(
        lambda x_t, t: m(x_t, t, b["y"], b["drop"]), b["x"], b["t"],
        b["noise"])["loss_total"].mean()
    loss.backward()
    total, grads = rflow.gradient(P, b, HEADS)
    assert abs(total - float(loss.detach())) < 2e-5 * abs(total)
    ref = S.from_trellis(grads)
    got = {k: p.grad for k, p in m.named_parameters()}
    assert set(got) == set(ref)
    top = max(float(g.abs().max()) for g in ref.values())
    for k, g in got.items():
        if k.endswith("cross_attn.to_k.bias"):
            assert float(g.abs().max()) < 1e-7 * top, k
            continue
        scale = float(ref[k].abs().max())
        assert scale > 0, k
        assert float((g - ref[k]).abs().max()) < 1e-4 * scale, k


def test_two_train_steps_match_the_reference_trainer():
    """``make_train_step`` with the flow objective, AdamW at a constant
    rate and clip 1, against the reference's gradient and AdamW, on the
    same batches (t, drop and noise given)."""
    from topiaxl_torch.pipelines import train as T

    m = _model().train()
    P = {k: v for k, v in _trellis(m).items() if k != "pos_emb"}
    P0 = {k: v.clone() for k, v in P.items()}
    p0 = {k: v.detach().clone() for k, v in m.named_parameters()}
    lr = 1e-4
    state = T.create_train_state(m)
    step = T.make_train_step(m, RectifiedFlow(), T.make_optimizer(
        lr=lr, grad_clip=1.0, schedule="constant"))
    adam = rtrain.AdamW(lr, 0, 2 ** 62, clip=1.0)
    for s in range(2):
        b = _inputs(seed=10 + s)
        metrics = step(state, b, 0)
        loss, grads = rflow.gradient(P, b, HEADS)
        adam.step(P, grads)
        assert abs(float(metrics["loss"]) - loss) < 2e-5 * loss
    ref = S.from_trellis({k: P[k] - P0[k] for k in P})
    for k, p in m.named_parameters():
        if k.endswith("cross_attn.to_k.bias"):
            continue
        moved = p.detach() - p0[k]
        assert _rel(moved, ref[k]) < 1e-3, k
        assert float(moved.abs().max()) > 0.5 * lr, k
    assert state.step == 2 and state.opt_state.count == 2


def test_the_objective_draws_and_drops():
    """Flow times logit-normal(1, 1); the noised input and the target as
    TRELLIS writes them; the config node; a dropped row sees zero
    conditioning; the step's own draws come from its generator when the
    batch gives none."""
    f = RectifiedFlow()
    t, w = f.sample_times(200_000, torch.Generator().manual_seed(0))
    assert torch.equal(w, torch.ones_like(t))
    assert 0 < float(t.min()) and float(t.max()) < 1
    z = torch.logit(t.double())
    assert abs(float(z.mean()) - 1.0) < 0.01 and abs(float(z.std()) - 1.0) < 0.01
    x0, eps = torch.randn(2, 3), torch.randn(2, 3)
    tt = torch.tensor([0.25, 0.5])
    s = f.sigma_min
    assert torch.allclose(f.noised(x0, tt, eps),
                          (1 - tt[:, None]) * x0 + (s + (1 - s) * tt[:, None]) * eps)
    assert torch.allclose(f.target(x0, eps), (1 - s) * eps - x0)
    with pytest.raises(ValueError, match="t_schedule"):
        from_config({"name": "rectified_flow",
                     "t_schedule": {"name": "uniform"}})
    assert from_config({"name": "rectified_flow", "sigma_min": 1e-5,
                        "t_schedule": {"name": "logit_normal", "mean": 1.0,
                                       "std": 1.0}}) == f

    m = _model(cond_drop_prob=0.1)
    b = _inputs()
    with torch.no_grad():
        dropped = m(b["x"], b["t"], b["y"], torch.tensor([True, True]))
        zeros = m(b["x"], b["t"], torch.zeros_like(b["y"]))
    assert torch.equal(dropped, zeros)
    mask = m.cond_drop_mask(100_000, torch.Generator().manual_seed(2))
    assert abs(float(mask.float().mean()) - 0.1) < 0.005

    from topiaxl_torch.pipelines import train as T

    step = T.make_train_step(m.train(), f, T.make_optimizer(schedule="constant"))
    state = T.create_train_state(m)
    metrics = step(state, {"x": b["x"], "y": b["y"]}, 5)
    assert math.isfinite(float(metrics["loss"]))
    with pytest.raises(ValueError, match="lsm"):
        T.make_train_step(m, f, T.make_optimizer(), timestep_sampler="lsm")


def test_loads_trellis_names_strictly():
    """A TRELLIS state_dict (``to_qkv``, ``to_out``, one ``to_kv``,
    ``mlp.mlp.*``, the ``pos_emb`` buffer) loads with ``strict=True`` into
    a fresh model and gives the same tensors; ``to_trellis`` writes it
    back; a wrong ``pos_emb`` or a missing key raises."""
    src = _model(seed=4)
    sd = _trellis(src)
    assert "blocks.1.cross_attn.to_kv.weight" in sd
    dst = _model(seed=5)
    dst.load_state_dict(sd, strict=True)
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    back = S.to_trellis(dst.state_dict())
    assert set(back) == set(sd) - {"pos_emb"}
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k
    bad = dict(sd, pos_emb=sd["pos_emb"] + 1)
    with pytest.raises(ValueError, match="pos_emb"):
        dst.load_state_dict(bad)
    with pytest.raises(RuntimeError, match="Missing key"):
        dst.load_state_dict({k: v for k, v in sd.items()
                             if not k.endswith("q_rms_norm.gamma")})


def test_registry_builds_from_trellis_json_keys():
    from topiaxl_torch import registry  # noqa: F401
    from topiaxl_torch.core.config import build

    node = dict(class_name="SparseStructureFlowModel", resolution=4,
                in_channels=8, out_channels=8, model_channels=256,
                cond_channels=32, num_blocks=2, num_head_channels=64,
                mlp_ratio=4, patch_size=1, pe_mode="ape", qk_rms_norm=True,
                use_fp16=True)
    m = build(node, param_dtype=torch.float32)
    assert m.dtype == torch.bfloat16 and len(m.blocks) == 2
    assert m.blocks[0].self_attn.qk_rms_norm
    assert m.blocks[0].self_attn.q_rms_norm.gamma.shape == (4, 64)
    assert torch.equal(m.blocks[0].self_attn.q_rms_norm.gamma,
                       torch.ones(4, 64))
    with pytest.raises(ValueError, match="pe_mode"):
        build(dict(node, pe_mode="rope"))


def test_cli_trains_the_flow_model(tmp_path):
    """``cli.train`` on the shipped config at a tiny size: two steps on the
    synthetic stream, the flow objective and a constant rate."""
    from topiaxl_torch.cli import train as cli

    out: list = []
    rc = cli.main(["configs/trellis_ss_flow.yml", "train.device=cpu",
                   "train.synthetic=true", "train.max_steps=2",
                   "train.batch_size=2", "train.cond_seq=8",
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
def test_qk_norm_kernels_match_the_twin_on_the_card():
    """At [8, 4096, 16, 64], q read in place from a fused qkv tensor: the
    forward within one bf16 rounding of the twin, dx within 2^-7 of its
    largest entry and dgamma within 1e-4 relative (f32 sums over 32768
    rows in another order); a planted fault (the gains left out of dx)
    lands above the bar; the launches count."""
    from topiaxl_torch.ops import _cuda

    dev = _card()
    g = torch.Generator(dev).manual_seed(0)
    qkv = torch.randn((8, 4096, 3, 16, 64), generator=g, device=dev).to(
        torch.bfloat16)
    gamma = 1 + 0.1 * torch.randn((16, 64), generator=g, device=dev)
    dy = torch.randn((8, 4096, 16, 64), generator=g, device=dev).to(
        torch.bfloat16)
    q = qkv.unbind(2)[0]
    before = dict(_cuda.launches)
    y = Q._forward(q, gamma, 8.0)
    dx, dgamma = Q._backward(q, dy, gamma, 8.0)
    torch.cuda.synchronize()
    assert _cuda.launches["qk_rmsnorm"] == before["qk_rmsnorm"] + 1
    assert _cuda.launches["qk_rmsnorm_bwd"] == before["qk_rmsnorm_bwd"] + 1
    y_ref = Q.qk_rms_norm_plain(q, gamma, 8.0)
    dx_ref, dg_ref = Q.qk_rms_norm_bwd_plain(q, dy, gamma, 8.0)
    assert float((y.float() - y_ref.float()).abs().max()) <= \
        2 ** -8 * float(y_ref.float().abs().max())
    bar = 2 ** -7 * float(dx_ref.float().abs().max())
    assert float((dx.float() - dx_ref.float()).abs().max()) <= bar
    assert _rel(dgamma, dg_ref) < 1e-4
    fault, _ = Q.qk_rms_norm_bwd_plain(q, dy, torch.ones_like(gamma), 8.0)
    assert float((fault.float() - dx_ref.float()).abs().max()) > bar


@pytest.mark.cuda
def test_one_block_forward_and_backward_match_the_reference_on_the_card():
    """One block at the published widths (1024, 16 heads of 64) on 4096
    tokens and 1374 conditioning tokens, batch 2, bf16 with f32 masters,
    against the reference's block in f32 (TF32 off)."""
    from portbench.reference import ops

    dev = _card()
    ops.no_tf32()
    m = _model(seed=7, dtype=torch.bfloat16, device=dev, model_channels=1024,
               cond_channels=1024, num_blocks=1, num_heads=16, resolution=16)
    P = {k: v.to(dev) for k, v in _trellis(m).items()}
    blk = m.blocks[0]
    g = torch.Generator(dev).manual_seed(8)
    x = torch.randn((2, 4096, 1024), generator=g, device=dev)
    y = torch.randn((2, 1374, 1024), generator=g, device=dev)
    t_emb = torch.randn((2, 1024), generator=g, device=dev)
    xb = x.to(torch.bfloat16).requires_grad_()
    out = blk(xb, y.to(torch.bfloat16), t_emb)
    w = torch.randn(out.shape, generator=g, device=dev)
    (out.float() * w).sum().backward()
    Pr = {k: v.clone().requires_grad_() for k, v in P.items()}
    xr = xb.detach().float().requires_grad_()
    ref = rflow.block(Pr, 0, xr, torch.nn.functional.silu(t_emb),
                      y.to(torch.bfloat16).float(), 16)
    (ref * w).sum().backward()
    top = float(ref.detach().abs().max())
    assert float((out.float() - ref.detach()).abs().max()) < 2e-2 * top
    assert float((xb.grad.float() - xr.grad).abs().max()) < \
        2e-2 * float(xr.grad.abs().max())
    got = S.to_trellis({"blocks.0." + k: p.grad
                        for k, p in blk.named_parameters()})
    for k, gr in got.items():
        r = Pr[k].grad
        assert float((gr.float() - r).abs().max()) < \
            2e-2 * float(r.abs().max()) + 1e-6, k


@pytest.mark.cuda
def test_one_step_launches_at_the_published_widths():
    """One training step of the 24-block model at batch 8: flash forward 48
    (24 self over 4096 keys, 24 cross over 1374), the two-pass backward
    pair 24 + 24 (4096 keys), the single pass 24 (1374 keys), the QK norm
    48 + 48, LN+modulate 24 and 48."""
    from topiaxl_torch.ops import _cuda
    from topiaxl_torch.pipelines import train as T

    dev = _card()
    m = S.SparseStructureFlowModel(param_dtype=torch.float32, device=dev,
                                   cond_drop_prob=0.1).train()
    g = torch.Generator(dev).manual_seed(9)
    batch = {"x": torch.randn((8, 8, 16, 16, 16), generator=g, device=dev),
             "y": torch.randn((8, 1374, 1024), generator=g, device=dev)}
    step = T.make_train_step(m, RectifiedFlow(),
                             T.make_optimizer(schedule="constant"))
    state = T.create_train_state(m)
    before = dict(_cuda.launches)
    metrics = step(state, batch, 0)
    torch.cuda.synchronize()
    assert math.isfinite(float(metrics["loss"]))
    diff = {k: _cuda.launches[k] - before[k] for k in before}
    assert diff == dict(
        {k: 0 for k in before}, flash_attn_fwd=48, flash_attn_bwd_dq=24,
        flash_attn_bwd_dkv=24, flash_attn_bwd=24, qk_rmsnorm=48,
        qk_rmsnorm_bwd=48, ln_modulate=24, ln_modulate_residual=48)
