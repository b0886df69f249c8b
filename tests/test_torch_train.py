"""topiaxl_torch's DiT trainer against the JAX package on the CPU, f32.

Inputs, noise, timesteps and cond-drop masks come from numpy and go to
both frameworks. Tolerances: the diffusion losses 1e-5 (the same f32
chain in another order), their gradients 1e-4 relative; the fused AdamW + EMA update 2e-5 relative and
2e-6 absolute over four steps (the JAX test's bar for its own fused
path); the whole tiny-DiT step's loss 1e-5 relative and every gradient
within 1e-4 of its tensor's largest entry (~100 f32 ops deep, summed in
another order; the backward runs the port's plain attention and LN
VJPs), the key-projection bias's (zero in exact arithmetic) within 1e-8
of the largest gradient.
"""

import json
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import randomize_, torch_threads, tree  # noqa: F401
from topiaxl.core import convert
from topiaxl_torch.core import weights

TOL = 1e-5


def _port_diffusion(**kw):
    from topiaxl_torch.diffusion import create_diffusion

    return create_diffusion(timestep_respacing=None, **kw)


def _jax_diffusion(**kw):
    from topiaxl.diffusion import create_diffusion

    return create_diffusion(timestep_respacing=None, **kw)


@pytest.mark.parametrize("param,learn_sigma,use_kl", [
    ("v", True, False), ("eps", True, False), ("xstart", False, False),
    ("v", True, True)])
def test_training_losses_and_grads_match_jax(param, learn_sigma, use_kl):
    """Per-example loss terms, and the gradient of their sum with respect
    to the model output (which sees the frozen_out detach of the VB
    term), against the JAX package on the same x, t and noise."""
    from topiaxl.diffusion import gaussian as jg
    from topiaxl_torch.diffusion import gaussian as tg

    kw = dict(noise_schedule="squaredcos_cap_v2", diffusion_steps=1000,
              parameterization=param, learn_sigma=learn_sigma, use_kl=use_kl)
    td, jd = _port_diffusion(**kw), _jax_diffusion(**kw)
    rng = np.random.default_rng(0)
    C = 6
    x = rng.uniform(-1, 1, (4, 10, C)).astype(np.float32)
    noise = rng.standard_normal((4, 10, C)).astype(np.float32)
    out = rng.standard_normal((4, 10, 2 * C if learn_sigma else C)).astype(
        np.float32) * 0.5
    t = np.array([0, 1, 537, 999])

    def jloss(o):
        terms = jg.training_losses(jd, lambda *_: o, jnp.asarray(x),
                                   jnp.asarray(t), None,
                                   noise=jnp.asarray(noise))
        return terms["loss_total"].sum(), terms

    (_, jterms), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(out))
    o = torch.from_numpy(out).requires_grad_()
    terms = tg.training_losses(td, lambda *_: o, torch.from_numpy(x),
                               torch.from_numpy(t), noise=torch.from_numpy(noise))
    terms["loss_total"].sum().backward()
    assert sorted(terms) == sorted(jterms)
    for name in terms:
        np.testing.assert_allclose(terms[name].detach().numpy(),
                                   np.asarray(jterms[name]), rtol=TOL,
                                   atol=TOL, err_msg=name)
    # the decoder NLL at t = 0 differentiates log(cdf+ - cdf-), which
    # amplifies f32 rounding in the output gradient to ~7e-5 relative
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(jgrad), rtol=1e-4,
                               atol=TOL)


def test_discretized_log_likelihood_matches_jax():
    """All three branches (x < -0.999, x > 0.999, between) at scales that
    keep the approximate CDF out of f32 saturation."""
    from topiaxl.diffusion import gaussian as jg
    from topiaxl_torch.diffusion import gaussian as tg

    rng = np.random.default_rng(6)
    x = rng.uniform(-2, 2, 4000).astype(np.float32)
    means = (x + 0.3 * rng.standard_normal(4000)).astype(np.float32)
    log_scales = np.full_like(x, -1.0)
    ref = jg.discretized_gaussian_log_likelihood(
        jnp.asarray(x), means=jnp.asarray(means),
        log_scales=jnp.asarray(log_scales))
    got = tg.discretized_gaussian_log_likelihood(
        torch.from_numpy(x), means=torch.from_numpy(means),
        log_scales=torch.from_numpy(log_scales))
    assert (x < -0.999).any() and (x > 0.999).any()
    # log(cdf+ - cdf-) cancels: one f32 ulp of tanh reads as ~5e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=TOL)


def test_q_sample_and_v_target_match_jax():
    from topiaxl.diffusion import gaussian as jg
    from topiaxl_torch.diffusion import gaussian as tg

    kw = dict(noise_schedule="squaredcos_cap_v2", diffusion_steps=1000,
              parameterization="v")
    td, jd = _port_diffusion(**kw), _jax_diffusion(**kw)
    rng = np.random.default_rng(1)
    x, n = (rng.standard_normal((3, 5, 4)).astype(np.float32) for _ in "xn")
    t = np.array([0, 400, 999])
    for tfn, jfn in ((lambda: tg.q_sample(td.tables, *map(torch.from_numpy,
                                                          (x, t, n))),
                      lambda: jg.q_sample(jd.tables, *map(jnp.asarray,
                                                          (x, t, n)))),
                     (lambda: tg.get_v(td.tables, *map(torch.from_numpy,
                                                       (x, n, t))),
                      lambda: jg.get_v(jd.tables, *map(jnp.asarray,
                                                       (x, n, t))))):
        np.testing.assert_allclose(tfn().numpy(), np.asarray(jfn()),
                                   rtol=TOL, atol=TOL)
    for a, b in zip(tg.q_mean_variance(td.tables, torch.from_numpy(x),
                                       torch.from_numpy(t)),
                    jg.q_mean_variance(jd.tables, jnp.asarray(x),
                                       jnp.asarray(t))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


def test_cosine_schedule_matches_jax():
    from topiaxl.pipelines.train import cosine_warmup_schedule as jsched
    from topiaxl_torch.pipelines.train import cosine_warmup_schedule

    ours, ref = cosine_warmup_schedule(1e-3, 10, 100), jsched(1e-3, 10, 100)
    for step in (0, 1, 5, 9, 10, 11, 55, 99, 100, 150):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6,
                                   atol=1e-12)


def test_fused_update_matches_jax():
    """Four steps of clip + AdamW + EMA (step 1 clips, weight decay on)
    against the JAX package's fused update: params, EMA, both moments,
    the count and the reported norm."""
    from topiaxl.pipelines.train import fused_adamw_ema_update as jupdate
    from topiaxl.pipelines.train import make_optimizer as jmake
    from topiaxl_torch.pipelines.train import (
        AdamState, fused_adamw_ema_update, make_optimizer)

    rng = np.random.default_rng(0)
    init = {"w": rng.standard_normal((32, 16)).astype("f"),
            "b": rng.standard_normal((16,)).astype("f")}
    kw = dict(lr=3e-3, warmup_iters=2, max_iters=50, grad_clip=1.0,
              weight_decay=0.01)
    jopt, spec = jmake(**kw), make_optimizer(**kw)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    jst, je = jopt.init(jp), dict(jp)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    ema = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    st = AdamState(0, {k: torch.zeros(v.shape) for k, v in init.items()},
                   {k: torch.zeros(v.shape) for k, v in init.items()})
    for i in range(4):
        scale = 10.0 if i == 1 else 0.05
        g = {k: (rng.standard_normal(v.shape) * scale).astype("f")
             for k, v in init.items()}
        jp, jst, je, jn = jupdate({k: jnp.asarray(v) for k, v in g.items()},
                                  jst, jp, je, jopt.spec)
        n = fused_adamw_ema_update({k: torch.from_numpy(v) for k, v in
                                    g.items()}, st, params, ema, spec)
        np.testing.assert_allclose(float(n), float(jn), rtol=1e-5)
        adam = jst[1][0]
        assert st.count == int(adam.count) == i + 1
        for ours, ref in ((params, jp), (ema, je), (st.mu, adam.mu),
                          (st.nu, adam.nu)):
            for k in init:
                np.testing.assert_allclose(ours[k].detach().numpy(),
                                           np.asarray(ref[k]), rtol=2e-5,
                                           atol=2e-6, err_msg=f"{k} step {i}")


def test_lsm_sampler_state_matches_jax():
    """The loss history (appends, then shift-appends once full, a repeated
    timestep in one batch) and the warmed-up weights against JAX."""
    from topiaxl.diffusion import timestep_sampler as js
    from topiaxl_torch.diffusion import timestep_sampler as ts

    T, hist = 4, 3
    rng = np.random.default_rng(2)
    jst = js.LossSecondMomentState.create(T, hist)
    st = ts.LossSecondMomentState.create(T, hist)
    for step in range(5):
        t = np.array([0, 1, 2, 3, step % 4, 0])
        loss = rng.uniform(0.1, 2.0, t.shape).astype(np.float32)
        jst = js.lsm_update(jst, jnp.asarray(t), jnp.asarray(loss))
        st = ts.lsm_update(st, torch.from_numpy(t), torch.from_numpy(loss))
        np.testing.assert_allclose(st.loss_history.numpy(),
                                   np.asarray(jst.loss_history), rtol=0,
                                   atol=0)
        np.testing.assert_array_equal(st.loss_counts.numpy(),
                                      np.asarray(jst.loss_counts))
        np.testing.assert_allclose(ts.lsm_weights(st).numpy(),
                                   np.asarray(js._lsm_weights(jst)),
                                   rtol=1e-6)
    assert bool((st.loss_counts == hist).all())   # the weights were live
    t, w = ts.lsm_sample(st, 64, torch.Generator().manual_seed(0))
    p = ts.lsm_weights(st)
    assert t.shape == (64,) and int(t.min()) >= 0 and int(t.max()) < T
    np.testing.assert_allclose(w.numpy(), (1.0 / (T * p[t])).numpy())
    tu, wu = ts.uniform_sample(10, 32, torch.Generator().manual_seed(0))
    assert tu.dtype == torch.long and 0 <= int(tu.min()) <= int(tu.max()) < 10
    assert torch.equal(wu, torch.ones(32))


def _tiny_pair(seq=520, cond_seq=530, depth=2, seed=0, remat=False):
    """A randomised port DiT (f32, cond-drop 0.1) and the same weights in
    the JAX DiT, both under the remat mode ``remat``; both attentions take
    the flash path (>= 512 keys)."""
    from topiaxl.models import DiT as JaxDiT
    from topiaxl_torch.models.dit import DiT

    kw = dict(seq_length=seq, in_channels=68, condition_channels=32,
              hidden_size=144, depth=depth, num_heads=2, remat=remat)
    dit = DiT(cond_drop_prob=0.1, dtype=torch.float32,
              param_dtype=torch.float32, **kw)
    sd = randomize_(dit, seed)
    jd = JaxDiT(cond_drop_prob=0.1, attn_proj_bias=True, dtype=jnp.float32,
                **kw)
    return dit, jd, tree(convert.convert_dit(sd, depth=depth))


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_whole_train_step_loss_and_grads_match_jax(grad_accum):
    """The v-pred MSE + VB loss of one step and the gradient of every
    parameter, port (``accumulate_gradients``: plain attention and LN
    backward through the autograd functions) against jax.value_and_grad
    of the JAX loss with the same drop mask and noise, its gradient tree
    mapped by dit_from_jax. With ``grad_accum=1`` the dropped row takes
    the null embedding inside the gradient, as the JAX single pass does;
    with ``grad_accum=2`` it takes it outside, as the JAX accumulation
    path does (``topiaxl/pipelines/train.py:210-214``): there the null
    embedding's gradient is zero on both sides, and the microbatch
    gradients are summed and divided by 2."""
    _train_step_vs_jax(grad_accum, remat=False)


def test_remat_step_matches_plain_and_jax():
    """``remat=True`` recomputes each block in the backward (its two
    attentions run forward again): the same loss and gradients as the
    plain step, to f32 summation order, and JAX's within the bars
    above."""
    loss, grads = _train_step_vs_jax(1, remat=True)
    loss0, grads0 = _train_step_vs_jax(1, remat=False)
    np.testing.assert_allclose(loss, loss0, rtol=1e-6)
    gmax = max(g.abs().max().item() for g in grads0.values())
    for name, g in grads.items():
        torch.testing.assert_close(g, grads0[name], rtol=1e-5,
                                   atol=1e-6 * gmax, msg=name)


def test_gradient_checkpointing_reaches_remat(tmp_path, monkeypatch):
    """The reference's ``gradient_checkpointing: true`` builds the DiT with
    ``remat=True`` (``topiaxl/registry.py:make_dit``), and the trainer then
    runs every block under the checkpoint, with the plain run's losses."""
    from topiaxl_torch import registry  # noqa: F401
    from topiaxl_torch.cli.train import main
    from topiaxl_torch.core.attrdict import AttrDict
    from topiaxl_torch.core.config import build
    from topiaxl_torch.models import dit as dit_module

    small = dict(class_name="topiaxl.DiT", seq_length=8, in_channels=4,
                 condition_channels=6, hidden_size=16, depth=2, num_heads=2,
                 dtype="fp32", precision="bf16")
    assert build(AttrDict(small, gradient_checkpointing=True)).remat is True
    assert build(AttrDict(small)).remat is False
    assert build(AttrDict(small, remat="dots")).remat == "dots"
    with pytest.raises(ValueError, match="'dots'"):
        build(AttrDict(small, remat="everything"))

    calls = []
    real = dit_module.checkpoint
    monkeypatch.setattr(dit_module, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    runs = {}
    for tag, extra in (("plain", []),
                       ("remat", ["model.generator.gradient_checkpointing=true"])):
        recs: list = []
        os.makedirs(tmp_path / tag)
        assert main([_tiny_train_config(tmp_path / tag, 2), *extra],
                    metrics_out=recs) == 0
        runs[tag] = [r["loss"] for r in recs]
    assert len(calls) == 2   # one block, two steps: remat run only
    np.testing.assert_allclose(runs["remat"], runs["plain"], rtol=1e-6)


def _train_step_vs_jax(grad_accum: int, remat: bool | str):
    """One step of the tiny DiT, port against JAX (the test above), both
    under the remat mode ``remat``; returns the port's loss and
    gradients."""
    from topiaxl.diffusion import gaussian as jg
    from topiaxl_torch.ops import flash_attention as fa
    from topiaxl_torch.pipelines.train import accumulate_gradients

    dit, jd, params = _tiny_pair(remat=remat)
    kw = dict(noise_schedule="squaredcos_cap_v2", diffusion_steps=1000,
              parameterization="v")
    tdiff, jdiff = _port_diffusion(**kw), _jax_diffusion(**kw)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 520, 68)).astype(np.float32)
    y = rng.standard_normal((2, 530, 32)).astype(np.float32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    # t = 0's decoder NLL on N(0, 1) tokens saturates the approximate
    # normal CDF, where XLA's f32 tanh reaches 1.0 an ulp before
    # PyTorch's and log(1 - cdf) turns that ulp into a different clip; the
    # branch is held against JAX outside saturation below
    t = np.array([1, 537])
    drop = np.array([True, False])
    weights_ = np.array([1.0, 0.5], np.float32)

    def dropped(p):
        null = p["params"]["null_cond_embedding"][None, None, :]
        return jnp.where(jnp.asarray(drop)[:, None, None], null, jnp.asarray(y))

    def jloss(p, sl, yd=None):
        yd = dropped(p)[sl] if yd is None else yd[sl]
        terms = jg.training_losses(
            jdiff, lambda x_t, t_o: jd.apply(p, x_t, t_o, yd),
            jnp.asarray(x[sl]), jnp.asarray(t[sl]), None,
            noise=jnp.asarray(noise[sl]))
        return jnp.mean(terms["loss_total"] * jnp.asarray(weights_[sl]))

    if grad_accum == 1:
        jl, jgrads = jax.value_and_grad(jloss)(params, slice(None))
    else:   # the accumulation path: drop outside the gradient, then sum
        yd = dropped(params)
        parts = [jax.value_and_grad(jloss)(params, slice(i, i + 1), yd)
                 for i in range(2)]
        jl = (parts[0][0] + parts[1][0]) / 2
        jgrads = jax.tree.map(lambda a, b: (a + b) / 2, parts[0][1],
                              parts[1][1])
    calls = []
    real = fa._FlashAttention.apply

    def counting(*a):
        calls.append(a[0].shape)
        return real(*a)

    fa._FlashAttention.apply = counting
    try:
        loss, _ = accumulate_gradients(
            dit, tdiff, *map(torch.from_numpy, (x, y, t, weights_, noise,
                                                drop)), grad_accum)
    finally:
        fa._FlashAttention.apply = real
    # self + cross in each of the two blocks, per microbatch; remat runs
    # them again in the backward (a policy that keeps the flash outputs
    # enters the Function again but not its kernel, test_torch_remat.py)
    assert len(calls) == 4 * grad_accum * (2 if remat else 1)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=TOL)
    ref = weights.dit_from_jax(jax.tree.map(np.asarray, jgrads))
    got = {n: (torch.zeros_like(p) if p.grad is None else p.grad / grad_accum)
           for n, p in dit.named_parameters()}
    assert sorted(got) == sorted(ref)
    gmax = max(float(np.abs(r.numpy()).max()) for r in ref.values())
    for name, g in got.items():
        r = ref[name].numpy()
        if name == "null_cond_embedding" and grad_accum > 1:
            assert not np.abs(r).any() and not g.abs().any(), name
            continue
        if name.endswith("crossattn.to_k.bias"):
            # zero in exact arithmetic: the softmax ignores a shift that
            # the bias adds to every logit of a row
            assert np.abs(g.numpy()).max() <= 1e-8 * gmax, name
            continue
        assert np.abs(r).max() > 1e-4 * gmax, name   # not vacuous
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max(), err_msg=name)
    return loss.item(), got


def test_dit_from_jax_takes_scan_layout_and_moment_trees():
    """dit_from_jax maps the scan_blocks layout as the unrolled one, and
    an optax Adam moment tree the same way as the parameters; a stacked
    checkpoint loads into the port's ``scan_blocks`` DiT and gives JAX's
    scanned forward."""
    import optax

    from topiaxl.models import DiT as JaxDiT
    from topiaxl.models.dit import stack_block_params

    jd = JaxDiT(seq_length=8, in_channels=4, condition_channels=6,
                hidden_size=16, depth=3, num_heads=2, dtype=jnp.float32)
    params = jd.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 4)),
                     jnp.zeros((1,), jnp.int32), jnp.zeros((1, 3, 6)))
    params = jax.tree.map(
        lambda a: a + jax.random.normal(jax.random.PRNGKey(1), a.shape),
        params)
    flat = weights.dit_from_jax(jax.tree.map(np.asarray, params))
    stacked = weights.dit_from_jax(
        jax.tree.map(np.asarray, stack_block_params(params)))
    assert sorted(flat) == sorted(stacked)
    assert any(k.startswith("blocks.2.") for k in flat)
    for k in flat:
        assert torch.equal(flat[k], stacked[k]), k
    mu = optax.adam(1e-3).init(params)[0].mu
    mapped = weights.dit_from_jax(jax.tree.map(np.asarray, mu))
    assert sorted(mapped) == sorted(flat)
    assert all(v.shape == flat[k].shape for k, v in mapped.items())
    # the stacked checkpoint loads, strictly, into the DiT that the
    # registry builds for scan_blocks: true, which computes JAX's scanned
    # forward: within 1e-5 of the largest output (these N(0, 1)-perturbed
    # weights give outputs in the hundreds, so f32 summation order moves
    # single entries by ~1e-5 relative)
    from topiaxl_torch import registry  # noqa: F401
    from topiaxl_torch.core.attrdict import AttrDict
    from topiaxl_torch.core.config import build

    dit = build(AttrDict(class_name="topiaxl.DiT", seq_length=8,
                         in_channels=4, condition_channels=6, hidden_size=16,
                         depth=3, num_heads=2, attn_proj_bias=True,
                         dtype="fp32", scan_blocks=True)).eval()
    dit.load_state_dict(stacked)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 4)).astype(np.float32)
    y = rng.standard_normal((2, 3, 6)).astype(np.float32)
    t = np.array([3, 7])
    ref = jd.clone(scan_blocks=True).apply(stack_block_params(params), x, t, y)
    with torch.no_grad():
        out = dit(*map(torch.from_numpy, (x, t, y)))
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def _tiny_fit_setup(cond_drop_prob=0.1):
    from topiaxl_torch.models.dit import DiT

    model = DiT(seq_length=8, in_channels=4, condition_channels=6,
                hidden_size=16, depth=1, num_heads=2,
                cond_drop_prob=cond_drop_prob,
                learn_sigma=False, dtype=torch.float32,
                param_dtype=torch.float32, device="cpu",
                generator=torch.Generator().manual_seed(0))
    diffusion = _port_diffusion(noise_schedule="linear",
                                parameterization="xstart", diffusion_steps=1,
                                learn_sigma=False)
    return model, diffusion


def test_train_step_decreases_loss():
    """tests/test_train.py's fixed batch: 200 steps must halve the MSE
    (xstart on a one-step chain, so the target is the batch itself)."""
    from topiaxl_torch.pipelines.train import (
        create_train_state, make_optimizer, make_train_step)

    model, diffusion = _tiny_fit_setup()
    state = create_train_state(model)
    step = make_train_step(model, diffusion,
                           make_optimizer(lr=1e-2, warmup_iters=1,
                                          max_iters=100000))
    rng = np.random.default_rng(0)
    batch = {"x": torch.from_numpy(
        rng.standard_normal((4, 8, 4)).astype("f")) * 0.5,
        "y": torch.from_numpy(rng.standard_normal((4, 3, 6)).astype("f"))}
    mse = [float(step(state, batch, 42)["loss_mse"]) for _ in range(200)]
    assert state.step == state.opt_state.count == 200
    assert np.isfinite(mse).all()
    assert np.mean(mse[-20:]) < 0.5 * np.mean(mse[:10]), (
        np.mean(mse[:10]), np.mean(mse[-20:]))


def test_ema_tracks_params_and_accumulation_matches():
    """EMA with decay 0.5 is the mean of old and new weights; two
    microbatches give the step that one batch gives (same draws). The
    model drops no conditioning: a dropped row's null embedding takes a
    gradient in the single pass and none under accumulation, as in the
    JAX package (the test above holds that against JAX)."""
    from topiaxl_torch.pipelines.train import (
        create_train_state, make_optimizer, make_train_step)

    rng = np.random.default_rng(4)
    batch = {"x": torch.from_numpy(rng.standard_normal((4, 8, 4)).astype("f")),
             "y": torch.from_numpy(rng.standard_normal((4, 3, 6)).astype("f"))}
    after = []
    for accum in (1, 2):
        model, diffusion = _tiny_fit_setup(cond_drop_prob=0.0)
        with torch.no_grad():          # leave the zero-init identity
            for p in model.parameters():
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator(
                ).manual_seed(p.numel())))
        state = create_train_state(model)
        old = {n: p.detach().clone() for n, p in model.named_parameters()}
        step = make_train_step(model, diffusion,
                               make_optimizer(lr=1e-2, warmup_iters=1,
                                              max_iters=100),
                               ema_decay=0.5, grad_accum=accum)
        m = step(state, batch, 7)
        assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
        for n, p in model.named_parameters():
            torch.testing.assert_close(state.ema_params[n],
                                       0.5 * old[n] + 0.5 * p.detach())
        after.append({n: p.detach().clone() for n, p in
                      model.named_parameters()})
    for n in after[0]:
        torch.testing.assert_close(after[1][n], after[0][n], rtol=1e-5,
                                   atol=1e-6)


def test_checkpoint_manager_keeps_newest(tmp_path):
    from topiaxl_torch.core.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    for step in (1, 5, 12):
        mgr.save(step, {"step": step, "w": torch.full((3,), float(step))})
    assert mgr.steps() == [5, 12] and mgr.latest_step() == 12
    sd = mgr.restore()
    assert sd["step"] == 12 and torch.equal(sd["w"], torch.full((3,), 12.0))
    assert mgr.restore(5)["step"] == 5


def test_token_shards_and_prefetch(tmp_path):
    from topiaxl_torch.pipelines.data import (
        TokenShardDataset, prefetch_to_device, synthetic_batches)

    rng = np.random.default_rng(5)
    for i in range(2):
        np.savez(tmp_path / f"shard{i}.npz",
                 x=rng.standard_normal((5, 8, 4)).astype("f"),
                 y=rng.standard_normal((5, 3, 6)).astype("f"))
    ds = TokenShardDataset(str(tmp_path / "shard*.npz"), batch_size=3)
    assert len(ds) == 10
    epoch = [b["x"] for b in ds.epoch(0)]
    assert len(epoch) == 3 and all(x.shape == (3, 8, 4) for x in epoch)
    again = [b["x"] for b in ds.epoch(0)]
    assert all(np.array_equal(a, b) for a, b in zip(epoch, again))
    halves = [TokenShardDataset(str(tmp_path / "shard*.npz"), 1, host_id=h,
                                host_count=2) for h in (0, 1)]
    rows = [np.concatenate([b["x"] for b in d.epoch(0)]) for d in halves]
    assert rows[0].shape[0] == rows[1].shape[0] == 5
    out = list(prefetch_to_device(ds.epoch(1), "cpu"))
    assert len(out) == 3 and isinstance(out[0]["x"], torch.Tensor)
    syn = next(synthetic_batches(2, shape=(8, 4), cond_seq=3, cond_ch=6))
    assert syn["x"].shape == (2, 8, 4) and syn["y"].shape == (2, 3, 6)


def _tiny_train_config(tmp_path, max_steps):
    cfg = tmp_path / "tiny_train.yml"
    cfg.write_text(textwrap.dedent(f"""
        root_data_dir: {tmp_path}/runs
        global_seed: 3
        model:
          num_prims: 8
          generator:
            class_name: topiaxl.DiT
            seq_length: ${{model.num_prims}}
            in_channels: 4
            condition_channels: 6
            hidden_size: 16
            depth: 1
            num_heads: 2
            attn_proj_bias: true
            cond_drop_prob: 0.1
        diffusion:
          noise_schedule: squaredcos_cap_v2
          diffusion_steps: 50
          parameterization: v
        optimizer:
          lr: 0.001
          weight_decay: 0
        scheduler:
          warmup_iters: 2
          max_iters: 100
        train:
          device: cpu
          synthetic: true
          cond_seq: 3
          batch_size: 2
          max_steps: {max_steps}
          log_every_n_steps: 1
          ckpt_every_n_steps: 2
          keep_ckpts: 2
        tag: tiny
        output_dir: ${{root_data_dir}}/train/${{tag}}
    """))
    return str(cfg)


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    from topiaxl_torch.cli.train import main

    recs: list = []
    assert main([_tiny_train_config(tmp_path, 3)], metrics_out=recs) == 0
    out = tmp_path / "runs" / "train" / "tiny" / "train"
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert all(np.isfinite([r["loss"], r["grad_norm"], r["loss_vb"]]).all()
               for r in recs)
    ckpts = sorted(os.listdir(out / "ckpts"))
    assert ckpts == ["step_000000002.pt", "step_000000003.pt"]
    # a second run with a higher cap resumes from step 3
    assert main([_tiny_train_config(tmp_path, 5)], metrics_out=recs) == 0
    assert [r["step"] for r in recs] == [1, 2, 3, 4, 5]
    lines = [json.loads(s) for s in (out / "metrics.jsonl").read_text()
             .splitlines()]
    assert [d["step"] for d in lines] == [1, 2, 3, 4, 5]
    state = torch.load(out / "ckpts" / "step_000000005.pt", weights_only=True)
    assert state["step"] == 5 and state["opt"]["count"] == 5
    assert sorted(os.listdir(out / "ckpts")) == ["step_000000004.pt",
                                                 "step_000000005.pt"]


def test_cli_refuses_what_is_not_ported(tmp_path):
    """``quant`` is inference-only, as in JAX's CLI; remat policies and
    ``scan_blocks`` train (``test_cli_takes_remat_policies_and_scan_blocks``)."""
    from topiaxl_torch.cli.train import main

    cfg = _tiny_train_config(tmp_path, 1)
    with pytest.raises(ValueError, match="quant"):
        main([cfg, "model.generator.quant=true"])
    assert main([]) == 1


def test_cli_takes_remat_policies_and_scan_blocks(tmp_path):
    """``model.generator.remat=<policy>`` and ``scan_blocks=true`` train,
    two steps each, with the plain run's losses and grad norms
    (``scan_blocks`` builds the unrolled blocks: the same math)."""
    from topiaxl_torch.cli.train import main

    runs = {}
    for tag, extra in (("plain", []),
                       ("flash", ["model.generator.remat=flash"]),
                       ("dots_plus", ["model.generator.remat=dots_plus"]),
                       ("scan", ["model.generator.scan_blocks=true"])):
        recs: list = []
        os.makedirs(tmp_path / tag)
        assert main([_tiny_train_config(tmp_path / tag, 2), *extra],
                    metrics_out=recs) == 0
        runs[tag] = [(r["loss"], r["grad_norm"]) for r in recs]
    assert len(runs["plain"]) == 2
    for tag in ("flash", "dots_plus", "scan"):
        np.testing.assert_allclose(runs[tag], runs["plain"], rtol=1e-6,
                                   err_msg=tag)


def test_cli_checkpoints_and_exits_on_sigterm(tmp_path):
    """SIGTERM during step 2 of 5: the step finishes, a checkpoint of step
    2 is written and the run exits 0; the handlers are restored."""
    import signal

    from topiaxl_torch.cli.train import main

    class KillAtStep2(list):
        def append(self, rec):
            super().append(rec)
            if rec["step"] == 2:
                os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    recs = KillAtStep2()
    assert main([_tiny_train_config(tmp_path, 5),
                 "train.ckpt_every_n_steps=100"], metrics_out=recs) == 0
    assert [r["step"] for r in recs] == [1, 2]
    out = tmp_path / "runs" / "train" / "tiny" / "train" / "ckpts"
    assert sorted(os.listdir(out)) == ["step_000000002.pt"]
    assert signal.getsignal(signal.SIGTERM) is before
