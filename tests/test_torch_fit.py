"""PrimX fitting (``topiaxl_torch/models/primx.py:query(training=True)``,
``pipelines/fit.py``) against the JAX package on the CPU, f32, on the
same numpy-seeded inputs. The JAX fit step is composed from
``topiaxl``'s public functions as ``topiaxl/pipelines/fit.py:122-148``
composes it. Bars: the query and its gradients 1e-5 of max, the auto
scale 1e-6, five fit steps' parameters and losses 1e-4 of max."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_models import torch_threads  # noqa: F401
from topiaxl.models import primx as JPX
from topiaxl.pipelines import fit as jfit
from topiaxl.pipelines.losses import primsdf_fit_loss as jax_fit_loss
from topiaxl_torch.models import primx as PX
from topiaxl_torch.pipelines import fit as F


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def sphere_sdf(pts):
    return np.linalg.norm(pts, axis=-1) - 0.5


def sphere_tex(pts):
    return (0.5 + 0.4 * np.tanh(pts)).astype(np.float32)


def random_field(seed=0, N=24, S=4, P=200):
    rng = np.random.default_rng(seed)
    srt = np.concatenate([rng.uniform(0.25, 0.5, (N, 1)),
                          rng.uniform(-0.6, 0.6, (N, 3))], 1).astype("f")
    feat = rng.standard_normal((N, 6 * S**3)).astype("f")
    x = rng.uniform(-0.8, 0.8, (P, 3)).astype("f")
    # some points far out: covered by nothing
    x[:10] = rng.uniform(0.95, 1.0, (10, 3))
    return srt, feat, x


@pytest.mark.parametrize("training", [True, False])
def test_query_training_matches_jax(training):
    srt, feat, x = random_field()
    kw = dict(dim_feat=6, prim_shape=4, top_k=8, training=training)
    ref = JPX.query(JPX.PrimXParams(jnp.asarray(srt), jnp.asarray(feat)),
                    jnp.asarray(x), **kw)
    got = PX.query(PX.PrimXParams(torch.from_numpy(srt),
                                  torch.from_numpy(feat)),
                   torch.from_numpy(x), **kw)
    for k in ref:
        assert rel_err(got[k].numpy(), ref[k]) <= 1e-5, k
    # uncovered points: 0 when training, the fallback otherwise
    assert (got["sdf"][:10] == 0).all().item() == training


def test_query_training_gradients_match_jax():
    """d(sum(w * sdf) + sum(v * tex))/d(srt, feat) against ``jax.grad``:
    srt through the tent weights and coordinates, feat through the
    trilinear gather."""
    srt, feat, x = random_field(1)
    rng = np.random.default_rng(2)
    wa, wb = rng.standard_normal((200, 1)).astype("f"), \
        rng.standard_normal((200, 3)).astype("f")
    kw = dict(dim_feat=6, prim_shape=4, top_k=8, training=True)

    def jloss(s, f):
        out = JPX.query(JPX.PrimXParams(s, f), jnp.asarray(x), **kw)
        return jnp.sum(out["sdf"] * wa) + jnp.sum(out["feat"][:, 1:4] * wb)

    ref_s, ref_f = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(srt),
                                                  jnp.asarray(feat))
    s = torch.from_numpy(srt).requires_grad_()
    f = torch.from_numpy(feat).requires_grad_()
    out = PX.query(PX.PrimXParams(s, f), torch.from_numpy(x), **kw)
    ((out["sdf"] * torch.from_numpy(wa)).sum()
     + (out["feat"][:, 1:4] * torch.from_numpy(wb)).sum()).backward()
    assert np.abs(np.asarray(ref_s)).max() > 1e-2
    assert rel_err(s.grad.numpy(), ref_s) <= 1e-5
    assert rel_err(f.grad.numpy(), ref_f) <= 1e-5


def test_zeros_params_and_descriptor():
    p = PX.zeros_params(16, 6, 4)
    assert p.srt.shape == (16, 4) and p.feat.shape == (16, 6 * 64)
    assert not p.feat.any()
    d = PX.PrimX(num_prims=16, prim_shape=4)
    assert d.init_params().feat.shape == (16, 384)
    srt, feat, x = random_field(3, N=16)
    params = PX.PrimXParams(torch.from_numpy(srt), torch.from_numpy(feat))
    a = d.query(params, torch.from_numpy(x), training=True)["sdf"]
    b = PX.query(params, torch.from_numpy(x), prim_shape=4, training=True)["sdf"]
    assert torch.equal(a, b)
    assert PX.PrimX()._fields == JPX.PrimX()._fields
    assert tuple(PX.PrimX()) == tuple(JPX.PrimX())


def test_auto_scale_matches_jax():
    """JAX's init_prims subsampling exactly N surface points: the port's
    auto scale of its positions is JAX's scale; the port's own init from
    the same points places the same set with the same scale per point."""
    pts = np.random.default_rng(5).uniform(-0.9, 0.9, (64, 3)).astype("f")
    ref = jfit.init_prims(64, jax.random.PRNGKey(0), surface_points=pts)
    ref_srt = np.asarray(ref.srt)
    got = F.auto_scale(torch.from_numpy(ref_srt[:, 1:4]))
    np.testing.assert_allclose(got.numpy(), ref_srt[:, :1], atol=1e-6, rtol=0)

    mine = F.init_prims(64, torch.Generator().manual_seed(0),
                        surface_points=pts).srt.numpy()
    order = lambda a: a[np.lexsort(a[:, 1:4].T)]  # noqa: E731
    np.testing.assert_allclose(order(mine), order(ref_srt), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("sampling", ["uniform", "random"])
def test_init_prims_places_and_scales(sampling):
    """The jittered lattice stays within a quarter spacing of its nodes;
    any other sampling within [-0.9, 0.9]; no auto scale means
    ``init_scale``; the same generator seed places the same prims."""
    gen = lambda: torch.Generator().manual_seed(1)  # noqa: E731
    p = F.init_prims(27, gen(), init_sampling=sampling, prim_shape=4)
    assert torch.equal(p.srt, F.init_prims(27, gen(), init_sampling=sampling,
                                           prim_shape=4).srt)
    pos = p.srt[:, 1:4].numpy()
    if sampling == "uniform":
        lin = np.linspace(-0.9, 0.9, 3, dtype=np.float32)
        gz, gy, gx = np.meshgrid(lin, lin, lin, indexing="ij")
        nodes = np.stack([gx, gy, gz], -1).reshape(-1, 3)
        assert np.abs(pos - nodes).max() <= 0.25 * 0.9 + 1e-6
    else:
        assert np.abs(pos).max() <= 0.9
    ref = jfit.init_prims(27, jax.random.PRNGKey(0), init_sampling=sampling,
                          auto_scale_init=False, prim_shape=4)
    mine = F.init_prims(27, gen(), init_sampling=sampling,
                        auto_scale_init=False, prim_shape=4)
    np.testing.assert_array_equal(mine.srt[:, 0].numpy(),
                                  np.asarray(ref.srt[:, 0]))


def test_sample_batch_draws_as_jax():
    """The port's batches are the JAX host loop's (``fit.py:150-161``)."""
    cfg = F.FitConfig(batch_points=100)
    surf = np.random.default_rng(6).uniform(-1, 1, (50, 3)).astype("f")
    for pool in (surf, None):
        a, b = np.random.default_rng(0), np.random.default_rng(0)
        for _ in range(2):
            uni = b.uniform(-1, 1, (50, 3)).astype(np.float32)
            base = (pool[b.integers(0, len(pool), 50)] if pool is not None
                    else b.uniform(-0.8, 0.8, (50, 3)).astype(np.float32))
            near = base + b.normal(0, 0.05, (50, 3)).astype(np.float32)
            ref = np.concatenate([uni, near]).clip(-1, 1)
            np.testing.assert_array_equal(F.sample_batch(a, cfg, pool), ref)


def test_fit_steps_match_jax():
    """Five Adam steps across the shape -> texture switch (shape < 3 <=
    tex < 5) from the same initial params and batches: the JAX step
    composed as ``fit.py:122-148`` does against ``fit_step``."""
    cfg = F.FitConfig(prim_shape=4, batch_points=256, lr=2e-2,
                      shape_opt_steps=3, tex_opt_steps=5)
    assert tuple(F.FitConfig()) == tuple(jfit.FitConfig())
    assert F.FitConfig._fields == jfit.FitConfig._fields
    init = jfit.init_prims(27, jax.random.PRNGKey(0), prim_shape=4)
    weights = F.fit_weights(cfg, sphere_tex, None)
    assert weights == {"sdf_l1": 1.0, "rgb_l1": 1.0, "vol_sum": 1e-4}
    opt = optax.adam(cfg.lr)
    scale0 = init.srt[:, 0]
    lo, hi = jnp.maximum(scale0 * 0.5, 5e-3), jnp.minimum(scale0 * 3.0, 0.9)

    @jax.jit
    def jstep(params, opt_state, pts, sdf, tex, mat, it):
        def loss_fn(p):
            out = JPX.query(p, pts, dim_feat=6, prim_shape=4, training=True)
            preds = {"sdf": out["sdf"], "tex": out["feat"][:, 1:4],
                     "mat": out["feat"][:, 4:6],
                     "prim_scale": 1.0 / jnp.broadcast_to(
                         p.srt[:, 0:1], (p.srt.shape[0], 3))[None]}
            return jax_fit_loss({"sdf": sdf, "tex": tex, "mat": mat}, preds,
                                weights, it, shape_opt_steps=3,
                                tex_opt_steps=5)

        (loss, ld), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        params = params._replace(srt=params.srt.at[:, 0].set(
            jnp.clip(params.srt[:, 0], lo, hi)))
        return params, opt_state, loss

    params = PX.PrimXParams(torch.from_numpy(np.array(init.srt)).requires_grad_(),
                            torch.from_numpy(np.array(init.feat)).requires_grad_())
    optimizer = torch.optim.Adam(list(params), lr=cfg.lr)
    bounds = F.scale_bounds(params.srt[:, 0].detach().clone())
    jparams, jopt = init, opt.init(init)
    rng = np.random.default_rng(0)
    for it in range(cfg.tex_opt_steps):
        pts = F.sample_batch(rng, cfg, None)
        arrs = (pts, sphere_sdf(pts)[:, None].astype("f"), sphere_tex(pts),
                np.zeros((len(pts), 2), "f"))
        jparams, jopt, ref_loss = jstep(jparams, jopt,
                                        *map(jnp.asarray, arrs), it)
        loss, _ = F.fit_step(params, optimizer,
                             tuple(map(torch.from_numpy, arrs)), it, cfg,
                             weights, bounds)
        assert rel_err(loss.item(), ref_loss) <= 1e-4, it
    assert rel_err(params.srt.detach().numpy(), jparams.srt) <= 1e-4
    assert rel_err(params.feat.detach().numpy(), jparams.feat) <= 1e-4
    # the texture stage ran: the payload's colour moved
    assert np.abs(np.asarray(jparams.feat)[:, 64:256]).max() > 1e-3


def test_fit_reduces_sdf_error():
    """The port's counterpart of ``tests/test_fit.py``'s
    ``test_fit_reduces_sdf_error``: 27 prims of 4^3 voxels fitted to a
    sphere for 400 steps drive the mean |SDF error| at held-out points
    below half of the zero payload's."""
    cfg = F.FitConfig(batch_points=512, lr=2e-2, shape_opt_steps=400,
                      tex_opt_steps=401, prim_shape=4)
    params = F.fit_primx(sphere_sdf, torch.Generator().manual_seed(0),
                         num_prims=27, config=cfg)
    pts = np.random.default_rng(1).uniform(-0.7, 0.7, (512, 3)).astype("f")
    pred = PX.query(params, torch.from_numpy(pts), prim_shape=4,
                    training=True)["sdf"][:, 0].numpy()
    tgt = sphere_sdf(pts)
    assert np.abs(pred - tgt).mean() < 0.5 * np.abs(tgt).mean()
