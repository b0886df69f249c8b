"""The port's losses (``topiaxl_torch/pipelines/losses.py``) and the VAE
posterior against the JAX package on the CPU, f32, on the same
numpy-seeded inputs. The port's payloads are NCDHW, the JAX package's
NDHWC: each side gets its own layout of the same numbers. Bar: 1e-5
(absolute and relative), the sample with JAX's own draw fed in."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import torch_threads  # noqa: F401
from topiaxl.models.vae3d import DiagonalGaussian as JaxGaussian
from topiaxl.pipelines import losses as jl
from topiaxl_torch.models.vae3d import DiagonalGaussian
from topiaxl_torch.pipelines import losses as tl

TOL = 1e-5
WEIGHTS = {"recon": 1.0, "kl": 1e-3, "sdf": 2.0, "rgb": 0.5, "mat": 0.25}


def ncdhw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(np.moveaxis(a, -1, 1)))


def close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def _moments(seed=0, shape=(3, 4, 4, 4, 2)):
    """Posterior moments, channels-last; logvar pushed past both clips."""
    m = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    m[0, 0, 0, 0, 1] = 40.0
    m[1, 0, 0, 0, 1] = -45.0
    return m


def test_diagonal_gaussian_matches_jax():
    m = _moments()
    jp, tp = JaxGaussian(jnp.asarray(m)), DiagonalGaussian(ncdhw(m))
    close(tp.kl().numpy(), jp.kl())
    close(tp.mode().permute(0, 2, 3, 4, 1).numpy(), jp.mode())
    assert tp.logvar.max() == 20.0 and tp.logvar.min() == -30.0
    key = jax.random.PRNGKey(7)
    ref = jp.sample(key)
    eps = np.asarray(jax.random.normal(key, jp.mean.shape, jnp.float32))
    got = tp.sample(noise=ncdhw(eps))
    close(got.permute(0, 2, 3, 4, 1).numpy(), ref)
    close(tp.nll(got).numpy(), jp.nll(ref))
    # a draw from the generator: the same shape, repeatable by seed
    a = tp.sample(torch.Generator().manual_seed(1))
    b = tp.sample(torch.Generator().manual_seed(1))
    assert a.shape == tp.mean.shape and torch.equal(a, b)


@pytest.mark.parametrize("kind", ["l1", "sep_l1", "sep_l2", "dct"])
def test_vae_loss_matches_jax(kind):
    rng = np.random.default_rng(1)
    gt = rng.uniform(-1, 1, (2, 8, 8, 8, 6)).astype(np.float32)
    recon = (gt + 0.3 * rng.standard_normal(gt.shape)).astype(np.float32)
    m = _moments(2, (2, 4, 4, 4, 2))
    ref_total, ref = jl.vae_loss(jnp.asarray(gt), jnp.asarray(recon),
                                 JaxGaussian(jnp.asarray(m)), WEIGHTS, kind)
    got_total, got = tl.vae_loss(ncdhw(gt), ncdhw(recon),
                                 DiagonalGaussian(ncdhw(m)), WEIGHTS, kind)
    assert sorted(got) == sorted(ref)
    for k in ref:
        close(got[k].numpy(), ref[k])
    close(got_total.numpy(), ref_total)


def test_vae_loss_dct_depends_on_the_channels_last_order():
    """Flattening NCDHW as it lies gives another sequence and another
    loss: the port must move the channels last first."""
    rng = np.random.default_rng(3)
    gt = rng.uniform(-1, 1, (2, 8, 8, 8, 6)).astype(np.float32)
    recon = (gt + 0.3 * rng.standard_normal(gt.shape)).astype(np.float32)
    ref = float(jl.vae_loss(jnp.asarray(gt), jnp.asarray(recon),
                            JaxGaussian(jnp.asarray(_moments(4, (2, 4, 4, 4, 2)))),
                            WEIGHTS, "dct")[1]["loss_recon_dct_l1"])
    g, r = ncdhw(gt), ncdhw(recon)
    fg, fr = torch.fft.fft(g.reshape(2, -1)), torch.fft.fft(r.reshape(2, -1))
    wrong = float(((fg.real - fr.real).abs().mean()
                   + (fg.imag - fr.imag).abs().mean()) / 2)
    assert abs(wrong - ref) > 1e-3


def _fit_inputs(seed=5, P=64, N=16):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    inputs = {"sdf": f(P, 1), "tex": f(P, 3), "mat": f(P, 2)}
    preds = {"sdf": f(P, 1), "tex": f(P, 3), "mat": f(P, 2),
             "prim_scale": (0.5 + rng.uniform(size=(1, N, 3))).astype(
                 np.float32)}
    return inputs, preds


@pytest.mark.parametrize("it", [0, 9, 10, 25, 30, 31])
def test_primsdf_fit_loss_matches_jax(it):
    """Before, between and after the stages (shape < 10 <= tex < 30), with
    the iteration as an int and as a tensor."""
    inputs, preds = _fit_inputs()
    w = {"sdf_l1": 1.0, "rgb_l1": 0.7, "mat_l1": 0.3, "vol_sum": 1e-2}
    kw = dict(shape_opt_steps=10, tex_opt_steps=30)
    ref_total, ref = jl.primsdf_fit_loss(
        {k: jnp.asarray(v) for k, v in inputs.items()},
        {k: jnp.asarray(v) for k, v in preds.items()}, w, it, **kw)
    t_in = {k: torch.from_numpy(v) for k, v in inputs.items()}
    t_pr = {k: torch.from_numpy(v) for k, v in preds.items()}
    for iteration in (it, torch.tensor(it)):
        got_total, got = tl.primsdf_fit_loss(t_in, t_pr, w, iteration, **kw)
        assert sorted(got) == sorted(ref)
        for k in ref:
            close(torch.as_tensor(got[k]).numpy(), ref[k])
        close(torch.as_tensor(got_total).numpy(), ref_total)


def test_process_losses_matches_jax():
    d = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
         "b": np.float32(2.5)}
    ref = jl.process_losses({k: jnp.asarray(v) for k, v in d.items()})
    got = tl.process_losses({k: torch.as_tensor(v) for k, v in d.items()})
    for k in d:
        close(got[k].numpy(), ref[k])
    raw = tl.process_losses({"a": torch.from_numpy(d["a"])}, reduce=False)
    assert raw["a"].shape == (2, 3)
