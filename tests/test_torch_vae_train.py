"""The VAE's forward, loss, gradients and train step
(``topiaxl_torch/models/vae3d.py``, ``pipelines/train_vae.py``) against the
JAX package on the CPU, f32, at widths (8, 16). One randomised state_dict
feeds both (``test_torch_models.tiny_vae``); the posterior's noise is
JAX's own draw, fed to the port. Gradients come back to the port's names
through ``core/weights.py:vae_from_jax``. Bars: 1e-4 of each tensor's
max |JAX| for outputs, gradients and the Adam step's parameters; a
gradient that is zero in exact arithmetic (``vanishing``) within 1e-4 of
the largest one."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_models import tiny_vae, torch_threads  # noqa: F401
from topiaxl.models import VAE3D as JaxVAE
from topiaxl.pipelines.losses import vae_loss as jax_vae_loss
from topiaxl.pipelines.train_vae import (
    create_vae_train_state as jax_create_state)
from topiaxl.pipelines.train_vae import make_vae_train_step as jax_make_step
from topiaxl_torch.core.weights import vae_from_jax
from topiaxl_torch.pipelines.train_vae import (create_vae_train_state,
                                               make_vae_train_step)

REL = 1e-4
WEIGHTS = {"sdf": 1.0, "rgb": 1.0, "mat": 1.0, "kl": 1e-3}


def jax_vae():
    return JaxVAE(down_channels=(8, 16), up_channels=(16, 8),
                  dtype=jnp.float32)


def ncdhw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.moveaxis(np.asarray(a), -1, 1)))


def rel_close(got, ref, what=""):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(got - ref).max() / scale
    assert err <= REL, f"{what}: {err:.3e} of max {scale:.3e}"


def vanishing(grads: dict) -> set:
    """Parameters whose gradient is zero in exact arithmetic and rounding
    noise in f32 (below 1e-6 of the largest): at these widths every
    GroupNorm has one channel a group, and the encoder's and the decoder's
    norm_out remove any per-channel constant, so the biases that only add
    one before them (convs, the attention's proj) get none."""
    top = max(g.abs().max().item() for g in grads.values())
    return {n for n, g in grads.items() if g.abs().max().item() <= 1e-6 * top}


def payload(seed, B=2):
    return np.random.default_rng(seed).uniform(
        -1, 1, (B, 8, 8, 8, 6)).astype(np.float32)


def test_vae_forward_mode_matches_jax():
    vae, params = tiny_vae(seed=10)
    x = payload(11)
    recon, post = jax_vae().apply(params, jnp.asarray(x), None, sample=False)
    with torch.no_grad():
        got, got_post = vae(ncdhw(x), sample=False)
    rel_close(got.permute(0, 2, 3, 4, 1).numpy(), recon, "recon")
    rel_close(got_post.kl().numpy(), post.kl(), "kl")
    rel_close(got_post.mode().permute(0, 2, 3, 4, 1).numpy(), post.mode(),
              "mode")


@pytest.mark.parametrize("kind", ["sep_l1", "dct"])
def test_vae_loss_and_gradients_match_jax(kind):
    """Through a posterior sample (JAX's draw): the loss and every
    parameter's gradient against ``jax.value_and_grad``."""
    vae, params = tiny_vae(seed=12)
    jv = jax_vae()
    x = payload(13)
    key = jax.random.PRNGKey(14)
    w = dict(WEIGHTS, recon=1.0)

    def loss_fn(p):
        recon, post = jv.apply(p, jnp.asarray(x), key)
        return jax_vae_loss(jnp.asarray(x), recon, post, w, kind)

    (ref_loss, ref_ld), ref_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    mean_shape = (x.shape[0], 4, 4, 4, 1)
    eps = ncdhw(jax.random.normal(key, mean_shape, jnp.float32))

    from topiaxl_torch.pipelines.losses import vae_loss

    xt = ncdhw(x)
    post = vae.encode(xt)
    loss, ld = vae_loss(xt, vae.decode(post.sample(noise=eps)), post, w, kind)
    loss.backward()
    rel_close(loss.item(), ref_loss, "loss")
    for k in ref_ld:
        rel_close(ld[k].item(), ref_ld[k], k)
    ref_sd = vae_from_jax(ref_grads)
    got = dict(vae.named_parameters())
    assert sorted(ref_sd) == sorted(got)
    top = max(g.abs().max().item() for g in ref_sd.values())
    noise = vanishing(ref_sd)
    assert "encoder.down_blocks.0.nets.0.conv1.bias" in noise
    for name, g in ref_sd.items():
        if name in noise:
            assert got[name].grad.abs().max().item() <= REL * top, name
        else:
            rel_close(got[name].grad.numpy(), g.numpy(), name)


def test_vae_train_step_matches_optax_adam():
    """One step of each package's trainer (Adam, lr 1e-3): metrics and
    the updated parameters; the port's step takes the JAX step's draw
    (``fold_in(key, 0)``) as ``batch['noise']``."""
    vae, params = tiny_vae(seed=15)
    jv = jax_vae()
    x = payload(16, B=3)
    key = jax.random.PRNGKey(17)
    opt = optax.adam(1e-3)
    jstep = jax.jit(jax_make_step(jv, opt, weights=WEIGHTS))
    jstate, ref = jstep(jax_create_state(params, opt), {"gt": jnp.asarray(x)},
                        key)
    eps = jax.random.normal(jax.random.fold_in(key, 0), (3, 4, 4, 4, 1),
                            jnp.float32)

    state = create_vae_train_state(vae, torch.optim.Adam(vae.parameters(),
                                                         lr=1e-3))
    step = make_vae_train_step(vae, weights=WEIGHTS)
    got = step(state, {"gt": ncdhw(x), "noise": ncdhw(eps)}, seed=0)
    assert state.step == 1 and int(jstate.step) == 1
    assert sorted(got) == sorted(ref)
    for k in ref:
        rel_close(got[k].item(), ref[k], k)
    # Adam moves a parameter whose gradient is rounding noise by up to lr
    # either way: those are held to that, the rest to the bar
    def loss_fn(p):
        recon, post = jv.apply(p, jnp.asarray(x), jax.random.fold_in(key, 0))
        return jax_vae_loss(jnp.asarray(x), recon, post, WEIGHTS, "sep_l1")[0]

    noise = vanishing(vae_from_jax(jax.grad(loss_fn)(params)))
    old, new = vae_from_jax(params), vae_from_jax(jstate.params)
    for name, p in vae.named_parameters():
        if name in noise:
            assert (p.detach() - old[name]).abs().max().item() <= 1.001e-3
        else:
            rel_close(p.detach().numpy(), new[name].numpy(), name)


def test_vae_train_step_draws_from_seed_and_step():
    """Without ``batch['noise']`` the draw comes from (seed, step): two
    fresh states at the same seed take the same step, another seed
    another."""
    x = ncdhw(payload(18))
    runs = []
    for seed in (3, 3, 4):
        vae, _ = tiny_vae(seed=19)
        state = create_vae_train_state(
            vae, torch.optim.Adam(vae.parameters(), lr=1e-3))
        runs.append(make_vae_train_step(vae)(state, {"gt": x}, seed)
                    ["loss_total"].item())
    assert runs[0] == runs[1] and runs[0] != runs[2]


def test_f32_master_vae_loads_jax_weights_and_computes_in_bf16():
    """``vae_from_jax`` loads into a VAE holding f32 masters and computing
    in bf16; its decode is the f32 VAE's within bf16 rounding, and the
    masters take f32 gradients."""
    from topiaxl_torch.models.vae3d import VAE3D

    ref, params = tiny_vae(seed=20)
    mixed = VAE3D(down_channels=(8, 16), up_channels=(16, 8),
                  dtype=torch.bfloat16, param_dtype=torch.float32)
    mixed.load_state_dict(vae_from_jax(params))
    assert all(p.dtype == torch.float32 for p in mixed.parameters())
    z = torch.from_numpy(np.random.default_rng(21).standard_normal(
        (2, 1, 4, 4, 4)).astype(np.float32))
    with torch.no_grad():
        a, b = mixed.decode(z), ref.decode(z)
    assert ((a - b).abs().max() / b.abs().max()).item() < 3e-2
    recon, post = mixed(ncdhw(payload(22)), torch.Generator().manual_seed(0))
    (recon.abs().mean() + post.kl().mean()).backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in mixed.parameters())


def test_vae_train_step_learns():
    """The port's counterpart of ``tests/test_meshsdf_objio.py``'s
    ``test_vae_train_step_learns`` (Adam 3e-3, 40 steps on four payloads
    in [-0.5, 0.5], layers_per_block 1): the mean of the last five losses
    below 0.7x that of the first five."""
    from topiaxl_torch.models.vae3d import VAE3D

    vae = VAE3D(down_channels=(8, 16), up_channels=(16, 8),
                layers_per_block=1, dtype=torch.float32,
                generator=torch.Generator().manual_seed(0))
    state = create_vae_train_state(
        vae, torch.optim.Adam(vae.parameters(), lr=3e-3))
    step = make_vae_train_step(vae)
    gt = ncdhw(np.random.default_rng(0).uniform(
        -0.5, 0.5, (4, 8, 8, 8, 6)).astype(np.float32))
    losses = [step(state, {"gt": gt}, 2)["loss_total"].item()
              for _ in range(40)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < 0.7 * np.mean(losses[:5])
