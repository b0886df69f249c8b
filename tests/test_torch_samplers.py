"""The port's ancestral and DPM-Solver++(2M) chains against the JAX
package's (``topiaxl/diffusion/gaussian.py``) on the CPU, f32, and the
CLI's ``inference.sampler``. Inputs and the ancestral chain's per-step
noise come from numpy or from JAX's own keys, handed to both sides.
Bar: atol 5e-5, rtol 1e-3, the DDIM chain's."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import tiny_dit, torch_threads  # noqa: F401
from test_torch_pipeline import _tiny_config
from topiaxl.diffusion import create_diffusion as jax_diffusion
from topiaxl.diffusion import gaussian as jg
from topiaxl_torch.diffusion import create_diffusion, gaussian

KW = dict(noise_schedule="squaredcos_cap_v2", parameterization="v")
ATOL, RTOL = 5e-5, 1e-3


def _toy_jax(x, t):
    """A smooth stand-in for the model: mean and variance channels."""
    s = t.astype(jnp.float32)[:, None, None] / 1000.0
    return jnp.concatenate([jnp.tanh(0.7 * x + s), 0.5 * jnp.sin(x - s)], -1)


def _toy_torch(x, t):
    s = t.float()[:, None, None] / 1000.0
    return torch.cat([torch.tanh(0.7 * x + s), 0.5 * torch.sin(x - s)], -1)


def _noise(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_step_noises(key, steps, shape):
    """The noise JAX's ancestral loop draws, one key per step."""
    return [torch.from_numpy(np.array(jax.random.normal(k, shape,
                                                          jnp.float32)))
            for k in jax.random.split(key, steps)]


@pytest.mark.parametrize("respacing", ["ddim12", "ddim5"])
def test_dpm_loop_matches_jax(respacing):
    noise = _noise((2, 16, 6), 0)
    ref = jg.dpm_solver_pp_2m_loop(jax_diffusion(respacing, **KW), _toy_jax,
                                   jnp.asarray(noise))
    got = gaussian.dpm_solver_pp_2m_loop(create_diffusion(respacing, **KW),
                                         _toy_torch, torch.from_numpy(noise))
    assert np.isfinite(got.sample.numpy()).all()
    assert np.abs(np.asarray(ref.sample) - noise).max() > 0.1
    np.testing.assert_allclose(got.sample.numpy(), np.asarray(ref.sample),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.pred_xstart.numpy(),
                               np.asarray(ref.pred_xstart), atol=ATOL,
                               rtol=RTOL)


def test_p_sample_matches_jax():
    x = _noise((2, 16, 6), 1)
    key = jax.random.PRNGKey(3)
    jd, td = jax_diffusion("ddim12", **KW), create_diffusion("ddim12", **KW)
    for i in (7, 0):   # no noise is added at t = 0
        t = np.full((2,), i, np.int32)
        ref, ref_x0 = jg.p_sample(jd, _toy_jax, jnp.asarray(x), jnp.asarray(t),
                                  key)
        z = torch.from_numpy(np.array(jax.random.normal(key, x.shape)))
        got, got_x0 = gaussian.p_sample(td, _toy_torch, torch.from_numpy(x),
                                        torch.from_numpy(t).long(), z)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_allclose(got_x0.numpy(), np.asarray(ref_x0),
                                   atol=ATOL, rtol=RTOL)


def test_p_sample_loop_matches_jax():
    noise = _noise((2, 16, 6), 2)
    key = jax.random.PRNGKey(4)
    jd, td = jax_diffusion("ddim12", **KW), create_diffusion("ddim12", **KW)
    ref = jg.p_sample_loop(jd, _toy_jax, jnp.asarray(noise), key)
    got = gaussian.p_sample_loop(
        td, _toy_torch, torch.from_numpy(noise),
        step_noises=_jax_step_noises(key, td.num_timesteps, noise.shape))
    np.testing.assert_allclose(got.sample.numpy(), np.asarray(ref.sample),
                               atol=ATOL, rtol=RTOL)


def test_p_sample_loop_draws_from_the_generator():
    noise = torch.from_numpy(_noise((1, 8, 6), 5))
    td = create_diffusion("ddim5", **KW)
    runs = [gaussian.p_sample_loop(td, _toy_torch, noise,
                                   generator=torch.Generator().manual_seed(s))
            for s in (0, 0, 1)]
    assert torch.equal(runs[0].sample, runs[1].sample)
    assert not torch.equal(runs[0].sample, runs[2].sample)


def test_tiny_dit_chains_match_jax():
    """DPM through ``sample_tokens(sampler='dpm')`` and the ancestral chain
    over the tiny DiT's CFG fast path, against JAX's loops."""
    from topiaxl.models import DiT as JaxDiT
    from topiaxl_torch.pipelines import infer as P

    dit, params = tiny_dit(seed=30)
    rng = np.random.default_rng(31)
    noise = rng.standard_normal((1, 64, 68)).astype(np.float32)
    y = rng.standard_normal((1, 10, 32)).astype(np.float32)
    jd = JaxDiT(seq_length=64, in_channels=68, condition_channels=32,
                hidden_size=144, depth=2, num_heads=2, attn_proj_bias=True,
                dtype=jnp.float32)
    kvs = jd.apply(params, jnp.asarray(y), method=JaxDiT.precompute_kv)
    nulls = jd.apply(params, method=JaxDiT.precompute_null_out)

    def model_fn(x, t):
        return jd.apply(params, x, t, kvs, nulls, 6.0,
                        method=JaxDiT.forward_with_cfg_fast)

    jdf, tdf = jax_diffusion("ddim12", **KW), create_diffusion("ddim12", **KW)
    ref = jg.dpm_solver_pp_2m_loop(jdf, model_fn, jnp.asarray(noise))
    got = P.sample_tokens(dit, tdf, torch.from_numpy(y), 6.0,
                          noise=torch.from_numpy(noise), sampler="dpm")
    np.testing.assert_allclose(got.sample.numpy(), np.asarray(ref.sample),
                               atol=ATOL, rtol=RTOL)

    key = jax.random.PRNGKey(32)
    ref = jg.p_sample_loop(jdf, model_fn, jnp.asarray(noise), key)
    t_kvs = dit.precompute_kv(torch.from_numpy(y))
    t_nulls = dit.precompute_null_out()
    with torch.no_grad():
        got = gaussian.p_sample_loop(
            tdf, lambda x, t: dit.forward_with_cfg_fast(x, t, t_kvs, t_nulls,
                                                        6.0),
            torch.from_numpy(noise),
            step_noises=_jax_step_noises(key, tdf.num_timesteps, noise.shape))
    np.testing.assert_allclose(got.sample.numpy(), np.asarray(ref.sample),
                               atol=ATOL, rtol=RTOL)


def test_sample_tokens_refuses_an_unknown_sampler():
    from topiaxl_torch.pipelines import infer as P

    dit, _ = tiny_dit(seed=33)
    with pytest.raises(ValueError, match="sampler='foo': expected one of "
                                         r"\['ancestral', 'ddim', 'dpm'\]"):
        P.sample_tokens(dit, create_diffusion("ddim3", **KW),
                        torch.zeros(1, 10, 32), sampler="foo")


def test_cli_honours_inference_sampler(tmp_path):
    """``inference.sampler=dpm`` gives what ``generate_primx(sampler='dpm')``
    gives on the same models, image and generator, and not the DDIM
    chain's; an unknown sampler raises."""
    import cv2

    from topiaxl_torch.cli.infer import build_models, main, prepare_image
    from topiaxl_torch.core.config import load_config
    from topiaxl_torch.models.latent_stats import resolve_latent_stats
    from topiaxl_torch.pipelines import infer as P
    from test_torch_models import randomize_

    img_dir = tmp_path / "imgs"
    os.makedirs(img_dir)
    img = np.zeros((64, 64, 3), np.uint8)
    cv2.circle(img, (32, 32), 20, (200, 180, 160), -1)
    cv2.imwrite(str(img_dir / "blob.png"), img)
    cfg_path = str(_tiny_config(tmp_path, img_dir))
    # a randomised DiT: the zero-initialised one ignores x and t
    dit, _, _ = build_models(load_config(cfg_path), torch.device("cpu"),
                             torch.Generator().manual_seed(0))
    ckpt = tmp_path / "dit.pt"
    torch.save({"ema": randomize_(dit, seed=34)}, ckpt)
    overrides = ["inference.export_glb=false", f"checkpoint_path={ckpt}",
                 "inference.ddim=4", "inference.sampler=dpm"]
    assert main([cfg_path] + overrides) == 0
    z = np.load(tmp_path / "runs" / "tiny" / "inference_folder" / "blob"
                / "denoised.npz")

    cfg = load_config(cfg_path, overrides=overrides)
    gen = torch.Generator().manual_seed(int(cfg.inference.seed))
    dit, vae, encoder = build_models(cfg, torch.device("cpu"), gen)
    with torch.no_grad():
        y = encoder(torch.from_numpy(prepare_image(str(img_dir / "blob.png"))[None]))
    mean, std = resolve_latent_stats(cfg.model)
    diffusion = create_diffusion("ddim4", **KW, diffusion_steps=50)
    state = gen.get_state()
    out = {}
    for sampler in ("dpm", "ddim"):
        gen.set_state(state)
        out[sampler] = P.generate_primx(
            dit, vae, diffusion, y, mean, std, cfg_scale=2.0, generator=gen,
            sampler=sampler)
    np.testing.assert_allclose(z["srt"], out["dpm"].srt.numpy(), atol=1e-6)
    np.testing.assert_allclose(z["feat"], out["dpm"].feat.numpy(), atol=1e-6)
    assert np.abs(z["srt"] - out["ddim"].srt.numpy()).max() > 1e-3

    with pytest.raises(ValueError, match="sampler='foo'"):
        main([cfg_path, "inference.export_glb=false", "inference.sampler=foo"])


@pytest.mark.parametrize("eta,clip", [(0.0, False), (0.7, False), (0.7, True)])
def test_ddim_loop_options_match_jax(eta, clip):
    """DDIM with ``eta`` (JAX's per-step draws fed in), ``clip_denoised``,
    ``denoised_fn`` and ``keep_trajectory`` against ``jg.ddim_sample_loop``."""
    noise = _noise((2, 16, 6), 6)
    key = jax.random.PRNGKey(8)
    jd, td = jax_diffusion("ddim12", **KW), create_diffusion("ddim12", **KW)
    ref = jg.ddim_sample_loop(jd, _toy_jax, jnp.asarray(noise), key,
                              clip_denoised=clip,
                              denoised_fn=lambda x0: 0.9 * x0, eta=eta,
                              keep_trajectory=True)
    got = gaussian.ddim_sample_loop(
        td, _toy_torch, torch.from_numpy(noise), clip_denoised=clip,
        denoised_fn=lambda x0: 0.9 * x0, eta=eta, keep_trajectory=True,
        step_noises=_jax_step_noises(key, td.num_timesteps, noise.shape))
    assert got.trajectory.shape == (12, 2, 16, 6)
    for a, b in ((got.sample, ref.sample), (got.pred_xstart, ref.pred_xstart),
                 (got.trajectory, ref.trajectory)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=RTOL)
    if clip:
        assert got.pred_xstart.abs().max() <= 0.9 + 1e-6
    plain = gaussian.ddim_sample_loop(td, _toy_torch, torch.from_numpy(noise))
    assert plain.trajectory is None
    assert (np.abs(plain.sample.numpy() - got.sample.numpy()).max() > 1e-3)


def test_ddim_eta_draws_from_the_generator():
    noise = torch.from_numpy(_noise((1, 8, 6), 9))
    td = create_diffusion("ddim5", **KW)
    runs = [gaussian.ddim_sample_loop(
        td, _toy_torch, noise, eta=1.0,
        generator=torch.Generator().manual_seed(s)).sample for s in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


def test_calc_bpd_loop_and_prior_bpd_match_jax():
    """The full bound over a 6-step chain (JAX's q_sample draws fed in),
    x_start inside (-0.999, 0.999) and away from the t = 0 decoder NLL's
    saturation (``ROADMAP.md`` queue 3, "Kept on purpose")."""
    x0 = np.random.default_rng(10).uniform(-0.8, 0.8, (2, 16, 6)).astype("f")
    key = jax.random.PRNGKey(11)
    jd, td = jax_diffusion("ddim6", **KW), create_diffusion("ddim6", **KW)
    ref = jg.calc_bpd_loop(jd, _toy_jax, jnp.asarray(x0), key)
    got = gaussian.calc_bpd_loop(
        td, _toy_torch, torch.from_numpy(x0),
        step_noises=_jax_step_noises(key, td.num_timesteps, x0.shape))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=ATOL, rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(
        gaussian.prior_bpd(td, torch.from_numpy(x0)).numpy(),
        np.asarray(jg.prior_bpd(jd, jnp.asarray(x0))), atol=ATOL, rtol=RTOL)
