"""Gaussian diffusion (counterpart of ``topiaxl/diffusion/gaussian.py``):
p_mean_variance; the three sampling chains as Python loops over the
spaced timesteps (DDIM with ``eta``, ancestral, DPM-Solver++(2M)); q_sample
and the training losses (MSE on the eps / x0 / v target plus the
variational-bound term for a learned variance); the prior term and the
full variational bound in bits per dim (``prior_bpd``, ``calc_bpd_loop``).

Where a step draws noise (ancestral, DDIM with ``eta > 0``, the bound's
q_sample), it comes from the caller's generator, one draw a step, or is
given per step (``step_noises``), so a test can hand in the JAX draws.

``model_fn`` receives ``(x, t_original)``, where ``t_original`` is the
spaced index already mapped through ``tables.timestep_map``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .schedule import Diffusion, DiffusionTables

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-batch scalars table[t], broadcastable over ``ndim`` dims."""
    out = table[t].float()
    return out.reshape(out.shape + (1,) * (ndim - 1))


def q_sample(tables: DiffusionTables, x_start, t, noise):
    """Sample q(x_t | x_0) (reference gaussian_diffusion.py:216-231)."""
    nd = x_start.ndim
    return (_extract(tables.sqrt_alphas_cumprod, t, nd) * x_start
            + _extract(tables.sqrt_one_minus_alphas_cumprod, t, nd) * noise)


def q_mean_variance(tables: DiffusionTables, x_start, t):
    nd = x_start.ndim
    return (_extract(tables.sqrt_alphas_cumprod, t, nd) * x_start,
            _extract(1.0 - tables.alphas_cumprod, t, nd),
            _extract(tables.log_one_minus_alphas_cumprod, t, nd))


def get_v(tables: DiffusionTables, x, noise, t):
    """Velocity target (gaussian_diffusion.py:358-362)."""
    nd = x.ndim
    return (_extract(tables.sqrt_alphas_cumprod, t, nd) * noise
            - _extract(tables.sqrt_one_minus_alphas_cumprod, t, nd) * x)


def q_posterior_mean_variance(tables: DiffusionTables, x_start, x_t, t):
    nd = x_t.ndim
    mean = (_extract(tables.posterior_mean_coef1, t, nd) * x_start
            + _extract(tables.posterior_mean_coef2, t, nd) * x_t)
    return (mean, _extract(tables.posterior_variance, t, nd),
            _extract(tables.posterior_log_variance_clipped, t, nd))


def predict_xstart_from_eps(tables: DiffusionTables, x_t, t, eps):
    nd = x_t.ndim
    return (_extract(tables.sqrt_recip_alphas_cumprod, t, nd) * x_t
            - _extract(tables.sqrt_recipm1_alphas_cumprod, t, nd) * eps)


def predict_xstart_from_v(tables: DiffusionTables, x_t, t, v):
    nd = x_t.ndim
    return (_extract(tables.sqrt_alphas_cumprod, t, nd) * x_t
            - _extract(tables.sqrt_one_minus_alphas_cumprod, t, nd) * v)


def predict_eps_from_xstart(tables: DiffusionTables, x_t, t, pred_xstart):
    nd = x_t.ndim
    return ((_extract(tables.sqrt_recip_alphas_cumprod, t, nd) * x_t
             - pred_xstart)
            / _extract(tables.sqrt_recipm1_alphas_cumprod, t, nd))


class PMeanVariance(NamedTuple):
    mean: torch.Tensor
    variance: torch.Tensor
    log_variance: torch.Tensor
    pred_xstart: torch.Tensor


def p_mean_variance(diffusion: Diffusion, model_fn: ModelFn, x, t,
                    clip_denoised: bool = False,
                    denoised_fn=None) -> PMeanVariance:
    """p(x_{t-1} | x_t) mean/variance and the x0 prediction, which
    ``denoised_fn`` maps and ``clip_denoised`` clips to [-1, 1] (neither,
    as the serving path calls it)."""
    tables = diffusion.tables
    nd = x.ndim
    model_output = model_fn(x, tables.timestep_map[t])
    if diffusion.var_type == "learned_range":
        model_output, var_values = model_output.chunk(2, dim=-1)
        min_log = _extract(tables.posterior_log_variance_clipped, t, nd)
        max_log = _extract(tables.log_betas, t, nd)
        frac = (var_values.float() + 1) / 2
        log_variance = frac * max_log + (1 - frac) * min_log
        variance = torch.exp(log_variance)
    elif diffusion.var_type == "fixed_large":
        variance = _extract(tables.fixed_large_variance, t, nd).expand_as(x)
        log_variance = _extract(tables.fixed_large_log_variance, t,
                                nd).expand_as(x)
    elif diffusion.var_type == "fixed_small":
        variance = _extract(tables.posterior_variance, t, nd).expand_as(x)
        log_variance = _extract(tables.posterior_log_variance_clipped, t,
                                nd).expand_as(x)
    else:
        raise NotImplementedError(diffusion.var_type)

    model_output = model_output.float()
    if diffusion.mean_type == "xstart":
        pred_xstart = model_output
    elif diffusion.mean_type == "eps":
        pred_xstart = predict_xstart_from_eps(tables, x, t, model_output)
    elif diffusion.mean_type == "v":
        pred_xstart = predict_xstart_from_v(tables, x, t, model_output)
    else:
        raise NotImplementedError(diffusion.mean_type)
    if denoised_fn is not None:
        pred_xstart = denoised_fn(pred_xstart)
    if clip_denoised:
        pred_xstart = pred_xstart.clamp(-1.0, 1.0)
    mean, _, _ = q_posterior_mean_variance(tables, pred_xstart, x, t)
    return PMeanVariance(mean, variance, log_variance, pred_xstart)


def ddim_sample(diffusion: Diffusion, model_fn: ModelFn, x, t,
                clip_denoised: bool = False, denoised_fn=None,
                eta: float = 0.0, noise=None):
    """One DDIM step (reference gaussian_diffusion.py:531-578); returns
    (sample, pred_xstart). With ``eta > 0`` it adds ``sigma * noise``
    (none at t = 0), where ``noise`` is a standard normal like ``x``; at
    ``eta = 0`` the step is deterministic and ``noise`` is not read."""
    tables = diffusion.tables
    nd = x.ndim
    out = p_mean_variance(diffusion, model_fn, x, t, clip_denoised,
                          denoised_fn)
    eps = predict_eps_from_xstart(tables, x, t, out.pred_xstart)
    ab = _extract(tables.alphas_cumprod, t, nd)
    ab_prev = _extract(tables.alphas_cumprod_prev, t, nd)
    if not eta:
        sample = (out.pred_xstart * torch.sqrt(ab_prev)
                  + torch.sqrt(1 - ab_prev) * eps)
        return sample, out.pred_xstart
    sigma = (eta * torch.sqrt((1 - ab_prev) / (1 - ab))
             * torch.sqrt(1 - ab / ab_prev))
    mean_pred = (out.pred_xstart * torch.sqrt(ab_prev)
                 + torch.sqrt(1 - ab_prev - sigma ** 2) * eps)
    nonzero = (t != 0).float().reshape((-1,) + (1,) * (nd - 1))
    return mean_pred + nonzero * sigma * noise, out.pred_xstart


def p_sample(diffusion: Diffusion, model_fn: ModelFn, x, t, noise):
    """One ancestral step (reference gaussian_diffusion.py:394-435) with
    the given standard-normal ``noise``; no noise is added at t = 0.
    Returns (sample, pred_xstart)."""
    out = p_mean_variance(diffusion, model_fn, x, t)
    nonzero = (t != 0).float().reshape((-1,) + (1,) * (x.ndim - 1))
    sample = out.mean + nonzero * torch.exp(0.5 * out.log_variance) * noise
    return sample, out.pred_xstart


class SampleLoopOutput(NamedTuple):
    sample: torch.Tensor
    pred_xstart: torch.Tensor
    trajectory: torch.Tensor | None = None   # [steps, B, ...] per step


def _step_noise(n: int, x: torch.Tensor, generator, step_noises):
    """Step n's standard-normal noise: given, or drawn from ``generator``."""
    if step_noises is not None:
        return step_noises[n]
    return torch.randn(x.shape, generator=generator, device=x.device,
                       dtype=x.dtype)


def _steps(diffusion: Diffusion, noise: torch.Tensor):
    """The chain's timesteps, last first, as [B] index tensors."""
    for i in reversed(range(diffusion.num_timesteps)):
        yield torch.full((noise.shape[0],), i, dtype=torch.long,
                         device=noise.device)


def ddim_sample_loop(diffusion: Diffusion, model_fn: ModelFn,
                     noise: torch.Tensor, clip_denoised: bool = False,
                     denoised_fn=None, eta: float = 0.0,
                     keep_trajectory: bool = False,
                     generator: torch.Generator | None = None,
                     step_noises=None) -> SampleLoopOutput:
    """The DDIM chain from ``noise`` down to t = 0, one step per spaced
    timestep (reference gaussian_diffusion.py:651-698). With ``eta > 0``
    step n adds ``step_noises[n]`` or a draw from ``generator``; at eta 0
    nothing is drawn. ``keep_trajectory`` also returns every step's
    sample."""
    x, pred = noise, torch.zeros_like(noise)
    traj = []
    for n, t in enumerate(_steps(diffusion, noise)):
        z = _step_noise(n, x, generator, step_noises) if eta else None
        x, pred = ddim_sample(diffusion, model_fn, x, t, clip_denoised,
                              denoised_fn, eta, z)
        if keep_trajectory:
            traj.append(x)
    return SampleLoopOutput(x, pred,
                            torch.stack(traj) if keep_trajectory else None)


def p_sample_loop(diffusion: Diffusion, model_fn: ModelFn,
                  noise: torch.Tensor,
                  generator: torch.Generator | None = None,
                  step_noises=None) -> SampleLoopOutput:
    """The ancestral chain (reference gaussian_diffusion.py:482-529). Step
    n adds ``step_noises[n]`` where given, else a standard normal drawn
    from ``generator`` (one draw a step, the last step's included, as the
    JAX loop draws one per key of ``jax.random.split(key, num_steps)``)."""
    x, pred = noise, torch.zeros_like(noise)
    for n, t in enumerate(_steps(diffusion, noise)):
        z = _step_noise(n, x, generator, step_noises)
        x, pred = p_sample(diffusion, model_fn, x, t, z)
    return SampleLoopOutput(x, pred)


def dpm_solver_pp_2m_loop(diffusion: Diffusion, model_fn: ModelFn,
                          noise: torch.Tensor) -> SampleLoopOutput:
    """DPM-Solver++(2M) over the (respaced) chain, deterministic
    (``topiaxl/diffusion/gaussian.py:dpm_solver_pp_2m_loop``; Lu et al.
    2022): ``x <- (sig_p / sig) x - alph_p (exp(-h) - 1) D`` with ``h =
    lam_p - lam``, ``lam = log(alph / sig)`` and D blending the current and
    previous x0 predictions, ``(1 + 1/2r) x0 - 1/2r x0_old``, ``r = h_old /
    h``. The first step and the last (sig_p = 0) are first order (D = x0);
    exp(-h) comes from the tables, so it stays finite where sig_p = 0,
    while lam_p, h and the second-order blend are then inf or NaN and
    ``torch.where`` selects them away."""
    tables = diffusion.tables
    nd = noise.ndim
    x = noise
    old_x0 = torch.zeros_like(noise)
    old_h = torch.zeros((noise.shape[0],) + (1,) * (nd - 1),
                        device=noise.device)
    has_old = False
    for t in _steps(diffusion, noise):
        acp = _extract(tables.alphas_cumprod, t, nd)
        acp_p = _extract(tables.alphas_cumprod_prev, t, nd)
        alph, sig = torch.sqrt(acp), torch.sqrt(1.0 - acp)
        alph_p, sig_p = torch.sqrt(acp_p), torch.sqrt(1.0 - acp_p)
        x0 = p_mean_variance(diffusion, model_fn, x, t).pred_xstart
        exp_neg_h = (alph * sig_p) / (sig * alph_p)
        lam = 0.5 * (torch.log(acp) - torch.log1p(-acp))
        lam_p = 0.5 * (torch.log(acp_p) - torch.log1p(-acp_p))
        h = lam_p - lam
        c = h / (2.0 * torch.clamp_min(old_h, 1e-20))
        d_2m = (1.0 + c) * x0 - c * old_x0
        first_order = (sig_p <= 0.0) | (not has_old)
        d = torch.where(first_order, x0, d_2m)
        x = (sig_p / torch.clamp_min(sig, 1e-20)) * x \
            - alph_p * (exp_neg_h - 1.0) * d
        old_x0, old_h, has_old = x0, h, True
    return SampleLoopOutput(x, old_x0)


SAMPLERS = {"ddim": ddim_sample_loop, "dpm": dpm_solver_pp_2m_loop,
            "ancestral": p_sample_loop}


# ---------------------------------------------------------------------------
# Likelihoods / training losses
# ---------------------------------------------------------------------------

def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL between two Gaussians (reference diffusion_utils.py:10-36)."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2) ** 2 * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                   * (x + 0.044715 * torch.pow(x, 3))))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of a Gaussian discretised to 1/255 bins
    (reference diffusion_utils.py:62-88)."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(
        x < -0.999, log_cdf_plus,
        torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


def mean_flat(x):
    return x.reshape(x.shape[0], -1).mean(dim=-1)


def vb_terms_bpd(diffusion: Diffusion, model_fn: ModelFn, x_start, x_t, t,
                 clip_denoised: bool = False):
    """Variational-bound term in bits/dim (reference
    gaussian_diffusion.py:700-731); returns (bpd [B], pred_xstart)."""
    true_mean, _, true_log_var = q_posterior_mean_variance(
        diffusion.tables, x_start, x_t, t)
    out = p_mean_variance(diffusion, model_fn, x_t, t, clip_denoised)
    kl = mean_flat(normal_kl(true_mean, true_log_var, out.mean,
                             out.log_variance)) / math.log(2.0)
    decoder_nll = -discretized_gaussian_log_likelihood(
        x_start, means=out.mean, log_scales=0.5 * out.log_variance)
    decoder_nll = mean_flat(decoder_nll) / math.log(2.0)
    return torch.where(t == 0, decoder_nll, kl), out.pred_xstart


def training_losses(diffusion: Diffusion, model_fn: ModelFn, x_start, t,
                    noise):
    """Per-example training losses {loss_total, loss_mse[, loss_vb]}
    (reference gaussian_diffusion.py:733-806) on the given noise. ``t``
    indexes the chain (unspaced for training, so it is the original
    timestep)."""
    tables = diffusion.tables
    x_t = q_sample(tables, x_start, t, noise)
    terms = {}
    if diffusion.loss_type in ("kl", "rescaled_kl"):
        terms["loss_total"], _ = vb_terms_bpd(diffusion, model_fn, x_start,
                                              x_t, t)
        if diffusion.loss_type == "rescaled_kl":
            terms["loss_total"] = terms["loss_total"] * diffusion.num_timesteps
        return terms

    model_output = model_fn(x_t, tables.timestep_map[t]).float()
    if diffusion.var_type == "learned_range":
        model_output, var_values = model_output.chunk(2, dim=-1)
        # the VB term learns the variance without moving the mean
        # prediction (frozen_out, gaussian_diffusion.py:776-787)
        frozen_out = torch.cat([model_output.detach(), var_values], dim=-1)
        vb, _ = vb_terms_bpd(diffusion, lambda *_: frozen_out, x_start, x_t,
                             t)
        if diffusion.loss_type == "rescaled_mse":
            vb = vb * (diffusion.num_timesteps / 1000.0)
        terms["loss_vb"] = vb

    if diffusion.mean_type == "xstart":
        target = x_start
    elif diffusion.mean_type == "eps":
        target = noise
    elif diffusion.mean_type == "v":
        target = get_v(tables, x_start, noise, t)
    else:
        raise NotImplementedError(diffusion.mean_type)
    terms["loss_mse"] = mean_flat((target - model_output) ** 2)
    terms["loss_total"] = terms["loss_mse"] + terms.get("loss_vb", 0.0)
    return terms


def prior_bpd(diffusion: Diffusion, x_start):
    """Prior KL term in bits/dim (reference gaussian_diffusion.py:808-822)."""
    t = torch.full((x_start.shape[0],), diffusion.num_timesteps - 1,
                   dtype=torch.long, device=x_start.device)
    qt_mean, _, qt_log_var = q_mean_variance(diffusion.tables, x_start, t)
    zero = torch.zeros((), device=x_start.device)
    return mean_flat(normal_kl(qt_mean, qt_log_var, zero, zero)) / math.log(2.0)


def calc_bpd_loop(diffusion: Diffusion, model_fn: ModelFn, x_start,
                  generator: torch.Generator | None = None,
                  clip_denoised: bool = False, step_noises=None) -> dict:
    """The full variational bound in bits/dim over every timestep
    (reference gaussian_diffusion.py:824-877): {total_bpd [B], prior_bpd
    [B], vb [B, T], xstart_mse [B, T], mse [B, T]}, column 0 at t = T - 1
    as in the reference's reversed loop. Step n's q_sample noise is
    ``step_noises[n]`` or a draw from ``generator``."""
    tables = diffusion.tables
    vb, xstart_mse, mse = [], [], []
    for n, t in enumerate(_steps(diffusion, x_start)):
        noise = _step_noise(n, x_start, generator, step_noises)
        x_t = q_sample(tables, x_start, t, noise)
        term, pred_xstart = vb_terms_bpd(diffusion, model_fn, x_start, x_t, t,
                                         clip_denoised)
        vb.append(term)
        xstart_mse.append(mean_flat((pred_xstart - x_start) ** 2))
        eps = predict_eps_from_xstart(tables, x_t, t, pred_xstart)
        mse.append(mean_flat((eps - noise) ** 2))
    vb = torch.stack(vb, dim=1)
    prior = prior_bpd(diffusion, x_start)
    return {"total_bpd": vb.sum(dim=1) + prior, "prior_bpd": prior, "vb": vb,
            "xstart_mse": torch.stack(xstart_mse, dim=1),
            "mse": torch.stack(mse, dim=1)}
