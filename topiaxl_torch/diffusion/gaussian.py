"""Gaussian-diffusion sampling (counterpart of
``topiaxl/diffusion/gaussian.py``): p_mean_variance, the DDIM step and
the DDIM chain as a Python loop over the spaced timesteps.

``model_fn`` receives ``(x, t_original)``, where ``t_original`` is the
spaced index already mapped through ``tables.timestep_map``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .schedule import Diffusion, DiffusionTables

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-batch scalars table[t], broadcastable over ``ndim`` dims."""
    out = table[t].float()
    return out.reshape(out.shape + (1,) * (ndim - 1))


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


def p_mean_variance(diffusion: Diffusion, model_fn: ModelFn, x,
                    t) -> PMeanVariance:
    """p(x_{t-1} | x_t) mean/variance and the x0 prediction (no clipping,
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
    mean, _, _ = q_posterior_mean_variance(tables, pred_xstart, x, t)
    return PMeanVariance(mean, variance, log_variance, pred_xstart)


def ddim_sample(diffusion: Diffusion, model_fn: ModelFn, x, t):
    """One deterministic (eta = 0) DDIM step; returns (sample, pred_xstart)."""
    tables = diffusion.tables
    nd = x.ndim
    out = p_mean_variance(diffusion, model_fn, x, t)
    eps = predict_eps_from_xstart(tables, x, t, out.pred_xstart)
    ab_prev = _extract(tables.alphas_cumprod_prev, t, nd)
    sample = (out.pred_xstart * torch.sqrt(ab_prev)
              + torch.sqrt(1 - ab_prev) * eps)
    return sample, out.pred_xstart


class SampleLoopOutput(NamedTuple):
    sample: torch.Tensor
    pred_xstart: torch.Tensor


def ddim_sample_loop(diffusion: Diffusion, model_fn: ModelFn,
                     noise: torch.Tensor) -> SampleLoopOutput:
    """The eta = 0 DDIM chain from ``noise`` down to t = 0, one step per
    spaced timestep."""
    x, pred = noise, torch.zeros_like(noise)
    for i in reversed(range(diffusion.num_timesteps)):
        t = torch.full((noise.shape[0],), i, dtype=torch.long,
                       device=noise.device)
        x, pred = ddim_sample(diffusion, model_fn, x, t)
    return SampleLoopOutput(x, pred)
