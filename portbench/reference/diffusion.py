"""Gaussian diffusion as 3DTopia-XL trains and samples it, in plain
float64 tables and float32 tensors: the squaredcos_cap_v2 schedule over
1000 steps, DDIM's respacing to an even stride, the deterministic DDIM
chain (eta 0) under v-parameterisation, and the training loss: MSE on v
plus the variational-bound term of the learned-range variance, whose
mean is held fixed (Nichol and Dhariwal's hybrid loss).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import dit


def alphas_cumprod(steps: int = 1000) -> np.ndarray:
    f = lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2  # noqa: E731
    betas = np.array([min(1 - f((i + 1) / steps) / f(i / steps), 0.999)
                      for i in range(steps)], np.float64)
    return np.cumprod(1.0 - betas)


def ddim_timesteps(count: int, steps: int = 1000) -> list[int]:
    """The retained timesteps: the integer stride that gives ``count``."""
    for stride in range(1, steps):
        if len(range(0, steps, stride)) == count:
            return list(range(0, steps, stride))
    raise ValueError(f"no integer stride gives {count} of {steps} steps")


def ddim_chain(model, noise: torch.Tensor, count: int = 25,
               steps: int = 1000) -> torch.Tensor:
    """x_T = ``noise`` down to x_0 along the retained timesteps; ``model(x,
    t)`` returns [B, N, 2C] whose first C channels predict v."""
    ac_full = alphas_cumprod(steps)
    ts = ddim_timesteps(count, steps)
    x = noise.float()
    C = x.shape[-1]
    for k in reversed(range(len(ts))):
        ac = float(ac_full[ts[k]])
        ac_prev = float(ac_full[ts[k - 1]]) if k else 1.0
        t = torch.full((x.shape[0],), ts[k], device=x.device)
        v = model(x, t)[..., :C].float()
        x0 = math.sqrt(ac) * x - math.sqrt(1 - ac) * v
        eps = (math.sqrt(1 / ac) * x - x0) / math.sqrt(1 / ac - 1)
        x = x0 * math.sqrt(ac_prev) + math.sqrt(1 - ac_prev) * eps
    return x


def _tables(t: torch.Tensor, steps: int = 1000) -> dict:
    ac = alphas_cumprod(steps)
    ac_prev = np.append(1.0, ac[:-1])
    betas = 1.0 - ac / ac_prev
    post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
    cols = {
        "sqrt_ac": np.sqrt(ac), "sqrt_1m_ac": np.sqrt(1.0 - ac),
        "post_logvar": np.log(np.append(post_var[1], post_var[1:])),
        "log_betas": np.log(betas),
        "coef1": betas * np.sqrt(ac_prev) / (1.0 - ac),
        "coef2": (1.0 - ac_prev) * np.sqrt(1.0 - betas) / (1.0 - ac),
    }
    idx = t.long().cpu().numpy()
    return {k: torch.as_tensor(v[idx], dtype=torch.float32,
                               device=t.device)[:, None, None]
            for k, v in cols.items()}


def _normal_kl(m1, lv1, m2, lv2):
    return 0.5 * (-1.0 + lv2 - lv1 + torch.exp(lv1 - lv2)
                  + (m1 - m2) ** 2 * torch.exp(-lv2))


def _cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                   * (x + 0.044715 * x ** 3)))


def _decoder_nll(x, mean, log_scale):
    """-log-likelihood of x under a Gaussian discretised to 1/255 bins."""
    c = x - mean
    inv = torch.exp(-log_scale)
    plus, minus = _cdf(inv * (c + 1 / 255)), _cdf(inv * (c - 1 / 255))
    ll = torch.where(
        x < -0.999, torch.log(plus.clamp(min=1e-12)),
        torch.where(x > 0.999, torch.log((1 - minus).clamp(min=1e-12)),
                    torch.log((plus - minus).clamp(min=1e-12))))
    return -ll


def training_loss(P: dict, x0, y, t, noise, drop, heads: int,
                  block_fn=None) -> torch.Tensor:
    """Per-row loss [B]: mean squared error of v plus the variational
    bound in bits a dimension of the learned-range variance, the model's
    mean held fixed in the bound."""
    T = _tables(t)
    x0, noise = x0.float(), noise.float()
    x_t = T["sqrt_ac"] * x0 + T["sqrt_1m_ac"] * noise
    out = dit.forward(P, x_t, t, y, heads, drop=drop, block_fn=block_fn)
    C = x0.shape[-1]
    v_pred, var = out[..., :C], out[..., C:]
    v = T["sqrt_ac"] * noise - T["sqrt_1m_ac"] * x0
    mse = ((v - v_pred) ** 2).flatten(1).mean(1)
    frac = (var + 1) / 2
    logvar = frac * T["log_betas"] + (1 - frac) * T["post_logvar"]
    x0_pred = T["sqrt_ac"] * x_t - T["sqrt_1m_ac"] * v_pred.detach()
    mean = T["coef1"] * x0_pred + T["coef2"] * x_t
    true_mean = T["coef1"] * x0 + T["coef2"] * x_t
    kl = _normal_kl(true_mean, T["post_logvar"], mean, logvar)
    kl = kl.flatten(1).mean(1) / math.log(2.0)
    nll = _decoder_nll(x0, mean, 0.5 * logvar).flatten(1).mean(1) / math.log(2.0)
    return mse + torch.where(t == 0, nll, kl)
