"""Diffusion beta schedules, respacing and precomputed tables
(counterpart of ``topiaxl/diffusion/schedule.py``).

Every table is computed once in float64 numpy, exactly as the JAX
package's ``build_tables`` does, and cast once to float32 tensors on the
target device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .timestep_sampler import uniform_sample


def get_named_beta_schedule(schedule_name: str, num_diffusion_timesteps: int) -> np.ndarray:
    """Named beta schedules (reference gaussian_diffusion.py:99-142)."""
    if schedule_name == "linear":
        scale = 1000 / num_diffusion_timesteps
        return np.linspace(
            scale * 0.0001, scale * 0.02, num_diffusion_timesteps, dtype=np.float64
        )
    if schedule_name == "squaredcos_cap_v2":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def betas_for_alpha_bar(num_diffusion_timesteps, alpha_bar, max_beta=0.999) -> np.ndarray:
    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


def space_timesteps(num_timesteps: int, section_counts) -> set[int]:
    """Subset of original timesteps to retain (reference respace.py:12-62)."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired_count:
                    return set(range(0, num_timesteps, i))
            raise ValueError(
                f"cannot create exactly {desired_count} steps with an integer stride"
            )
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        if section_count <= 1:
            frac_stride = 1
        else:
            frac_stride = (size - 1) / (section_count - 1)
        cur_idx = 0.0
        taken_steps = []
        for _ in range(section_count):
            taken_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        all_steps += taken_steps
        start_idx += size
    return set(all_steps)


@dataclass(frozen=True)
class DiffusionTables:
    """Per-timestep constants over the (possibly respaced) chain, f32."""

    betas: torch.Tensor
    log_betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    fixed_large_variance: torch.Tensor
    fixed_large_log_variance: torch.Tensor
    # spaced index -> original timestep fed to the network
    timestep_map: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def build_tables(betas: np.ndarray, use_timesteps: Sequence[int] | None = None,
                 device=None) -> DiffusionTables:
    """All sampling tables, optionally respaced onto ``use_timesteps``
    (betas recomputed on the retained subset)."""
    betas = np.asarray(betas, dtype=np.float64)
    if betas.ndim != 1 or not ((betas > 0).all() and (betas <= 1).all()):
        raise ValueError("betas must be a 1-D array in (0, 1]")
    alphas_cumprod_full = np.cumprod(1.0 - betas, axis=0)
    if use_timesteps is not None:
        use = set(int(t) for t in use_timesteps)
        timestep_map, new_betas, last_ac = [], [], 1.0
        for i, ac in enumerate(alphas_cumprod_full):
            if i in use:
                new_betas.append(1 - ac / last_ac)
                last_ac = ac
                timestep_map.append(i)
        betas = np.array(new_betas, dtype=np.float64)
    else:
        timestep_map = list(range(len(betas)))

    alphas = 1.0 - betas
    ac = np.cumprod(alphas, axis=0)
    ac_prev = np.append(1.0, ac[:-1])
    ac_next = np.append(ac[1:], 0.0)
    post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
    if len(post_var) > 1:
        post_log_var = np.log(np.append(post_var[1], post_var[1:]))
        fixed_large = np.append(post_var[1], betas[1:])
    else:  # single-step chain
        post_log_var = np.log(np.maximum(betas, 1e-20))
        fixed_large = betas.copy()

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)

    return DiffusionTables(
        betas=t(betas),
        log_betas=t(np.log(betas)),
        alphas_cumprod=t(ac),
        alphas_cumprod_prev=t(ac_prev),
        alphas_cumprod_next=t(ac_next),
        sqrt_alphas_cumprod=t(np.sqrt(ac)),
        sqrt_one_minus_alphas_cumprod=t(np.sqrt(1.0 - ac)),
        log_one_minus_alphas_cumprod=t(np.log(1.0 - ac)),
        sqrt_recip_alphas_cumprod=t(np.sqrt(1.0 / ac)),
        sqrt_recipm1_alphas_cumprod=t(np.sqrt(1.0 / ac - 1)),
        posterior_variance=t(post_var),
        posterior_log_variance_clipped=t(post_log_var),
        posterior_mean_coef1=t(betas * np.sqrt(ac_prev) / (1.0 - ac)),
        posterior_mean_coef2=t((1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac)),
        fixed_large_variance=t(fixed_large),
        fixed_large_log_variance=t(np.log(fixed_large)),
        timestep_map=torch.as_tensor(np.array(timestep_map), dtype=torch.long,
                                     device=device),
    )


@dataclass(frozen=True)
class Diffusion:
    tables: DiffusionTables
    mean_type: str   # 'eps' | 'xstart' | 'v'
    var_type: str    # 'learned_range' | 'fixed_small' | 'fixed_large'
    loss_type: str   # 'mse' | 'rescaled_mse' | 'rescaled_kl'

    @property
    def num_timesteps(self) -> int:
        return self.tables.num_timesteps

    def sample_times(self, n: int, generator: torch.Generator, device=None):
        """[n] uniform timesteps (long) and unit weights (f32)."""
        return uniform_sample(self.num_timesteps, n, generator, device)

    def training_losses(self, model_fn, x, t, noise) -> dict:
        """``gaussian.training_losses``' per-row terms."""
        from . import gaussian
        return gaussian.training_losses(self, model_fn, x, t, noise)


def create_diffusion(timestep_respacing=None, noise_schedule: str = "linear",
                     use_kl: bool = False, sigma_small: bool = False,
                     parameterization: str = "eps", learn_sigma: bool = True,
                     rescale_learned_sigmas: bool = False,
                     diffusion_steps: int = 1000, device=None) -> Diffusion:
    """Factory with the JAX package's arguments, tables on ``device``."""
    betas = get_named_beta_schedule(noise_schedule, diffusion_steps)
    if use_kl:
        loss_type = "rescaled_kl"
    elif rescale_learned_sigmas:
        loss_type = "rescaled_mse"
    else:
        loss_type = "mse"
    if timestep_respacing is None or timestep_respacing == "":
        timestep_respacing = [diffusion_steps]
    if parameterization not in ("eps", "xstart", "v"):
        raise NotImplementedError(
            f"parameterization {parameterization} not supported")
    var_type = ("learned_range" if learn_sigma
                else ("fixed_small" if sigma_small else "fixed_large"))
    tables = build_tables(
        betas, sorted(space_timesteps(diffusion_steps, timestep_respacing)),
        device=device)
    return Diffusion(tables, parameterization, var_type, loss_type)
