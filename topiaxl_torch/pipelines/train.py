"""DiT training on one device (counterpart of
``topiaxl/pipelines/train.py``).

The reference recipe (configs/inference_dit.yml:77-95): AdamW lr 1e-4 wd
0 with clip-by-global-norm 1, cosine schedule with 3k warmup,
v-prediction MSE + VB (learned-range sigma), cond-drop 0.1, EMA. One
train step draws timesteps, the cond-drop mask and the noise over the
full batch, runs ``grad_accum`` microbatches forward and backward
(gradients accumulate in ``.grad``), then applies ``fused_adamw_ema_update``.

The model holds f32 master weights (``DiT(param_dtype=torch.float32)``);
Adam moments and EMA are f32 tensors keyed by parameter name. The update
runs in place on the parameters, moments, EMA and gradients, where the
JAX package returns new trees.

Random draws come from generators seeded with ``(seed, step)``, so a
resumed run draws what an uninterrupted one would. The cond-drop follows
the JAX package: the single pass (``grad_accum == 1``) drops inside the
model's forward, so the null embedding gets the dropped rows' gradient;
with ``grad_accum > 1`` the dropped rows take the null embedding before
the microbatch loop and outside the gradient (``train.py:210-214``), so
the null embedding gets none from them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..diffusion import Diffusion, gaussian
from ..diffusion.timestep_sampler import (
    LossSecondMomentState,
    lsm_sample,
    lsm_update,
    uniform_sample,
)


def cosine_warmup_schedule(base_lr: float, warmup_iters: int,
                           max_iters: int) -> Callable[[int], float]:
    """Linear warmup then cosine decay to 0 (reference
    dva/scheduler.py:4-21), in f32 as the JAX package computes it."""
    f32 = np.float32

    def lr(step: int) -> float:
        s = f32(step)
        if s < warmup_iters:
            return float(f32(base_lr) * s / f32(max(warmup_iters, 1)))
        prog = (s - f32(warmup_iters)) / f32(max(max_iters - warmup_iters, 1))
        prog = min(max(prog, f32(0.0)), f32(1.0))
        return float(f32(base_lr) * f32(0.5)
                     * (f32(1.0) + f32(math.cos(math.pi * prog))))

    return lr


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.0,
                   warmup_iters: int = 3000, max_iters: int = 200000,
                   grad_clip: Optional[float] = 1.0) -> dict:
    """The hyperparameters of clip-by-global-norm + AdamW (optax's b1,
    b2, eps) with the cosine warmup schedule."""
    return dict(sched=cosine_warmup_schedule(lr, warmup_iters, max_iters),
                weight_decay=weight_decay, grad_clip=grad_clip, b1=0.9,
                b2=0.999, eps=1e-8)


@dataclass
class AdamState:
    count: int
    mu: dict
    nu: dict


@torch.no_grad()
def fused_adamw_ema_update(grads: dict, opt_state: AdamState, params: dict,
                           ema_params: dict, spec: dict,
                           ema_decay: float = 0.9999,
                           grad_prescale: float = 1.0) -> torch.Tensor:
    """clip-by-global-norm + AdamW + EMA, in place, with the JAX
    package's math (``topiaxl/pipelines/train.py:77-139``): moments in
    f32; the gradient scaled by ``grad_prescale * min(1, clip / gnorm)``,
    the clip taking effect only when ``gnorm >= clip`` (no epsilon on the
    norm, unlike ``clip_grad_norm_``); the learning rate from the
    schedule at the count before this step; the EMA folded in after the
    parameter update. Dicts are keyed alike; ``grads`` is scaled in place.
    Returns the global norm of the prescaled gradient (a device scalar)."""
    names = list(params)
    p = [params[n].data for n in names]
    g = [grads[n] for n in names]
    m = [opt_state.mu[n] for n in names]
    v = [opt_state.nu[n] for n in names]
    e = [ema_params[n] for n in names]
    b1, b2, eps = spec["b1"], spec["b2"], spec["eps"]
    wd, clip = spec["weight_decay"], spec["grad_clip"]

    f32 = np.float32
    cf = f32(opt_state.count + 1)
    c1 = float(f32(1.0) - f32(b1) ** cf)
    c2 = float(f32(1.0) - f32(b2) ** cf)
    lr = spec["sched"](opt_state.count)
    gnorm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(g))) * grad_prescale
    if clip:
        gscale = grad_prescale * torch.where(gnorm < clip, 1.0, clip / gnorm)
    else:
        gscale = torch.tensor(grad_prescale, device=gnorm.device)
    torch._foreach_mul_(g, gscale)
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, g, alpha=1.0 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, g, g, value=1.0 - b2)
    denom = torch._foreach_div(v, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    upd = torch._foreach_div(m, c1)
    torch._foreach_div_(upd, denom)
    if wd:
        torch._foreach_add_(upd, p, alpha=wd)
    torch._foreach_add_(p, upd, alpha=-lr)
    torch._foreach_mul_(e, ema_decay)
    torch._foreach_add_(e, p, alpha=1.0 - ema_decay)
    opt_state.count += 1
    return gnorm


@dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: AdamState
    ema_params: dict
    sampler_state: Optional[LossSecondMomentState] = None

    def params(self) -> dict:
        return dict(self.model.named_parameters())

    def state_dict(self) -> dict:
        """Everything a resume needs, as tensors and ints."""
        s = self.sampler_state
        return {"step": self.step, "params": self.model.state_dict(),
                "ema": self.ema_params,
                "opt": {"count": self.opt_state.count,
                        "mu": self.opt_state.mu, "nu": self.opt_state.nu},
                "sampler": None if s is None else {
                    "loss_history": s.loss_history,
                    "loss_counts": s.loss_counts}}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Copy a ``state_dict`` into this state's tensors, in place."""
        self.step = int(sd["step"])
        self.model.load_state_dict(sd["params"])
        self.opt_state.count = int(sd["opt"]["count"])
        for mine, theirs in ((self.ema_params, sd["ema"]),
                             (self.opt_state.mu, sd["opt"]["mu"]),
                             (self.opt_state.nu, sd["opt"]["nu"])):
            if mine.keys() != theirs.keys():
                raise KeyError("checkpoint parameters differ from the model's")
            for n, t in mine.items():
                t.copy_(theirs[n])
        if sd["sampler"] is not None:
            self.sampler_state = LossSecondMomentState(
                sd["sampler"]["loss_history"].cpu(),
                sd["sampler"]["loss_counts"].cpu())


def create_train_state(model: nn.Module,
                       lsm_timesteps: Optional[int] = None) -> TrainState:
    """Zero f32 moments and an EMA copy of every parameter."""
    params = dict(model.named_parameters())
    zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
                     for n, p in params.items()}
    return TrainState(
        step=0, model=model, opt_state=AdamState(0, zeros(), zeros()),
        ema_params={n: p.detach().float().clone() for n, p in params.items()},
        sampler_state=(LossSecondMomentState.create(lsm_timesteps)
                       if lsm_timesteps else None))


def _step_generators(seed: int, step: int, device):
    """(device generator, CPU generator) seeded with (seed, step)."""
    s = (int(seed) * 1_000_003 + int(step)) % (2 ** 63)
    dev = torch.Generator(device=device).manual_seed(s)
    return dev, torch.Generator().manual_seed(s)


def accumulate_gradients(model, diffusion: Diffusion, x, y, t, weights,
                         noise, drop, grad_accum: int = 1):
    """Forward and backward of ``grad_accum`` equal microbatches, the
    gradients summed into the parameters' ``.grad`` (undivided, as the JAX
    package's ``accum_grads`` returns them). ``drop`` ([B] bool or None)
    marks the rows whose conditioning is the null embedding: inside the
    model's forward for the single pass, before the loop and outside the
    gradient for ``grad_accum > 1``. Returns (the mean of the microbatch
    losses, the per-row loss terms, detached)."""
    B = x.shape[0]
    if B % grad_accum:
        raise ValueError(f"batch {B} not divisible by grad_accum={grad_accum}")
    if grad_accum > 1 and drop is not None:
        null = model.null_cond_embedding.detach().to(y.dtype)
        y = torch.where(drop[:, None, None], null[None, None, :], y)
        drop = None
    mb = B // grad_accum
    terms_all: dict = {}
    loss_sum = torch.zeros((), device=x.device)
    for i in range(grad_accum):
        sl = slice(i * mb, (i + 1) * mb)
        drop_i = None if drop is None else drop[sl]

        def model_fn(x_t, t_orig, y=y[sl], drop=drop_i):
            return model(x_t, t_orig, y, drop)

        terms = gaussian.training_losses(diffusion, model_fn, x[sl], t[sl],
                                         noise=noise[sl])
        loss = (terms["loss_total"] * weights[sl]).mean()
        loss.backward()
        loss_sum += loss.detach()
        for k, val in terms.items():
            terms_all.setdefault(k, []).append(val.detach())
    return loss_sum / grad_accum, {k: torch.cat(vs)
                                   for k, vs in terms_all.items()}


def make_train_step(model, diffusion: Diffusion, optimizer: dict,
                    ema_decay: float = 0.9999,
                    timestep_sampler: str = "uniform", grad_accum: int = 1):
    """Returns ``train_step(state, batch, seed) -> metrics``, which
    advances ``state`` in place. ``batch`` is {'x': [B, N, C] clean
    tokens, 'y': [B, M, Cc] conditioning} on the model's device; metrics
    are device scalars (loss, loss_mse, grad_norm[, loss_vb])."""

    def train_step(state: TrainState, batch: dict, seed: int) -> dict:
        x, y = batch["x"], batch["y"]
        B, device = x.shape[0], x.device
        gen, cpu_gen = _step_generators(seed, state.step, device)
        if timestep_sampler == "lsm" and state.sampler_state is not None:
            t, weights = lsm_sample(state.sampler_state, B, cpu_gen)
            t, weights = t.to(device), weights.to(device)
        else:
            t, weights = uniform_sample(diffusion.num_timesteps, B, gen,
                                        device)
        drop = model.cond_drop_mask(B, gen, device)
        noise = torch.randn(x.shape, generator=gen, device=device,
                            dtype=x.dtype)
        loss, terms = accumulate_gradients(model, diffusion, x, y, t, weights,
                                           noise, drop, grad_accum)

        params = state.params()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.items()}
        gnorm = fused_adamw_ema_update(
            grads, state.opt_state, params, state.ema_params, optimizer,
            ema_decay=ema_decay, grad_prescale=1.0 / grad_accum)
        model.zero_grad(set_to_none=True)
        if timestep_sampler == "lsm" and state.sampler_state is not None:
            state.sampler_state = lsm_update(state.sampler_state, t.cpu(),
                                             terms["loss_total"])
        state.step += 1
        metrics = {"loss": loss,
                   "loss_mse": terms["loss_mse"].mean(), "grad_norm": gnorm}
        if "loss_vb" in terms:
            metrics["loss_vb"] = terms["loss_vb"].mean()
        return metrics

    return train_step
