"""Rectified flow: TRELLIS's flow-matching objective
(``trellis/trainers/flow_matching/flow_matching.py``), for models trained
on velocity.

With data x0, noise eps and a time t in (0, 1):

    x_t = (1 - t) x0 + (sigma_min + (1 - sigma_min) t) eps
    v   = (1 - sigma_min) eps - x0

the model is called on (x_t, 1000 t) and trained on the mean squared
error of its prediction against v. Times are drawn logit-normal:
``t = sigmoid(N(mean, std))`` (``t_schedule: {name: logit_normal, mean,
std}``). ``pipelines/train.py`` takes this objective where a config's
``diffusion.name`` is ``rectified_flow`` (``from_config``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class RectifiedFlow:
    sigma_min: float = 1e-5
    t_mean: float = 1.0
    t_std: float = 1.0

    def sample_t(self, n: int, generator: torch.Generator,
                 device=None) -> torch.Tensor:
        """[n] f32 logit-normal times in (0, 1) from ``generator``."""
        z = torch.randn(n, generator=generator, device=device)
        return torch.sigmoid(z * self.t_std + self.t_mean)

    def noised(self, x0: torch.Tensor, t: torch.Tensor,
               noise: torch.Tensor) -> torch.Tensor:
        """x_t for rows at times ``t`` [B]."""
        tb = t.float().reshape(-1, *(1,) * (x0.dim() - 1))
        sigma = self.sigma_min + (1 - self.sigma_min) * tb
        return (1 - tb) * x0 + sigma * noise

    def target(self, x0: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """The velocity the model is trained on."""
        return (1 - self.sigma_min) * noise - x0

    def training_losses(self, model_fn, x0: torch.Tensor, t: torch.Tensor,
                        noise: torch.Tensor) -> dict:
        """{"loss_total", "loss_mse"}: [B] per-row mean squared error of
        ``model_fn(x_t, 1000 t)`` against the velocity, in f32."""
        x0 = x0.float()
        pred = model_fn(self.noised(x0, t, noise.float()), t.float() * 1000)
        err = (pred.float() - self.target(x0, noise.float())).square()
        mse = err.reshape(err.shape[0], -1).mean(dim=1)
        return {"loss_total": mse, "loss_mse": mse}


def from_config(node) -> RectifiedFlow:
    """The objective of a ``diffusion`` config node ``{name:
    rectified_flow, sigma_min, t_schedule: {name, mean, std}}``."""
    sched = node.get("t_schedule") or {}
    if sched.get("name", "logit_normal") != "logit_normal":
        raise ValueError(f"t_schedule {sched.get('name')!r}: only "
                         f"'logit_normal' is implemented")
    return RectifiedFlow(sigma_min=float(node.get("sigma_min", 1e-5)),
                         t_mean=float(sched.get("mean", 1.0)),
                         t_std=float(sched.get("std", 1.0)))
