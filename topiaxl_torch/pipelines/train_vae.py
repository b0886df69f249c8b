"""3D VAE training, the payload compressor (counterpart of
``topiaxl/pipelines/train_vae.py``).

The reference trains its VAE with L1 / per-group / DCT reconstruction and
KL (dva/losses.py:17-100) but never shipped the loop. Batches are raw
payloads [B, C, S, S, S] normalised as the pipeline expects (sdf * 5,
rest * 2 - 1: ``pipelines/data.py:normalize_payload``).

The model holds f32 master weights and computes in its ``dtype``
(``VAE3D(param_dtype=torch.float32)``); the optimizer is any
``torch.optim`` optimizer over its parameters (``torch.optim.Adam`` is
optax's ``adam``). The step advances the state in place, where the JAX
package returns a new one. The posterior's noise comes from a generator
seeded with ``(seed, step)`` (the JAX step folds the step into its key),
so a resumed run draws what an uninterrupted one would.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .losses import vae_loss
from .train import _step_generators

DEFAULT_WEIGHTS = {"sdf": 1.0, "rgb": 1.0, "mat": 1.0, "kl": 1e-6}


@dataclass
class VAETrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer


def create_vae_train_state(model: torch.nn.Module,
                           optimizer: torch.optim.Optimizer) -> VAETrainState:
    return VAETrainState(step=0, model=model, optimizer=optimizer)


def make_vae_train_step(vae, loss_kind: str = "sep_l1", weights=None):
    """Returns ``step(state, batch, seed) -> metrics``: one optimizer
    update on ``batch['gt']`` [B, C, S, S, S]. ``batch['noise']`` (shaped
    like the posterior's mean), when given, replaces the generator's draw.
    Metrics are the loss dict's device scalars and ``grad_norm``, the
    global norm of the gradient."""
    weights = dict(weights or DEFAULT_WEIGHTS)

    def step(state: VAETrainState, batch: dict, seed: int) -> dict:
        gt = batch["gt"]
        gen, _ = _step_generators(seed, state.step, gt.device)
        posterior = vae.encode(gt)
        z = posterior.sample(gen, noise=batch.get("noise"))
        recon = vae.decode(z)
        total, ld = vae_loss(gt, recon, posterior, weights, loss_kind)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        grads = [p.grad for p in vae.parameters() if p.grad is not None]
        gnorm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        state.optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in ld.items()}
        metrics["grad_norm"] = gnorm
        return metrics

    return step
