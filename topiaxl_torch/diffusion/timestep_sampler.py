"""Importance sampling of training timesteps (counterpart of
``topiaxl/diffusion/timestep_sampler.py``).

``uniform_sample`` draws uniform timesteps with unit weights;
``LossSecondMomentState`` keeps the last ``history`` losses of every
timestep, and ``lsm_sample`` draws timesteps in proportion to
sqrt(E[loss^2]) once every timestep has a full history, with importance
weights 1 / (T p_t). The state is small ([T, history]) and lives on the
CPU; ``lsm_update`` folds a batch in sample by sample, in order, as the
JAX package's scan does. Under data parallelism ``lsm_update`` takes the
process group of the data ranks and first gathers every rank's (t, loss)
in rank order (``jax.lax.all_gather(..., tiled=True)`` in the JAX
package), so every rank keeps the same history.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def uniform_sample(num_timesteps: int, batch: int, generator: torch.Generator,
                   device=None):
    """Uniform timesteps [batch] (long) and unit weights [batch] (f32)
    (reference timestep_sampler.py:62-70)."""
    t = torch.randint(0, num_timesteps, (batch,), generator=generator,
                      device=device)
    return t, torch.ones(batch, dtype=torch.float32, device=device)


@dataclass
class LossSecondMomentState:
    """Loss history per timestep (reference timestep_sampler.py:120-150)."""

    loss_history: torch.Tensor   # [T, history] f32
    loss_counts: torch.Tensor    # [T] int32

    @classmethod
    def create(cls, num_timesteps: int, history_per_term: int = 10):
        return cls(torch.zeros(num_timesteps, history_per_term),
                   torch.zeros(num_timesteps, dtype=torch.int32))


def lsm_weights(state: LossSecondMomentState,
                uniform_prob: float = 0.001) -> torch.Tensor:
    """Sampling probabilities [T]: uniform until every timestep's history
    is full, then sqrt(E[loss^2]) mixed with ``uniform_prob`` of uniform."""
    num_t, hist = state.loss_history.shape
    if not bool((state.loss_counts == hist).all()):
        return torch.full((num_t,), 1.0 / num_t)
    w = state.loss_history.square().mean(dim=-1).sqrt()
    w = w / w.sum()
    return w * (1 - uniform_prob) + uniform_prob / num_t


def lsm_sample(state: LossSecondMomentState, batch: int,
               generator: torch.Generator, uniform_prob: float = 0.001):
    """Timesteps [batch] drawn from ``lsm_weights`` with importance
    weights 1 / (T p_t) (reference timestep_sampler.py:27-59); on the
    CPU, with a CPU generator."""
    p = lsm_weights(state, uniform_prob)
    t = torch.multinomial(p, batch, replacement=True, generator=generator)
    return t, 1.0 / (p.shape[0] * p[t])


def lsm_update(state: LossSecondMomentState, ts: torch.Tensor,
               losses: torch.Tensor, group=None) -> LossSecondMomentState:
    """Fold (t, loss) pairs into the history, in batch order: append while
    a timestep's history has room, else shift it left and write the newest
    last. With ``group`` (every rank passing as many pairs) the pairs of
    all its ranks, in rank order. Returns a new state."""
    if group is not None:
        from ..parallel.collectives import gather

        dev = losses.device
        ts = gather(ts.to(dev, torch.long), group)
        losses = gather(losses.detach().float(), group)
    history = state.loss_history.clone()
    counts = state.loss_counts.clone()
    hist = history.shape[1]
    for t, loss in zip(ts.tolist(), losses.detach().float().cpu().tolist()):
        if counts[t] == hist:
            history[t] = torch.cat([history[t, 1:], history.new_tensor([loss])])
        else:
            history[t, counts[t]] = loss
            counts[t] += 1
    return LossSecondMomentState(history, counts)
