"""The DiT's training step in plain float32: the hybrid loss averaged over
the batch, its gradient, clip-by-global-norm at 1 (no epsilon), and AdamW
(b1 0.9, b2 0.999, eps 1e-8, weight decay 0) at the learning rate of a
linear warm-up from 0 over ``warmup`` steps then a cosine decay, read at
the count before the step. Each sample's forward and backward runs on its
own, every block under checkpointing, so the step fits beside nothing
else on one card.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from . import diffusion


def lr_at(step: int, base: float, warmup: int, total: int) -> float:
    if step < warmup:
        return base * step / max(warmup, 1)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return base * 0.5 * (1.0 + math.cos(math.pi * prog))


def _ckpt(f, *args):
    return checkpoint(f, *args, use_reentrant=False)


def gradient(P: dict, batch: dict, heads: int):
    """(mean loss, {name: gradient}) of one batch, one sample at a time."""
    params = {k: v.detach().float().requires_grad_() for k, v in P.items()}
    B = batch["x"].shape[0]
    total = 0.0
    for b in range(B):
        rows = {k: v[b:b + 1] for k, v in batch.items()}
        loss = diffusion.training_loss(
            params, rows["x"], rows["y"], rows["t"], rows["noise"],
            rows["drop"], heads, block_fn=_ckpt).sum() / B
        loss.backward()
        total += float(loss.detach())
    return total, {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                   for k, v in params.items()}


@torch.no_grad()
def loss(P: dict, batch: dict, heads: int) -> float:
    """The mean loss of one batch, one sample at a time, no gradient."""
    B = batch["x"].shape[0]
    return sum(float(diffusion.training_loss(
        P, *(batch[k][b:b + 1] for k in ("x", "y", "t", "noise", "drop")),
        heads).sum()) for b in range(B)) / B


class AdamW:
    def __init__(self, lr: float, warmup: int, total: int, clip: float = 1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.warmup, self.total, self.clip = lr, warmup, total, clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.m: dict = {}
        self.v: dict = {}

    @torch.no_grad()
    def step(self, P: dict, grads: dict) -> dict:
        """Updates ``P`` in place; returns the clipped gradients."""
        gnorm = math.sqrt(sum(float(g.double().square().sum())
                              for g in grads.values()))
        scale = 1.0 if gnorm < self.clip else self.clip / gnorm
        lr = lr_at(self.count, self.lr, self.warmup, self.total)
        self.count += 1
        c1, c2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        clipped = {}
        for k, g in grads.items():
            g = g * scale
            clipped[k] = g
            m = self.m.get(k, torch.zeros_like(g)) * self.b1 + (1 - self.b1) * g
            v = self.v.get(k, torch.zeros_like(g)) * self.b2 + (1 - self.b2) * g * g
            self.m[k], self.v[k] = m, v
            P[k] = P[k] - lr * (m / c1) / (torch.sqrt(v / c2) + self.eps)
        return clipped
