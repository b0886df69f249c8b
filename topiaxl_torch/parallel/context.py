"""Model-level context parallelism: the DiT's tokens sharded over a mesh
axis, self-attention over the K/V ring (counterpart of
``topiaxl/parallel/context.py``).

For prim counts beyond one card's attention budget: each rank of the
``sp`` axis embeds, modulates and projects its own slice of the tokens;
self-attention runs ``ops/ring_attention.py`` over the axis's group,
cross-attention attends the local queries against the whole
conditioning (which every rank holds), and every other op of the DiT is
per token and needs no communication.
"""

from __future__ import annotations

import contextlib

import torch

from ..models.layers import SelfAttention
from .collectives import gather


@contextlib.contextmanager
def ring_self_attention(model: torch.nn.Module, group):
    """Every ``SelfAttention`` of ``model`` on the ring over ``group`` while
    the context is open."""
    attns = [m for m in model.modules() if isinstance(m, SelfAttention)]
    for a in attns:
        a.backend, a.group = "ring", group
    try:
        yield model
    finally:
        for a in attns:
            a.backend, a.group = "auto", None


def make_cp_forward(model: torch.nn.Module, mesh, axis: str = "sp"):
    """``fwd(x, t, y) -> out``: the model's forward (``model(x, t, y)``)
    with the token dim of x and out sharded over ``axis``. Every rank
    passes the whole x [B, N, C] and gets the whole output; it computes
    only its slice of the N / P tokens. N must divide by the axis size."""
    group = mesh.group(axis)
    parts, r = mesh.shape[axis], mesh.coords[axis]

    def fwd(x, t, y):
        N = x.shape[1]
        if N % parts:
            raise ValueError(f"{N} tokens do not divide over {axis}={parts}")
        n = N // parts
        with ring_self_attention(model, group):
            out = model(x[:, r * n:(r + 1) * n], t, y)
        return gather(out, group, dim=1)

    return fwd
