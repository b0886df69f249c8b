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

from .collectives import gather_grad


@contextlib.contextmanager
def ring_self_attention(model: torch.nn.Module, group):
    """Every ``SelfAttention`` of ``model`` on the ring over ``group`` while
    the context is open."""
    from ..models.layers import SelfAttention

    attns = [m for m in model.modules() if isinstance(m, SelfAttention)]
    for a in attns:
        a.backend, a.group = "ring", group
    try:
        yield model
    finally:
        for a in attns:
            a.backend, a.group = "auto", None


def make_cp_forward(model: torch.nn.Module, mesh, axis: str = "sp"):
    """``fwd(x, t, y, drop=None) -> out``: the model's forward
    (``model(x, t, y, drop)``) with the token dim of x and out sharded over
    ``axis``. Every rank passes the whole x [B, N, C] and gets the whole
    output; it computes only its slice of the N / P tokens. N must divide
    by the axis size. Differentiable: where every rank computes the same
    loss on the whole output, each rank's parameter gradient is P times its
    tokens' share (the gather's adjoint sums the ranks' gradients), so
    their mean over the axis is the whole gradient."""
    from .sharding import sequence_sharding

    group = mesh.group(axis)
    tokens = sequence_sharding(mesh, (), axis)

    def fwd(x, t, y, drop=None):
        with ring_self_attention(model, group):
            out = model(tokens(x), t, y, drop)
        return gather_grad(out, group, dim=1)

    return fwd
