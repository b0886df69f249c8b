"""The few collectives the port's multi-rank paths use, on
``torch.distributed``.

Every one is an ``all_reduce``, which each backend takes on every device
(gloo takes CUDA tensors for ``all_reduce`` but not for ``all_gather``,
and gloo is the only backend for two ranks on one card): ``gather``
writes this rank's part into a zeroed buffer of the whole and sums the
buffers, which is exact (x + 0 = x). That moves about twice what an
``all_gather_into_tensor`` would under NCCL; what it gathers is small (a
PrimX batch, the LSM rows of a step, the DiT's output tokens), so one
route for every backend is kept. Gradients are not synced here:
``DistributedDataParallel`` and FSDP2 do that (``pipelines/train.py``).
A ``group`` of None means a single process: nothing is communicated.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_mean(t: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``t`` over the group's ranks (a new tensor)."""
    if group is None:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out / size(group)


def gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in rank
    order, on every rank."""
    if group is None:
        return t
    n, r = size(group), rank(group)
    shape = list(t.shape)
    part = shape[dim]
    shape[dim] = part * n
    out = t.new_zeros(shape)
    out.narrow(dim, r * part, part).copy_(t)
    dist.all_reduce(out, group=group)
    return out


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of an FSDP2 (DTensor) parameter or state; any
    other tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole of a DTensor (collective over its mesh); any other tensor
    as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t
