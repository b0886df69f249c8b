"""The few collectives the port's multi-rank paths use, on
``torch.distributed``.

Every one but the pipeline's stage-to-stage ``shift`` is an
``all_reduce``, which each backend takes on every device
(gloo takes CUDA tensors for ``all_reduce`` but not for ``all_gather``,
and gloo is the only backend for two ranks on one card): ``gather``
writes this rank's part into a zeroed buffer of the whole and sums the
buffers, which is exact (x + 0 = x). That moves about twice what an
``all_gather_into_tensor`` would under NCCL; what it gathers is small (a
PrimX batch, the LSM rows of a step, the DiT's output tokens), so one
route for every backend is kept. Gradients are not synced here:
``DistributedDataParallel`` and FSDP2 do that (``pipelines/train.py``).
A ``group`` of None means a single process: nothing is communicated.

Tensor parallelism (``models/layers.py``) needs two conjugate operators,
Megatron's f and g, each an ``autograd.Function`` over ``all_reduce``:
``copy_to_tp`` (identity forward, the gradient summed over the group) at
the entry of a column-parallel projection, ``reduce_from_tp`` (the
partial products summed, identity backward) after a row-parallel one.
``gather_grad`` is ``gather`` with its adjoint (the gradient summed over
the group, then this rank's slice), for a loss computed on the gathered
tensor by every rank.

``shift`` moves a tensor one stage along the pipeline: direct P2P
(``batch_isend_irecv``) where the backend takes the tensor's device, as
NCCL takes CUDA tensors and gloo CPU ones; gloo with a CUDA tensor stages
it through host memory (a device-to-host copy, gloo's P2P, a copy back).
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


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """x unchanged; in the backward its gradient summed over ``group``
    (each rank's column-parallel slice contributed a part of it)."""
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` (partial products of a row-parallel
    projection); the gradient passes through unchanged."""
    return x if group is None else _ReduceFromTP.apply(x, group)


class _GatherGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        part = g.shape[ctx.dim] // size(ctx.group)
        return g.narrow(ctx.dim, rank(ctx.group) * part, part), None, None


def gather_grad(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``gather`` with a gradient: its adjoint sums every rank's gradient
    of the whole and hands each rank its slice."""
    return t if group is None else _GatherGrad.apply(t, group, dim)


def shift(t: torch.Tensor, group, step: int = 1, send: bool = True,
          recv: bool = True) -> torch.Tensor:
    """Each rank sends ``t`` to the rank ``step`` places along ``group``
    (+1 downstream, -1 upstream; none past either end) where ``send``, and
    where ``recv`` returns what the rank ``step`` places before it sent
    (a tensor like ``t``): zeros where nothing came. The ranks must agree
    on who sends to whom."""
    n, r = size(group), rank(group)
    if n == 1:
        return torch.zeros_like(t)
    dst, src = r + step, r - step
    host = t.is_cuda and dist.get_backend(group) != "nccl"
    buf = (t.cpu() if host else t).contiguous()
    got = torch.zeros_like(buf)
    ops = []
    if send and 0 <= dst < n:
        ops.append(dist.P2POp(dist.isend, buf, dist.get_global_rank(
            group, dst), group))
    if recv and 0 <= src < n:
        ops.append(dist.P2POp(dist.irecv, got, dist.get_global_rank(
            group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return got.to(t.device) if host else got
