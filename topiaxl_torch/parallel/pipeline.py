"""Pipeline parallelism for the DiT over a ``pp`` mesh axis (counterpart
of ``topiaxl/parallel/pipeline.py``).

The DiT's ``depth`` blocks are cut into ``pp`` stages of ``depth / pp``
consecutive blocks; each ``pp`` rank holds one stage (the memory point of
pp) and microbatches flow through the stages in a GPipe schedule:

* ``shard_pp_params`` keeps this rank's blocks ``[s * L/pp, (s+1) *
  L/pp)`` in place, under their global names (``blocks.7.attn...``), so
  a stage's state_dict is a part of a whole checkpoint and loads from one
  (``PipelineStage.shard``); ``PipelineStage.gather`` gives back the whole
  (every stage's blocks stacked per leaf, ``stack_dit_params``, summed
  over ``pp`` as zero-padded buffers, then ``unstack_dit_params``);
* the token and timestep embeddings and the final layer are small and run
  replicated on every ``pp`` rank, as in JAX;
* ``make_pp_forward`` runs plain GPipe: ``n_micro + pp - 1`` ticks, stage
  i on microbatch ``tick - i``, the bubble ``(pp - 1) / (n_micro + pp -
  1)`` of each stage's ticks; the last stage's outputs are broadcast to
  every ``pp`` rank (JAX's ``psum`` of them);
* the backward runs the schedule in reverse (``_Pipeline.backward``): the
  last stage starts each microbatch from the output's gradient, each
  stage backpropagates its blocks and hands the input's gradient one
  stage up; the timestep embedding's and the conditioning's gradients are
  summed over the stages, the token embedding's comes from stage 0.

A tick's transfer is JAX's ``ppermute``: ``collectives.shift``, direct
P2P under NCCL and through host memory under gloo with CUDA tensors (the
two ranks on one card), one [mb, N, D] activation (or its gradient) per
stage and tick. Each stage keeps every microbatch's activations for the
backward (GPipe's memory), or, with ``remat``, only each block's input
(``torch.utils.checkpoint``, as ``DiT.forward`` does), and under the
policies JAX's pipeline takes (``dots``, ``flash``, ``flash_mlp``) the
outputs of the ops the policy names as well (``models/dit.py:
remat_context``); ``dots_plus`` raises, as in JAX.

This composes with ``dp``: each dp slice runs its own pipeline on its
rows; ``make_pp_train_step`` averages the gradients over ``dp``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from .collectives import rank as group_rank, shift, size as group_size

# the remat policies JAX's pipeline takes (topiaxl/parallel/pipeline.py:
# stage), beside False and True
PP_REMAT_POLICIES = ("dots", "flash", "flash_mlp")


# --------------------------------------------------------------------------
# layout: a stage's blocks under their global names
# --------------------------------------------------------------------------

class StageBlocks(nn.ModuleDict):
    """One stage's blocks keyed by their global index; iterates its blocks
    in order, as the whole DiT's ``ModuleList`` does."""

    def __iter__(self):
        return iter(self.values())


def stack_dit_params(sd: dict, depth: int) -> dict:
    """``{'stacked': {leaf: [depth, ...]}, 'rest': {...}}`` of a DiT
    state_dict: each block leaf (``blocks.<i>.<leaf>``) stacked over the
    blocks, the rest as it is."""
    blocks = [{k[len(f"blocks.{i}."):]: v for k, v in sd.items()
               if k.startswith(f"blocks.{i}.")} for i in range(depth)]
    stacked = {leaf: torch.stack([b[leaf] for b in blocks])
               for leaf in blocks[0]}
    rest = {k: v for k, v in sd.items() if not k.startswith("blocks.")}
    return {"stacked": stacked, "rest": rest}


def unstack_dit_params(pp_sd: dict, depth: int) -> dict:
    """Inverse of :func:`stack_dit_params` (checkpoint interop)."""
    sd = dict(pp_sd["rest"])
    for i in range(depth):
        sd.update({f"blocks.{i}.{leaf}": v[i]
                   for leaf, v in pp_sd["stacked"].items()})
    return sd


class PipelineStage:
    """This rank's stage: the blocks ``[first, first + per)`` of ``depth``
    over the ``pp`` group. ``shard`` keeps a whole dict's entries that the
    stage holds; ``gather`` rebuilds the whole from every stage's (a
    collective over ``pp``)."""

    def __init__(self, group, depth: int):
        self.group, self.depth = group, depth
        self.stages, self.index = group_size(group), group_rank(group)
        self.per = depth // self.stages
        self.first = self.index * self.per

    def holds(self, name: str) -> bool:
        if not name.startswith("blocks."):
            return True
        i = int(name.split(".")[1])
        return self.first <= i < self.first + self.per

    def shard(self, sd: dict) -> dict:
        return {n: t for n, t in sd.items() if self.holds(n)}

    def gather(self, sd: dict) -> dict:
        rest = {k: v for k, v in sd.items() if not k.startswith("blocks.")}
        mine = {k[len("blocks."):]: v for k, v in sd.items()
                if k.startswith("blocks.")}
        leaves = {k.split(".", 1)[1] for k in mine}
        stacked = {}
        for leaf in sorted(leaves):
            own = mine[f"{self.first}.{leaf}"]
            buf = own.new_zeros((self.depth, *own.shape))
            for i in range(self.first, self.first + self.per):
                buf[i] = mine[f"{i}.{leaf}"]
            if self.group is not None:
                dist.all_reduce(buf, group=self.group)
            stacked[leaf] = buf
        return unstack_dit_params({"stacked": stacked, "rest": rest},
                                  self.depth)


def shard_pp_params(model, mesh, pp_axis: str = "pp"):
    """Keep this rank's stage of ``model`` (a whole DiT, the same weights
    on every rank) in place: its ``depth / pp`` blocks under their global
    names, the rest replicated; the layout as ``model.pp_layout`` (a
    ``PipelineStage``). Build the optimizer state after this. Collective
    (the group's first use); returns ``model``."""
    pp = mesh.shape[pp_axis]
    if model.depth % pp:
        raise ValueError(f"depth {model.depth} not divisible by pp={pp}")
    stage = PipelineStage(mesh.group(pp_axis), model.depth)
    model.blocks = StageBlocks({
        str(i): model.blocks[i]
        for i in range(stage.first, stage.first + stage.per)})
    model.pp_layout = stage
    return model


# --------------------------------------------------------------------------
# pipelined forward and its reverse schedule
# --------------------------------------------------------------------------

class _Schedule:
    """One pipeline's constants: the stage's blocks and group, the
    microbatch count, and how blocks are recomputed in the backward (the
    model's remat mode, False outside training)."""

    def __init__(self, model, n_micro: int):
        self.blocks = list(model.blocks)
        self.stage = model.pp_layout
        self.group = self.stage.group
        self.n_micro = n_micro
        self.remat = model.remat if model.training else False
        self.ticks = n_micro + self.stage.stages - 1
        if self.remat:
            from ..models.dit import remat_context

            self.context_fn = remat_context(self.remat)

    def active(self, tick: int) -> int | None:
        """The microbatch this stage works on at ``tick``, or None."""
        m = tick - self.stage.index
        return m if 0 <= m < self.n_micro else None

    def run(self, h, t_emb, y):
        for blk in self.blocks:
            h = (checkpoint(_block, blk, h, y, t_emb, use_reentrant=False,
                            context_fn=self.context_fn)
                 if self.remat and torch.is_grad_enabled()
                 else _block(blk, h, y, t_emb))
        return h


def _block(blk, h, y, t_emb):
    return blk(h, None, t_emb, y=y)


class _Pipeline(torch.autograd.Function):
    """h [B, N, D], t_emb [B, D], y [B, M, C] -> the stages' output [B, N,
    D] on every pp rank. The forward keeps each microbatch's graph (on
    detached inputs); the backward replays the schedule in reverse. The
    stage's block parameters come in as inputs too, so the output needs a
    gradient whenever they do, whatever h's, t_emb's and y's need; their
    gradients accumulate in their ``.grad`` as the schedule replays."""

    @staticmethod
    def forward(ctx, sched, h, t_emb, y, *block_params):
        n, last = sched.n_micro, sched.stage.stages - 1
        s = sched.stage.index
        hs, ts, ys = h.chunk(n), t_emb.chunk(n), y.chunk(n)
        grad = any(ctx.needs_input_grad[1:])
        records = [None] * n
        outs = torch.zeros_like(h)
        mb = hs[0].shape[0]
        carry = torch.zeros_like(hs[0])
        for tick in range(sched.ticks):
            m = sched.active(tick)
            out = carry
            if m is not None:
                ins = [(hs[m] if s == 0 else carry), ts[m], ys[m]]
                if grad:
                    # a later stage's input carries its blocks' gradient
                    # upstream whatever h's own need
                    needs = list(ctx.needs_input_grad[1:4])
                    needs[0] = needs[0] or s > 0
                    ins = [a.detach().requires_grad_(need)
                           for a, need in zip(ins, needs)]
                with torch.set_grad_enabled(grad):
                    out = sched.run(*ins)
                records[m] = (ins, out)
                if s == last:
                    outs[m * mb:(m + 1) * mb] = out.detach()
            if tick < sched.ticks - 1:
                carry = shift(out.detach(), sched.group, 1,
                              send=m is not None,
                              recv=sched.active(tick + 1) is not None)
        if sched.group is not None:
            dist.broadcast(outs, dist.get_global_rank(sched.group, last),
                           group=sched.group)
        ctx.sched, ctx.records = sched, records
        return outs

    @staticmethod
    def backward(ctx, g):
        sched, records = ctx.sched, ctx.records
        n, s = sched.n_micro, sched.stage.index
        last = sched.stage.stages - 1
        g = g.contiguous()
        gs = g.chunk(n)
        gh = torch.zeros_like(g)
        gt = gy = None
        carry = torch.zeros_like(gs[0])
        for tick in reversed(range(sched.ticks)):
            m = sched.active(tick)
            send = torch.zeros_like(gs[0])
            if m is not None:
                (h_in, t_in, y_in), out = records[m]
                torch.autograd.backward(out, gs[m] if s == last else carry)
                records[m] = None
                if h_in.grad is not None:
                    send = h_in.grad
                    if s == 0:
                        gh[m * send.shape[0]:(m + 1) * send.shape[0]] = send
                if t_in.grad is not None:
                    gt = [None] * n if gt is None else gt
                    gt[m] = t_in.grad
                if y_in.grad is not None:
                    gy = [None] * n if gy is None else gy
                    gy[m] = y_in.grad
            if tick > 0:
                carry = shift(send, sched.group, -1, send=m is not None,
                              recv=sched.active(tick - 1) is not None)
        out = [None]
        for need, part, whole in ((ctx.needs_input_grad[1], None, gh),
                                  (ctx.needs_input_grad[2], gt, None),
                                  (ctx.needs_input_grad[3], gy, None)):
            if not need:
                out.append(None)
                continue
            t = whole if whole is not None else torch.cat(part)
            if sched.group is not None:
                dist.all_reduce(t, group=sched.group)
            out.append(t)
        return (*out, *(None for _ in ctx.needs_input_grad[4:]))


def make_pp_forward(model, mesh, n_micro: int):
    """Returns ``forward(x, t, y, drop=None) -> [B, N, C_out]`` of a DiT
    stage (``shard_pp_params``): ``model(x, t, y, drop)``'s numbers, the
    blocks pipelined over ``pp`` in ``n_micro`` microbatches (every op is
    per row, so microbatching only re-tiles the batch). x, t, y are this
    dp slice's rows; every pp rank passes the same and gets the output.
    ``mesh`` is the one the stage was cut on (``depth % pp`` raised there).
    """
    from ..models.dit import check_remat

    check_remat(model.remat, PP_REMAT_POLICIES)
    if getattr(model, "pp_layout", None) is None:
        raise ValueError("make_pp_forward takes a stage: shard_pp_params "
                         "first")

    def forward(x, t, y, drop=None):
        B = x.shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
        y = model.drop_cond(y, drop)
        h = model.embed_tokens(x)
        t_emb = model.embed_t(t)
        sched = _Schedule(model, n_micro)
        h = _Pipeline.apply(sched, h, t_emb, y, *(
            p for blk in sched.blocks for p in blk.parameters()))
        return model.apply_final(h, t_emb)

    return forward


# --------------------------------------------------------------------------
# pipelined train step (mirrors pipelines/train.make_train_step)
# --------------------------------------------------------------------------

def make_pp_train_step(model, diffusion, optimizer, mesh, n_micro: int,
                       ema_decay: float = 0.9999, dp_axis: str = "dp"):
    """``train_step(state, batch, seed) -> metrics`` over a DiT stage, with
    ``pipelines/train.py:make_train_step``'s contract and numbers (the
    same draws over the global batch, the same loss and update); only the
    blocks run pipelined. ``batch`` holds this dp slice's rows; the
    gradients are averaged over ``dp`` (one all-reduce of every gradient)
    and the clip's norm sums the stages' blocks over ``pp`` and counts the
    replicated tensors once."""
    from ..pipelines.train import build_train_step

    forward = make_pp_forward(model, mesh, n_micro)
    dp_group = mesh.group(dp_axis)
    stage = model.pp_layout

    def sync_grads(grads: dict) -> None:
        if dp_group is None:
            return
        flat = torch.cat([g.reshape(-1) for g in grads.values()])
        dist.all_reduce(flat, group=dp_group)
        flat /= group_size(dp_group)
        offset = 0
        for g in grads.values():
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    blocks = frozenset(n for n, _ in model.named_parameters()
                       if n.startswith("blocks."))
    return build_train_step(
        model, diffusion, optimizer, forward, mesh.split((dp_axis,)),
        dp_group, dict(split_group=stage.group, split_names=blocks),
        ema_decay=ema_decay, sync_grads=sync_grads)
