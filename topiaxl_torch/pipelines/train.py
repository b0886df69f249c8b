"""DiT training on one device or across ranks (counterpart of
``topiaxl/pipelines/train.py``).

The reference recipe (configs/inference_dit.yml:77-95): AdamW lr 1e-4 wd
0 with clip-by-global-norm 1, cosine schedule with 3k warmup,
v-prediction MSE + VB (learned-range sigma), cond-drop 0.1, EMA. One
train step draws the times, the cond-drop mask and the noise over the
full batch, runs ``grad_accum`` microbatches forward and backward
(gradients accumulate in ``.grad``), then applies ``fused_adamw_ema_update``.
It knows neither its model nor its objective: the objective draws the
times and weights (``sample_times``) and gives the per-row loss terms
(``training_losses``: the Gaussian diffusion's hybrid loss, or TRELLIS's
velocity MSE, ``diffusion/flow.py``); the model draws the mask
(``cond_drop_mask``) and says what a dropped row's conditioning is
(``drop_cond``).

The model holds f32 master weights (``DiT(param_dtype=torch.float32)``);
Adam moments and EMA are f32 tensors keyed by parameter name. The update
runs in place on the parameters, moments and EMA, where the JAX package
returns new trees; on the card it is one kernel over every tensor.

Random draws come from generators seeded with ``(seed, step)``, so a
resumed run draws what an uninterrupted one would.

Across ranks (``make_train_step(mesh=...)``, ``parallel/mesh.py``) each
rank holds its slice of the global batch (row-major over the mesh, as
JAX's ``batch_sharding`` splits it over ``dp``). Timesteps, cond-drop and
noise are drawn over the global batch on every rank and sliced, so the
step is the single process's step at the global batch, up to summation
order. Gradients are averaged over the data ranks by the library: by
``DistributedDataParallel`` (made by ``make_train_step``, its all-reduce
overlapping the backward) for a model that is not sharded, by FSDP2's
reduce-scatter for one that ``shard_model`` sharded (every DiT block and
the root ``fully_shard``-ed over ``fsdp``, replicated over ``dp``). The
clip uses the global norm (the squared norms of the local shards summed
over the ``fsdp`` group); Adam moments and EMA
shard with their parameters; the loss metrics are averaged over the
ranks; the LSM history gathers every rank's (t, loss). The cond-drop follows
the JAX package: the single pass (``grad_accum == 1``) drops inside the
model's forward, so a null embedding gets the dropped rows' gradient;
with ``grad_accum > 1`` the dropped rows take the null conditioning before
the microbatch loop and outside the gradient (``train.py:210-214``), so
it gets none from them.

Tensor parallelism (a model that ``parallel/sharding.py:shard_params``
split over ``tp``): every ``tp`` rank of a data slice holds the same rows
and the same draws; the split sublayers sum their partial products over
the ``tp`` group (``models/layers.py``), so every replicated parameter
gets the whole gradient on each ``tp`` rank. Data parallelism then runs
over the ranks of this rank's ``tp`` coordinate (DDP over its
``("dp", "fsdp")`` group, or FSDP2 over that sub-mesh). The clip's
global norm sums the squares of the split tensors' shards over ``tp``
and counts the replicated ones once. Context parallelism (``sp``, the dp
x sp step): every ``sp`` rank of a data slice holds its rows, the model
runs through ``parallel/context.py:make_cp_forward`` (its tokens over
``sp``, self-attention on the ring) and the gradients are averaged over
dp x sp by DDP (each ``sp`` rank's is P times its tokens' share).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..core.profiling import span
from ..diffusion.timestep_sampler import (
    LossSecondMomentState,
    lsm_sample,
    lsm_update,
)
from ..ops.adamw_ema import adamw_ema
from ..parallel.collectives import all_mean, full, local

# the axes a global batch is split over; the others (tp, sp, pp) hold the
# same rows
DATA_AXES = ("dp", "fsdp")


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
                   grad_clip: Optional[float] = 1.0,
                   schedule: str = "cosine_warmup") -> dict:
    """The hyperparameters of clip-by-global-norm + AdamW (optax's b1,
    b2, eps) with the cosine warmup schedule, or with ``schedule=
    "constant"`` the rate ``lr`` at every step (TRELLIS's trainer)."""
    if schedule == "constant":
        sched = lambda step: float(np.float32(lr))  # noqa: E731
    elif schedule == "cosine_warmup":
        sched = cosine_warmup_schedule(lr, warmup_iters, max_iters)
    else:
        raise ValueError(f"schedule={schedule!r}: expected 'cosine_warmup' "
                         f"or 'constant'")
    return dict(sched=sched,
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
                           grad_prescale: float = 1.0,
                           norm_group=None, split_group=None,
                           split_names=frozenset()) -> torch.Tensor:
    """clip-by-global-norm + AdamW + EMA, in place, with the JAX
    package's math (``topiaxl/pipelines/train.py:77-139``): moments in
    f32; the gradient scaled by ``grad_prescale * min(1, clip / gnorm)``,
    the clip taking effect only when ``gnorm >= clip`` (no epsilon on the
    norm, unlike ``clip_grad_norm_``); the learning rate from the
    schedule at the count before this step; the EMA folded in after the
    parameter update. Dicts are keyed alike; ``grads`` is left as it is.
    After the norm, one pass over every tensor (``ops/adamw_ema.py``: the
    CUDA kernel on the card, its plain foreach twin on the CPU).
    Returns the global norm of the prescaled gradient (a device scalar).
    FSDP2 parameters update their local shards; ``norm_group`` (the ranks
    a shard is split over) sums the squared norms of the shards. Under
    tensor or pipeline parallelism the squares of the ``split_names``
    tensors (their ``tp`` parts, a stage's blocks) are summed over
    ``split_group`` as well; the replicated ones count once."""
    names = list(params)
    p = [local(params[n].data) for n in names]
    g = [local(grads[n]) for n in names]
    m = [local(opt_state.mu[n]) for n in names]
    v = [local(opt_state.nu[n]) for n in names]
    e = [local(ema_params[n]) for n in names]
    b1, b2, eps = spec["b1"], spec["b2"], spec["eps"]
    wd, clip = spec["weight_decay"], spec["grad_clip"]

    f32 = np.float32
    cf = f32(opt_state.count + 1)
    c1 = float(f32(1.0) - f32(b1) ** cf)
    c2 = float(f32(1.0) - f32(b2) ** cf)
    lr = spec["sched"](opt_state.count)
    norms = torch.stack(torch._foreach_norm(g))
    if norm_group is None and split_group is None:
        gnorm = torch.linalg.vector_norm(norms) * grad_prescale
    else:
        split = torch.tensor([n in split_names for n in names],
                             device=norms.device)
        sq = norms.square()
        sq = torch.stack([sq[split].sum(), sq[~split].sum()])
        if norm_group is not None:
            torch.distributed.all_reduce(sq, group=norm_group)
        if split_group is not None:
            torch.distributed.all_reduce(sq[0:1], group=split_group)
        gnorm = sq.sum().sqrt() * grad_prescale
    if clip:
        gscale = grad_prescale * torch.where(gnorm < clip, 1.0, clip / gnorm)
    else:
        gscale = torch.full((), grad_prescale, device=gnorm.device)
    adamw_ema(p, g, m, v, e, gscale, lr=lr, c1=c1, c2=c2, b1=b1, b2=b2,
              eps=eps, wd=wd, decay=ema_decay)
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
        """Everything a resume needs, as tensors and ints; sharded (FSDP2,
        tensor-parallel, pipeline-stage) tensors gathered whole, which is
        collective: the same dict whatever mesh the state lives on."""
        from ..parallel.sharding import gather_params

        s = self.sampler_state

        def whole(d):
            return gather_params(self.model,
                                 {n: full(t) for n, t in d.items()})

        return {"step": self.step,
                "params": whole(self.model.state_dict()),
                "ema": whole(self.ema_params),
                "opt": {"count": self.opt_state.count,
                        "mu": whole(self.opt_state.mu),
                        "nu": whole(self.opt_state.nu)},
                "sampler": None if s is None else {
                    "loss_history": s.loss_history,
                    "loss_counts": s.loss_counts}}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Copy a ``state_dict`` (whole tensors, written under any mesh)
        into this state's tensors, in place: a pipeline stage takes its
        blocks, a tensor-parallel tensor its ``tp`` part, an FSDP2 one its
        shard of that."""
        from ..parallel.sharding import scatter_params

        self.step = int(sd["step"])
        self.opt_state.count = int(sd["opt"]["count"])
        for mine, theirs in ((self.model.state_dict(), sd["params"]),
                             (self.ema_params, sd["ema"]),
                             (self.opt_state.mu, sd["opt"]["mu"]),
                             (self.opt_state.nu, sd["opt"]["nu"])):
            theirs = scatter_params(self.model, theirs)
            if mine.keys() != theirs.keys():
                raise KeyError("checkpoint parameters differ from the model's")
            for n, t in mine.items():
                _copy_whole_(t, theirs[n])
        if sd["sampler"] is not None:
            self.sampler_state = LossSecondMomentState(
                sd["sampler"]["loss_history"].cpu(),
                sd["sampler"]["loss_counts"].cpu())


def _copy_whole_(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst.copy_(src), where a DTensor ``dst`` takes its shard of the whole
    ``src`` (every rank holds ``src``)."""
    if not hasattr(dst, "to_local"):
        dst.copy_(src)
        return
    from torch.distributed.tensor import distribute_tensor

    shard = distribute_tensor(src.to(dst.device, dst.dtype), dst.device_mesh,
                              dst.placements, src_data_rank=None)
    dst.to_local().copy_(shard.to_local())


def shard_model(model: nn.Module, mesh, device_type: str) -> nn.Module:
    """FSDP2 over ``mesh``'s ``fsdp`` axis (replicated over ``dp``): every
    block of ``model.blocks`` sharded on its own, then the rest at the
    root. Parameters keep their dtype (f32 masters). Under tensor
    parallelism (``shard_params`` first) each rank's local tensors shard
    over the ``("dp", "fsdp")`` sub-mesh of its ``tp`` coordinate."""
    from torch.distributed.fsdp import fully_shard

    axes = tuple(n for n in ("dp", "fsdp") if n in mesh.shape)
    dm = mesh.device_mesh(device_type, axes)
    for blk in model.blocks:
        fully_shard(blk, mesh=dm)
    fully_shard(model, mesh=dm)
    return model


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


def accumulate_gradients(model, diffusion, x, y, t, weights, noise, drop,
                         grad_accum: int = 1, forward=None):
    """Forward and backward of ``grad_accum`` equal microbatches of the
    objective ``diffusion``'s loss, the gradients summed into the
    parameters' ``.grad`` (undivided, as the JAX package's
    ``accum_grads`` returns them). ``drop`` ([B] bool or None) marks the
    rows whose conditioning is the model's null conditioning
    (``model.drop_cond``): inside the model's forward for the single
    pass, before the loop and outside the gradient for ``grad_accum > 1``.
    ``forward`` (default ``model``) runs
    the model: a ``DistributedDataParallel`` wrapper syncs the gradients
    in the last microbatch's backward only. Returns (the mean of the
    microbatch losses, the per-row loss terms, detached)."""
    forward = model if forward is None else forward
    B = x.shape[0]
    if B % grad_accum:
        raise ValueError(f"batch {B} not divisible by grad_accum={grad_accum}")
    if grad_accum > 1:
        y, drop = model.drop_cond(y, drop).detach(), None
    mb = B // grad_accum
    terms_all: dict = {}
    loss_sum = torch.zeros((), device=x.device)
    for i in range(grad_accum):
        sl = slice(i * mb, (i + 1) * mb)
        drop_i = None if drop is None else drop[sl]

        def model_fn(x_t, t_orig, y=y[sl], drop=drop_i):
            return forward(x_t, t_orig, y, drop)

        last = i == grad_accum - 1
        with (contextlib.nullcontext() if last or not hasattr(
                forward, "no_sync") else forward.no_sync()):
            with span("train.forward"):
                terms = diffusion.training_losses(model_fn, x[sl], t[sl],
                                                  noise[sl])
                loss = (terms["loss_total"] * weights[sl]).mean()
            with span("train.backward"):
                loss.backward()
        loss_sum += loss.detach()
        for k, val in terms.items():
            terms_all.setdefault(k, []).append(val.detach())
    return loss_sum / grad_accum, {k: torch.cat(vs)
                                   for k, vs in terms_all.items()}


def mesh_groups(mesh) -> dict:
    """The process groups a train step on ``mesh`` uses, made (collective,
    every rank in this order) on first call: ``data`` (the ranks whose rows
    differ: dp x fsdp) and ``sync`` (the ranks that average gradients:
    dp x fsdp x sp, this rank's ``tp`` and ``pp`` coordinates)."""
    return {"data": mesh.group(DATA_AXES),
            "sync": mesh.group(DATA_AXES + ("sp",)),
            "tp": mesh.group("tp"), "fsdp": mesh.group("fsdp")}


def make_train_step(model, diffusion, optimizer: dict,
                    ema_decay: float = 0.9999,
                    timestep_sampler: str = "uniform", grad_accum: int = 1,
                    mesh=None):
    """Returns ``train_step(state, batch, seed) -> metrics``, which
    advances ``state`` in place, on the objective ``diffusion`` (a Gaussian
    diffusion or a rectified flow). ``batch`` is {'x': [B, ...] clean
    samples, 'y': [B, M, Cc] conditioning} on the model's device: this
    rank's rows of the global batch when ``mesh`` is given (every rank
    holding as many). It may carry draws for these rows, 't' [B] in the
    objective's time (a timestep, or a flow time in (0, 1)) with unit
    weights, 'drop' [B] bool and 'noise' [B, ...] (another framework's,
    for parity), which replace the step's own. Metrics are
    device scalars (loss, loss_mse, grad_norm[, loss_vb]), averaged over
    the ranks. Across ranks a model that ``shard_model`` did not shard is
    wrapped in ``DistributedDataParallel`` here, which is collective. A
    model that ``shard_params`` split over ``tp`` trains tensor-parallel;
    a mesh with an ``sp`` axis runs the model through ``make_cp_forward``
    (not with FSDP2)."""
    if timestep_sampler == "lsm" and not diffusion.num_timesteps:
        raise ValueError("timestep_sampler='lsm' weighs the Gaussian "
                         "diffusion's timesteps; a rectified flow draws "
                         "its own")
    parts, index, forward = 1, 0, model
    data_group = norm_group = tp_group = None
    layout = getattr(model, "tp_layout", None)
    if layout is not None and layout.placements:
        tp_group = layout.group
    sp = mesh is not None and mesh.shape.get("sp", 1) > 1
    if mesh is not None:
        index, parts = mesh.split(DATA_AXES)
        data_group = mesh_groups(mesh)["data"]
    sync_group = mesh_groups(mesh)["sync"] if mesh is not None else None
    if sync_group is not None:
        from torch.distributed.fsdp import FSDPModule
        from torch.nn.parallel import DistributedDataParallel

        if isinstance(model, FSDPModule):
            if sp:
                raise ValueError("sp with fsdp: FSDP2 would not average the "
                                 "gradients over sp; use dp x sp")
            # FSDP2 averages the gradients; the norm sums over the shards
            norm_group = mesh.group("fsdp")
        else:
            # the null embedding takes no gradient where nothing drops
            forward = DistributedDataParallel(
                model, process_group=sync_group, broadcast_buffers=False,
                find_unused_parameters=(model.cond_drop_prob <= 0
                                        or grad_accum > 1))
    if sp:
        from ..parallel.context import make_cp_forward

        forward = make_cp_forward(forward, mesh)

    return build_train_step(
        model, diffusion, optimizer, forward, (index, parts), data_group,
        dict(norm_group=norm_group, split_group=tp_group,
             split_names=frozenset(layout.placements) if layout else ()),
        ema_decay=ema_decay, timestep_sampler=timestep_sampler,
        grad_accum=grad_accum)


def build_train_step(model, diffusion, optimizer: dict, forward,
                     split: tuple[int, int], data_group, norm: dict,
                     ema_decay: float = 0.9999,
                     timestep_sampler: str = "uniform", grad_accum: int = 1,
                     sync_grads: Callable | None = None):
    """The step ``make_train_step`` returns, given how the model runs
    (``forward(x_t, t, y, drop)``), this rank's (index, count) of the
    global batch's row blocks, the group whose metrics are averaged, the
    norm's groups (``fused_adamw_ema_update``'s ``norm_group``,
    ``split_group``, ``split_names``) and ``sync_grads(params)``, run
    after the backward where no library syncs the gradients (the
    pipeline, ``parallel/pipeline.py``). The step is the root span
    ``train_step``; its draws (``train.draws``), each microbatch's forward
    and loss (``train.forward``) and backward (``train.backward``) and the
    update (``train.optimizer``) are spans inside it."""
    index, parts = split

    def train_step(state: TrainState, batch: dict, seed: int) -> dict:
        with span("train_step"):
            return step(state, batch, seed)

    def step(state: TrainState, batch: dict, seed: int) -> dict:
        x, y = batch["x"], batch["y"]
        B, device = x.shape[0], x.device
        rows = slice(index * B, (index + 1) * B)
        lsm = timestep_sampler == "lsm" and state.sampler_state is not None
        with span("train.draws"):
            gen, cpu_gen = _step_generators(seed, state.step, device)
            # every draw over the global batch, then this rank's rows:
            # the times, the cond-drop mask, the noise
            if lsm:
                t, weights = lsm_sample(state.sampler_state, B * parts,
                                        cpu_gen)
            else:
                t, weights = diffusion.sample_times(B * parts, gen, device)
            t, weights = t[rows].to(device), weights[rows].to(device)
            drop = model.cond_drop_mask(B * parts, gen, device)
            drop = None if drop is None else drop[rows]
            noise = torch.randn((B * parts, *x.shape[1:]), generator=gen,
                                device=device, dtype=x.dtype)[rows]
            if "t" in batch:
                t = batch["t"].to(device)
                weights = torch.ones_like(weights)
            drop = batch["drop"].to(device) if "drop" in batch else drop
            noise = (batch["noise"].to(device, x.dtype) if "noise" in batch
                     else noise)
        loss, terms = accumulate_gradients(model, diffusion, x, y, t, weights,
                                           noise, drop, grad_accum, forward)

        with span("train.optimizer"):
            params = state.params()
            grads = {n: (p.grad if p.grad is not None
                         else torch.zeros_like(p))
                     for n, p in params.items()}
            if sync_grads is not None:
                sync_grads(grads)
            gnorm = fused_adamw_ema_update(
                grads, state.opt_state, params, state.ema_params, optimizer,
                ema_decay=ema_decay, grad_prescale=1.0 / grad_accum,
                **norm)
            model.zero_grad(set_to_none=True)
        if lsm:
            state.sampler_state = lsm_update(state.sampler_state, t.cpu(),
                                             terms["loss_total"], data_group)
        state.step += 1
        metrics = {"loss": loss,
                   "loss_mse": terms["loss_mse"].mean(), "grad_norm": gnorm}
        if "loss_vb" in terms:
            metrics["loss_vb"] = terms["loss_vb"].mean()
        return {k: (v if k == "grad_norm" else all_mean(v, data_group))
                for k, v in metrics.items()}

    return train_step
