"""Training CLI: ``python -m topiaxl_torch.cli.train config.yml [k=v ...]``.

Runs the reference's DiT training recipe (counterpart of
``topiaxl/cli/train.py``): AdamW + cosine warmup, v-pred MSE + VB,
cond-drop, EMA, checkpoints with resume. Same config keys (train.* /
optimizer.* / scheduler.* / model.generator.* / diffusion.*), read
through ``topiaxl_torch.core.config.load_config``.

Across ranks: ``torchrun --nproc-per-node N -m topiaxl_torch.cli.train
config.yml ...`` and ``train.mesh`` (``{dp: -1}`` as shipped: every rank
on ``dp``; ``{dp: 2, fsdp: 2}``; ``parallel/mesh.py``'s rules). The
global batch is ``train.batch_size`` x dp, split over every rank of the
mesh in JAX's order; ``dp`` alone runs the DiT under
``DistributedDataParallel``, ``fsdp`` shards it, its Adam moments and EMA
with FSDP2 (``pipelines/train.py:shard_model``). ``tp`` > 1 splits the
DiT's heads and MLP units over that many ranks (``dit_param_rules``, as
JAX's CLI places them; ``parallel/sharding.py``), each ``tp`` rank of a
data slice on the same rows; with ``fsdp`` each rank's part is then
sharded over the ``("dp", "fsdp")`` ranks of its ``tp`` coordinate. A
``pp`` axis replicates, as in JAX's CLI, which never pipelines: every
``pp`` rank trains on the same rows with the same numbers (pipelining
is the library's ``parallel/pipeline.py:make_pp_train_step``). Ranks
beyond an explicit smaller mesh idle, as JAX's devices do. Rank 0 writes
the metrics and checkpoints (whole tensors, gathered: a checkpoint
written under one mesh resumes under any other). Without ``torchrun``
the run is one process on one device, every rank on a mesh of one.

The DiT is the one ``model.generator.class_name`` names (``topiaxl.DiT``
or ``topiaxl.DiTAdditivePosEmb``), TRELLIS's sparse-structure flow
transformer (``SparseStructureFlowModel``, ``configs/trellis_ss_flow.yml``:
a [8, 16, 16, 16] latent grid a sample), or Hunyuan3D-2's shape DiT
(``Hunyuan3DDiT``, ``configs/hunyuan3d_dit.yml``: a [3072, 64] latent set
a sample). ``train_recipe``, which
``cli.profile`` calls too, reads the objective (``diffusion.name:
rectified_flow``, ``diffusion/flow.py``, or else the Gaussian diffusion) and
the schedule (``scheduler.class_name: constant``, or else cosine warm-up).
``model.generator.remat=true``, or the reference's
``gradient_checkpointing: true``, recomputes each block in the backward
instead of keeping its activations (less memory, a slower step); a remat
policy by name keeps some of them: ``flash`` the flash
forwards' outputs, ``flash_mlp`` those and fc1's pre-activation, ``dots``
those and every matmul's output, ``dots_plus`` those and the LN streams
(``models/dit.py:REMAT_POLICIES``). ``scan_blocks: true`` trains the
unrolled blocks (the same math). ``quant`` is refused, as in JAX's CLI.

Data: ``train.data_glob`` pointing at token shards (pipelines/data), or
``train.synthetic=true`` for smoke runs and measurement. ``train.device``
(default ``cuda``) picks the device; there is no silent fallback to the
CPU. ``train.max_steps`` caps the run (default ``scheduler.max_iters``).
Metrics go to ``<output_dir>/train/metrics.jsonl``, checkpoints to
``<output_dir>/train/ckpts`` (``train.keep_ckpts``, default 3); a run
resumes from the newest checkpoint there. SIGTERM or SIGINT finishes the
step in flight (across ranks: the steps up to the next that logs or
checkpoints), checkpoints and exits.
"""

from __future__ import annotations

import itertools
import logging
import os
import signal
import sys

import torch

logger = logging.getLogger("topiaxl_torch.train")


def build_dit(g, device, generator: torch.Generator):
    """The trainable DiT that ``model.generator`` names (its
    ``class_name``, through ``topiaxl_torch/registry.py``): f32 master
    weights, compute in ``g.dtype`` (default bf16), ``remat`` (a bool or
    a policy by name) or ``gradient_checkpointing`` honoured."""
    from .. import registry  # noqa: F401  (fills the factory table)
    from ..core.config import build

    if g.get("quant", False):
        raise ValueError("model.generator.quant=true is inference-only; unset "
                         "it for training")
    return build(g, device=device, generator=generator,
                 param_dtype=torch.float32)


def train_recipe(cfg, device) -> tuple:
    """(the objective, the optimizer spec, ``make_train_step``'s
    ``timestep_sampler``, ``grad_accum`` and ``ema_decay``,
    ``create_train_state``'s ``lsm_timesteps``) of a config's
    ``diffusion``, ``optimizer``, ``scheduler``, ``train`` and
    ``model.generator.learn_sigma``: the one reader of ``diffusion.name``
    and ``scheduler.class_name``."""
    from ..diffusion import flow
    from ..diffusion.schedule import create_diffusion
    from ..pipelines.train import make_optimizer

    d, sched, t = cfg.diffusion, cfg.scheduler, cfg.train
    sampler = t.get("timestep_sampler", "uniform")
    if d.get("name") == "rectified_flow":
        objective = flow.from_config(d)
    else:
        objective = create_diffusion(
            timestep_respacing=None, noise_schedule=d.noise_schedule,
            diffusion_steps=d.diffusion_steps,
            parameterization=d.parameterization,
            learn_sigma=cfg.model.generator.get("learn_sigma", True),
            device=device)
    constant = sched.get("class_name") == "constant"
    optimizer = make_optimizer(
        lr=float(cfg.optimizer.lr),
        weight_decay=float(cfg.optimizer.get("weight_decay", 0.0)),
        warmup_iters=int(sched.get("warmup_iters", 0)),
        max_iters=int(sched.max_iters),
        schedule="constant" if constant else "cosine_warmup")
    step_args = dict(timestep_sampler=sampler,
                     grad_accum=int(t.get("grad_accum", 1)),
                     ema_decay=float(t.get("ema_decay", 0.9999)))
    return (objective, optimizer, step_args,
            objective.num_timesteps if sampler == "lsm" else None)


def main(argv=None, metrics_out: list | None = None) -> int:
    """Run the CLI; ``metrics_out`` (a list) receives each step's metrics
    as floats, with the step and its wall seconds."""
    from topiaxl_torch.core.config import load_config

    from ..parallel import mesh_from_config
    from ..parallel.mesh import init_distributed

    argv = list(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(level=logging.INFO)
    if not argv:
        print(__doc__)
        return 1
    cfg = load_config(argv[0], overrides=argv[1:])
    device, joined = init_distributed(
        torch.device(cfg.train.get("device", "cuda")))
    try:
        mesh = mesh_from_config(cfg.train.get("mesh"))
        return _train(cfg, mesh, device, metrics_out)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _train(cfg, mesh, device, metrics_out) -> int:
    import time

    from ..core.checkpoint import CheckpointManager
    from ..core.profiling import MetricLogger, StepMeter
    from ..models.dit import DiT
    from ..pipelines import data as D
    from ..parallel.sharding import dit_param_rules, shard_params
    from ..pipelines.train import (
        DATA_AXES, create_train_state, make_train_step, mesh_groups,
        shard_model)

    fsdp = mesh.shape.get("fsdp", 1) > 1
    tp = mesh.shape.get("tp", 1) > 1
    for axis in (None, *mesh.axis_names):   # collective: every rank
        mesh.group(axis)
    mesh_groups(mesh)
    if fsdp:
        mesh.device_mesh(device.type, tuple(
            n for n in ("dp", "fsdp") if n in mesh.shape))
    if mesh.index is None:
        logger.info("rank %d is outside the mesh %s: idle", mesh.rank,
                    mesh.shape)
        return 0
    lead = mesh.index == 0
    logger.info("mesh %s: rank %d on %s", mesh.shape, mesh.rank, device)
    if "pp" in mesh.shape:
        logger.info("mesh axis pp=%d replicates, as JAX's CLI does (it never "
                    "pipelines): the same rows and numbers on every pp rank",
                    mesh.shape["pp"])
    out_dir = os.path.join(cfg.output_dir, "train")
    os.makedirs(out_dir, exist_ok=True)
    seed = int(cfg.global_seed)

    dit = build_dit(cfg.model.generator, device,
                    torch.Generator(device=device).manual_seed(seed)).train()
    if tp:
        if not isinstance(dit, DiT):
            raise ValueError("train.mesh.tp splits the DiT's heads; "
                             f"{type(dit).__name__} has no tp rules")
        shard_params(dit, mesh, dit_param_rules())
    if fsdp:
        shard_model(dit, mesh, device.type)
    objective, optimizer, step_args, lsm = train_recipe(cfg, device)
    state = create_train_state(dit, lsm)

    ckpt = CheckpointManager(os.path.join(out_dir, "ckpts"),
                             max_to_keep=int(cfg.train.get("keep_ckpts", 3)))
    if ckpt.latest_step() is not None:
        state.load_state_dict(ckpt.restore())
        logger.info("resumed from step %d", state.step)

    global_bs = int(cfg.train.batch_size) * mesh.shape.get("dp", 1)
    index, parts = mesh.split(DATA_AXES)
    if global_bs % parts:
        raise ValueError(f"global batch {global_bs} (train.batch_size x dp) "
                         f"does not split over the mesh's {parts} data ranks")
    if cfg.train.get("synthetic") or not cfg.train.get("data_glob"):
        logger.warning("using synthetic data stream")
        stream = D.synthetic_batches(
            global_bs, cond_seq=int(cfg.train.get("cond_seq", 1370)),
            cond_ch=dit.condition_channels, seed=seed + state.step,
            shape=dit.input_shape)
    else:
        ds = D.TokenShardDataset(cfg.train.data_glob, global_bs,
                                 shuffle_seed=seed)
        stream = itertools.chain.from_iterable(
            ds.epoch(e) for e in itertools.count())
    # this rank's rows of every global batch (row-major over dp x fsdp)
    n = global_bs // parts
    rows = slice(index * n, (index + 1) * n)
    batches = D.prefetch_to_device(
        ({k: v[rows] for k, v in b.items()} for b in stream), device)

    step_fn = make_train_step(dit, objective, optimizer, **step_args,
                              mesh=mesh if mesh.size > 1 else None)
    meter = StepMeter()
    log_every = int(cfg.train.log_every_n_steps)
    mlog = (MetricLogger(os.path.join(out_dir, "metrics.jsonl"),
                         print_every=log_every) if lead else None)
    max_steps = int(cfg.train.get("max_steps", cfg.scheduler.max_iters))
    ckpt_every = int(cfg.train.ckpt_every_n_steps)
    saved = [ckpt.latest_step()]    # every rank decides alike

    def save(step: int) -> None:
        sd = state.state_dict()    # collective under fsdp
        if lead:
            ckpt.save(step, sd)
        saved[0] = step

    def stop(step: int) -> bool:
        """A signal on any rank stops every rank. Alone, after the step in
        flight; across ranks the flags are compared (a collective the host
        waits for) only after a step that logs or checkpoints."""
        group = mesh.group()
        if group is None:
            return bool(preempted)
        if step % log_every and step % ckpt_every:
            return False
        flag = torch.tensor([float(bool(preempted))], device=device)
        torch.distributed.all_reduce(flag, torch.distributed.ReduceOp.MAX,
                                     group=group)
        return bool(flag.item())

    # preemption: finish the step in flight, checkpoint, exit cleanly so
    # the next run resumes from it
    preempted: list = []
    prev = {s: signal.signal(s, lambda sig, frame: preempted.append(sig))
            for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        while state.step < max_steps and not stop(state.step):
            batch = next(batches)
            t0 = time.perf_counter()
            metrics = step_fn(state, batch, seed)
            meter.tick()
            step = state.step
            if step % log_every == 0 or metrics_out is not None:
                vals = {k: float(v) for k, v in metrics.items()}
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                if metrics_out is not None:
                    metrics_out.append(
                        {"step": step, "seconds": time.perf_counter() - t0,
                         **vals})
                if step % log_every == 0 and mlog is not None:
                    mlog.log(step, {**vals,
                                    "steps_per_sec": meter.steps_per_sec})
            if step % ckpt_every == 0:
                save(step)
        if preempted:
            logger.warning("signal %s: checkpointing at step %d and exiting",
                           preempted[0], state.step)
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
        if mlog is not None:
            mlog.close()
    if saved[0] != state.step:
        save(state.step)
    logger.info("training done at step %d", state.step)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
