"""Training CLI: ``python -m topiaxl_torch.cli.train config.yml [k=v ...]``.

Runs the reference's DiT training recipe on one device (counterpart of
``topiaxl/cli/train.py``): AdamW + cosine warmup, v-pred MSE + VB,
cond-drop, EMA, checkpoints with resume. Same config keys (train.* /
optimizer.* / scheduler.* / model.generator.* / diffusion.*), read
through ``topiaxl_torch.core.config.load_config``; no mesh
(``train.mesh`` is ignored).

The DiT is the one ``model.generator.class_name`` names (``topiaxl.DiT``
or ``topiaxl.DiTAdditivePosEmb``). ``model.generator.remat=true``, or the
reference's ``gradient_checkpointing: true``, recomputes each block in
the backward instead of keeping its activations (less memory, a slower
step); a remat policy by name (``dots``, ``flash``, ...), ``scan_blocks``
and ``quant`` are refused.

Data: ``train.data_glob`` pointing at token shards (pipelines/data), or
``train.synthetic=true`` for smoke runs and measurement. ``train.device``
(default ``cuda``) picks the device; there is no silent fallback to the
CPU. ``train.max_steps`` caps the run (default ``scheduler.max_iters``).
Metrics go to ``<output_dir>/train/metrics.jsonl``, checkpoints to
``<output_dir>/train/ckpts`` (``train.keep_ckpts``, default 3); a run
resumes from the newest checkpoint there. SIGTERM or SIGINT finishes the
step in flight, checkpoints and exits.
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
    weights, compute in ``g.dtype`` (default bf16), ``remat`` or
    ``gradient_checkpointing`` honoured."""
    from .. import registry  # noqa: F401  (fills the factory table)
    from ..core.config import build

    if g.get("quant", False):
        raise ValueError("model.generator.quant=true is inference-only; unset "
                         "it for training")
    return build(g, device=device, generator=generator,
                 param_dtype=torch.float32)


def main(argv=None, metrics_out: list | None = None) -> int:
    """Run the CLI; ``metrics_out`` (a list) receives each step's metrics
    as floats, with the step and its wall seconds."""
    import time

    from topiaxl_torch.core.config import load_config

    from ..core.checkpoint import CheckpointManager
    from ..core.profiling import MetricLogger, StepMeter
    from ..diffusion.schedule import create_diffusion
    from ..pipelines import data as D
    from ..pipelines.train import (
        create_train_state, make_optimizer, make_train_step)

    argv = list(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(level=logging.INFO)
    if not argv:
        print(__doc__)
        return 1
    cfg = load_config(argv[0], overrides=argv[1:])
    device = torch.device(cfg.train.get("device", "cuda"))
    out_dir = os.path.join(cfg.output_dir, "train")
    os.makedirs(out_dir, exist_ok=True)
    seed = int(cfg.global_seed)

    dit = build_dit(cfg.model.generator, device,
                    torch.Generator(device=device).manual_seed(seed)).train()
    diffusion = create_diffusion(
        timestep_respacing=None, noise_schedule=cfg.diffusion.noise_schedule,
        diffusion_steps=cfg.diffusion.diffusion_steps,
        parameterization=cfg.diffusion.parameterization,
        learn_sigma=cfg.model.generator.get("learn_sigma", True),
        device=device)
    optimizer = make_optimizer(
        lr=float(cfg.optimizer.lr),
        weight_decay=float(cfg.optimizer.get("weight_decay", 0.0)),
        warmup_iters=int(cfg.scheduler.warmup_iters),
        max_iters=int(cfg.scheduler.max_iters))
    sampler = cfg.train.get("timestep_sampler", "uniform")
    state = create_train_state(
        dit, lsm_timesteps=diffusion.num_timesteps if sampler == "lsm" else None)

    ckpt = CheckpointManager(os.path.join(out_dir, "ckpts"),
                             max_to_keep=int(cfg.train.get("keep_ckpts", 3)))
    if ckpt.latest_step() is not None:
        state.load_state_dict(ckpt.restore())
        logger.info("resumed from step %d", state.step)

    bs = int(cfg.train.batch_size)
    if cfg.train.get("synthetic") or not cfg.train.get("data_glob"):
        logger.warning("using synthetic data stream")
        stream = D.synthetic_batches(
            bs, dit.seq_length, dit.in_channels,
            cond_seq=int(cfg.train.get("cond_seq", 1370)),
            cond_ch=dit.condition_channels, seed=seed + state.step)
    else:
        ds = D.TokenShardDataset(cfg.train.data_glob, bs, shuffle_seed=seed)
        stream = itertools.chain.from_iterable(
            ds.epoch(e) for e in itertools.count())
    batches = D.prefetch_to_device(stream, device)

    step_fn = make_train_step(
        dit, diffusion, optimizer,
        ema_decay=float(cfg.train.get("ema_decay", 0.9999)),
        timestep_sampler=sampler,
        grad_accum=int(cfg.train.get("grad_accum", 1)))
    meter = StepMeter()
    log_every = int(cfg.train.log_every_n_steps)
    mlog = MetricLogger(os.path.join(out_dir, "metrics.jsonl"),
                        print_every=log_every)
    max_steps = int(cfg.train.get("max_steps", cfg.scheduler.max_iters))
    ckpt_every = int(cfg.train.ckpt_every_n_steps)

    # preemption: finish the step in flight, checkpoint, exit cleanly so
    # the next run resumes from it
    preempted: list = []
    prev = {s: signal.signal(s, lambda sig, frame: preempted.append(sig))
            for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        while state.step < max_steps and not preempted:
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
                if step % log_every == 0:
                    mlog.log(step, {**vals,
                                    "steps_per_sec": meter.steps_per_sec})
            if step % ckpt_every == 0:
                ckpt.save(step, state.state_dict())
        if preempted:
            logger.warning("signal %s: checkpointing at step %d and exiting",
                           preempted[0], state.step)
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
        mlog.close()
    if ckpt.latest_step() != state.step:
        ckpt.save(state.step, state.state_dict())
    logger.info("training done at step %d", state.step)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
