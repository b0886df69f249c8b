"""Entry points of the CPU ranks that ``tests/test_torch_parallel.py``
spawns (gloo over localhost), and the spawner.

This module imports torch, numpy and topiaxl_torch only: a spawned child
re-imports the module that holds its function, and one that imported JAX
would pay for it and see the test run's 8-CPU platform. The parent
computes the JAX side and hands every rank numpy inputs in one
``torch.save`` file; each rank writes its results to ``rank<r>.pt``.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(world: int, job: dict, tmp: str, timeout: float = 120.0) -> list:
    """Run ``job`` on ``world`` spawned ranks; returns each rank's results.
    Raises with a rank's traceback if one failed, and kills them all if
    they do not end within ``timeout`` seconds."""
    job_path = os.path.join(tmp, "job.pt")
    torch.save(job, job_path)
    port = free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, world, port, job_path, tmp))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        if any(p.is_alive() for p in procs):
            raise TimeoutError(f"{world} ranks still running after "
                               f"{timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    for r, p in enumerate(procs):
        err = os.path.join(tmp, f"rank{r}.err")
        if os.path.exists(err):
            with open(err) as f:
                raise RuntimeError(f"rank {r} of {world} failed:\n{f.read()}")
        if p.exitcode != 0:
            raise RuntimeError(f"rank {r} of {world} exited {p.exitcode}")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def run(rank: int, world: int, port: int, job_path: str, tmp: str) -> None:
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
        job = torch.load(job_path, weights_only=False)
        out = {name: TASKS[name](rank, world, args)
               for name, args in job.items()}
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rows(a, rank: int, world: int, dim: int = 0):
    n = a.shape[dim] // world
    return a.narrow(dim, rank * n, n)


def task_ring(rank, world, args):
    """This rank's tokens through ``ring_attention`` over the world, and
    the gradient of sum(o * w)."""
    from topiaxl_torch.ops.ring_attention import ring_attention

    q, k, v, w = (_rows(_t(args[n]), rank, world, 1).clone()
                  .requires_grad_(n != "w") for n in ("q", "k", "v", "w"))
    o = ring_attention(q, k, v, args["scale"], dist.group.WORLD)
    (o.float() * w.float()).sum().backward()
    return {"o": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}


def _dit(args):
    from topiaxl_torch.models.dit import DiT

    dit = DiT(dtype=torch.float32, param_dtype=torch.float32, **args["kw"])
    dit.load_state_dict({k: _t(v) for k, v in args["sd"].items()})
    return dit


def task_cp(rank, world, args):
    """``make_cp_forward`` over an ``sp`` mesh of the whole world."""
    from topiaxl_torch.parallel import make_cp_forward, make_mesh

    dit = _dit(args).eval()
    fwd = make_cp_forward(dit, make_mesh({"sp": -1}), axis="sp")
    with torch.no_grad():
        return fwd(_t(args["x"]), _t(args["t"]).long(), _t(args["y"]))


def task_lsm(rank, world, args):
    """``lsm_update`` of this rank's rows of the batch, across ranks."""
    from topiaxl_torch.diffusion.timestep_sampler import (
        LossSecondMomentState, lsm_update)

    state = LossSecondMomentState(_t(args["history"]), _t(args["counts"]))
    state = lsm_update(state, _rows(_t(args["ts"]), rank, world),
                       _rows(_t(args["losses"]), rank, world),
                       group=dist.group.WORLD)
    return {"history": state.loss_history, "counts": state.loss_counts}


def task_generate(rank, world, args):
    """``generate_primx_sharded`` over a ``dp`` mesh of the whole world:
    "own" draws the noise from a generator, "fed" takes the given noise."""
    from topiaxl_torch.diffusion import create_diffusion
    from topiaxl_torch.models.vae3d import VAE3D
    from topiaxl_torch.parallel import make_mesh
    from topiaxl_torch.pipelines.infer import generate_primx_sharded

    dit = _dit(args).eval()
    vae = VAE3D(**args["vae_kw"]).eval()
    vae.load_state_dict({k: _t(v) for k, v in args["vae_sd"].items()})
    diffusion = create_diffusion(**args["diffusion"])
    mesh = make_mesh({"dp": -1})
    res = {}
    for name, kw in (("own", dict(generator=torch.Generator().manual_seed(
            args["seed"]))), ("fed", dict(noise=_t(args["noise"])))):
        out = generate_primx_sharded(
            dit, vae, diffusion, _t(args["y"]), args["mean"], args["std"],
            mesh, cfg_scale=args["cfg_scale"], **kw)
        res[name] = {"srt": torch.stack([p.srt for p in out]),
                     "feat": torch.stack([p.feat for p in out])}
    return res


def task_train(rank, world, args):
    """One train step on a ``mesh`` of the whole world (dp, fsdp or both) with
    the given draws; returns the metrics and the whole state after it."""
    from topiaxl_torch.diffusion import create_diffusion
    from topiaxl_torch.parallel import make_mesh
    from topiaxl_torch.pipelines.train import (
        create_train_state, make_optimizer, make_train_step, shard_model)

    mesh = make_mesh(args["mesh"])
    dit = _dit(args).train()
    if "fsdp" in mesh.shape:
        shard_model(dit, mesh, "cpu")
    state = create_train_state(dit)
    step = make_train_step(dit, create_diffusion(**args["diffusion"]),
                           make_optimizer(**args["optimizer"]),
                           ema_decay=args["ema_decay"],
                           grad_accum=args["grad_accum"], mesh=mesh)
    batch = {k: _rows(_t(args["batch"][k]), mesh.index, mesh.size)
             for k in ("x", "y", "t", "drop", "noise")}
    metrics = {k: float(v) for k, v in step(state, batch, 0).items()}
    sd = state.state_dict()
    # a resume: the whole tensors copied back into (the shards of) a state
    fresh = create_train_state(dit)
    fresh.load_state_dict(sd)
    again = fresh.state_dict()
    same = all(torch.equal(again[part][n], sd[part][n])
               for part in ("params", "ema") for n in sd[part])
    return {"metrics": metrics, "params": sd["params"], "ema": sd["ema"],
            "mu": sd["opt"]["mu"], "nu": sd["opt"]["nu"], "resumes": same}


def task_cli(rank, world, args):
    """``cli.train.main`` on every rank (the process group exists, as
    ``torchrun`` would have made it); returns each step's metrics."""
    from topiaxl_torch.cli.train import main

    recs: list = []
    assert main(args["argv"], metrics_out=recs) == 0
    return recs


TASKS = {"ring": task_ring, "cp": task_cp, "lsm": task_lsm,
         "generate": task_generate, "train_dp": task_train,
         "train_dp_accum": task_train,
         "train_fsdp": task_train, "train_hsdp": task_train,
         "cli_dp": task_cli, "cli_fsdp": task_cli}
