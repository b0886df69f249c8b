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
        out = {name: TASKS[name.split(":")[0]](rank, world, args)
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


def _mesh(spec):
    """A mesh from a job's spec: {axis: size}, or {"ici": ..., "dcn": ...}
    for ``make_hybrid_mesh``."""
    from topiaxl_torch.parallel import make_hybrid_mesh, make_mesh

    if "ici" in spec:
        return make_hybrid_mesh(spec["ici"], spec["dcn"])
    return make_mesh(spec)


def rules(name):
    """``dit_param_rules()``, or under "contiguous" the planted fault: the
    fused qkv rows split as one block (rank 0 gets all of q and half of
    k), as a contiguous ``P(fs, tp)`` would without GSPMD's reshard."""
    from topiaxl_torch.parallel.sharding import Split, dit_param_rules

    out = dit_param_rules()
    if name == "contiguous":
        out = [(pat, tuple(e.axis if isinstance(e, Split) else e
                           for e in spec)) for pat, spec in out]
    return out


def task_generate(rank, world, args):
    """``generate_primx_sharded`` over ``args["mesh"]`` (default: a ``dp``
    mesh of the whole world), with ``param_rules`` where "rules" names
    them: "own" draws the noise from a generator, "fed" takes the given
    noise."""
    from topiaxl_torch.diffusion import create_diffusion
    from topiaxl_torch.models.vae3d import VAE3D
    from topiaxl_torch.parallel import make_mesh
    from topiaxl_torch.pipelines.infer import generate_primx_sharded

    dit = _dit(args).eval()
    vae = VAE3D(**args["vae_kw"]).eval()
    vae.load_state_dict({k: _t(v) for k, v in args["vae_sd"].items()})
    diffusion = create_diffusion(**args["diffusion"])
    mesh = _mesh(args.get("mesh", {"dp": -1}))
    param_rules = rules(args["rules"]) if "rules" in args else None
    res = {}
    for name, kw in (("own", dict(generator=torch.Generator().manual_seed(
            args["seed"]))), ("fed", dict(noise=_t(args["noise"])))):
        out = generate_primx_sharded(
            dit, vae, diffusion, _t(args["y"]), args["mean"], args["std"],
            mesh, cfg_scale=args["cfg_scale"], param_rules=param_rules, **kw)
        res[name] = {"srt": torch.stack([p.srt for p in out]),
                     "feat": torch.stack([p.feat for p in out])}
    return res


def task_train(rank, world, args):
    """One train step on ``args["mesh"]`` (dp, fsdp, tp, sp, hybrid) with
    the given draws, tensor-parallel under ``args["rules"]`` where given;
    returns the metrics and the whole state after it, whether the
    whole tensors load back into a fresh (sharded) state unchanged, and
    under tp the first block's qkv layout and whether the tp parts gather
    back to the weights exactly."""
    from topiaxl_torch.diffusion import create_diffusion
    from topiaxl_torch.parallel.sharding import gather_params, shard_params
    from topiaxl_torch.pipelines.train import (
        DATA_AXES, create_train_state, make_optimizer, make_train_step,
        mesh_groups, shard_model)

    mesh = _mesh(args["mesh"])
    mesh_groups(mesh)
    dit = _dit(args).train()
    out = {}
    if "rules" in args:
        whole = {n: t.clone() for n, t in dit.state_dict().items()}
        shard_params(dit, mesh, rules(args["rules"]))
        qkv = "blocks.0.attn.qkv.weight"
        out["qkv"] = (tuple(dit.state_dict()[qkv].shape),
                      dit.tp_layout.placements.get(qkv))
        out["gathers"] = all(torch.equal(t, whole[n]) for n, t in
                             gather_params(dit).items())
    if "fsdp" in mesh.shape:
        shard_model(dit, mesh, "cpu")
    state = create_train_state(dit)
    step = make_train_step(dit, create_diffusion(**args["diffusion"]),
                           make_optimizer(**args["optimizer"]),
                           ema_decay=args["ema_decay"],
                           grad_accum=args["grad_accum"], mesh=mesh)
    i, n = mesh.split(DATA_AXES)
    batch = {k: _rows(_t(args["batch"][k]), i, n)
             for k in ("x", "y", "t", "drop", "noise")}
    metrics = {k: float(v) for k, v in step(state, batch, 0).items()}
    sd = state.state_dict()
    # a resume: the whole tensors copied back into (the shards of) a state
    fresh = create_train_state(dit)
    fresh.load_state_dict(sd)
    again = fresh.state_dict()
    same = all(torch.equal(again[part][n], sd[part][n])
               for part in ("params", "ema") for n in sd[part])
    return {**out, "metrics": metrics, "params": sd["params"],
            "ema": sd["ema"], "mu": sd["opt"]["mu"], "nu": sd["opt"]["nu"],
            "resumes": same}


def _state_on(args, spec, seed):
    """A model and train step on the mesh ``spec`` (tensor-parallel under
    dit rules where it has tp, FSDP2 where fsdp), its weights drawn from
    ``seed``; the state and step, and this rank's rows of a global batch."""
    from topiaxl_torch.diffusion import create_diffusion
    from topiaxl_torch.models.dit import DiT
    from topiaxl_torch.parallel.sharding import shard_params
    from topiaxl_torch.pipelines.train import (
        DATA_AXES, create_train_state, make_optimizer, make_train_step,
        mesh_groups, shard_model)

    mesh = _mesh(spec)
    mesh_groups(mesh)
    dit = DiT(dtype=torch.float32, param_dtype=torch.float32,
              generator=torch.Generator().manual_seed(seed),
              **args["kw"]).train()
    if mesh.shape.get("tp", 1) > 1:
        shard_params(dit, mesh, rules("dit"))
    if mesh.shape.get("fsdp", 1) > 1:
        shard_model(dit, mesh, "cpu")
    state = create_train_state(dit)
    step = make_train_step(dit, create_diffusion(**args["diffusion"]),
                           make_optimizer(**args["optimizer"]),
                           ema_decay=args["ema_decay"], mesh=mesh)
    i, n = mesh.split(DATA_AXES)
    rows = {k: _rows(_t(args["batch"][k]), i, n) for k in ("x", "y")}
    return state, step, rows


def _snapshot(sd):
    """A copy of a state_dict (whose tensors may be the live ones)."""
    if isinstance(sd, dict):
        return {k: _snapshot(v) for k, v in sd.items()}
    return sd.clone() if isinstance(sd, torch.Tensor) else sd


def task_restore(rank, world, args):
    """A checkpoint written under ``args["a"]`` (two steps) restored into a
    state on ``args["b"]`` built from other weights (``sharded_restore``),
    a third step on each, then the reverse: the whole state dicts, the
    restored qkv layout and the two third-step losses."""
    from topiaxl_torch.core.checkpoint import sharded_restore

    path_a = os.path.join(args["tmp"], "a.pt")
    path_b = os.path.join(args["tmp"], "b.pt")
    sa, step_a, rows_a = _state_on(args, args["a"], 0)
    step_a(sa, rows_a, 7)
    step_a(sa, rows_a, 8)
    sd_a = _snapshot(sa.state_dict())
    if rank == 0:
        torch.save(sd_a, path_a)
    dist.barrier()
    sb, step_b, rows_b = _state_on(args, args["b"], 1)
    sharded_restore(path_a, sb)
    qkv = "blocks.0.attn.qkv.weight"
    layout = (tuple(sb.model.state_dict()[qkv].shape),
              tuple(sb.opt_state.mu[qkv].shape))
    restored = _snapshot(sb.state_dict())
    loss_a = float(step_a(sa, rows_a, 9)["loss"])
    loss_b = float(step_b(sb, rows_b, 9)["loss"])
    sd_b = _snapshot(sb.state_dict())
    if rank == 0:
        torch.save(sd_b, path_b)
    dist.barrier()
    sc, _, _ = _state_on(args, args["a"], 2)
    sharded_restore(path_b, sc)
    return {"a": sd_a, "restored": restored, "b": sd_b,
            "back": sc.state_dict(), "layout": layout, "loss_a": loss_a,
            "loss_b": loss_b}


def task_pp(rank, world, args):
    """The pipeline: forwards over ``args["mesh"]`` at each ``n_micro``
    (float, and W8A8 at the last), whether a stage's state_dict gathers
    back to the weights, and train steps over ``args["train_mesh"]`` with
    the given draws (plain and with remat), each returning its metrics and
    the whole state."""
    from topiaxl_torch.diffusion import create_diffusion
    from topiaxl_torch.models.dit import DiT, quantize_dit_state_dict
    from topiaxl_torch.parallel import (make_pp_forward, make_pp_train_step,
                                        shard_pp_params)
    from topiaxl_torch.parallel.sharding import gather_params
    from topiaxl_torch.pipelines.train import (create_train_state,
                                               make_optimizer)

    mesh = _mesh(args["mesh"])
    x, t, y = (_t(args[k]) for k in ("x", "t", "y"))
    out = {"forward": {}}
    for n_micro in args["n_micro"]:
        stage = shard_pp_params(_dit(args).eval(), mesh)
        with torch.no_grad():
            out["forward"][n_micro] = make_pp_forward(stage, mesh, n_micro)(
                x, t.long(), y)
    out["gathers"] = all(torch.equal(a, _t(args["sd"][k])) for k, a in
                         gather_params(stage).items())
    q = DiT(dtype=torch.float32, quant=True, **args["kw"]).eval()
    q.load_state_dict(quantize_dit_state_dict(q, _dit(args).state_dict()))
    q = shard_pp_params(q, mesh)
    with torch.no_grad():
        out["int8"] = make_pp_forward(q, mesh, args["n_micro"][-1])(
            x, t.long(), y)
    mesh = _mesh(args["train_mesh"])
    i, n = mesh.split(("dp",))
    batch = {k: _rows(_t(args["batch"][k]), i, n)
             for k in ("x", "y", "t", "drop", "noise")}
    for name, remat in (("train", False), ("train_remat", True)):
        dit = _dit(args)
        dit.remat = remat
        stage = shard_pp_params(dit.train(), mesh)
        state = create_train_state(stage)
        step = make_pp_train_step(stage, create_diffusion(**args["diffusion"]),
                                  make_optimizer(**args["optimizer"]), mesh,
                                  n_micro=2, ema_decay=args["ema_decay"])
        metrics = {k: float(v) for k, v in step(state, batch, 0).items()}
        sd = state.state_dict()
        # the whole state (gathered over pp) loads back into a fresh stage
        fresh = create_train_state(stage)
        fresh.load_state_dict(sd)
        again = fresh.state_dict()
        same = all(torch.equal(again[part][n], sd[part][n])
                   for part in ("params", "ema") for n in sd[part])
        out[name] = {"metrics": metrics, "params": sd["params"],
                     "ema": sd["ema"], "mu": sd["opt"]["mu"],
                     "nu": sd["opt"]["nu"], "resumes": same}
    return out


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
         "cli_dp": task_cli, "cli_fsdp": task_cli, "train": task_train,
         "cli": task_cli, "restore": task_restore, "pp": task_pp}
