"""topiaxl_torch across ranks against the JAX package, on the CPU: gloo
ranks spawned by ``tests/torch_dist_workers.py`` (2 and 4 of them, each
with a time limit), the JAX side on this process's 8-CPU mesh.

Bars (f32): ring attention's output within 2e-5 of JAX's ring and of
dense attention (JAX's own test's bar), its gradients within 1e-5 of the
largest (each block's backward against the merged lse is exact up to
summation order); ``make_cp_forward`` within 1e-4 of the plain forward
(JAX's bar); ``lsm_update`` exact; ``generate_primx_sharded`` within
1e-6 of ``generate_primx`` (the same graph per asset) and within 5e-5 of
JAX's on a dp = 2 mesh, fed JAX's noise (``test_torch_pipeline.py``'s bar
for the DDIM chain; 4.2e-6 read, 0.85 with a rank's own noise); the dp
and fsdp
train steps: loss 1e-5 and grad norm 1e-4 relative to JAX's mesh step
(the bars of ``test_torch_train.py`` and JAX's), Adam moments 1e-4 of
their largest entry, EMA and parameters 1e-6 where the gradient is above
1e-3 of the largest (Adam's first step moves each by about lr * sign(g),
which rounding can flip where g is near 0), and the same beside the
port's own single-process step at the same global batch (loss and grad
norm 1e-5, moments 1e-5 of the largest).
"""

import functools
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist_workers as W
from test_torch_models import randomize_, torch_threads  # noqa: F401
from topiaxl.core import convert

RING_ABS = 2e-5
RING_GRAD_REL = 1e-5
CP_ABS = 1e-4
GENERATE_ABS = 5e-5
WORLDS = (2, 4)

DIT_KW = dict(seq_length=32, in_channels=6, condition_channels=8,
              hidden_size=32, depth=2, num_heads=4, cond_drop_prob=0.1)
TRAIN_KW = dict(seq_length=16, in_channels=4, condition_channels=8,
                hidden_size=32, depth=1, num_heads=4, cond_drop_prob=0.5)
DIFFUSION = dict(timestep_respacing=None, noise_schedule="squaredcos_cap_v2",
                 parameterization="v", diffusion_steps=20)
OPTIMIZER = dict(lr=1e-3, warmup_iters=0, max_iters=100)
EMA = 0.5


def _ring_inputs():
    rng = np.random.default_rng(1)
    q, k, v, w = (rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
                  for _ in range(4))
    return dict(q=q, k=k, v=v, w=w, scale=16 ** -0.5)


def _dit_sd(kw, seed):
    from topiaxl_torch.models.dit import DiT

    dit = DiT(dtype=torch.float32, **kw)
    return {k: v.numpy() for k, v in randomize_(dit, seed).items()}


def _cp_inputs():
    rng = np.random.default_rng(2)
    return dict(kw=DIT_KW, sd=_dit_sd(DIT_KW, 3),
                x=rng.standard_normal((2, 32, 6)).astype(np.float32),
                t=np.array([3, 7]), y=rng.standard_normal((2, 5, 8)).astype(
                    np.float32))


def _lsm_inputs():
    rng = np.random.default_rng(4)
    return dict(history=rng.uniform(0, 1, (6, 2)).astype(np.float32),
                counts=np.array([0, 1, 2, 2, 1, 0], np.int32),
                ts=rng.integers(0, 6, 8), losses=rng.uniform(
                    0, 2, 8).astype(np.float32))


def _generate_inputs():
    """Four assets for sharded generation: the port's weights (numpy), and
    the initial noise that JAX's ``sample_tokens`` draws from key 8."""
    from topiaxl_torch.models.vae3d import VAE3D

    vae_kw = dict(down_channels=(8, 16), up_channels=(16, 8),
                  dtype=torch.float32)
    kw = dict(seq_length=8, in_channels=68, condition_channels=6,
              hidden_size=32, depth=1, num_heads=2)
    mean, std = np.zeros(68, np.float32), np.ones(68, np.float32)
    mean[0], std[0] = 0.35, 0.02
    std[1:4] = 0.25
    noise_key = jax.random.split(jax.random.PRNGKey(8))[0]
    return dict(kw=kw, sd=_dit_sd(kw, 5), vae_kw=vae_kw,
                vae_sd={k: v.numpy() for k, v in randomize_(
                    VAE3D(**vae_kw), 6).items()},
                diffusion=dict(timestep_respacing="ddim3",
                               noise_schedule="squaredcos_cap_v2",
                               parameterization="v", diffusion_steps=50),
                y=np.random.default_rng(7).standard_normal((4, 3, 6)).astype(
                    np.float32), mean=mean, std=std, cfg_scale=2.0, seed=8,
                noise=np.asarray(jax.random.normal(noise_key, (4, 8, 68),
                                                   jnp.float32)))


def _jax_train_pair():
    """The JAX DiT, its params (numpy draws), a global batch of 4 and
    JAX's own draws for step 0 of ``make_train_step`` under key 7."""
    from topiaxl.models import DiT as JaxDiT

    jd = JaxDiT(dtype=jnp.float32, **TRAIN_KW)
    params = jd.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 4)),
                     jnp.zeros((1,), jnp.int32), jnp.zeros((1, 3, 8)))
    rng = np.random.default_rng(9)
    params = jax.tree.map(lambda a: (rng.standard_normal(a.shape) / np.sqrt(
        a.shape[0] if a.ndim > 1 else 100)).astype(np.float32), params)
    x = rng.standard_normal((4, 16, 4)).astype(np.float32)
    y = rng.standard_normal((4, 3, 8)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    t_key, loss_key = jax.random.split(jax.random.fold_in(key, 0))
    drop_key, noise_key = jax.random.split(loss_key)
    t = np.asarray(jax.random.randint(t_key, (4,), 0, 20))
    drop = np.asarray(jax.random.uniform(drop_key, (4,)) < 0.5)
    noise = np.asarray(jax.random.normal(noise_key, x.shape, x.dtype))
    return jd, params, key, dict(x=x, y=y, t=t, drop=drop, noise=noise)


def _train_inputs(mesh, grad_accum=1):
    from topiaxl_torch.core import weights

    _, params, _, batch = _jax_train_pair()
    sd = {k: v.numpy() for k, v in weights.dit_from_jax(
        jax.tree.map(np.asarray, params)).items()}
    return dict(kw=TRAIN_KW, sd=sd, mesh=mesh, diffusion=DIFFUSION,
                optimizer=OPTIMIZER, ema_decay=EMA, batch=batch,
                grad_accum=grad_accum)


CLI_RUNS = {"dp": ["train.mesh.dp=-1", "train.batch_size=1"],
            "fsdp": ["train.mesh.fsdp=-1", "train.batch_size=2"]}


def _cli_argv(root, axis=None):
    """``cli.train`` at ``test_torch_train.py``'s tiny config, in f32 (in
    bf16 each rank's weight gradients would be rounded on their own), for
    two steps at global batch 2: over two ranks on ``axis``, or in one
    process."""
    from test_torch_train import _tiny_train_config

    os.makedirs(root, exist_ok=True)
    return [_tiny_train_config(pathlib.Path(root), 2),
            "train.ckpt_every_n_steps=100", "model.generator.dtype=fp32",
            *CLI_RUNS.get(axis, [])]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: [results of each rank]}: one spawn per world size; under
    "cli_root" the directory of the CLI runs."""
    cli_root = tmp_path_factory.mktemp("cli")
    out = {"cli_root": cli_root}
    for world in WORLDS:
        job = dict(ring=_ring_inputs(), cp=_cp_inputs(), lsm=_lsm_inputs())
        if world == 4:
            job.update(train_hsdp=_train_inputs({"dp": 2, "fsdp": 2}))
        if world == 2:
            job.update(generate=_generate_inputs(),
                       train_dp=_train_inputs({"dp": -1}),
                       train_dp_accum=_train_inputs({"dp": -1}, 2),
                       train_fsdp=_train_inputs({"fsdp": -1}),
                       **{f"cli_{a}": {"argv": _cli_argv(str(cli_root / a), a)}
                          for a in CLI_RUNS})
        out[world] = W.spawn(world, job, str(tmp_path_factory.mktemp(
            f"ranks{world}")), timeout=150)
    return out


def _jax_ring(world, q, k, v, scale):
    from jax import shard_map

    from topiaxl.ops.ring_attention import ring_attention
    from topiaxl.parallel import make_mesh

    spec = P(None, "sp", None, None)
    return shard_map(functools.partial(ring_attention, scale=scale,
                                       axis_name="sp"),
                     mesh=make_mesh({"sp": world}),
                     in_specs=(spec, spec, spec), out_specs=spec)


@pytest.mark.parametrize("axes,n", [
    (None, 8), ({"dp": -1}, 6), ({"dp": 2, "fsdp": -1}, 8),
    ({"dp": -1, "sp": 2}, 4), ({"dp": 2, "fsdp": 2}, 8), ({"sp": 3}, 8),
    ({"dp": -1, "fsdp": 3}, 8), ({"dp": 4, "fsdp": 3}, 8)])
def test_make_mesh_rules_match_jax(axes, n):
    """Axis names, sizes and the rank (device) layout, or the same error:
    one axis may be -1, an indivisible count raises, an explicit smaller
    mesh takes the first ranks, the default is all on dp."""
    from topiaxl.parallel import make_mesh as jax_make_mesh
    from topiaxl_torch.parallel import make_mesh, mesh_from_config

    try:
        ref = jax_make_mesh(axes, jax.devices()[:n])
    except ValueError as e:
        with pytest.raises(ValueError) as info:
            make_mesh(axes, world_size=n)
        assert str(info.value) == str(e)
        return
    mesh = make_mesh(axes, world_size=n)
    assert mesh.shape == dict(ref.shape)
    assert mesh.axis_names == tuple(ref.axis_names)
    np.testing.assert_array_equal(mesh.ranks, np.vectorize(
        lambda d: d.id)(ref.devices))
    assert mesh.index == (0 if mesh.size else None)
    assert mesh_from_config(axes, world_size=n).shape == mesh.shape


def test_tp_and_pp_are_refused(tmp_path):
    """``tp`` > 1 or a ``pp`` axis raises by name, in the trainer's CLI and
    in sharded generation, as does tensor-parallel ``param_rules``."""
    from test_torch_train import _tiny_train_config
    from topiaxl_torch.cli.train import main
    from topiaxl_torch.parallel import make_mesh
    from topiaxl_torch.parallel.mesh import refuse_unported
    from topiaxl_torch.pipelines.infer import generate_primx_sharded

    with pytest.raises(NotImplementedError, match=r"pipeline \(pp\)"):
        main([_tiny_train_config(tmp_path, 1), "train.mesh.pp=1"])
    refuse_unported(make_mesh({"dp": 2, "tp": 1}, world_size=2))
    with pytest.raises(NotImplementedError, match=r"tensor \(tp > 1\)"):
        refuse_unported(make_mesh({"dp": 1, "tp": 2}, world_size=2))
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        generate_primx_sharded(None, None, None, None, None, None,
                               make_mesh(world_size=1), param_rules=[])


def test_ring_attention_single_rank_is_dense():
    """``group=None``: dense attention, as JAX's ``axis_name=None``, and
    its gradient."""
    from topiaxl.ops.ring_attention import ring_attention as jring
    from topiaxl_torch.ops.ring_attention import ring_attention

    a = _ring_inputs()
    ref = jring(*(jnp.asarray(a[n]) for n in "qkv"), a["scale"])
    q, k, v = (torch.from_numpy(a[n]).requires_grad_() for n in "qkv")
    o = ring_attention(q, k, v, a["scale"])
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(ref), rtol=0,
                               atol=RING_ABS)
    (o * torch.from_numpy(a["w"])).sum().backward()
    grads = jax.grad(lambda *qkv: (jring(*qkv, a["scale"]) * a["w"]).sum(),
                     argnums=(0, 1, 2))(*(jnp.asarray(a[n]) for n in "qkv"))
    for got, g in zip((q.grad, k.grad, v.grad), grads):
        g = np.asarray(g)
        np.testing.assert_allclose(got.numpy(), g, rtol=0,
                                   atol=RING_GRAD_REL * np.abs(g).max())


@pytest.mark.parametrize("world", WORLDS)
def test_ring_attention_across_ranks_matches_jax_ring(ranks, world):
    """The tokens over 2 and 4 gloo ranks: output against JAX's ring over
    as many devices and against dense attention; dq, dk, dv of sum(o * w)
    against JAX's gradient of its ring."""
    from topiaxl.ops.attention import multi_head_attention

    a = _ring_inputs()
    q, k, v = (jnp.asarray(a[n]) for n in "qkv")
    ring = _jax_ring(world, q, k, v, a["scale"])
    res = ranks[world]
    got = np.concatenate([r["ring"]["o"].numpy() for r in res], axis=1)
    for ref in (ring(q, k, v), multi_head_attention(q, k, v, a["scale"],
                                                    backend="xla")):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0,
                                   atol=RING_ABS)
    grads = jax.jit(jax.grad(lambda *qkv: (ring(*qkv) * a["w"]).sum(),
                             argnums=(0, 1, 2)))(q, k, v)
    for name, g in zip(("dq", "dk", "dv"), grads):
        g = np.asarray(g)
        got = np.concatenate([r["ring"][name].numpy() for r in res], axis=1)
        np.testing.assert_allclose(got, g, rtol=0,
                                   atol=RING_GRAD_REL * np.abs(g).max(),
                                   err_msg=name)


@pytest.mark.parametrize("world", WORLDS)
def test_cp_forward_matches_plain_dit(ranks, world):
    """``make_cp_forward`` over ``sp`` = 2 and 4 ranks (each 16 or 8 of the
    32 tokens, self-attention on the ring, the whole output gathered on
    every rank) against the JAX DiT's plain forward on the same weights."""
    from topiaxl.models import DiT as JaxDiT

    a = _cp_inputs()
    jd = JaxDiT(dtype=jnp.float32, attn_backend="xla", **a["kw"])
    params = jax.tree.map(jnp.asarray, convert.convert_dit(
        {k: torch.from_numpy(v) for k, v in a["sd"].items()}, depth=2))
    ref = np.asarray(jd.apply(params, jnp.asarray(a["x"]), jnp.asarray(
        a["t"], jnp.int32), jnp.asarray(a["y"])))
    assert np.abs(ref).max() > 0.1
    for r in ranks[world]:
        np.testing.assert_allclose(r["cp"].numpy(), ref, rtol=0, atol=CP_ABS)


@pytest.mark.parametrize("world", WORLDS)
def test_lsm_update_across_ranks_matches_jax(ranks, world):
    """Each rank folds in its rows; every rank ends with the history JAX's
    ``lsm_update`` keeps for the rows in rank order (its all_gather,
    tiled), appending and shifting."""
    from topiaxl.diffusion.timestep_sampler import (
        LossSecondMomentState, lsm_update)

    a = _lsm_inputs()
    ref = lsm_update(LossSecondMomentState(jnp.asarray(a["history"]),
                                           jnp.asarray(a["counts"])),
                     jnp.asarray(a["ts"], jnp.int32), jnp.asarray(a["losses"]))
    assert (np.asarray(ref.loss_counts) == 2).sum() > 2   # shifts happened
    for r in ranks[world]:
        np.testing.assert_array_equal(r["lsm"]["history"].numpy(),
                                      np.asarray(ref.loss_history))
        np.testing.assert_array_equal(r["lsm"]["counts"].numpy(),
                                      np.asarray(ref.loss_counts))


def test_generate_primx_sharded_matches_generate_primx(ranks):
    """Four assets over dp = 2: every rank returns the four PrimX that one
    process's ``generate_primx`` gives from the same generator state."""
    from topiaxl_torch.diffusion import create_diffusion
    from topiaxl_torch.models.dit import DiT
    from topiaxl_torch.models.vae3d import VAE3D
    from topiaxl_torch.pipelines.infer import generate_primx

    a = _generate_inputs()
    dit = DiT(dtype=torch.float32, **a["kw"]).eval()
    dit.load_state_dict({k: torch.from_numpy(v) for k, v in a["sd"].items()})
    vae = VAE3D(**a["vae_kw"]).eval()
    vae.load_state_dict({k: torch.from_numpy(v)
                         for k, v in a["vae_sd"].items()})
    ref = generate_primx(dit, vae, create_diffusion(**a["diffusion"]),
                         torch.from_numpy(a["y"]), a["mean"], a["std"],
                         cfg_scale=2.0,
                         generator=torch.Generator().manual_seed(a["seed"]))
    srt = torch.stack([p.srt for p in ref]).numpy()
    feat = torch.stack([p.feat for p in ref]).numpy()
    for r in ranks[2]:
        np.testing.assert_allclose(r["generate"]["own"]["srt"].numpy(), srt,
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(r["generate"]["own"]["feat"].numpy(), feat,
                                   rtol=0, atol=1e-6)


def test_generate_primx_sharded_matches_jax(ranks):
    """Four assets over dp = 2 gloo ranks, each fed the noise JAX draws
    from the key for the whole batch: every rank's gathered PrimX against
    JAX's ``generate_primx_sharded`` on a dp = 2 mesh of CPU devices."""
    from topiaxl.diffusion import create_diffusion as jax_diffusion
    from topiaxl.models import DiT as JaxDiT
    from topiaxl.models import VAE3D as JaxVAE
    from topiaxl.parallel import make_mesh
    from topiaxl.pipelines.infer import generate_primx_sharded

    a = _generate_inputs()
    jd = JaxDiT(dtype=jnp.float32, attn_proj_bias=True, **a["kw"])
    jv = JaxVAE(down_channels=(8, 16), up_channels=(16, 8), dtype=jnp.float32)
    tree = lambda p: jax.tree.map(jnp.asarray, p)  # noqa: E731
    dparams = tree(convert.convert_dit(
        {k: torch.from_numpy(v) for k, v in a["sd"].items()}, depth=1))
    vparams = tree(convert.convert_vae(
        {k: torch.from_numpy(v) for k, v in a["vae_sd"].items()}, (8, 16),
        (16, 8)))
    ref = generate_primx_sharded(
        jd, jv, jax_diffusion(**a["diffusion"]), dparams, vparams,
        jnp.asarray(a["y"]), jax.random.PRNGKey(a["seed"]), a["mean"],
        a["std"], make_mesh({"dp": 2}, jax.devices()[:2]),
        cfg_scale=a["cfg_scale"])
    srt = np.stack([np.asarray(p.srt) for p in ref])
    feat = np.stack([np.asarray(p.feat) for p in ref])
    assert np.abs(srt[..., 1:]).max() > 0.1
    for r in ranks[2]:
        np.testing.assert_allclose(r["generate"]["fed"]["srt"].numpy(), srt,
                                   rtol=0, atol=GENERATE_ABS)
        np.testing.assert_allclose(r["generate"]["fed"]["feat"].numpy(), feat,
                                   rtol=0, atol=GENERATE_ABS)


@pytest.mark.parametrize("axis", ["dp", "dp_accum", "fsdp", "hsdp"])
def test_mesh_train_step_matches_jax(ranks, axis):
    """One step at global batch 4 over gloo ranks (``dp``, two ranks:
    ``DistributedDataParallel``; ``dp_accum``, the same in two microbatches
    a rank, synced in the last one's backward, the null embedding without
    a gradient; ``fsdp``, two ranks: FSDP2, moments and EMA
    sharded, the clip on the norm of the shards; ``hsdp``, four ranks on
    dp 2 x fsdp 2: FSDP2 sharded over fsdp and replicated over dp)
    against JAX's step on a mesh of the same axes (replicated params for
    dp, ``dit_param_rules`` otherwise) with JAX's draws fed in, and
    against the port's single-process step at the same batch. The
    state's whole tensors load back into a fresh (sharded) state
    unchanged, as a resume does."""
    from topiaxl.diffusion import create_diffusion as jax_diffusion
    from topiaxl.parallel import (batch_sharding, dit_param_rules, make_mesh,
                                  shard_params)
    from topiaxl.parallel.sharding import replicated
    from topiaxl.pipelines.train import (create_train_state as jax_state,
                                         make_optimizer as jax_optimizer,
                                         make_train_step as jax_step)
    from topiaxl_torch.core import weights

    jd, params, key, batch = _jax_train_pair()
    opt = jax_optimizer(**OPTIMIZER)
    accum = 2 if axis == "dp_accum" else 1
    step = jax_step(jd, jax_diffusion(**DIFFUSION), opt, ema_decay=EMA,
                    grad_accum=accum)
    mesh = make_mesh({"dp": 2, "fsdp": 2} if axis == "hsdp" else
                     {axis.split("_")[0]: 2})
    with mesh:
        state = jax_state(params, opt)
        place = ((lambda p: jax.device_put(p, replicated(mesh)))
                 if axis.startswith("dp") else
                 (lambda p: shard_params(p, mesh, dit_param_rules())))
        state = state._replace(params=place(state.params),
                               ema_params=place(state.ema_params),
                               opt_state=place(state.opt_state))
        b = {k: jax.device_put(jnp.asarray(batch[k]), batch_sharding(
            mesh, "dp")) for k in ("x", "y")}
        s2, m2 = jax.jit(step)(state, b, key)
    ref = {n: weights.dit_from_jax(jax.tree.map(np.asarray, t)) for n, t in (
        ("params", s2.params), ("ema", s2.ema_params),
        ("mu", s2.opt_state[1][0].mu), ("nu", s2.opt_state[1][0].nu))}
    single = _single_process_step(accum)

    for r in ranks[4 if axis == "hsdp" else 2]:
        got = r[f"train_{axis}"]
        assert got["resumes"]
        np.testing.assert_allclose(got["metrics"]["loss"], float(m2["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(got["metrics"]["grad_norm"],
                                   float(m2["grad_norm"]), rtol=1e-4)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got["metrics"][k],
                                       single["metrics"][k], rtol=1e-5)
        _check_state(got, ref, single)


def _check_state(got, ref, single):
    """Moments, EMA and parameters of a mesh step against JAX's (``ref``)
    and the port's single-process step. Gradients that are zero in exact
    arithmetic (the key bias's: softmax ignores a shift of every logit)
    are rounding noise on every side: held below 1e-6 of the largest.
    EMA and parameters are held where the gradient is above 1e-3 of the
    largest."""
    gmax = {part: max(np.abs(t.numpy()).max() for t in ref[part].values())
            for part in ("mu", "nu")}
    for name, m_ref in ref["mu"].items():
        m_ref = np.abs(m_ref.numpy())
        noise = m_ref.max() <= 1e-6 * gmax["mu"]
        sure = m_ref > 1e-3 * gmax["mu"]
        for part in ("mu", "nu", "ema", "params"):
            g, w = got[part][name].numpy(), ref[part][name].numpy()
            s = single[part][name].numpy()
            msg = f"{part} {name}"
            if part in gmax:
                if noise:
                    assert np.abs(g).max() <= 1e-6 * gmax[part], msg
                    continue
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(
                    w).max(), err_msg=msg)
                np.testing.assert_allclose(g, s, rtol=0,
                                           atol=1e-5 * gmax[part], err_msg=msg)
            else:
                np.testing.assert_allclose(g[sure], w[sure], rtol=0,
                                           atol=1e-6, err_msg=msg)
                np.testing.assert_allclose(g[sure], s[sure], rtol=0,
                                           atol=1e-6, err_msg=msg)


def _single_process_step(grad_accum=1):
    """The port's step in this process at the same global batch."""
    from topiaxl_torch.diffusion import create_diffusion
    from topiaxl_torch.models.dit import DiT
    from topiaxl_torch.pipelines.train import (create_train_state,
                                               make_optimizer, make_train_step)

    a = _train_inputs(None, grad_accum)
    dit = DiT(dtype=torch.float32, param_dtype=torch.float32, **a["kw"])
    dit.load_state_dict({k: torch.from_numpy(v) for k, v in a["sd"].items()})
    state = create_train_state(dit.train())
    step = make_train_step(dit, create_diffusion(**DIFFUSION),
                           make_optimizer(**OPTIMIZER), ema_decay=EMA,
                           grad_accum=grad_accum)
    metrics = step(state, {k: torch.from_numpy(np.array(v))
                           for k, v in a["batch"].items()}, 0)
    sd = state.state_dict()
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": sd["params"], "ema": sd["ema"], "mu": sd["opt"]["mu"],
            "nu": sd["opt"]["nu"]}


@pytest.mark.parametrize("axis", sorted(CLI_RUNS))
def test_cli_train_honours_the_mesh(ranks, axis, tmp_path):
    """``cli.train`` on two ranks with ``train.mesh`` dp=-1 (batch 1 a
    rank) or fsdp=-1 (the batch of 2 split over the shards): each step's
    loss and grad norm on every rank, and rank 0's last checkpoint, are
    one process's at the same global batch (the bars of the mesh step
    above)."""
    from topiaxl_torch.cli.train import main

    single: list = []
    assert main(_cli_argv(str(tmp_path)), metrics_out=single) == 0
    for recs in (r[f"cli_{axis}"] for r in ranks[2]):
        assert [r["step"] for r in recs] == [1, 2]
        for got, ref in zip(recs, single):
            for k in ("loss", "loss_mse", "loss_vb", "grad_norm"):
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-5,
                                           err_msg=k)

    def last(root):
        d = pathlib.Path(root) / "runs" / "train" / "tiny" / "train" / "ckpts"
        return torch.load(d / "step_000000002.pt", weights_only=True)

    def state(root):
        d = pathlib.Path(root) / "runs" / "train" / "tiny" / "train" / "ckpts"
        sd = torch.load(d / "step_000000002.pt", weights_only=True)
        return {"mu": sd["opt"]["mu"], "nu": sd["opt"]["nu"],
                "ema": sd["ema"], "params": sd["params"]}

    ref = state(tmp_path)
    _check_state(state(ranks["cli_root"] / axis), ref, ref)
