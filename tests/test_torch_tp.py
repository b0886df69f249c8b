"""topiaxl_torch's tensor parallelism, the dp x sp step, the hybrid mesh,
restore onto any mesh and the CLI on tp and pp meshes, against the JAX
package on the CPU: gloo ranks spawned by ``tests/torch_dist_workers.py``
(2 and 4 of them, each spawn with a time limit), the JAX side on this
process's 8-CPU mesh.

Bars (f32), JAX's own (``tests/test_train.py:175-228, 365``): each mesh
step against JAX's step on a mesh of the same axes (``dit_param_rules``
for tp, ``sequence_sharding`` for sp) with JAX's draws, loss rtol 2e-5,
grad norm rtol 2e-4, the updated ``x_embedder`` within 2e-6; with the
moments, EMA and parameters held as ``test_torch_parallel.py`` holds the
dp and fsdp steps. The planted fault (the fused qkv rows split as one
block) must miss the loss bar. A restored state equals the written one
bit for bit (``tests/test_train.py:279``) and its next loss agrees at
2e-5. ``generate_primx_sharded`` with tp rules within 5e-5 of JAX's,
fed JAX's noise (``test_torch_parallel.py``'s bar). The CLI on tp and pp
meshes: each step's metrics within 1e-5 of one process's. The remat
policies under tp = 2 and FSDP2: ``remat=True``'s step on the same mesh
within 1e-6.
"""

import logging
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from test_torch_models import torch_threads  # noqa: F401
from test_torch_parallel import (
    DIFFUSION, EMA, GENERATE_ABS, OPTIMIZER, TRAIN_KW, _check_state,
    _cli_argv, _dit_sd, _generate_inputs, _jax_train_pair, _train_inputs)
from topiaxl.core import convert

LOSS_REL, GNORM_REL, EMBED_ABS = 2e-5, 2e-4, 2e-6
TRAIN_MESHES = {  # name: (world, mesh, rules)
    "tp": (2, {"tp": 2}, "dit"),
    "dp_tp": (4, {"dp": 2, "tp": 2}, "dit"),
    "fsdp_tp": (4, {"fsdp": 2, "tp": 2}, "dit"),
    "hybrid": (4, {"ici": {"tp": 2}, "dcn": {"dp": 2}}, "dit"),
    "dp_sp": (4, {"dp": 2, "sp": 2}, None),
}
# three heads do not split over tp = 2: the attention sublayers replicate
HEADS3_KW = dict(TRAIN_KW, hidden_size=24, num_heads=3)
# the remat policies over ranks, each against remat=True on the same mesh,
# on a DiT whose attentions take the flash path (520 tokens, 530 condition
# tokens, head dim 72; two heads a tp rank)
POLICY_KW = dict(seq_length=520, in_channels=4, condition_channels=8,
                 hidden_size=288, depth=2, num_heads=4, cond_drop_prob=0.5)
POLICY_MESHES = {"tp": ({"tp": 2}, ("flash", "dots")),
                 "fsdp": ({"fsdp": 2}, ("flash",))}
CLI_MESHES = {
    "dp_tp": ["train.mesh.dp=2", "train.mesh.tp=2", "train.batch_size=1"],
    "fsdp_tp": ["train.mesh.dp=1", "train.mesh.fsdp=2", "train.mesh.tp=2",
                "train.batch_size=2"],
    "dp_pp": ["train.mesh.dp=2", "train.mesh.pp=2", "train.batch_size=1"],
}


def _policy_inputs(mesh, remat):
    """One step of the flash-path DiT under ``remat`` on ``mesh`` (tp
    under ``dit_param_rules``), its weights and a global batch of 2 with
    the step's draws from numpy."""
    from test_torch_models import randomize_
    from topiaxl_torch.models.dit import DiT

    spec, _ = POLICY_MESHES[mesh]
    sd = randomize_(DiT(dtype=torch.float32, **POLICY_KW), 13)
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 520, 4)).astype(np.float32)
    batch = dict(x=x, y=rng.standard_normal((2, 530, 8)).astype(np.float32),
                 t=np.array([4, 15]), drop=np.array([False, True]),
                 noise=rng.standard_normal(x.shape).astype(np.float32))
    return dict(kw=dict(POLICY_KW, remat=remat),
                sd={k: v.numpy() for k, v in sd.items()}, mesh=spec,
                diffusion=DIFFUSION, optimizer=OPTIMIZER, ema_decay=EMA,
                batch=batch, grad_accum=1,
                **({"rules": "dit"} if "tp" in spec else {}))


def _restore_inputs(tmp):
    rng = np.random.default_rng(11)
    return dict(kw=TRAIN_KW, diffusion=DIFFUSION, optimizer=OPTIMIZER,
                ema_decay=EMA, tmp=tmp, a={"dp": 4},
                b={"dp": 1, "fsdp": 2, "tp": 2},
                batch={"x": rng.standard_normal((8, 16, 4)).astype(np.float32),
                       "y": rng.standard_normal((8, 3, 8)).astype(np.float32)})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: [results of each rank]}: one spawn per world size; under
    "cli_root" the directory of the CLI runs."""
    cli_root = tmp_path_factory.mktemp("cli")
    out = {"cli_root": cli_root}
    for world in (2, 4):
        job = {f"train:{name}": dict(_train_inputs(mesh), **(
            {"rules": rules} if rules else {}))
            for name, (w, mesh, rules) in TRAIN_MESHES.items() if w == world}
        if world == 2:
            job["train:tp_fault"] = dict(_train_inputs({"tp": 2}),
                                         rules="contiguous")
            job["train:heads3"] = dict(_train_inputs({"tp": 2}), rules="dit",
                                       kw=HEADS3_KW, sd=_dit_sd(HEADS3_KW, 12))
            job["generate:dp1_tp2"] = dict(_generate_inputs(), rules="dit",
                                           mesh={"dp": 1, "tp": 2})
            job["generate:fault"] = dict(_generate_inputs(),
                                         rules="contiguous",
                                         mesh={"dp": 1, "tp": 2})
            job.update({f"train:{mesh}_{remat}": _policy_inputs(mesh, remat)
                        for mesh, (_, policies) in POLICY_MESHES.items()
                        for remat in (True, *policies)})
        else:
            job["generate:dp2_tp2"] = dict(_generate_inputs(), rules="dit",
                                           mesh={"dp": 2, "tp": 2})
            job["restore"] = _restore_inputs(str(tmp_path_factory.mktemp(
                "restore")))
            job.update({f"cli:{name}": {"argv": _cli_argv(
                str(cli_root / name)) + extra}
                for name, extra in CLI_MESHES.items()})
        out[world] = W.spawn(world, job, str(tmp_path_factory.mktemp(
            f"ranks{world}")), timeout=150)
    return out


def _jax_mesh_step(name):
    """JAX's train step on the mesh of ``TRAIN_MESHES[name]`` (params placed
    by ``dit_param_rules``; x sequence-sharded for sp), JAX's draws: the
    metrics and the state as port state_dicts."""
    from topiaxl.diffusion import create_diffusion as jax_diffusion
    from topiaxl.parallel import (batch_sharding, dit_param_rules,
                                  make_hybrid_mesh, make_mesh,
                                  sequence_sharding, shard_params)
    from topiaxl.parallel.sharding import replicated
    from topiaxl.pipelines.train import (create_train_state as jax_state,
                                         make_optimizer as jax_optimizer,
                                         make_train_step as jax_step)
    from topiaxl_torch.core import weights

    jd, params, key, batch = _jax_train_pair()
    opt = jax_optimizer(**OPTIMIZER)
    step = jax_step(jd, jax_diffusion(**DIFFUSION), opt, ema_decay=EMA)
    world, spec, rules = TRAIN_MESHES[name]
    devices = jax.devices()[:world]
    mesh = (make_hybrid_mesh(spec["ici"], spec["dcn"], devices)
            if "ici" in spec else make_mesh(spec, devices))
    with mesh:
        state = jax_state(params, opt)
        place = ((lambda p: shard_params(p, mesh, dit_param_rules())) if rules
                 else (lambda p: jax.device_put(p, replicated(mesh))))
        state = state._replace(params=place(state.params),
                               ema_params=place(state.ema_params),
                               opt_state=place(state.opt_state))
        xs = sequence_sharding(mesh) if "sp" in spec else batch_sharding(
            mesh, "dp")
        b = {"x": jax.device_put(jnp.asarray(batch["x"]), xs),
             "y": jax.device_put(jnp.asarray(batch["y"]),
                                 batch_sharding(mesh, "dp"))}
        s2, m2 = jax.jit(step)(state, b, key)
    ref = {n: weights.dit_from_jax(jax.tree.map(np.asarray, t)) for n, t in (
        ("params", s2.params), ("ema", s2.ema_params),
        ("mu", s2.opt_state[1][0].mu), ("nu", s2.opt_state[1][0].nu))}
    return {k: float(v) for k, v in m2.items()}, ref


def _single(args):
    """The port's step in this process on ``args`` (a ``_train_inputs``
    dict): metrics and whole state."""
    from topiaxl_torch.diffusion import create_diffusion
    from topiaxl_torch.models.dit import DiT
    from topiaxl_torch.pipelines.train import (create_train_state,
                                               make_optimizer, make_train_step)

    dit = DiT(dtype=torch.float32, param_dtype=torch.float32, **args["kw"])
    dit.load_state_dict({k: torch.from_numpy(v)
                         for k, v in args["sd"].items()})
    state = create_train_state(dit.train())
    step = make_train_step(dit, create_diffusion(**DIFFUSION),
                           make_optimizer(**OPTIMIZER), ema_decay=EMA)
    metrics = step(state, {k: torch.from_numpy(np.array(v))
                           for k, v in args["batch"].items()}, 0)
    sd = state.state_dict()
    return ({k: float(v) for k, v in metrics.items()},
            {"params": sd["params"], "ema": sd["ema"], "mu": sd["opt"]["mu"],
             "nu": sd["opt"]["nu"]})


@pytest.mark.parametrize("name", sorted(TRAIN_MESHES))
def test_mesh_train_step_matches_jax(ranks, name):
    """One step at global batch 4: tp = 2 alone, beside dp = 2, beside
    fsdp = 2 (FSDP2 over each tp coordinate's sub-mesh), on the hybrid
    mesh (dcn dp = 2 x ici tp = 2) and dp x sp (tokens over sp, the ring),
    against JAX's step on a mesh of the same axes and the port's single
    process. Under tp the rules split the fused qkv by heads within q, k
    and v (rows [3, H/2, hd] a rank), and its parts gather back exactly."""
    m_ref, ref = _jax_mesh_step(name)
    single_metrics, single = _single(_train_inputs(None))
    world, spec, rules = TRAIN_MESHES[name]
    for r in ranks[world]:
        got = r[f"train:{name}"]
        assert got["resumes"]
        if rules:
            shape, placement = got["qkv"]
            assert shape == (3 * 32 // 2, 32) and placement.groups == 3, got[
                "qkv"]
            assert got["gathers"]
        np.testing.assert_allclose(got["metrics"]["loss"], m_ref["loss"],
                                   rtol=LOSS_REL)
        np.testing.assert_allclose(got["metrics"]["grad_norm"],
                                   m_ref["grad_norm"], rtol=GNORM_REL)
        np.testing.assert_allclose(got["params"]["x_embedder.weight"].numpy(),
                                   ref["params"]["x_embedder.weight"].numpy(),
                                   rtol=0, atol=EMBED_ABS)
        _check_state(got, ref, single)


def test_contiguous_qkv_split_is_caught(ranks):
    """The planted fault: qkv's rows split as one block over tp = 2 mixes
    q with k on both ranks; the loss misses JAX's by far more than the
    bar."""
    m_ref, _ = _jax_mesh_step("tp")
    for r in ranks[2]:
        got = r["train:tp_fault"]["metrics"]["loss"]
        assert abs(got - m_ref["loss"]) > 100 * LOSS_REL * abs(m_ref["loss"])


def test_indivisible_heads_replicate_loudly(ranks, caplog):
    """Three heads over tp = 2: JAX computes (GSPMD reshards); the port
    replicates both attention sublayers, says so, splits the MLP, and
    trains as one process does."""
    from topiaxl_torch.models.dit import DiT
    from topiaxl_torch.parallel import make_mesh
    from topiaxl_torch.parallel.sharding import dit_param_rules, tp_placements

    dit = DiT(dtype=torch.float32, **HEADS3_KW)
    with caplog.at_level(logging.WARNING, "topiaxl_torch.parallel.sharding"):
        placed = tp_placements(dit, make_mesh({"tp": 2}, world_size=2),
                               dit_param_rules())
    assert sorted({n.rsplit(".", 2)[0] for n in placed}) == ["blocks.0.mlp"]
    warned = " ".join(r.message for r in caplog.records)
    assert "blocks.0.attn replicated" in warned
    assert "blocks.0.crossattn replicated" in warned
    args = dict(_train_inputs(None), kw=HEADS3_KW, sd=_dit_sd(HEADS3_KW, 12))
    single_metrics, single = _single(args)
    for r in ranks[2]:
        got = r["train:heads3"]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got["metrics"][k], single_metrics[k],
                                       rtol=1e-5)
        _check_state(got, single, single)


@pytest.mark.parametrize("mesh,remat", [
    (mesh, remat) for mesh, (_, policies) in POLICY_MESHES.items()
    for remat in policies])
def test_policy_step_over_ranks_is_remats(ranks, mesh, remat):
    """A remat policy under tp = 2 (the f / g all-reduces inside the
    checkpointed block: the policy sees them and recomputes them, as
    ``remat=True`` does) and under FSDP2 over two ranks: the step's loss,
    grad norm and updated parameters are ``remat=True``'s on the same
    mesh (1e-6, ``test_torch_remat.py``'s bar)."""
    for r in ranks[2]:
        got, ref = r[f"train:{mesh}_{remat}"], r[f"train:{mesh}_True"]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k],
                                       rtol=1e-6, err_msg=k)
        assert got["params"].keys() == ref["params"].keys()
        for n, p in got["params"].items():
            torch.testing.assert_close(p, ref["params"][n], rtol=0,
                                       atol=1e-6, msg=n)


def test_fit_spec_indivisible_warns_as_jax(caplog):
    """``fit_spec`` drops an axis that does not divide its dim, loudly,
    where JAX's ``_fit_spec`` does (``tests/test_train.py:231``), and
    quietly drops axes the mesh lacks."""
    from jax.sharding import PartitionSpec as P

    from topiaxl.parallel import make_mesh as jax_mesh
    from topiaxl.parallel.sharding import _fit_spec
    from topiaxl_torch.parallel import make_mesh
    from topiaxl_torch.parallel.sharding import fit_spec

    axes = {"dp": 2, "fsdp": 2, "tp": 2}
    assert _fit_spec(P("tp", None), (7, 4), jax_mesh(axes)) == P(None, None)
    with caplog.at_level(logging.WARNING, "topiaxl_torch.parallel.sharding"):
        spec = fit_spec(("tp", None), (7, 4), make_mesh(axes, world_size=8),
                        name="w.weight")
    assert spec == (None, None)
    assert any("not divisible" in r.message for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING, "topiaxl_torch.parallel.sharding"):
        assert fit_spec(("tp", "fsdp"), (8, 4), make_mesh(
            {"dp": 2}, world_size=2)) == (None, None)
    assert not caplog.records


def test_rules_place_the_dit_as_jax(caplog):
    """``dit_param_rules`` on the port's names: every tensor JAX's rules
    split over tp (its [in, out] kernel transposed) is split on the same
    dim here; qkv by heads within q, k, v; nothing else. (JAX's rules
    also split its timestep MLP, whose layers JAX names fc1 and fc2; the
    port keeps the reference's names, ``t_embedder.mlp.0`` / ``.2``, and
    that once-a-step 256 -> D MLP replicates.)"""
    from topiaxl.models import DiT as JaxDiT
    from topiaxl.parallel import dit_param_rules as jax_rules
    from topiaxl.parallel import make_mesh as jax_mesh
    from topiaxl.parallel.sharding import _fit_spec, _path_str, spec_for
    from topiaxl_torch.models.dit import DiT
    from topiaxl_torch.parallel import make_mesh
    from topiaxl_torch.parallel.sharding import (Placement, dit_param_rules,
                                                 tp_placements)

    axes = {"dp": 2, "fsdp": 2, "tp": 2}
    jd = JaxDiT(dtype=jnp.float32, **TRAIN_KW)
    params = jax.eval_shape(lambda: jd.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 4)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 3, 8))))
    mesh = jax_mesh(axes)
    jax_tp = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = _path_str(path)
        spec = _fit_spec(spec_for(name, jax_rules()), leaf.shape, mesh, name)
        if "tp" in tuple(spec) and ".blocks_" in name:
            parts = name.split(".")   # params.blocks_0.attn.qkv.kernel
            dim = tuple(spec).index("tp")
            dim = 1 - dim if leaf.ndim == 2 else dim   # [in, out] -> [out, in]
            leaf_name = {"kernel": "weight", "bias": "bias"}[parts[-1]]
            jax_tp.add((".".join([parts[1].replace("_", ".")] + parts[2:-1]
                                 + [leaf_name]), dim))
    placed = tp_placements(DiT(dtype=torch.float32, **TRAIN_KW),
                           make_mesh(axes, world_size=8), dit_param_rules())
    assert {(n, p.dim) for n, p in placed.items()} == jax_tp
    assert placed["blocks.0.attn.qkv.weight"] == Placement(0, 3)
    assert placed["blocks.0.crossattn.to_k.weight"] == Placement(0, 1)


@pytest.mark.parametrize("world,mesh", [(2, "dp1_tp2"), (4, "dp2_tp2")])
def test_generate_tp_matches_jax(ranks, world, mesh):
    """Four assets with ``param_rules=dit_param_rules()`` over dp 1 x tp 2
    and dp 2 x tp 2, fed JAX's noise: every rank's gathered PrimX against
    JAX's ``generate_primx_sharded`` with its rules on a dp 2 x tp 2 mesh;
    the contiguous qkv split misses the bar."""
    from topiaxl.diffusion import create_diffusion as jax_diffusion
    from topiaxl.models import DiT as JaxDiT
    from topiaxl.models import VAE3D as JaxVAE
    from topiaxl.parallel import dit_param_rules, make_mesh
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
        a["std"], make_mesh({"dp": 2, "tp": 2}, jax.devices()[:4]),
        cfg_scale=a["cfg_scale"], param_rules=dit_param_rules())
    srt = np.stack([np.asarray(p.srt) for p in ref])
    feat = np.stack([np.asarray(p.feat) for p in ref])
    for r in ranks[world]:
        got = r[f"generate:{mesh}"]["fed"]
        np.testing.assert_allclose(got["srt"].numpy(), srt, rtol=0,
                                   atol=GENERATE_ABS)
        np.testing.assert_allclose(got["feat"].numpy(), feat, rtol=0,
                                   atol=GENERATE_ABS)
    if world == 2:
        for r in ranks[2]:
            bad = r["generate:fault"]["fed"]
            assert max(np.abs(bad["srt"].numpy() - srt).max(),
                       np.abs(bad["feat"].numpy() - feat).max()) > \
                100 * GENERATE_ABS


def test_checkpoint_restores_onto_another_mesh(ranks):
    """Two steps under {dp: 4}, the checkpoint restored into {dp: 1, fsdp:
    2, tp: 2} (a state built from other weights): the restored state is
    the written one bit for bit, parameters and moments laid out tensor-
    parallel; a third step on each mesh gives the same loss; and a
    checkpoint of the tp state restores bit for bit under {dp: 4}."""
    for r in ranks[4]:
        got = r["restore"]
        assert got["layout"] == ((3 * 32 // 2, 32), (3 * 32 // 2, 32))
        for a, b in ((got["a"], got["restored"]), (got["b"], got["back"])):
            assert a["step"] == b["step"] and a["opt"]["count"] == b["opt"][
                "count"]
            for part in ("params", "ema"):
                for n, t in a[part].items():
                    assert torch.equal(t, b[part][n]), (part, n)
            for part in ("mu", "nu"):
                for n, t in a["opt"][part].items():
                    assert torch.equal(t, b["opt"][part][n]), (part, n)
        assert got["a"]["step"] == 2 and got["b"]["step"] == 3
        np.testing.assert_allclose(got["loss_b"], got["loss_a"],
                                   rtol=LOSS_REL)


def test_hybrid_mesh_matches_jax():
    """``make_hybrid_mesh``: dcn axes outermost, ranks node by node, JAX's
    names, sizes and device order on the CPU platform; the same errors
    (``tests/test_train.py:438, 487``)."""
    from topiaxl.parallel import make_hybrid_mesh as jax_hybrid
    from topiaxl_torch.parallel import make_hybrid_mesh

    for ici, dcn in (({"fsdp": 2, "tp": 2}, {"dp": 2}), ({"tp": 2}, {"dp": 2}),
                     ({"tp": 4}, {})):
        ref = jax_hybrid(ici, dcn)
        mesh = make_hybrid_mesh(ici, dcn, world_size=8)
        assert mesh.axis_names == tuple(ref.axis_names)
        assert mesh.shape == dict(ref.shape)
        np.testing.assert_array_equal(mesh.ranks, np.vectorize(
            lambda d: d.id)(ref.devices))
    for ici, dcn, match in (({"dp": 2}, {"dp": 2}, "both ici and dcn"),
                            ({"tp": 8}, {"dp": 4}, "devices")):
        with pytest.raises(ValueError, match=match):
            jax_hybrid(ici, dcn)
        with pytest.raises(ValueError, match=match):
            make_hybrid_mesh(ici, dcn, world_size=8)


@pytest.mark.parametrize("name", sorted(CLI_MESHES))
def test_cli_train_on_tp_and_pp_meshes(ranks, name, tmp_path):
    """``cli.train`` on four ranks at ``train.mesh`` {dp: 2, tp: 2}, {dp:
    1, fsdp: 2, tp: 2} and {dp: 2, pp: 2} (replicated over pp, as JAX's
    CLI does): each step's metrics on every rank, and rank 0's last
    checkpoint, are one process's at the same global batch of 2."""
    from topiaxl_torch.cli.train import main

    single: list = []
    assert main(_cli_argv(str(tmp_path)), metrics_out=single) == 0
    for recs in (r[f"cli:{name}"] for r in ranks[4]):
        assert [r["step"] for r in recs] == [1, 2]
        for got, ref in zip(recs, single):
            for k in ("loss", "loss_mse", "loss_vb", "grad_norm"):
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-5,
                                           err_msg=k)

    def state(root):
        d = pathlib.Path(root) / "runs" / "train" / "tiny" / "train" / "ckpts"
        sd = torch.load(d / "step_000000002.pt", weights_only=True)
        return {"mu": sd["opt"]["mu"], "nu": sd["opt"]["nu"],
                "ema": sd["ema"], "params": sd["params"]}

    ref = state(tmp_path)
    _check_state(state(ranks["cli_root"] / name), ref, ref)
    assert os.path.isdir(ranks["cli_root"] / name)
