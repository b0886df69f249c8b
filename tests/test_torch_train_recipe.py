"""The trainer knows neither its model nor its objective
(``pipelines/train.py``, ``parallel/pipeline.py``): each model says what a
dropped row's conditioning is (``drop_cond``), each objective draws the
step's times and gives its loss (``sample_times``, ``training_losses``),
and ``cli/train.py:train_recipe`` turns a config into the objective, the
optimizer spec and the step's arguments for ``cli.train`` and
``cli.profile`` alike. On the CPU at tiny widths, in f32; every
comparison is exact (the same arithmetic on the same inputs). The file
imports no JAX.
"""

from __future__ import annotations

import ast
import dataclasses
import inspect
import pathlib

import pytest
import torch

from topiaxl_torch.diffusion import create_diffusion
from topiaxl_torch.diffusion.flow import RectifiedFlow
from topiaxl_torch.diffusion.timestep_sampler import lsm_sample
from topiaxl_torch.models.dit import DiT, DiTAdditivePosEmb
from topiaxl_torch.models.ss_flow import SparseStructureFlowModel
from topiaxl_torch.pipelines import train as T

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, M, COND = 4, 5, 6       # global batch, conditioning tokens and channels
SEED = 3


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _dit(cls=DiT):
    return cls(seq_length=8, in_channels=4, condition_channels=COND,
               hidden_size=16, depth=1, num_heads=2, cond_drop_prob=0.5,
               dtype=torch.float32, param_dtype=torch.float32, device="cpu",
               generator=torch.Generator().manual_seed(0))


def _flow():
    return SparseStructureFlowModel(
        resolution=2, in_channels=4, out_channels=4, model_channels=32,
        cond_channels=COND, num_blocks=1, num_heads=2, cond_drop_prob=0.5,
        dtype=torch.float32, param_dtype=torch.float32, device="cpu",
        generator=torch.Generator().manual_seed(0))


# one sample's x of each
SHAPES = {"DiT": (8, 4), "SparseStructureFlowModel": (4, 2, 2, 2)}
MODELS = {"DiT": _dit, "DiTAdditivePosEmb": lambda: _dit(DiTAdditivePosEmb),
          "SparseStructureFlowModel": _flow}

# the model and objective classes the trainer must not name
KINDS = {"DiT", "DiTAdditivePosEmb", "SparseStructureFlowModel",
         "RectifiedFlow", "Diffusion"}
# what the trainer may ask of a model: the parallel layouts it applies itself
LAYOUTS = {"FSDPModule", "tp_layout", "pp_layout"}


def test_the_trainer_names_no_model_and_no_objective():
    """``pipelines/train.py`` and ``parallel/pipeline.py`` import no model
    or objective class, read no model's null embedding, and ask the model
    and the objective (``isinstance``, ``hasattr``, ``getattr``) only for
    the parallel layouts the trainer applies itself."""
    for rel in ("topiaxl_torch/pipelines/train.py",
                "topiaxl_torch/parallel/pipeline.py"):
        tree = ast.parse((ROOT / rel).read_text())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = {a.name.rsplit(".", 1)[-1] for a in node.names}
                assert not names & KINDS, (rel, node.lineno, names)
            elif isinstance(node, ast.Attribute):
                assert node.attr != "null_cond_embedding", (rel, node.lineno)
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Name)
                  and node.func.id in ("isinstance", "hasattr", "getattr")):
                what = node.args[1]
                what = (what.value if isinstance(what, ast.Constant)
                        else ast.unparse(what))
                assert what not in KINDS, (rel, node.lineno, ast.unparse(node))
                if ast.unparse(node.args[0]) in ("model", "diffusion"):
                    assert what in LAYOUTS, (rel, node.lineno,
                                             ast.unparse(node))


@pytest.mark.parametrize("name", list(MODELS))
def test_drop_cond_is_what_the_forward_used(name):
    """``drop_cond`` puts in the dropped rows what each model's forward
    put there: the DiT's null embedding (reference dit_crossattn.py:
    193-196; the embedding takes the rows' gradient), the flow model's
    zeros (TRELLIS's negative condition); the rest pass as they are, and
    the forward with ``drop`` is the forward on ``drop_cond``'s y."""
    m = MODELS[name]()
    g = torch.Generator().manual_seed(1)
    y = torch.randn(3, M, COND, generator=g)
    drop = torch.tensor([True, False, True])
    flow = name == "SparseStructureFlowModel"
    want = y.clone()
    want[drop] = 0.0 if flow else m.null_cond_embedding.detach()
    got = m.drop_cond(y, drop)
    assert torch.equal(got, want)
    assert m.drop_cond(y, None) is y
    if not flow:
        got.sum().backward()
        assert torch.equal(m.null_cond_embedding.grad,
                           torch.full((COND,), 2.0 * M))
    x = torch.randn(3, *m.input_shape, generator=g)
    t = torch.tensor([1.0, 500.0, 999.0])
    with torch.no_grad():
        assert torch.equal(m(x, t, y, drop), m(x, t, got.detach()))


OBJECTIVES = ("uniform", "lsm", "flow")


def _name(kind: str) -> str:
    return "SparseStructureFlowModel" if kind == "flow" else "DiT"


def _draws(kind: str) -> dict:
    """The step's draws made directly from ``_step_generators(SEED, 0)`` in
    their documented order, each over the global batch: the times (the
    uniform draw on the device generator, LSM's on the CPU one, the flow's
    logit-normal(1, 1)), the cond-drop mask, the noise."""
    gen, cpu_gen = T._step_generators(SEED, 0, "cpu")
    ones = torch.ones(B)
    if kind == "uniform":
        t, w = torch.randint(0, 1000, (B,), generator=gen), ones
    elif kind == "lsm":
        fresh = T.create_train_state(_dit(), lsm_timesteps=1000)
        t, w = lsm_sample(fresh.sampler_state, B, cpu_gen)
    else:
        t = torch.sigmoid(torch.randn(B, generator=gen) * 1.0 + 1.0)
        w = ones
    drop = torch.rand(B, generator=gen) < 0.5
    noise = torch.randn((B, *SHAPES[_name(kind)]), generator=gen)
    return {"t": t, "weights": w, "drop": drop, "noise": noise}


def _step(kind: str, grad_accum: int, monkeypatch, overrides=()):
    """One step from a fresh model and state on a fixed batch (with the
    draws ``overrides`` names given in it); returns its loss, the updated
    parameters and the draws ``accumulate_gradients`` was handed."""
    model = MODELS[_name(kind)]().train()
    objective = (RectifiedFlow() if kind == "flow" else create_diffusion(
        timestep_respacing=None, noise_schedule="linear",
        diffusion_steps=1000, parameterization="v"))
    state = T.create_train_state(
        model, lsm_timesteps=1000 if kind == "lsm" else None)
    step = T.make_train_step(
        model, objective, T.make_optimizer(lr=1e-3, schedule="constant"),
        timestep_sampler="lsm" if kind == "lsm" else "uniform",
        grad_accum=grad_accum)
    g = torch.Generator().manual_seed(2)
    batch = {"x": torch.randn(B, *SHAPES[_name(kind)], generator=g),
             "y": torch.randn(B, M, COND, generator=g)}
    batch.update({k: v for k, v in _draws(kind).items() if k in overrides})
    seen = {}
    real = T.accumulate_gradients

    def recording(*a, **kw):
        bound = inspect.signature(real).bind(*a, **kw)
        seen.update(bound.arguments)
        return real(*a, **kw)

    monkeypatch.setattr(T, "accumulate_gradients", recording)
    metrics = step(state, batch, SEED)
    monkeypatch.setattr(T, "accumulate_gradients", real)
    assert state.step == 1
    return metrics["loss"], dict(model.named_parameters()), seen


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("kind", OBJECTIVES)
def test_a_steps_draws_and_their_overrides(kind, grad_accum, monkeypatch):
    """A step's times, weights, cond-drop mask and noise are the draws made
    directly in the documented order; the same step with them handed in
    as the batch's 't', 'drop' and 'noise' gives the same loss and
    parameters, bit for bit."""
    want = _draws(kind)
    assert want["drop"].any() and not want["drop"].all()
    loss, params, seen = _step(kind, grad_accum, monkeypatch)
    for k, v in want.items():
        assert torch.equal(seen[k], v), k
    loss_o, params_o, _ = _step(kind, grad_accum, monkeypatch,
                                overrides=("t", "drop", "noise"))
    assert torch.equal(loss, loss_o)
    init = dict(MODELS[_name(kind)]().named_parameters())
    assert any(not torch.equal(p, init[n]) for n, p in params.items())
    for n, p in params.items():
        assert torch.equal(p, params_o[n]), n


# the shipped training configs at a CPU size: every width cut, the rest as
# shipped
TINY = {
    "configs/inference_dit.yml": [
        "model.num_prims=8", "model.generator.in_channels=4",
        f"model.generator.condition_channels={COND}",
        "model.generator.hidden_size=16", "model.generator.depth=1",
        "model.generator.num_heads=2"],
    "configs/trellis_ss_flow.yml": [
        "model.generator.resolution=2", "model.generator.in_channels=4",
        "model.generator.out_channels=4", "model.generator.model_channels=32",
        f"model.generator.cond_channels={COND}",
        "model.generator.num_blocks=1", "model.generator.num_heads=2"],
}


class _Built(Exception):
    """Raised in place of ``make_train_step`` once its arguments are seen."""


def _step_arguments(monkeypatch, run) -> dict:
    seen = {}
    real = T.make_train_step

    def capture(*a, **kw):
        bound = inspect.signature(real).bind(*a, **kw)
        bound.apply_defaults()
        seen.update(bound.arguments)
        raise _Built

    monkeypatch.setattr(T, "make_train_step", capture)
    with pytest.raises(_Built):
        run()
    monkeypatch.setattr(T, "make_train_step", real)
    return seen


def _same(a, b) -> bool:
    if torch.is_tensor(a):
        return torch.equal(a, b)
    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and all(
            _same(getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a))
    return a == b


@pytest.mark.parametrize("config", list(TINY))
def test_cli_train_and_cli_profile_build_the_same_step(config, tmp_path,
                                                       monkeypatch):
    """``cli.train`` and ``cli.profile``'s ``train_step`` hand
    ``make_train_step`` the same objective, optimizer spec and step
    arguments for each shipped training config, and the objective and the
    schedule are the ones the config names."""
    from topiaxl_torch.cli.profile import profile_train_step
    from topiaxl_torch.cli.train import main
    from topiaxl_torch.core.config import load_config

    argv = [str(ROOT / config), *TINY[config], f"root_data_dir={tmp_path}",
            "train.device=cpu", "train.synthetic=true", "train.batch_size=2",
            "train.cond_seq=3"]
    trained = _step_arguments(monkeypatch, lambda: main(argv))
    profiled = _step_arguments(monkeypatch, lambda: profile_train_step(
        load_config(argv[0], overrides=argv[1:]), torch.device("cpu")))
    assert _same(trained["diffusion"], profiled["diffusion"])
    for k in ("ema_decay", "timestep_sampler", "grad_accum"):
        assert trained[k] == profiled[k], k
    ours, theirs = trained["optimizer"], profiled["optimizer"]
    assert ({k: v for k, v in ours.items() if k != "sched"}
            == {k: v for k, v in theirs.items() if k != "sched"})
    steps = (0, 1, 2999, 3000, 10 ** 5)
    assert ([ours["sched"](s) for s in steps]
            == [theirs["sched"](s) for s in steps])
    flow = config.endswith("trellis_ss_flow.yml")
    assert isinstance(trained["diffusion"], RectifiedFlow) == flow
    assert (ours["sched"](0) == ours["sched"](10 ** 5)) == flow
