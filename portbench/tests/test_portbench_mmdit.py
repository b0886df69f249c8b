"""Hunyuan3D-2's shape-DiT cell (``hunyuan3d_dit.train_bs4``): its files are
found by name; its counts hold against ``FlopCounterMode`` on the plain
reference and come to what the published shapes give; a run of its driver
on the CPU at a tiny size comes out correct, and not correct under each
fault (an altered answer, a state left unchanged, half of each batch left
out); a program without the model fails at set-up; a run and the
reference import what they may."""

from __future__ import annotations

import copy
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts_flow, counts_mmdit
from portbench import run as R
from portbench.reference import mmdit as rmm

CELL = "hunyuan3d_dit.train_bs4"
BENCH = R.load_json(R.CHECKOUT / "BENCHMARK.json")
SEED = 2 ** 31 + 23
TINY = dict(hidden_size=128, num_heads=2, depth=2, depth_single_blocks=2,
            num_latents=40, context_in_dim=48)
COND = 23
METRICS = ["hy_train_mfu", "attn_roofline.hy_train",
           "qk_norm_roofline.hy_train", "device_idle.hy_train",
           "double_device_ms.hy_train", "single_device_ms.hy_train",
           "backward_device_ms.hy_train"]
FORBIDDEN = {"jax", "jaxlib", "flax", "topiaxl"}


@pytest.fixture(autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def tiny_mmdit_cell() -> dict:
    cell = copy.deepcopy(R.load_cell(CELL))
    c = cell["config_data"]
    c["generator"].update(TINY)
    c["cond_tokens"] = COND
    return cell


def _run(seconds: float = 0.5) -> dict:
    return R.run_cell(tiny_mmdit_cell(), SEED, seconds, False,
                      torch.device("cpu"), BENCH, setup_start=0.0)


def test_the_cell_its_mix_driver_and_metrics_are_found():
    cell = R.load_cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "hunyuan3d_dit", "mmdit_train_bs4", 1)
    assert cell["traffic_data"] == {"driver": "train_mmdit", "first_steps": 3}
    c = cell["config_data"]
    assert c["reduced"] == [] and c["train"]["batch_size"] == 4
    assert c["cond_tokens"] == 1370 and c["generator"]["num_latents"] == 3072
    assert set(cell["limits"]) == {"grad_gap", "grad_median_gap", "update_gap"}
    e2e, layer = R.cell_metrics(BENCH, CELL)
    assert {m["name"] for m in e2e} == {"train_samples_per_s", "setup_s"}
    assert [m["name"] for m in layer] == METRICS
    for m in layer:
        assert m["workloads"] == [CELL], m["name"]
        reader, _ = R.load_reader(m["name"])
        assert callable(reader.read)
    spans = {m["name"]: R.load_reader(m["name"])[1].get("span")
             for m in layer}
    assert spans["double_device_ms.hy_train"] == "mmdit.double"
    assert spans["single_device_ms.hy_train"] == "mmdit.single"
    assert spans["backward_device_ms.hy_train"] == "train.backward"


def _weights(depth=2, single=2, C=64, H=2, cin=8, cc=32, seed=0) -> dict:
    g = torch.Generator().manual_seed(seed)
    D, F = C // H, 4 * C
    P = {"latent_in.weight": (C, cin), "latent_in.bias": (C,),
         "time_in.in_layer.weight": (C, 256), "time_in.in_layer.bias": (C,),
         "time_in.out_layer.weight": (C, C), "time_in.out_layer.bias": (C,),
         "cond_in.weight": (C, cc), "cond_in.bias": (C,),
         "final_layer.adaLN_modulation.1.weight": (2 * C, C),
         "final_layer.adaLN_modulation.1.bias": (2 * C,),
         "final_layer.linear.weight": (cin, C),
         "final_layer.linear.bias": (cin,)}
    for i in range(depth):
        for s in ("img", "txt"):
            p = f"double_blocks.{i}.{s}_"
            P.update({p + "mod.lin.weight": (6 * C, C),
                      p + "mod.lin.bias": (6 * C,),
                      p + "attn.qkv.weight": (3 * C, C),
                      p + "attn.qkv.bias": (3 * C,),
                      p + "attn.norm.query_norm.scale": (D,),
                      p + "attn.norm.key_norm.scale": (D,),
                      p + "attn.proj.weight": (C, C), p + "attn.proj.bias": (C,),
                      p + "mlp.0.weight": (F, C), p + "mlp.0.bias": (F,),
                      p + "mlp.2.weight": (C, F), p + "mlp.2.bias": (C,)})
    for i in range(single):
        p = f"single_blocks.{i}."
        P.update({p + "linear1.weight": (3 * C + F, C),
                  p + "linear1.bias": (3 * C + F,),
                  p + "linear2.weight": (C, C + F), p + "linear2.bias": (C,),
                  p + "norm.query_norm.scale": (D,),
                  p + "norm.key_norm.scale": (D,),
                  p + "modulation.lin.weight": (3 * C, C),
                  p + "modulation.lin.bias": (3 * C,)})
    return {k: torch.randn(s, generator=g) * 0.1 for k, s in P.items()}


def test_train_step_flops_count_the_reference_forward_and_backward():
    """The forward's count equals the reference's products; forward and
    backward are three forwards but for the products no gradient needs
    (the inputs' own: the latents, the timestep frequencies, the
    conditioning)."""
    depth, single, C, H, N, M, cc, cin, B = 2, 2, 64, 2, 12, 7, 32, 8, 2
    P = {k: v.requires_grad_() for k, v in _weights(depth, single, C, H, cin,
                                                   cc).items()}
    g = torch.Generator().manual_seed(1)
    b = {"x": torch.randn((B, N, cin), generator=g),
         "y": torch.randn((B, M, cc), generator=g),
         "t": torch.tensor([0.2, 0.9]),
         "noise": torch.randn((B, N, cin), generator=g),
         "drop": torch.tensor([False, True])}
    args = (B, depth, single, C, N, M, cc)
    with FlopCounterMode(display=False) as fwd:
        rmm.training_loss(P, b["x"], b["y"], b["t"], b["noise"], b["drop"], H)
    assert fwd.get_total_flops() == pytest.approx(
        counts_mmdit.forward_flops(*args, in_channels=cin), rel=1e-9)
    with FlopCounterMode(display=False) as both:
        rmm.training_loss(P, b["x"], b["y"], b["t"], b["noise"], b["drop"],
                          H).mean().backward()
    no_input_grad = 2 * B * (N * cin * C + 256 * C + M * cc * C)
    assert both.get_total_flops() == pytest.approx(
        counts_mmdit.train_step_flops(*args, in_channels=cin) - no_input_grad,
        rel=1e-9)


def test_the_published_shapes_count_9_25_tflop_a_sample():
    """9.25 TFLOP a sample forward, of which the joint attention (48 blocks
    over 4442 tokens) is 41.9%, each block kind 192.6 GFLOP."""
    args = (1, 16, 32, 1024, 3072, 1370, 1536)
    per_sample = counts_mmdit.forward_flops(*args)
    assert per_sample == pytest.approx(9.25e12, rel=1e-3)
    attn = 48 * 4 * 4442 ** 2 * 1024
    assert attn / per_sample == pytest.approx(0.419, abs=1e-3)
    double = counts_mmdit.forward_flops(1, 1, 0, 1024, 3072, 1370, 1536) - \
        counts_mmdit.forward_flops(1, 0, 0, 1024, 3072, 1370, 1536)
    single = counts_mmdit.forward_flops(1, 0, 1, 1024, 3072, 1370, 1536) - \
        counts_mmdit.forward_flops(1, 0, 0, 1024, 3072, 1370, 1536)
    assert double == pytest.approx(192.6e9, rel=1e-3)
    assert single == pytest.approx(192.6e9, rel=1e-3)
    assert counts_mmdit.train_step_flops(4, *args[1:]) == \
        pytest.approx(12 * per_sample)


def test_qk_norm_bytes_count_every_call_of_a_step():
    """q and k of both streams of 16 double blocks and of 32 single
    blocks, forward and backward, each call ``counts_flow``'s bytes."""
    got = counts_mmdit.step_qk_norm_bytes(4, 16, 32, 3072, 1370, 16, 64)

    def call(tokens):
        return sum(counts_flow.qk_norm_bytes(4, tokens, 16, 64))

    assert got == 2 * (16 * (call(3072) + call(1370)) + 32 * call(4442))
    assert call(4442) == 5 * 2 * 4 * 4442 * 16 * 64 + 12 * 16 * 64


def test_a_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    e2e, _ = R.cell_metrics(BENCH, CELL)
    assert set(res["metrics"]) == {m["name"] for m in e2e}


def test_an_altered_answer_fails(monkeypatch):
    """The RMS QK norm without its gains, where the program computes it."""
    from topiaxl_torch.models import layers
    from topiaxl_torch.ops import qk_norm

    monkeypatch.setattr(
        layers, "qk_rms_norm", lambda x, gamma, scale, form="l2":
        qk_norm.qk_rms_norm(x, gamma.detach() * 0 + 1, scale, form))
    res = _run()
    assert not res["correct"], res["checks"]


def test_a_step_that_leaves_its_state_unchanged_fails(monkeypatch):
    from topiaxl_torch.pipelines import train

    real = train.make_train_step

    def frozen(*a, **kw):
        step = real(*a, **kw)

        def run(state, batch, seed):
            tensors = (list(state.model.parameters())
                       + list(state.opt_state.mu.values())
                       + list(state.opt_state.nu.values()))
            keep = [t.detach().clone() for t in tensors]
            out = step(state, batch, seed)
            with torch.no_grad():
                for t, k in zip(tensors, keep):
                    t.copy_(k)
            return out
        return run

    monkeypatch.setattr(train, "make_train_step", frozen)
    res = _run()
    assert not res["correct"], res["checks"]


def test_half_of_the_batch_left_out_fails(monkeypatch):
    from portbench.drivers import train_mmdit

    monkeypatch.setattr(
        train_mmdit.Driver, "_program_batch",
        lambda self, i: {k: v[: v.shape[0] // 2]
                         for k, v in self.batch(i).items()})
    res = _run()
    assert not res["correct"], res["checks"]


def test_a_program_without_the_model_fails_at_set_up(monkeypatch):
    """The parent commit has no ``models/mmdit.py``: the cell's set-up
    raises at once, and ``portbench.run`` exits with the error."""
    monkeypatch.setitem(sys.modules, "topiaxl_torch.models.mmdit", None)
    with pytest.raises(ImportError):
        _run()


RUN = """
import json, sys, torch
sys.path.insert(0, {tests!r})
torch.set_num_threads(2)
from test_portbench_mmdit import tiny_mmdit_cell, SEED
from portbench import run as R
R.run_cell(tiny_mmdit_cell(), SEED, 0.2, False, torch.device("cpu"),
           R.load_json(R.CHECKOUT / "BENCHMARK.json"), setup_start=0.0)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=R.CHECKOUT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_imports_no_jax_and_the_reference_nothing_of_the_program():
    mods = _top_level_modules(RUN.format(tests=str(Path(__file__).parent)))
    assert "topiaxl_torch" in mods and not mods & FORBIDDEN, mods & FORBIDDEN
    ref = _top_level_modules(
        "import json, sys\nimport portbench.reference.mmdit\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not ref & (FORBIDDEN | {"topiaxl_torch"})
