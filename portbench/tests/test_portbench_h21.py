"""Hunyuan3D-2.1's shape-DiT cell (``hunyuan3d21_dit.train_bs2``): its files
are found by name; its counts hold against ``FlopCounterMode`` on the
plain reference at two tiny sizes and come to what the configuration's
shapes give; a run of its driver on the CPU at a tiny size (in f32) comes
out correct, and not correct under each fault (a state left unchanged,
half of each batch left out, renormalised top-2 weights); the routing
faults of the calibration change what they name; its readers read
nothing from a program without the counter or the spans; a program
without the model fails at set-up; a run and the reference import what
they may."""

from __future__ import annotations

import copy
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts_flow, counts_h21
from portbench import run as R
from portbench.reference import hunyuandit as rh

CELL = "hunyuan3d21_dit.train_bs2"
BENCH = R.load_json(R.CHECKOUT / "BENCHMARK.json")
SEED = 2 ** 31 + 25
TINY = dict(hidden_size=128, num_heads=2, depth=5, num_moe_layers=2,
            num_experts=4, input_size=40, context_dim=48)
COND = 23
METRICS = ["h21_train_mfu", "attn_roofline.h21_train",
           "qk_norm_roofline.h21_train", "moe_device_ms.h21_train",
           "moe_expert_roofline.h21_train", "moe_load_max.h21_train",
           "device_idle.h21_train", "backward_device_ms.h21_train",
           "forward_device_ms.h21_train", "optimizer_device_ms.h21_train"]
FORBIDDEN = {"jax", "jaxlib", "flax", "topiaxl"}


@pytest.fixture(autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def tiny_h21_cell() -> dict:
    """The cell at the tiny size, computing in f32: in bf16 a model this
    small reads a median gradient gap of ~1e-3 (its leaves average few
    roundings), above the limit that 12 sound seeds at the configuration's
    widths set on the card (PERF.md §2)."""
    cell = copy.deepcopy(R.load_cell(CELL))
    c = cell["config_data"]
    c["generator"].update(TINY, dtype="fp32")
    c["cond_tokens"] = COND
    return cell


def _run(seconds: float = 0.5, fault=None) -> dict:
    cell = tiny_h21_cell()
    if fault is not None:
        from portbench.drivers import train_h21

        real = train_h21.Driver.__init__

        def init(self, run, fault_=None):
            real(self, run, fault=fault)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(train_h21.Driver, "__init__", init)
            return R.run_cell(cell, SEED, seconds, False, torch.device("cpu"),
                              BENCH, setup_start=0.0)
    return R.run_cell(cell, SEED, seconds, False, torch.device("cpu"), BENCH,
                      setup_start=0.0)


def test_the_cell_its_mix_driver_and_metrics_are_found():
    cell = R.load_cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "hunyuan3d21_dit", "h21_train_bs2", 1)
    assert cell["traffic_data"] == {"driver": "train_h21", "first_steps": 3}
    c = cell["config_data"]
    assert set(c["reduced"]) == {"depth", "num_moe_layers"}
    entry = next(e for e in BENCH["configs"] if e["name"] == "hunyuan3d21_dit")
    assert entry["reduced"] == ["depth", "num_moe_layers"]
    assert entry["file"] == "portbench/configs/hunyuan3d21_dit.json"
    g = c["generator"]
    assert (g["depth"], g["num_moe_layers"], g["hidden_size"], g["num_heads"],
            g["input_size"], g["context_dim"]) == (13, 4, 2048, 16, 4096, 1024)
    assert c["train"]["batch_size"] == 2 and c["cond_tokens"] == 1370
    assert set(cell["limits"]) == {"grad_median_diff", "grad_median_gap",
                                   "update_gap", "update_median_gap"}
    e2e, layer = R.cell_metrics(BENCH, CELL)
    assert {m["name"] for m in e2e} == {"train_samples_per_s", "setup_s"}
    assert [m["name"] for m in layer] == METRICS
    for m in layer:
        assert m["workloads"] == [CELL], m["name"]
        reader, _ = R.load_reader(m["name"])
        assert callable(reader.read)
    spans = {m["name"]: R.load_reader(m["name"])[1].get("span")
             for m in layer}
    assert spans["moe_device_ms.h21_train"] == "h21.moe"
    assert spans["moe_expert_roofline.h21_train"] == "h21.moe.experts"
    assert spans["backward_device_ms.h21_train"] == "train.backward"
    assert spans["forward_device_ms.h21_train"] == "train.forward"
    assert spans["optimizer_device_ms.h21_train"] == "train.optimizer"


def _weights(depth, moe, C, H, cin, cc, E, seed=0) -> dict:
    """Release-named weights of a tiny model."""
    g = torch.Generator().manual_seed(seed)
    D, F = C // H, 4 * C
    P = {"x_embedder.weight": (C, cin), "x_embedder.bias": (C,),
         "t_embedder.mlp.0.weight": (F, C), "t_embedder.mlp.0.bias": (F,),
         "t_embedder.mlp.2.weight": (C, F), "t_embedder.mlp.2.bias": (C,),
         "final_layer.norm_final.weight": (C,),
         "final_layer.norm_final.bias": (C,),
         "final_layer.linear.weight": (cin, C), "final_layer.linear.bias": (cin,)}
    for i in range(depth):
        p = f"blocks.{i}."
        for n in ("norm1", "norm2", "norm3"):
            P.update({f"{p}{n}.weight": (C,), f"{p}{n}.bias": (C,)})
        for a, kd in (("attn1", C), ("attn2", cc)):
            P.update({f"{p}{a}.to_q.weight": (C, C),
                      f"{p}{a}.to_k.weight": (C, kd),
                      f"{p}{a}.to_v.weight": (C, kd),
                      f"{p}{a}.q_norm.weight": (D,),
                      f"{p}{a}.k_norm.weight": (D,),
                      f"{p}{a}.out_proj.weight": (C, C),
                      f"{p}{a}.out_proj.bias": (C,)})
        if i > depth // 2:
            P.update({p + "skip_norm.weight": (C,), p + "skip_norm.bias": (C,),
                      p + "skip_linear.weight": (C, 2 * C),
                      p + "skip_linear.bias": (C,)})
        if depth - i <= moe:
            P[p + "moe.gate.weight"] = (E, C)
            for e in [f"experts.{j}." for j in range(E)] + ["shared_experts."]:
                P.update({f"{p}moe.{e}net.0.proj.weight": (F, C),
                          f"{p}moe.{e}net.0.proj.bias": (F,),
                          f"{p}moe.{e}net.2.weight": (C, F),
                          f"{p}moe.{e}net.2.bias": (C,)})
        else:
            P.update({p + "mlp.fc1.weight": (F, C), p + "mlp.fc1.bias": (F,),
                      p + "mlp.fc2.weight": (C, F), p + "mlp.fc2.bias": (C,)})
    return {k: torch.randn(s, generator=g) * 0.1 for k, s in P.items()}


@pytest.mark.parametrize("depth,moe,C,H,N,M,E", [
    (3, 1, 32, 2, 12, 7, 4), (5, 2, 64, 4, 19, 10, 8)])
def test_forward_flops_count_the_reference_forward(depth, moe, C, H, N, M, E):
    """The forward's count equals the reference's products (its routed
    experts run each on its own slots, so the products it counts are the
    top-2 slots'); forward and backward are three forwards but for the
    products no gradient needs (the latents', the time sinusoid's and the
    conditioning's)."""
    cc, cin, B = 16, 8, 2
    P = {k: v.requires_grad_() for k, v in _weights(depth, moe, C, H, cin, cc,
                                                   E).items()}
    g = torch.Generator().manual_seed(1)
    b = {"x": torch.randn((B, N, cin), generator=g),
         "y": torch.randn((B, M, cc), generator=g),
         "t": torch.tensor([0.2, 0.9]),
         "noise": torch.randn((B, N, cin), generator=g),
         "drop": torch.tensor([False, True])}
    args = (B, depth, moe, C, N, M, cc)
    kw = dict(in_channels=cin, experts=E)
    with FlopCounterMode(display=False) as fwd:
        rh.training_loss(P, b["x"], b["y"], b["t"], b["noise"], b["drop"], H)
    assert fwd.get_total_flops() == pytest.approx(
        counts_h21.forward_flops(*args, **kw), rel=1e-9)
    with FlopCounterMode(display=False) as both:
        rh.training_loss(P, b["x"], b["y"], b["t"], b["noise"], b["drop"],
                         H).mean().backward()
    no_input_grad = 2 * B * (N * cin * C + C * 4 * C + depth * 2 * M * cc * C)
    assert both.get_total_flops() == pytest.approx(
        counts_h21.train_step_flops(*args, **kw) - no_input_grad, rel=1e-9)


def test_the_configuration_counts_11_4_tflop_a_sample():
    """11.4 TFLOP a sample forward at 13 blocks of 2048 over 4097 tokens
    and 1370 keys of 1024, of which the MoE FFNs (gate, top-2 routed,
    shared) are 28.9% and attention 20.9%; the routed experts' products of
    a step of 2 are 4 layers x 2 products x 2 x 8194 x 2 x 2048 x 8192."""
    args = (1, 13, 4, 2048, 4096, 1370, 1024)
    per_sample = counts_h21.forward_flops(*args)
    assert per_sample == pytest.approx(11.40e12, rel=1e-3)
    attn = 13 * 4 * 4097 * (4097 + 1370) * 2048
    assert attn / per_sample == pytest.approx(0.209, abs=1e-3)
    moe = counts_h21.forward_flops(1, 13, 4, 2048, 4096, 1370, 1024) - \
        counts_h21.forward_flops(1, 13, 0, 2048, 4096, 1370, 1024) + \
        4 * 2 * 2 * 4097 * 2048 * 8192
    assert moe / per_sample == pytest.approx(0.289, abs=1e-3)
    assert counts_h21.expert_flops(2, 4, 2048, 4097) == \
        4 * 2 * 2 * 8194 * 2 * 2048 * 8192
    assert counts_h21.train_step_flops(2, *args[1:]) == \
        pytest.approx(6 * per_sample)


def test_qk_norm_bytes_count_every_call_of_a_step():
    """In each of 13 blocks q and k of the self-attention and q of the
    cross-attention over 4097 tokens, k of the cross-attention over 1370,
    forward and backward, each call ``counts_flow``'s bytes."""
    got = counts_h21.step_qk_norm_bytes(2, 13, 4096, 1370, 16, 128)

    def call(tokens):
        return sum(counts_flow.qk_norm_bytes(2, tokens, 16, 128))

    assert got == 13 * (3 * call(4097) + call(1370))
    assert call(4097) == 5 * 2 * 2 * 4097 * 16 * 128 + 12 * 16 * 128


def test_a_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    e2e, _ = R.cell_metrics(BENCH, CELL)
    assert set(res["metrics"]) == {m["name"] for m in e2e}


@pytest.mark.parametrize("fault", ["half_batch", "renorm_topk"])
def test_a_fault_in_the_program_fails(fault):
    res = _run(fault=fault)
    assert not res["correct"], res["checks"]


def test_the_routing_faults_change_what_they_name():
    """``renorm_topk`` gives each token's top-2 weights a sum of one;
    ``no_aux`` leaves the forward as it was and the gate the gradient of
    a layer without the auxiliary loss (in eval mode, as the release's
    gate)."""
    from portbench.drivers import train_h21
    from topiaxl_torch.models import moe

    g = torch.Generator().manual_seed(3)
    x0 = torch.randn((2, 11, 16), generator=g)

    def layer(fault=None, training=True):
        m = moe.MoEFFN(16, 24, 4, 2, dtype=torch.float32,
                       param_dtype=torch.float32).to_empty(device="cpu")
        with torch.no_grad():
            for p in m.parameters():
                p.copy_(torch.randn(p.shape, generator=torch.Generator()
                                    .manual_seed(p.numel())))
        if fault is not None:
            m.route = train_h21.FAULTS[fault](m.route)
        return m.train(training)

    _, w, _ = layer("renorm_topk").route(x0.reshape(-1, 16))
    assert torch.allclose(w.sum(-1), torch.ones(22))
    outs, grads = [], []
    for m in (layer(), layer("no_aux"), layer(training=False)):
        y = m(x0)
        # a loss small beside the auxiliary one, as a training loss's
        # gradient at the gate is
        (1e-6 * y.square().sum()).backward()
        outs.append(y.detach())
        grads.append(m.gate.weight.grad)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])
    assert torch.allclose(grads[1], grads[2], rtol=1e-6, atol=0)
    assert not torch.allclose(grads[0], grads[2], rtol=1e-3, atol=0)


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


def test_the_load_reader_reads_the_counter_and_nothing_without_it(monkeypatch):
    """``moe_load_max`` reads the busiest expert over the mean in the worst
    layer from the program's counter; None where it counted nothing or
    the program has no such module."""
    from topiaxl_torch.models import moe

    reader, params = R.load_reader("moe_load_max.h21_train")
    moe.reset_expert_tokens()
    assert reader.read(None, params) is None
    moe.expert_tokens.update({"blocks.3.moe": torch.tensor([10, 30, 20, 20]),
                              "blocks.4.moe": torch.tensor([20, 20, 20, 20])})
    try:
        assert reader.read(None, params) == pytest.approx(1.5)
    finally:
        moe.reset_expert_tokens()
    monkeypatch.setitem(sys.modules, "topiaxl_torch.models.moe", None)
    assert reader.read(None, params) is None


def test_a_program_without_the_model_fails_at_set_up(monkeypatch):
    """The parent commit has no ``models/hunyuandit.py``: the cell's set-up
    raises at once, and ``portbench.run`` exits with the error."""
    monkeypatch.setitem(sys.modules, "topiaxl_torch.models.hunyuandit", None)
    with pytest.raises(ImportError):
        _run()


RUN = """
import json, sys, torch
sys.path.insert(0, {tests!r})
torch.set_num_threads(2)
from test_portbench_h21 import tiny_h21_cell, SEED
from portbench import run as R
R.run_cell(tiny_h21_cell(), SEED, 0.2, False, torch.device("cpu"),
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
        "import json, sys\nimport portbench.reference.hunyuandit\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not ref & (FORBIDDEN | {"topiaxl_torch"})
