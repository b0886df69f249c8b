"""TRELLIS's flow-transformer cell (``trellis_ss_flow.train_bs8``): its
files are found by name; its counts hold against ``FlopCounterMode`` on
the plain reference; a run of its driver on the CPU at a tiny size comes
out correct, and not correct under each fault (an altered answer, a state
left unchanged, half of each batch left out); a program without the model
fails at set-up."""

from __future__ import annotations

import copy
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts_flow
from portbench import run as R
from portbench.reference import ss_flow as rflow

CELL = "trellis_ss_flow.train_bs8"
BENCH = R.load_json(R.CHECKOUT / "BENCHMARK.json")
SEED = 2 ** 31 + 11
TINY = dict(resolution=4, model_channels=256, cond_channels=64, num_blocks=2,
            num_heads=4)
METRICS = ["ss_train_mfu", "attn_roofline.ss_train", "qk_norm_roofline.ss_train",
           "device_idle.ss_train", "backward_device_ms.ss_train"]


@pytest.fixture(autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def tiny_flow_cell() -> dict:
    cell = copy.deepcopy(R.load_cell(CELL))
    c = cell["config_data"]
    c["generator"].update(TINY)
    c["cond_tokens"] = 8
    c["train"]["batch_size"] = 4
    return cell


def _run(seconds: float = 0.5) -> dict:
    return R.run_cell(tiny_flow_cell(), SEED, seconds, False,
                      torch.device("cpu"), BENCH, setup_start=0.0)


def test_the_cell_its_mix_driver_and_metrics_are_found():
    cell = R.load_cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "trellis_ss_flow", "flow_train_bs8", 1)
    assert cell["traffic_data"]["driver"] == "train_flow"
    assert cell["config_data"]["reduced"] == []
    assert set(cell["limits"]) == {"grad_gap", "grad_median_gap", "update_gap"}
    e2e, layer = R.cell_metrics(BENCH, CELL)
    assert {m["name"] for m in e2e} == {"train_samples_per_s", "setup_s"}
    assert [m["name"] for m in layer] == METRICS
    for name in METRICS:
        reader, _ = R.load_reader(name)
        assert callable(reader.read)


def _weights(depth=2, C=64, H=4, cin=8, cc=32, seed=0) -> dict:
    g = torch.Generator().manual_seed(seed)
    P = {"input_layer.weight": (C, cin), "input_layer.bias": (C,),
         "t_embedder.mlp.0.weight": (C, 256), "t_embedder.mlp.0.bias": (C,),
         "t_embedder.mlp.2.weight": (C, C), "t_embedder.mlp.2.bias": (C,),
         "out_layer.weight": (cin, C), "out_layer.bias": (cin,)}
    for i in range(depth):
        p = f"blocks.{i}."
        P.update({p + "adaLN_modulation.1.weight": (6 * C, C),
                  p + "adaLN_modulation.1.bias": (6 * C,),
                  p + "self_attn.to_qkv.weight": (3 * C, C),
                  p + "self_attn.to_qkv.bias": (3 * C,),
                  p + "self_attn.q_rms_norm.gamma": (H, C // H),
                  p + "self_attn.k_rms_norm.gamma": (H, C // H),
                  p + "self_attn.to_out.weight": (C, C),
                  p + "self_attn.to_out.bias": (C,),
                  p + "norm2.weight": (C,), p + "norm2.bias": (C,),
                  p + "cross_attn.to_q.weight": (C, C),
                  p + "cross_attn.to_q.bias": (C,),
                  p + "cross_attn.to_kv.weight": (2 * C, cc),
                  p + "cross_attn.to_kv.bias": (2 * C,),
                  p + "cross_attn.to_out.weight": (C, C),
                  p + "cross_attn.to_out.bias": (C,),
                  p + "mlp.mlp.0.weight": (4 * C, C), p + "mlp.mlp.0.bias": (4 * C,),
                  p + "mlp.mlp.2.weight": (C, 4 * C), p + "mlp.mlp.2.bias": (C,)})
    return {k: torch.randn(s, generator=g) * 0.1 for k, s in P.items()}


def test_train_step_flops_count_the_reference_forward_and_backward():
    """The forward's count equals the reference's products; forward and
    backward are three forwards but for the products no gradient needs
    (the inputs' own: the latent, the timestep frequencies, the
    conditioning through K/V)."""
    depth, C, H, R_, M, cc, B = 2, 64, 4, 4, 8, 32, 2
    N = R_ ** 3
    P = {k: v.requires_grad_() for k, v in _weights(depth, C, H, cc=cc).items()}
    g = torch.Generator().manual_seed(1)
    b = {"x": torch.randn((B, 8, R_, R_, R_), generator=g),
         "y": torch.randn((B, M, cc), generator=g),
         "t": torch.tensor([0.2, 0.9]), "noise": torch.randn(
             (B, 8, R_, R_, R_), generator=g),
         "drop": torch.tensor([False, True])}
    with FlopCounterMode(display=False) as fwd:
        loss = rflow.training_loss(P, b["x"], b["y"], b["t"], b["noise"],
                                   b["drop"], H)
    count = counts_flow.forward_flops(B, depth, C, N, M, cc)
    assert fwd.get_total_flops() == pytest.approx(count, rel=1e-9)
    with FlopCounterMode(display=False) as both:
        rflow.training_loss(P, b["x"], b["y"], b["t"], b["noise"], b["drop"],
                            H).mean().backward()
    no_input_grad = 2 * B * (N * 8 * C + 256 * C + depth * M * cc * 2 * C)
    assert both.get_total_flops() == pytest.approx(
        counts_flow.train_step_flops(B, depth, C, N, M, cc) - no_input_grad,
        rel=1e-9)
    del loss


def test_the_published_shapes_count_what_the_issue_states():
    per_sample = counts_flow.forward_flops(1, 24, 1024, 4096, 1374, 1024)
    assert per_sample == pytest.approx(5.23e12, rel=2e-3)
    assert counts_flow.train_step_flops(8, 24, 1024, 4096, 1374, 1024) == \
        pytest.approx(125.5e12, rel=2e-3)


def test_qk_norm_bytes_read_and_write_each_tensor_once():
    fwd, bwd = counts_flow.qk_norm_bytes(8, 4096, 16, 64)
    elems = 8 * 4096 * 16 * 64
    assert fwd == 2 * 2 * elems + 4 * 16 * 64
    assert bwd == 3 * 2 * elems + 8 * 16 * 64


def test_a_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    e2e, _ = R.cell_metrics(BENCH, CELL)
    assert set(res["metrics"]) == {m["name"] for m in e2e}


def test_an_altered_answer_fails(monkeypatch):
    """The QK norm without its gains, where the program computes it."""
    from topiaxl_torch.models import layers
    from topiaxl_torch.ops import qk_norm

    monkeypatch.setattr(layers, "qk_rms_norm", lambda x, gamma, scale:
                        qk_norm.qk_rms_norm(x, gamma.detach() * 0 + 1, scale))
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
    from portbench.drivers import train_flow

    monkeypatch.setattr(
        train_flow.Driver, "_program_batch",
        lambda self, i: {k: v[: v.shape[0] // 2]
                         for k, v in self.batch(i).items()})
    res = _run()
    assert not res["correct"], res["checks"]


def test_a_program_without_the_model_fails_at_set_up(monkeypatch):
    """The parent commit has no ``models/ss_flow.py``: the cell's set-up
    raises at once, and ``portbench.run`` exits with the error."""
    monkeypatch.setitem(sys.modules, "topiaxl_torch.models.ss_flow", None)
    with pytest.raises(ImportError):
        _run()
