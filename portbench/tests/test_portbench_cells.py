"""Each cell's run on the CPU at a tiny size (``tiny.py``), past the
look for a card: a sound run comes out correct, and a run with the timed
path broken underneath comes out not correct, once for each fault the
cell can have. The cells' limits are the committed ones."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

from portbench import run as R

sys.path.insert(0, str(Path(__file__).parent))
from tiny import tiny_cell  # noqa: E402

BENCH = R.load_json(R.CHECKOUT / "BENCHMARK.json")
SEED = 2 ** 31 + 11


@pytest.fixture(autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _run(name: str, seconds: float = 0.5) -> dict:
    return R.run_cell(tiny_cell(name), SEED, seconds, False,
                      torch.device("cpu"), BENCH, setup_start=0.0)


@pytest.mark.parametrize("name", ["xl_image.primx", "xl_train.bs8"])
def test_a_sound_run_is_correct(name):
    """Every compared number within its limit; at this size the training
    step's ``update_gap`` is left out: with two blocks of 64 the median
    leaf is a bias, against which the key biases' round-off moves inside
    the fused qkv bias weigh 0.04-0.05 (0.0008-0.0026 at the cell's size,
    PERF.md)."""
    res = _run(name)
    checks = {k: c for k, c in res["checks"].items() if k != "update_gap"}
    assert checks and all(c["value"] <= c["limit"] for c in checks.values()), \
        res["checks"]
    assert res["correct"] or name == "xl_train.bs8"
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    e2e, _ = R.cell_metrics(BENCH, name)
    assert set(res["metrics"]) == {m["name"] for m in e2e}


def test_a_token_altered_where_it_is_produced_fails(monkeypatch):
    from topiaxl_torch.models.primx import PrimXParams
    from topiaxl_torch.pipelines import infer

    real = infer.generate_primx

    def altered(*a, **kw):
        p = real(*a, **kw)
        feat = p.feat.clone()
        feat[7] = 10.0
        return PrimXParams(p.srt, feat)

    monkeypatch.setattr(infer, "generate_primx", altered)
    res = _run("xl_image.primx")
    assert not res["correct"], res["checks"]


def test_a_step_that_leaves_its_state_unchanged_fails(monkeypatch):
    from topiaxl_torch.pipelines import train

    real = train.make_train_step

    def frozen(*a, **kw):
        step = real(*a, **kw)

        def run(state, batch, seed):
            keep = [t.detach().clone() for t in (
                list(state.model.parameters()) + list(state.opt_state.mu.values())
                + list(state.opt_state.nu.values()))]
            out = step(state, batch, seed)
            with torch.no_grad():
                for t, k in zip(list(state.model.parameters())
                                + list(state.opt_state.mu.values())
                                + list(state.opt_state.nu.values()), keep):
                    t.copy_(k)
            return out
        return run

    monkeypatch.setattr(train, "make_train_step", frozen)
    res = _run("xl_train.bs8")
    assert not res["correct"], res["checks"]


def test_half_of_the_batch_left_out_fails(monkeypatch):
    from portbench.drivers import train_dit

    monkeypatch.setattr(
        train_dit.Driver, "_program_batch",
        lambda self, i: {k: v[: v.shape[0] // 2]
                         for k, v in self.batch(i).items()})
    res = _run("xl_train.bs8")
    assert not res["correct"], res["checks"]
