"""The port's benchmark (``topiaxl_torch/bench.py``) and the port's tracing
and timing (``topiaxl_torch/core/profiling.py``) on the CPU.

- ``cfg_step_flops`` equals ``FlopCounterMode``'s count of the port's CFG
  step (both forms) within 2% at small widths, and reads 5.40 TFLOP
  within 0.5% at the flagship shapes, below the 6.07 of ``bench.py``,
  which counts the null branch's cross-attention that the step does not
  run.
- The port's copies (``textured_sphere``, ``psnr``, and the DPM gate's
  ``tex_psnr`` and ``sdf_p99``) give the bits of the JAX side's
  (``tests/test_fidelity.py``; ``bench.py:bench_dpm_gate``'s nested
  functions, taken out with ``ast``).
- ``main(["--device", "cpu", "--tiny", "--fast"])`` prints JSON lines
  whose last carries exactly ``bench.py``'s keys (read from its source
  with ``ast``) less the four left out, and exits 0; a section that raises
  leaves ``<section>_error`` and exit 1; without a card it exits 2 and
  prints nothing.
"""

import ast
import io
import json
import os
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from test_torch_models import torch_threads  # noqa: F401 (autouse)
from topiaxl_torch import bench
from topiaxl_torch.core import profiling

ROOT = Path(__file__).resolve().parent.parent
BENCH_PY = ROOT / "bench.py"
# bench.py's keys the port leaves out (bench.py's own docstring names its
# TPU target; the reference runtime is not in the repository; the slow
# suite is the JAX package's record)
LEFT_OUT = {"image_to_glb_vs_target", "albedo_psnr_vs_reference_db",
            "slow_suite", "slow_suite_passed", "slow_suite_sha"}
RENAMED = {"flash_parity_on_tpu": "flash_parity_on_card"}


def _dict_keys(node) -> set:
    return {k.value for k in node.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)}


def bench_py_keys() -> set:
    """The metric keys ``bench.py`` reports: string subscripts assigned in
    its sections and ``main``, the dict literals assigned to ``result``,
    passed to ``result.update`` or returned; not the error keys, the
    popped ``total``, or the outage line of ``_require_tpu`` and the slow
    suite's record."""
    tree = ast.parse(BENCH_PY.read_text())
    keys = set()
    for fn in tree.body:
        if (not isinstance(fn, ast.FunctionDef)
                or fn.name in ("_require_tpu", "_read_slow_suite")):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if (isinstance(tgt, ast.Subscript)
                            and isinstance(tgt.slice, ast.Constant)
                            and isinstance(tgt.slice.value, str)):
                        keys.add(tgt.slice.value)
                    if (isinstance(tgt, ast.Name) and tgt.id == "result"
                            and isinstance(node.value, ast.Dict)):
                        keys |= _dict_keys(node.value)
            elif isinstance(node, ast.Return) and isinstance(node.value,
                                                             ast.Dict):
                keys |= _dict_keys(node.value)
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr == "update"
                  and isinstance(node.func.value, ast.Name)
                  and node.func.value.id == "result" and node.args
                  and isinstance(node.args[0], ast.Dict)):
                keys |= _dict_keys(node.args[0])
    return {k for k in keys if k != "total" and not k.endswith("_error")}


def expected_keys() -> set:
    return {RENAMED.get(k, k) for k in bench_py_keys() - LEFT_OUT}


def bench_py_constant(name: str):
    tree = ast.parse(BENCH_PY.read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == name):
            return ast.literal_eval(node.value)
    raise KeyError(name)


def dpm_gate_functions() -> dict:
    """``tex_psnr`` and ``sdf_p99`` as ``bench.py:bench_dpm_gate`` defines
    them (nested there), compiled from its source."""
    tree = ast.parse(BENCH_PY.read_text())
    gate = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name == "bench_dpm_gate")
    nested = [n for n in gate.body if isinstance(n, ast.FunctionDef)
              and n.name in ("tex_psnr", "sdf_p99")]
    ns = {"np": np}
    exec(compile(ast.Module(body=nested, type_ignores=[]), str(BENCH_PY),
                 "exec"), ns)
    return {k: ns[k] for k in ("tex_psnr", "sdf_p99")}


def test_bench_py_keys_are_read():
    keys = bench_py_keys()
    # a few of each section, so that an ast reader that finds nothing
    # cannot pass the key-set test below
    assert {"metric", "mfu", "image_to_glb_seconds", "matting_s",
            "e2e_runs_stages_s", "albedo_psnr_db", "uv_charts_lscm",
            "assets_per_min_pipelined", "dpm12_vs_ode_psnr_db",
            "flash_parity_on_tpu", "dit_denoise_steps_per_sec_int8",
            "train_steps_per_sec_bs8"} <= keys
    assert LEFT_OUT - {"slow_suite", "slow_suite_passed",
                       "slow_suite_sha"} <= keys


@pytest.mark.parametrize("cfg_fast", [True, False])
@pytest.mark.parametrize("depth,hidden,heads,n,m", [(2, 64, 4, 64, 16),
                                                    (3, 128, 2, 96, 40)])
def test_cfg_step_flops_match_the_flop_counter(cfg_fast, depth, hidden,
                                                heads, n, m):
    """Counted against ``FlopCounterMode`` over the port's step:
    ``forward_with_cfg_fast`` (cross-attention on the cond half) or
    ``forward_with_cfg_kv`` (both halves), within 2%."""
    from topiaxl_torch.models.dit import DiT

    dit = DiT(seq_length=n, in_channels=68, condition_channels=32,
              hidden_size=hidden, depth=depth, num_heads=heads,
              dtype=torch.float32, device="cpu",
              generator=torch.Generator().manual_seed(0)).eval()
    g = torch.Generator().manual_seed(1)
    x = torch.randn((1, n, 68), generator=g)
    y = torch.randn((1, m, 32), generator=g)
    t = torch.full((1,), 500)
    with torch.no_grad():
        if cfg_fast:
            kvs, nulls = dit.precompute_kv(y), dit.precompute_null_out()
            with FlopCounterMode(display=False) as fc:
                dit.forward_with_cfg_fast(x, t, kvs, nulls, 6.0)
        else:
            null = dit.null_cond_embedding[None, None, :].expand_as(y)
            kvs = dit.precompute_kv(torch.cat([y, null], dim=0))
            with FlopCounterMode(display=False) as fc:
                dit.forward_with_cfg_kv(x, t, kvs, 6.0)
    counted = bench.cfg_step_flops(depth, hidden, heads, n, m,
                                   cfg_fast=cfg_fast)
    assert abs(counted / fc.get_total_flops() - 1) <= 0.02, (
        counted, fc.get_total_flops())


def test_cfg_step_flops_at_the_flagship():
    flops = bench.cfg_step_flops(28, 1152, 16, 2048, 1370)
    assert abs(flops / 5.40e12 - 1) <= 0.005, flops
    # bench.py's count includes the null branch's cross-attention
    assert flops < bench_py_constant("STEP_TFLOPS") * 1e12
    assert bench.cfg_step_flops(28, 1152, 16, 2048, 1370,
                                cfg_fast=False) > flops


def _sphere_case():
    from test_fidelity import _textured_sphere
    from topiaxl_torch.pipelines.synthetic import textured_sphere

    ref, got = _textured_sphere(), textured_sphere()
    return ([np.asarray(ref.srt), np.asarray(ref.feat)],
            [got.srt.numpy(), got.feat.numpy()])


def _psnr_case():
    from test_fidelity import _psnr
    from topiaxl_torch.pipelines.synthetic import psnr

    rng = np.random.default_rng(5)
    a, b = rng.random((300, 3)), rng.random((300, 3)).astype(np.float32)
    return [_psnr(a, b), _psnr(a, a)], [psnr(a, b), psnr(a, a)]


def _payloads():
    rng = np.random.default_rng(6)
    a = rng.standard_normal((64, 6, 512)).astype(np.float32)
    return a, a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)


def _gate_case(name):
    def case():
        a, b = _payloads()
        return ([dpm_gate_functions()[name](a, b)],
                [getattr(bench, name)(a, b)])
    return case


@pytest.mark.parametrize("case", [_sphere_case, _psnr_case,
                                  _gate_case("tex_psnr"),
                                  _gate_case("sdf_p99")],
                         ids=["textured_sphere", "psnr", "tex_psnr",
                              "sdf_p99"])
def test_copies_give_the_bits_of_the_jax_side(case):
    ref, got = case()
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
        assert np.asarray(g).dtype == np.asarray(r).dtype


def _run_main(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = bench.main(argv)
    return rc, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def tiny_run():
    return _run_main(["--device", "cpu", "--tiny", "--fast"])


def test_main_prints_bench_py_keys_on_its_last_line(tiny_run):
    rc, lines = tiny_run
    assert rc == 0, lines[-1:]
    rows = [json.loads(line) for line in lines]    # every line is JSON
    assert len(rows) >= 6
    last = rows[-1]
    assert set(last) == expected_keys(), (
        set(last) ^ expected_keys())
    # each earlier line is a prefix of what the last carries
    assert all(set(r) <= set(last) for r in rows)
    assert last["flash_parity_on_card"] is True
    assert last["mfu"] is None      # no card: no peak to divide by
    for k in ("value", "image_to_glb_seconds", "assets_per_min_pipelined",
              "dit_denoise_steps_per_sec_int8", "train_steps_per_sec",
              "train_steps_per_sec_bs8"):
        assert last[k] > 0, k
    assert last["albedo_psnr_db"] > 30
    assert len(last["e2e_runs_s"]) == 1   # --fast: one warm run


def test_a_failing_section_is_recorded_and_fails_the_run(monkeypatch):
    """The e2e section raises: ``image_to_glb_error``, the sections that
    need its context leave no keys, the others still report, exit 1."""
    def broken(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(bench, "bench_e2e_seconds", broken)
    monkeypatch.setattr(bench, "bench_dit_steps", lambda *a, **k: (10.0, 1e9))
    monkeypatch.setattr(bench, "bench_fidelity",
                        lambda *a, **k: {"albedo_psnr_db": 40.0})
    monkeypatch.setattr(bench, "check_flash", lambda *a, **k: True)
    monkeypatch.setattr(bench, "bench_train_steps", lambda *a, **k: 1.0)
    rc, lines = _run_main(["--device", "cpu", "--tiny", "--fast"])
    last = json.loads(lines[-1])
    assert rc == 1
    assert last["image_to_glb_error"] == "RuntimeError('planted')"
    assert "assets_per_min_pipelined" not in last
    assert "dpm_albedo_psnr_db" not in last
    assert last["value"] == 10.0 and last["train_steps_per_sec_bs8"] == 1.0
    assert last["flash_parity_on_card"] is True


def test_without_a_card_it_exits_at_once(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "bench_dit_steps", lambda *a, **k: 1 / 0)
    rc, lines = _run_main([])
    assert rc == 2 and lines == []


def test_peak_table_raises_for_an_unknown_card():
    assert bench.peak_bf16_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    with pytest.raises(ValueError, match="no bf16 peak"):
        bench.peak_bf16_flops("Some Card")


def test_timeit_and_trace(tmp_path):
    calls = []
    t = profiling.timeit(lambda x: calls.append(x) or x * 2, 3, iters=4,
                         warmup=1)
    assert len(calls) == 5 and t["iters"] == 4 and t["out"] == 6
    assert t["mean_s"] > 0 and t["per_sec"] == pytest.approx(1 / t["mean_s"])
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any("mm" in str(n) for n in names), sorted(map(str, names))[:20]
    # a block that raises still writes its trace
    with pytest.raises(ZeroDivisionError):
        with profiling.trace(str(tmp_path / "tr2")):
            1 / 0
    assert os.path.exists(tmp_path / "tr2" / "trace.json")


def test_chip_smoke_checks_every_bench_key():
    """chip_smoke's bench phase asks the card's run for bench.py's keys."""
    import chip_smoke

    assert set(chip_smoke.BENCH_KEYS) == expected_keys()
