"""What a run imports: nothing whose top-level name, compared whole, is
``jax``, ``jaxlib``, ``flax`` or ``topiaxl`` (``topiaxl_torch`` begins with
``topiaxl`` and is the program); the reference imports nothing of the
program either."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run as R

FORBIDDEN = {"jax", "jaxlib", "flax", "topiaxl"}

CELL_RUN = """
import json, sys, torch
sys.path.insert(0, {tests!r})
torch.set_num_threads(2)
from tiny import tiny_cell
from portbench import run as R
R.run_cell(tiny_cell({cell!r}), 7, 0.2, False, torch.device("cpu"),
           R.load_json(R.CHECKOUT / "BENCHMARK.json"), setup_start=0.0)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=R.CHECKOUT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", ["xl_image.primx", "xl_train.bs8"])
def test_a_run_of_each_driver_imports_no_jax_and_not_the_jax_package(cell):
    mods = _top_level_modules(CELL_RUN.format(
        tests=str(Path(__file__).parent), cell=cell))
    assert "topiaxl_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    mods = _top_level_modules(
        "import json, sys\n"
        "import portbench.reference.dit, portbench.reference.dinov2\n"
        "import portbench.reference.vae, portbench.reference.diffusion\n"
        "import portbench.reference.train, portbench.reference.judge\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not mods & (FORBIDDEN | {"topiaxl_torch"})


def test_the_reference_sources_name_no_program_module():
    allowed = {"torch", "numpy", "math", "contextlib", "__future__"}
    for path in (R.ROOT / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [] if node.level else [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in allowed, (path.name, n)


def test_the_forbidden_names_are_compared_whole(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "topiaxl_torch_like", types.ModuleType("x"))
    assert "topiaxl" not in R.imported_forbidden()
    monkeypatch.setitem(sys.modules, "topiaxl.core", types.ModuleType("x"))
    assert R.imported_forbidden() == ["topiaxl"]


def test_without_a_card_a_run_exits_with_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "xl_train.bs8",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=R.CHECKOUT, timeout=300,
        env=dict(__import__("os").environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 3, out.stderr
    assert out.stdout == ""
