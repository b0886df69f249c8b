"""``BENCHMARK.json`` and the files the harness finds by its names; a new
cell, mix, configuration or per-layer metric as new files alone."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import run as R

BENCH = R.load_json(R.CHECKOUT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _names():
    yield from (c["name"] for c in BENCH["configs"])
    for w in BENCH["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        yield m["name"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_letters_digits_underscore_dot_and_dash(name):
    assert NAME.match(name), name


def test_units_are_short_and_plain():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m


def test_every_cell_takes_one_chip_and_has_its_files():
    for w in BENCH["workloads"]:
        assert w["chips"] == 1, w["name"]
        cell = R.load_cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        assert cell["limits"], w["name"]


def test_every_cell_reports_set_up_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e, layer = R.cell_metrics(BENCH, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert layer, w["name"]
        assert set(R.load_cell(w["name"])["end_to_end"]) == names - {"setup_s"}


def test_every_per_layer_metric_has_a_reader_and_moves_a_reported_metric():
    for m in BENCH["per_layer"]:
        reader, params = R.load_reader(m["name"])
        assert callable(reader.read), m["name"]
        for cell in m["workloads"]:
            e2e, _ = R.cell_metrics(BENCH, cell)
            assert m["moves"] in {e["name"] for e in e2e}, (m["name"], cell)


def test_every_configuration_file_is_under_the_paths():
    for c in BENCH["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert json.loads((R.CHECKOUT / c["file"]).read_text())["reduced"] \
            == c["reduced"]


def test_a_cell_dropped_in_as_files_is_found(tmp_path):
    """A copy of the benchmark's folder with one more configuration, mix,
    cell and per-layer metric, each a new file: the harness finds them by
    name, with no other edit."""
    root = tmp_path / "portbench"
    shutil.copytree(R.ROOT, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    cfg = json.loads((root / "configs" / "xl_image.json").read_text())
    cfg["inference"]["cfg"] = 3
    (root / "configs" / "xl_image_cfg3.json").write_text(json.dumps(cfg))
    (root / "traffic" / "primx_pair.json").write_text(json.dumps(
        {"driver": "serve_primx", "image_pool": 4,
         "check_requests": 4}))
    (root / "workloads" / "xl_image_cfg3.pair.json").write_text(json.dumps(
        {"config": "xl_image_cfg3", "traffic": "primx_pair", "chips": 1,
         "end_to_end": {"primx_per_s": "rate"},
         "limits": {"srt_gap": 0.1}}))
    (root / "metrics" / "graph_replays.pair.py").write_text(
        "def read(run, params):\n    return params['scale'] * run.units\n")
    (root / "metrics" / "graph_replays.pair.json").write_text('{"scale": 2}')

    cell = R.load_cell("xl_image_cfg3.pair", root=root)
    assert cell["config_data"]["inference"]["cfg"] == 3
    assert cell["traffic_data"]["check_requests"] == 4
    reader, params = R.load_reader("graph_replays.pair", root=root)

    class Run:
        units = 5

    assert reader.read(Run, params) == 10
    bench = dict(BENCH, per_layer=BENCH["per_layer"] + [
        {"name": "graph_replays.pair", "unit": "count", "better": "lower",
         "source": "program_counter", "layer": "DiT chain and decode",
         "moves": "primx_per_s", "workloads": ["xl_image_cfg3.pair"]}],
        end_to_end=[dict(m, workloads=m["workloads"] + ["xl_image_cfg3.pair"])
                    if m["name"] == "primx_per_s" else m
                    for m in BENCH["end_to_end"]])
    e2e, layer = R.cell_metrics(bench, "xl_image_cfg3.pair")
    assert {m["name"] for m in e2e} == {"primx_per_s", "setup_s"}
    assert [m["name"] for m in layer] == ["graph_replays.pair"]
