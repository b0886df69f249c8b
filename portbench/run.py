"""Run one cell of the benchmark once:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. The cell
(``workloads/<cell>.json``) names its configuration (``configs/``), its
traffic mix (``traffic/<mix>.json``, whose ``driver`` is the module under
``drivers/`` that drives the program), the chips it needs, how its
end-to-end metrics reduce from the window's counts, and the limit of each
number its check compares. Per-layer metrics are the readers
``metrics/<metric>.py`` (with their parameters in ``metrics/<metric>.json``
where they have any), found by the names in ``BENCHMARK.json``. A new cell,
mix, configuration or metric is new files alone.

A run: set-up (the cell's driver module builds the program from the seed
and warms every shape the traffic uses), then a closed-loop window of
``--seconds``: the module's requests back to back, each to its end, the
last one started before the deadline included; the window ends when the
device has finished it. With ``--trace 0`` the result carries the cell's
end-to-end metrics; with ``--trace 1`` the window (at most
``TRACE_SECONDS``) runs under ``torch.profiler`` and the result carries
the per-layer metrics, the device's busy time and a breakdown. Then the
module frees the program and checks what the window produced against the
plain reference (``reference/``); each compared number is printed beside
its limit, as the last lines on standard error and as the last key of the
result line, which is the last line on standard output.

It exits 3 without a result where no CUDA card is seen or fewer than the
cell asks for, and 4 where ``jax``, ``jaxlib``, ``flax`` or ``topiaxl``
has been imported by the time the window closes.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
TRACE_SECONDS = 12.0
FORBIDDEN = ("jax", "jaxlib", "flax", "topiaxl")
REDUCTIONS = {
    "rate": lambda units, window: units / window,
}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell's workload file with its configuration and traffic mix."""
    cell = load_json(root / "workloads" / f"{name}.json")
    return dict(cell, name=name,
                config_data=load_json(root / "configs" / f"{cell['config']}.json"),
                traffic_data=load_json(root / "traffic" / f"{cell['traffic']}.json"))


def load_reader(name: str, root: Path = ROOT):
    """(the reader module of a per-layer metric, its parameters)."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", root / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    params = root / "metrics" / f"{name}.json"
    return mod, (load_json(params) if params.exists() else {})


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end, per-layer) entries of ``BENCHMARK.json`` this cell
    reports: those listing it, those listing no cells, and per-layer ones
    that move an end-to-end metric the cell reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


class Run:
    """What one run has measured, for its driver module to add to and the
    per-layer readers to read."""

    def __init__(self, cell: dict, seed: int, device, traced: bool):
        import torch

        self.cell, self.seed, self.device, self.traced = cell, seed, device, traced
        self.config, self.traffic = cell["config_data"], cell["traffic_data"]
        self.spans: dict = {}      # name -> [seconds]
        self.marks: list = []      # traced runs: (name, start_ns, end_ns)
        self.work: dict = {}       # what one unit of work needs, by its driver
        self.units = 0
        self.window_s = 0.0
        self.trace = None
        self.card = (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu")

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        """A span of the window's host clock, the device synchronised at
        both ends (also kept on the trace's clock in a traced run)."""
        self.sync()
        t0, n0 = time.perf_counter(), time.time_ns()
        yield
        self.sync()
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)
        if self.traced:
            self.marks.append((name, n0, time.time_ns()))


def make_driver(run: Run):
    mod = importlib.import_module(f"portbench.drivers.{run.traffic['driver']}")
    return mod.Driver(run)


def window(run: Run, driver, seconds: float) -> tuple[int, int]:
    """The closed loop: requests back to back until ``seconds`` have gone
    by, each one to its end; (attempted, failed)."""
    import torch

    prof = None
    if run.traced:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        seconds = min(seconds, TRACE_SECONDS)
    attempted = failed = 0
    run.spans, run.marks = {}, []      # set-up's warm requests left out
    t0, n0 = time.perf_counter(), time.time_ns()
    while time.perf_counter() - t0 < seconds:
        attempted += 1
        try:
            run.units += driver.request(attempted - 1)
        except Exception:  # noqa: BLE001 (counted and reported)
            failed += 1
            traceback.print_exc()
            if failed >= 3:
                break
    run.sync()
    run.window_s = time.perf_counter() - t0
    if prof is not None:
        n1 = time.time_ns()
        prof.stop()
        from . import trace as T

        run.trace = T.from_profiler(prof, run.marks, n0, n1)
    return attempted, failed


def imported_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell: dict, seed: int, seconds: float, traced: bool,
             device, bench: dict, setup_start: float = None) -> dict:
    """One run of ``cell``: set-up, window, check; the result line as a
    dict (its ``checks`` last)."""
    import torch

    run = Run(cell, seed, device, traced)
    driver = make_driver(run)
    driver.setup()
    if traced:
        # the profiler's first start initialises CUPTI: do it in set-up
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]):
            run.sync()
    run.sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - (T_START if setup_start is None
                                     else setup_start)
    attempted, failed = window(run, driver, seconds)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    e2e, layer = cell_metrics(bench, cell["name"])
    metrics: dict = {}
    if traced:
        for m in layer:
            reader, params = load_reader(m["name"])
            value = reader.read(run, params)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            if m["name"] == "setup_s":
                value = setup_s
            else:
                kind = cell["end_to_end"][m["name"]]
                value = REDUCTIONS[kind](run.units, run.window_s)
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": run.card, "count": int(cell["chips"]),
           "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced:
        from . import trace as T

        dev["busy_s"] = T.busy_seconds(run.trace)
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = T.breakdown(run.trace)
    driver.finish()
    checks = driver.check()
    ok = failed == 0 and run.units > 0 and all(
        math.isfinite(v) and v <= lim for v, lim in checks.values())
    result["correct"] = bool(ok)
    result["checks"] = {k: {"value": v if math.isfinite(v) else None,
                            "limit": lim} for k, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache at a fixed place inside the checkout; no JAX through any
    # library
    cache = CHECKOUT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    bench = load_json(CHECKOUT / "BENCHMARK.json")
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" seen", file=sys.stderr)
        return 3
    from . import counts

    print(f"portbench: {counts.card_line()}; torch {torch.__version__}",
          file=sys.stderr, flush=True)
    device = torch.device("cuda", 0)
    counts.peaks(torch.cuda.get_device_name(device))
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device, bench)
    bad = imported_forbidden()
    if bad:
        print(f"portbench: imported {bad} by the window's close",
              file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
