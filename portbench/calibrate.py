"""The readings the check's limits are set from, many seeds in one process:

    python3 -m portbench.calibrate --workload <cell> --seeds 11,12,13 \
        [--variant program|w8a8|fp8|half_batch] [--requests 2]

For each seed it loads that seed's weights into the program built once
(a serving cell's captured chain graph reads them in place), runs
``--requests`` requests, or a training cell's first steps and the
window's first, as a run's window and set-up do, and prints one JSON line
of the numbers the cell's check reads, without limits. ``--variant``:
``program`` (sound runs: the lower readings), ``fp8`` (the control: the
reference with its products in float8 e4m3, put in the program's place),
``w8a8`` (a serving cell's second control: the DiT's products W8A8, the
program's own path), ``half_batch`` (a training cell's fault: half of
each batch left out). The benchmark's runs never run this; it needs the
card as a run does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import run as R


def readings(cell: dict, seeds: list, variant: str, requests: int,
             device) -> list:
    run = R.Run(cell, seeds[0], device, traced=False)
    serving = cell["traffic_data"]["driver"] == "serve_primx"
    if serving:
        from .drivers.serve_primx import Driver

        run.traffic = dict(run.traffic, check_requests=requests)
        drv = Driver(run, variant=variant)
    else:
        from .drivers.train_dit import Driver

        drv = Driver(run, fault=variant if variant == "half_batch" else None)
    t0 = time.perf_counter()
    drv.setup()
    out = []
    for n, seed in enumerate(seeds):
        if n:
            drv.load(seed)
        if serving:
            drv.kept = []
            for i in range(requests):
                drv.request(i)
            r = drv.readings("fp8" if variant == "fp8" else None)
        elif variant == "fp8":
            r = drv.compare(*drv.reference_readings("fp8"),
                            drv.reference_readings("f32"))
        else:
            drv.request(0)
            r = drv.readings()
        line = {"seed": seed, "variant": variant, **r,
                "elapsed_s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant", default="program",
                    choices=("program", "w8a8", "fp8", "half_batch"))
    ap.add_argument("--requests", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 3
    cell = R.load_cell(args.workload)
    readings(cell, [int(s) for s in args.seeds.split(",")], args.variant,
             args.requests, torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
