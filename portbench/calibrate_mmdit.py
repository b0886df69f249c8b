"""The readings the Hunyuan3D-2 cell's limits are set from, many seeds in
one process (``calibrate_flow.py``'s, for ``drivers/train_mmdit.py``):

    python3 -m portbench.calibrate_mmdit --seeds 11,12,13 \\
        [--variant program|fp8|half_batch] [--workload hunyuan3d_dit.train_bs4]

For each seed it loads that seed's weights into the program built once,
runs the first steps and the window's first, as a run's set-up and window
do, and prints one JSON line of the numbers the cell's check reads,
without limits. ``--variant``: ``program`` (sound runs: the lower
readings), ``fp8`` (the control: the reference with its products in
float8 e4m3 put in the program's place), ``half_batch`` (the fault: half
of each batch left out). The benchmark's runs never run this; it needs
the card as a run does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import run as R


def readings(cell: dict, seeds: list, variant: str, device) -> list:
    from .drivers.train_mmdit import Driver

    run = R.Run(cell, seeds[0], device, traced=False)
    drv = Driver(run, fault=variant if variant == "half_batch" else None)
    t0 = time.perf_counter()
    drv.setup()
    out = []
    for n, seed in enumerate(seeds):
        if n:
            drv.load(seed)
        if variant == "fp8":
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
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate_mmdit")
    ap.add_argument("--workload", default="hunyuan3d_dit.train_bs4")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant", default="program",
                    choices=("program", "fp8", "half_batch"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate_mmdit: no CUDA card", file=sys.stderr)
        return 3
    readings(R.load_cell(args.workload), [int(s) for s in args.seeds.split(",")],
             args.variant, torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
