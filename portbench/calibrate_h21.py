"""The readings the Hunyuan3D-2.1 cell's limits are set from, many seeds in
one process (``calibrate_mmdit.py``'s, for ``drivers/train_h21.py``):

    python3 -m portbench.calibrate_h21 --seeds 11,12,13 \\
        [--variant program|fp8|half_batch|renorm_topk|no_aux] \\
        [--workload hunyuan3d21_dit.train_bs2]

For each seed it builds the program from that seed, runs the first steps
and the window's first, as a run's set-up and window do, frees it, and
prints one JSON line of the numbers the cell's check reads, without
limits. ``--variant``: ``program`` (sound runs: the lower
readings), ``fp8`` (the control: the reference with its products in
float8 e4m3 put in the program's place), ``half_batch`` (a fault: half of
each batch left out), ``renorm_topk`` and ``no_aux`` (routing faults in
the program: each token's top-2 weights divided by their sum; the
auxiliary loss's gradient dropped). The benchmark's runs never run this;
it needs the card as a run does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import run as R

VARIANTS = ("program", "fp8", "half_batch", "renorm_topk", "no_aux")


def readings(cell: dict, seeds: list, variant: str, device) -> list:
    """One line a seed. Each seed gets a program of its own, freed before
    the reference runs: the two do not fit on one card together."""
    from .drivers.train_h21 import Driver

    t0 = time.perf_counter()
    out = []
    for seed in seeds:
        drv = Driver(R.Run(cell, seed, device, traced=False),
                     fault=None if variant in ("program", "fp8") else variant)
        drv.setup()
        if variant == "fp8":
            drv.finish()
            r = drv.compare(*drv.reference_readings("fp8"),
                            drv.reference_readings("f32"))
        else:
            drv.request(0)
            drv.finish()
            r = drv.readings()
        del drv
        line = {"seed": seed, "variant": variant, **r,
                "elapsed_s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate_h21")
    ap.add_argument("--workload", default="hunyuan3d21_dit.train_bs2")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant", default="program", choices=VARIANTS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate_h21: no CUDA card", file=sys.stderr)
        return 3
    readings(R.load_cell(args.workload), [int(s) for s in args.seeds.split(",")],
             args.variant, torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
