"""Read a cell's check numbers over many seeds in one process: the
program's (the lower readings its limits are set from) and the control's
(the float32 reference with TF32 products in the program's place, which
has to come out as not correct: the upper readings).

    python3 -m benchmark.control --workload <name> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--units 1]

Each seed builds the cell as a run does, runs `--units` units of its work
at the cell's own load (the states the check follows), and prints one JSON
line {"seed", "program", "control"}. Runs on the machine it is started on
(an NVIDIA GPU); the benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from .common import cell_files, load_manifest


def readings(workload: str, seeds, control_seeds, units: int = 1,
             device="cuda", files=None):
    """Yield {"seed", "program", "control"} for each seed."""
    from sph_sm_monodomain_tpu_torch.models import scan
    cell, conf, traffic, checks = files or cell_files(load_manifest(),
                                                      workload)
    drv = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    dev = torch.device(device)
    for seed in seeds:
        job = drv.Job(conf, traffic, checks, seed, dev)
        job.setup()
        for _ in range(units):
            job.unit()
        out = {"seed": seed, "program": job.readings(),
               "control": job.control() if seed in control_seeds else None}
        del job
        scan.clear_cache()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        yield out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--units", type=int, default=1)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    seeds = [int(s) for s in a.seeds.split(",")]
    ctrl = {int(s) for s in a.control_seeds.split(",") if s}
    for line in readings(a.workload, seeds, ctrl, a.units):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
