"""The readings that the correctness limits are set from: for a cell, the
compared numbers of the program on each seed, or of the cell's control (its
file's ``control``: the program's own path one precision below the
configuration's), all in one process.

    python3 benchmark/tools/calibrate.py --workload <name> --seeds 1,2,3 [--control | --fault F] [--out FILE]

Each seed makes the weights and the pool anew, answers as many of the
pool's batches as a run checks, frees the program and runs the check. One
JSON line a seed on standard output (and appended to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

from benchmark.harness import spec  # noqa: E402
from benchmark.run import run_cell  # noqa: E402
from benchmark.tests.faults import train_faults  # noqa: E402


def readings(workload, seeds, control=False, device="cuda", fault=None):
    """One dict a seed: the compared numbers of the program, of its control,
    or (a training cell) of the program with ``fault`` of
    ``tests/faults.py`` planted."""
    cell = spec.load_cell(workload)
    overrides = cell.options["control"] if control else None
    patch = train_faults()[fault] if fault else None
    opts = cell.options["driver_options"]
    calls = min(cell.traffic["pool"], opts["checked_batches"]) if "pool" in cell.traffic else 1
    for seed in seeds:
        t = time.perf_counter()
        result, _ = run_cell(cell, seed, 0.0, device=device, t0=t, overrides=overrides,
                             calls=calls, patch=patch)
        yield {"workload": workload, "seed": seed, "control": bool(control), "fault": fault,
               "overrides": overrides, "correct": result["correct"],
               "checks": {k: c["value"] for k, c in result["checks"].items()},
               "info": result["info"], "seconds": time.perf_counter() - t,
               "card": torch.cuda.get_device_name(0) if device != "cpu" else "cpu"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=("half", "altered"))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    for line in readings(args.workload, [int(s) for s in args.seeds.split(",")], args.control,
                         fault=args.fault):
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")


if __name__ == "__main__":
    main()
