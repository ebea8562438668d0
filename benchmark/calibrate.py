"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs):

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 ... \
        [--control-seeds ...] [--fault-seeds ...]

For each seed, one JSON line with the numbers the check compares:
``program`` (the cell's set-up, the least window, and the check), ``control`` (the reference in float8, put
in the program's place, against the reference in float32) and
``half_batch`` (the program on half of each batch, the mean over the rest).
Needs the card, as the benchmark does."""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import compare, manifest, run as runner


def control(cell_parts, seed: int, device) -> dict:
    run = runner.Run(cell_parts, seed, device)
    return manifest.driver(run.traffic["driver"]).control(run)


def program(cell_parts, seed: int, device, fault: str = "") -> dict:
    """A sound run's numbers (or a faulty one's): the set-up, a window of
    the least work the check reads, the check."""
    run = runner.Run(cell_parts, seed, device, fault)
    drv = manifest.driver(run.traffic["driver"])
    st = drv.setup(run)
    drv.window(st, 0.0)
    numbers = drv.check(st)
    if "prog" in st and "ref" in st:
        numbers["worst_leaves"] = compare.worst_leaves(st["prog"], st["ref"])
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    runner.set_caches(runner.ROOT)
    parts = manifest.parts(manifest.load(runner.ROOT), args.workload, runner.ROOT)
    dev = torch.device("cuda", 0)
    jobs = ([("program", s) for s in args.seeds] + [("control", s) for s in args.control_seeds]
            + [("half_batch", s) for s in args.fault_seeds])
    for kind, seed in jobs:
        t0 = time.perf_counter()
        if kind == "control":
            numbers = control(parts, seed, dev)
        else:
            numbers = program(parts, seed, dev, "" if kind == "program" else kind)
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "kind": kind, "seed": seed,
                          "numbers": numbers, "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
