"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs):

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 ... \
        [--control-seeds ...] [--fault-seeds ...]

For each seed, one JSON line with the numbers the check compares (the
faults' first, then the program's, then the control's):
``program`` (the cell's set-up, the least window, and the check), ``control`` (the reference in float8, put
in the program's place, against the reference in float32) and, for each
of ``--faults`` (``half_batch`` unless named), the program with that fault
planted: ``half_batch`` (the program on half of each batch, the mean over
the rest) or, in a cell of several ranks, a fault of the program's
collectives (``drivers/vae2_train_ddp.PROGRAM_FAULTS``). A cell of several
cards runs as that many ranks, as the benchmark runs it; each number is
then the worst over the ranks (``worst_leaves``: rank 0's).
Needs the card, as the benchmark does."""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import compare, manifest, run as runner


def control(cell_parts, seed: int, device, group=None) -> dict:
    run = runner.Run(cell_parts, seed, device, group=group)
    return manifest.driver(run.traffic["driver"]).control(run)


def program(cell_parts, seed: int, device, fault: str = "", group=None) -> dict:
    """A sound run's numbers (or a faulty one's): the set-up, a window of
    the least work the check reads, the check."""
    run = runner.Run(cell_parts, seed, device, fault, group)
    drv = manifest.driver(run.traffic["driver"])
    st = drv.setup(run)
    drv.window(st, 0.0)
    numbers = drv.check(st)
    if "prog" in st and "ref" in st:
        numbers["worst_leaves"] = compare.worst_leaves(st["prog"], st["ref"])
        numbers["loss_gaps_by_step"] = [compare.loss_gap([p], [r]) for p, r in
                                        zip(st["prog"]["losses"], st["ref"]["losses"])]
        if "stats" in st["prog"]:
            gaps = compare.stats_gaps(st["prog"]["stats"], st["ref"]["stats"])
            numbers["worst_leaves"]["stats"] = sorted(gaps.items(), key=lambda kv: -kv[1])[:5]
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=["half_batch"])
    ap.add_argument("--out", help="a file that each reading's line is also appended to, "
                    "as it comes (a cell of several cards prints only at the end)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)  # a rank's spec (ranks.py)
    args = ap.parse_args(argv)
    chips = int(manifest.cell(manifest.load(runner.ROOT), args.workload).get("chips", 1))
    if args.worker:
        from . import ranks

        runner.set_caches(runner.ROOT)
        spec = json.loads(args.worker)
        _, _, dev, group = ranks.join(spec)
        jobs(args, dev, group, spec.get("parts"))
        ranks.leave()
        return 0
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("calibrate: needs the cell's CUDA cards", file=sys.stderr)
        return 2
    if chips > 1:
        from . import ranks

        return ranks.launch("benchmark.calibrate", sys.argv[1:] if argv is None else argv,
                            chips, {"started": time.time()}, deadline=3 * 3600)
    runner.set_caches(runner.ROOT)
    jobs(args, torch.device("cuda", 0))
    return 0


def jobs(args, dev, group=None, parts: dict = None) -> None:
    """Run every asked-for reading in turn and print each (rank 0 alone in
    a run of several ranks, with each number the worst over the ranks).
    ``parts``: for a rehearsal of a tiny cell on the CPU."""
    parts = parts or manifest.parts(manifest.load(runner.ROOT), args.workload, runner.ROOT)
    todo = ([(f, s) for f in args.faults for s in args.fault_seeds]
            + [("program", s) for s in args.seeds] + [("control", s) for s in args.control_seeds])
    for kind, seed in todo:
        t0 = time.perf_counter()
        if kind == "control":
            numbers = control(parts, seed, dev, group)
        else:
            numbers = program(parts, seed, dev, "" if kind == "program" else kind, group)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if group is not None:
            numbers = worst(numbers, group)
            if numbers is None:
                continue
        line = json.dumps({"workload": args.workload, "kind": kind, "seed": seed,
                           "numbers": numbers, "s": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


def worst(numbers: dict, group):
    """On rank 0, each number the worst over the ranks (``worst_leaves``
    and other readings that are no number: rank 0's); None elsewhere."""
    from . import ranks

    every = ranks.gather(numbers, group)
    if ranks.rank_of(group) != 0:
        return None
    return {k: (max((r[k] for r in every), key=runner._worst)
                if isinstance(v, (int, float)) else v) for k, v in numbers.items()}


if __name__ == "__main__":
    sys.exit(main())
