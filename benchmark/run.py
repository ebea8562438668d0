"""The benchmark's one command:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. It finds the cell's parts by name (``manifest.py``), lets the cell's
driver build ``vae2_tpu_torch``'s entry point, make the inputs from the
seed and run the first units (the warm-up, whose readings the check
keeps), measures for ``--seconds`` (with ``--trace 0``, under a trace of
device activity alone where the cell reports an end-to-end metric from the
device trace), with ``--trace 1`` profiles a few more units, then checks against the plain reference and prints one JSON line:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks`` (each number compared,
beside its limit; also the last lines on standard error). An earlier line
(``info``) holds the card's power limit and the units' times.

A cell of ``chips`` > 1 runs as that many ranks, one process a card
(``ranks.py``): every rank runs the cell on its card, the driver keeps
them to the same steps, and rank 0 prints the one line for all of them
(:func:`merge`). A cell of one card runs in the calling process.

It exits 2 without a result when there is no CUDA card or too few, and 3
when JAX or the JAX package is loaded once the window has closed (in any
rank); non-zero, without a result, when a rank fails.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vae2_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``vae2_tpu_torch`` is not ``vae2_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_caches(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own kernels build into ``build/vae2_tpu_torch/`` there)."""
    cache = root / "build" / "bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)


def card_power() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


class Run:
    """What a driver is handed: the cell's parts, the seed and the device;
    in a run of several ranks, ``group``, their gloo side group on the host
    (None in a run of one process)."""

    def __init__(self, parts: dict, seed: int, device, fault: str = "", group=None):
        self.cell, self.config = parts["cell"], parts["config"]
        self.traffic, self.workload = parts["traffic"], parts["workload"]
        self.seed, self.device, self.fault, self.group = seed, device, fault, group

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def profile_units(run: Run, drv, state) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import trace

    acts = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    before = program_counters()
    with profile(activities=acts) as prof:
        for _ in range(int(run.traffic.get("traced_units", 1))):
            with torch.profiler.record_function(drv.UNIT):
                drv.traced_unit(state)
                run.sync()
    after = program_counters()
    red = trace.reduce(prof, drv.UNIT, collectives=run.group is not None)
    if red:
        red["counters"] = {k: v - before.get(k, 0) for k, v in after.items()}
    return red


def program_counters() -> dict:
    """The program's counters as they stand (``spans.counters()``); empty
    where it keeps none."""
    try:
        from vae2_tpu_torch.utils import spans
    except ImportError:
        return {}
    return spans.counters()


def profile_window(run: Run, drv, state, seconds: float):
    """The measured window under a trace of device activity alone (no host
    events: the host's dispatch slows less), reduced over all its work."""
    from torch.profiler import ProfilerActivity, profile

    from . import trace

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        work = drv.window(state, seconds)
        t0 = time.perf_counter()
    busy = trace.device_busy(prof, collectives=run.group is not None)
    busy["reduce_s"] = time.perf_counter() - t0
    return work, busy


def execute(cell_name: str, seed: int, seconds: float, traced: bool,
            root: Path = ROOT, device=None, parts: dict = None, fault: str = "",
            group=None, started: float = None) -> dict:
    """One run of a cell; returns the result (``info`` apart). ``device``
    and ``parts`` are for tests that drive a tiny cell on the CPU. In a run
    of several ranks every rank calls it with ``group`` (the ranks' gloo
    side group) and ``started`` (the launcher's start on the wall clock,
    from which set-up counts); rank 0 gets the result of all of them
    (:func:`merge`), the other ranks None."""
    import torch

    from . import manifest, peaks

    bench = manifest.load(root)
    if parts is None:
        parts = manifest.parts(bench, cell_name, root)
    if device is None:
        device = torch.device("cuda", 0)
    run = Run(parts, seed, device, fault, group)
    drv = manifest.driver(run.traffic["driver"])
    state = drv.setup(run)
    run.sync()
    setup_s = time.perf_counter() - T0 if started is None else time.time() - started
    device_e2e = any(m["source"] == "device_trace"
                     for m in manifest.end_to_end(bench, cell_name))
    if device_e2e and not traced and device.type == "cuda":
        work, window_trace = profile_window(run, drv, state, seconds)
    else:
        work, window_trace = drv.window(state, seconds), None
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
    red = profile_units(run, drv, state) if traced else None
    readings = drv.check(state)
    del state
    gc.collect()
    limits = run.workload.get("limits", {})
    numbers = {k: readings.get(k, math.inf) for k in limits} if limits else readings
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    correct = (work["failed"] == 0 and bool(limits)
               and all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items()))
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    ctx = {"setup_s": setup_s, "work": work, "trace": red, "window_trace": window_trace,
           "config": run.config,
           "traffic": run.traffic, "workload": run.workload,
           "peaks": peaks.of(kind), "kind": kind}
    wanted = (manifest.per_layer(bench, cell_name) if traced
              else manifest.end_to_end(bench, cell_name))
    metrics = read_metrics(wanted, ctx, root)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": kind,
           "count": int(run.cell.get("chips", 1)), "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": work["attempted"],
              "failed": work["failed"], "metrics": metrics, "device": dev}
    if red:
        dev["busy_s"], dev["window_s"] = red["busy_s"], red["window_s"]
        result["breakdown"] = {"device_ops": red["device_ops"],
                               "idle_gaps": red["idle_gaps"]}
    result["checks"] = checks
    result["_info"] = {"unit_s": work.get("unit_s", []), "units": work["attempted"],
                       "window_s": work["seconds"], "setup_s": setup_s,
                       "window_trace": window_trace and {
                           k: v for k, v in window_trace.items() if k != "collective_ns"}}
    return result if group is None else merge(result, ctx, wanted, root, group)


def read_metrics(wanted, ctx: dict, root: Path) -> dict:
    """Each wanted metric that its reader finds, with its unit."""
    from . import manifest

    metrics = {}
    for m in wanted:
        value = manifest.reader(m["name"], root / manifest.HERE.name).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def merge(result: dict, ctx: dict, wanted, root: Path, group):
    """On rank 0, the result of every rank of the run (None on the others):
    units attempted and failed summed; the peak memory of the fullest card;
    each checked number the worst over ranks, and ``correct`` only where
    every rank's is; the traced busy and window seconds averaged over the
    cards; the metrics read again on rank 0, with ``ctx['ranks']`` holding
    each rank's own readings (a reader that takes, say, the slowest rank's
    reads them there). ``_forbidden``: the JAX modules any rank loaded."""
    from . import ranks

    dev = result["device"]
    mine = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "peak": dev["memory_peak_bytes"],
            "busy": [dev.get("busy_s"), dev.get("window_s")],
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "numbers": {k: c["value"] for k, c in result["checks"].items()},
            "forbidden": forbidden_modules()}
    every = ranks.gather(mine, group)
    if ranks.rank_of(group) != 0:
        return None
    ctx["ranks"] = [r["metrics"] for r in every]
    dev["memory_peak_bytes"] = max(r["peak"] for r in every)
    if "busy_s" in dev:
        dev["busy_s"] = sum(r["busy"][0] for r in every) / len(every)
        dev["window_s"] = sum(r["busy"][1] for r in every) / len(every)
    out = {"correct": all(r["correct"] for r in every),
           "attempted": sum(r["attempted"] for r in every),
           "failed": sum(r["failed"] for r in every),
           "metrics": read_metrics(wanted, ctx, root), "device": dev}
    if "breakdown" in result:
        out["breakdown"] = result["breakdown"]
    out["checks"] = {k: {"value": max((r["numbers"][k] for r in every), key=_worst),
                         "limit": c["limit"]} for k, c in result["checks"].items()}
    out["_info"] = dict(result["_info"], ranks_attempted=[r["attempted"] for r in every])
    out["_forbidden"] = sorted(set().union(*(r["forbidden"] for r in every)))
    return out


def _worst(value: float) -> float:
    return value if math.isfinite(value) else math.inf


def report(args, result: dict, power: str, found) -> int:
    """Print the run's ``info`` line, its result line and its check lines;
    3, and nothing printed, where JAX or the JAX package was ``found``."""
    if found:
        from .ranks import GUARD_RC

        print(f"benchmark: loaded after the window: {', '.join(found)}", file=sys.stderr)
        return GUARD_RC
    info = result.pop("_info")
    units = sorted(info["unit_s"])
    info.update({"card": power, "workload": args.workload, "seed": args.seed,
                 "unit_s_median": units[len(units) // 2] if units else None,
                 "unit_s_max": units[-1] if units else None})
    info.pop("unit_s")
    print(json.dumps({"info": info}))
    print(json.dumps(result), flush=True)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


def run_rank(args, spec: dict) -> int:
    """One rank of a cell of several cards (started by :func:`main`)."""
    from . import ranks

    set_caches(ROOT)
    rank, _, device, group = ranks.join(spec)
    power = card_power() if rank == 0 else ""
    try:
        result = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                         device=device, parts=spec.get("parts"), fault=spec.get("fault", ""),
                         group=group, started=spec["started"])
    except Exception:
        # leave at once, without the process group's teardown, which may
        # wait for the other ranks: the launcher ends them on this exit
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    ranks.leave()
    return 0 if result is None else report(args, result, power, result.pop("_forbidden"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--worker", help=argparse.SUPPRESS)  # a rank's spec (ranks.py)
    args = ap.parse_args(argv)
    if args.worker:
        return run_rank(args, json.loads(args.worker))

    import torch

    from . import manifest

    chips = int(manifest.cell(manifest.load(ROOT), args.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if chips > 1:
        from . import ranks

        argv = ["--workload", args.workload, "--seed", str(args.seed),
                "--seconds", repr(args.seconds), "--trace", str(args.trace)]
        return ranks.launch("benchmark.run", argv, chips,
                            {"started": time.time() - (time.perf_counter() - T0)})
    set_caches(ROOT)
    power = card_power()
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    return report(args, result, power, forbidden_modules())


if __name__ == "__main__":
    sys.exit(main())
