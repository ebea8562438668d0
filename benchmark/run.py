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

It exits 2 without a result when there is no CUDA card or too few, and 3
when JAX or the JAX package is loaded once the window has closed.
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
    """What a driver is handed: the cell's parts, the seed and the device."""

    def __init__(self, parts: dict, seed: int, device, fault: str = ""):
        self.cell, self.config = parts["cell"], parts["config"]
        self.traffic, self.workload = parts["traffic"], parts["workload"]
        self.seed, self.device, self.fault = seed, device, fault

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
    with profile(activities=acts) as prof:
        for _ in range(int(run.traffic.get("traced_units", 1))):
            with torch.profiler.record_function(drv.UNIT):
                drv.traced_unit(state)
                run.sync()
    return trace.reduce(prof, drv.UNIT)


def profile_window(run: Run, drv, state, seconds: float):
    """The measured window under a trace of device activity alone (no host
    events: the host's dispatch slows less), reduced over all its work."""
    from torch.profiler import ProfilerActivity, profile

    from . import trace

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        work = drv.window(state, seconds)
        t0 = time.perf_counter()
    busy = trace.device_busy(prof)
    busy["reduce_s"] = time.perf_counter() - t0
    return work, busy


def execute(cell_name: str, seed: int, seconds: float, traced: bool,
            root: Path = ROOT, device=None, parts: dict = None) -> dict:
    """One run of a cell; returns the result (``info`` apart). ``device``
    and ``parts`` are for tests that drive a tiny cell on the CPU."""
    import torch

    from . import manifest, peaks

    bench = manifest.load(root)
    if parts is None:
        parts = manifest.parts(bench, cell_name, root)
    if device is None:
        device = torch.device("cuda", 0)
    run = Run(parts, seed, device)
    drv = manifest.driver(run.traffic["driver"])
    state = drv.setup(run)
    run.sync()
    setup_s = time.perf_counter() - T0
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
    metrics = {}
    for m in wanted:
        value = manifest.reader(m["name"], root / manifest.HERE.name).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
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
                       "window_trace": window_trace}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from . import manifest

    chips = int(manifest.cell(manifest.load(ROOT), args.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    set_caches(ROOT)
    power = card_power()
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
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


if __name__ == "__main__":
    sys.exit(main())
