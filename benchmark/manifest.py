"""Find a cell's parts by name: ``BENCHMARK.json`` at the checkout's root,
and under this folder ``configs/<config>.json``, ``traffic/<traffic>.json``
(whose ``driver`` names ``drivers/<driver>.py``), ``workloads/<cell>.json``
(the cell's counts and the limits of its checks) and ``metrics/<metric>.py``
(one reader per metric). A cell, a configuration, a traffic mix or a metric
is added by adding its files and its entry; no file that exists changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent


def load(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def data(kind: str, name: str, base: Path = HERE) -> dict:
    """``<base>/<kind>/<name>.json``."""
    return json.loads((Path(base) / kind / f"{name}.json").read_text())


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str) -> ModuleType:
    import importlib

    return importlib.import_module(f"benchmark.drivers.{name}")


def reader(metric: str, base: Path = HERE) -> ModuleType:
    path = Path(base) / "metrics" / f"{metric}.py"
    return _module(path, "benchmark.metrics." + metric.replace(".", "_"))


def end_to_end(manifest: dict, cell_name: str) -> List[dict]:
    return [m for m in manifest["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer(manifest: dict, cell_name: str) -> List[dict]:
    moved = {m["name"] for m in end_to_end(manifest, cell_name)}
    return [m for m in manifest["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def parts(manifest: dict, cell_name: str, root: Path) -> Dict[str, dict]:
    """The cell's entry, its configuration (the file that its entry in
    ``configs`` names), its traffic and its workload file."""
    c = cell(manifest, cell_name)
    conf = next(x for x in manifest["configs"] if x["name"] == c["config"])
    base = Path(root) / HERE.name
    return {"cell": c, "config": json.loads((Path(root) / conf["file"]).read_text()),
            "traffic": data("traffic", c["traffic"], base),
            "workload": data("workloads", cell_name, base)}
