"""BENCHMARK.json against the benchmark's contract, and the harness finding
a cell's parts by name."""

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import manifest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/")
    assert BENCH["command"][:3] == ["python3", "-m", "benchmark.run"]


def test_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_every_per_layer_metric_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert m["moves"] in {x["name"] for x in manifest.end_to_end(BENCH, cell)}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_enough(cell):
    names = {m["name"] for m in manifest.end_to_end(BENCH, cell)}
    assert "setup_s" in names and len(names) >= 2
    assert manifest.per_layer(BENCH, cell)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_are_found_by_name(cell):
    parts = manifest.parts(BENCH, cell, ROOT)
    assert parts["config"]["name"] == parts["cell"]["config"]
    assert (ROOT / "benchmark" / "drivers" / f"{parts['traffic']['driver']}.py").exists()
    assert parts["workload"]["counts"]["flops"] > 0
    for m in manifest.end_to_end(BENCH, cell) + manifest.per_layer(BENCH, cell):
        assert callable(manifest.reader(m["name"]).read)


def test_config_files_are_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]


def test_a_cell_added_as_files_is_picked_up(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric, added
    as new files and entries in a copy: found by name, no file edited."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    conf = json.loads((ROOT / BENCH["configs"][0]["file"]).read_text())
    conf["name"] = "vae2_w18sv2_cityscapes_64x128"
    conf["recipe"]["TRAIN"]["IMAGE_SIZE"] = [128, 64]
    (root / "benchmark/configs/vae2_w18sv2_cityscapes_64x128.json").write_text(json.dumps(conf))
    traffic = json.loads((ROOT / "benchmark/traffic/train_b8.json").read_text())
    traffic["batch"] = 4
    (root / "benchmark/traffic/train_b4.json").write_text(json.dumps(traffic))
    (root / "benchmark/workloads/vae2_train_64x128_b4.json").write_text(
        json.dumps({"counts": {"flops": 1.0}, "limits": {}}))
    (root / "benchmark/metrics/steps_seen.train.py").write_text(
        "def read(ctx):\n    return ctx['work']['attempted']\n")
    bench["configs"].append({**BENCH["configs"][0], "name": conf["name"],
                             "file": "benchmark/configs/vae2_w18sv2_cityscapes_64x128.json"})
    bench["workloads"].append({"name": "vae2_train_64x128_b4", "config": conf["name"],
                               "traffic": "train_b4", "chips": 1, "why": "a smaller frame"})
    bench["end_to_end"][0]["workloads"].append("vae2_train_64x128_b4")
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "step",
                               "moves": "train_samples_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    loaded = manifest.load(root)
    parts = manifest.parts(loaded, "vae2_train_64x128_b4", root)
    assert parts["traffic"]["batch"] == 4
    assert parts["config"]["recipe"]["TRAIN"]["IMAGE_SIZE"] == [128, 64]
    layer = {m["name"] for m in manifest.per_layer(loaded, "vae2_train_64x128_b4")}
    assert "steps_seen.train" in layer and "device_idle.train" not in layer
    reader = manifest.reader("steps_seen.train", root / "benchmark")
    assert reader.read({"work": {"attempted": 7}}) == 7
    after = {p: p.read_bytes() for p in before}
    assert after == before
