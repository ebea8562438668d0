"""Tiny cells for the CPU tests: the published configurations with every
stage cut to one module of one block and narrow branches, small frames,
float32 (a bfloat16 convolution on the CPU may leave channels_last)."""

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SHAPES = [([1], [8]), ([1, 1], [4, 8]), ([1, 1, 1], [4, 8, 16]), ([1, 1, 1, 1], [4, 8, 16, 32])]


def _cut(config: dict) -> dict:
    c = copy.deepcopy(config)
    extra = c["recipe"]["MODEL"]["EXTRA"]
    for i, (blocks, chans) in enumerate(SHAPES):
        extra[f"STAGE{i + 1}"].update(NUM_MODULES=1, NUM_BLOCKS=blocks, NUM_CHANNELS=chans)
    c["recipe"]["TPU"]["DTYPE"] = "float32"
    return c


def config(name: str) -> dict:
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def parts(cell: str) -> dict:
    """The cell's parts at a tiny size, with the cell's own limits."""
    from benchmark import manifest

    p = manifest.parts(BENCH, cell, ROOT)
    p["config"] = _cut(p["config"])
    t = p["traffic"]
    if t["driver"] in ("vae2_train", "vae2_train_ddp"):
        p["config"]["recipe"]["MODEL"]["EXTRA"]["Z_DIM"] = 4
        p["config"]["recipe"]["TRAIN"]["IMAGE_SIZE"] = [64, 48]
        t.update(batch=2, pool=3)
        if "ranks" in t:
            t["ranks"] = 2
            p["cell"] = dict(p["cell"], chips=2)
    elif t["driver"] == "vae2_prior":
        p["config"]["recipe"]["MODEL"]["EXTRA"]["Z_DIM"] = 4
        p["config"]["recipe"]["TRAIN"]["IMAGE_SIZE"] = [64, 48]
        t.update(samples=10, chunk=4, pool=2, checked_samples=5, checked_from=2)
    else:
        t.update(batch=2, crop=[64, 32], coarse=4)
    return p
