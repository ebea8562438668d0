"""The FLOP and byte counts that ``mfu.*`` and ``abn_roofline.*`` read:
hand-counted on a tiny net, the cells' stored counts equal to what the
reference gives at their shapes, and none of it read from the program."""

import ast
import json
import sys
from pathlib import Path

import pytest
import torch

from benchmark import counts, manifest
from benchmark.reference import nets

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

TINY = {"MODEL": {"EXTRA": {f"STAGE{i + 1}": s for i, s in enumerate([
    {"NUM_MODULES": 1, "NUM_BRANCHES": 1, "NUM_BLOCKS": [1], "NUM_CHANNELS": [2],
     "BLOCK": "BOTTLENECK"},
    {"NUM_MODULES": 1, "NUM_BRANCHES": 2, "NUM_BLOCKS": [1, 1], "NUM_CHANNELS": [2, 4],
     "BLOCK": "BASIC"},
    {"NUM_MODULES": 1, "NUM_BRANCHES": 3, "NUM_BLOCKS": [1, 1, 1], "NUM_CHANNELS": [2, 4, 8],
     "BLOCK": "BASIC"},
    {"NUM_MODULES": 1, "NUM_BRANCHES": 4, "NUM_BLOCKS": [1, 1, 1, 1],
     "NUM_CHANNELS": [2, 4, 8, 16], "BLOCK": "BASIC"}])}},
        "DATASET": {"NUM_CLASSES": 19}, "TPU": {"DTYPE": "bfloat16"}}


def hand_count(h, w, classes):
    """Forward MACs of the tiny SegNet, convolution by convolution: (in
    channels, out channels, kernel, output h, output w) from the structure
    of HRNet; a step is 3 x 2 x MACs (forward, input and weight grads),
    less the input gradient of the first convolution (images need none)."""
    convs = []
    h2, w2 = h // 2, w // 2
    h4, w4 = h // 4, w // 4
    convs += [(3, 64, 3, h2, w2), (64, 64, 3, h4, w4)]
    # layer1: one bottleneck 64 -> 2 -> 2 -> 8 and its projection
    convs += [(64, 2, 1, h4, w4), (2, 2, 3, h4, w4), (2, 8, 1, h4, w4), (64, 8, 1, h4, w4)]
    res = [(h4, w4), (h4 // 2, w4 // 2), (h4 // 4, w4 // 4), (h4 // 8, w4 // 8)]
    chans = [[2], [2, 4], [2, 4, 8], [2, 4, 8, 16]]
    prev = [8]
    for s in (1, 2, 3):
        cur = chans[s]
        for i, c in enumerate(cur):  # transition
            if i < len(prev):
                if prev[i] != c:
                    convs.append((prev[i], c, 3, *res[i]))
            else:
                convs.append((prev[-1], c, 3, *res[i]))
        for i, c in enumerate(cur):  # one basic block per branch
            convs += [(c, c, 3, *res[i]), (c, c, 3, *res[i])]
        for i in range(len(cur)):  # fuse
            for j in range(len(cur)):
                if j > i:
                    convs.append((cur[j], cur[i], 1, *res[j]))
                for k in range(i - j):
                    out = cur[i] if k == i - j - 1 else cur[j]
                    convs.append((cur[j], out, 3, *res[j + k + 1]))
        prev = cur
    width = sum(chans[3])
    convs += [(width, width, 1, h4, w4), (width, classes, 1, h4, w4)]
    macs = [ci * co * k * k * oh * ow for ci, co, k, oh, ow in convs]
    return 3 * 2 * sum(macs) - 2 * macs[0]


def test_seg_flops_by_hand():
    got = counts.seg_train(TINY, 2, 64, 128)
    assert got["flops"] == 2 * hand_count(64, 128, 19)


def test_abn_bytes_by_hand():
    calls = [(1000, 4), (50, 2)]
    train = counts.abn_work(calls, 2, train=True)
    # forward 4n + 20C, sums 4n + 16C, dx 6n + 20C
    assert train["abn_bytes"] == sum(14 * n + 56 * c for n, c in calls)
    assert train["abn_ops"] == sum(13 * n for n, _ in calls)
    infer = counts.abn_work(calls, 2, train=False)
    assert infer["abn_bytes"] == sum(4 * n + 16 * c for n, c in calls)


def test_identity_bns_of_the_tiny_net():
    with torch.device("meta"):
        net = nets.seg_module(TINY)
    got = counts.seg_train(TINY, 2, 64, 128)
    assert got["abn_calls"] == len(nets.identity_bns(net))


def _cell_counts(cell):
    parts = manifest.parts(BENCH, cell, ROOT)
    drv = manifest.driver(parts["traffic"]["driver"])
    return drv.counts(parts["config"]["recipe"], parts["traffic"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_stored_counts_come_from_the_reference(cell, monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] == "vae2_tpu_torch":
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "vae2_tpu_torch", None)  # any import fails
    stored = json.loads((ROOT / "benchmark" / "workloads" / f"{cell}.json").read_text())
    assert _cell_counts(cell) == stored["counts"]


def test_counts_read_nothing_of_the_program():
    tree = ast.parse((ROOT / "benchmark" / "counts.py").read_text())
    mods = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    mods |= {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    assert not any(m and m.startswith("vae2_tpu") for m in mods)
