"""The readers of the program's step records (``step_host_ms.*``,
``gc_pause_ms.*``): a traced tiny training cell on the CPU reports them,
finite, from the window's steps; they give None where the program keeps no
such records (a checkout without ``vae2_tpu_torch.utils.spans``) or too few
of them."""

import math
import sys

import pytest
import torch
import vae2_tpu_torch.utils

from benchmark import manifest
from benchmark import run as runner

from . import tiny

CPU = torch.device("cpu")
READERS = {"vae2_train_b8": ("step_host_ms.train_device", "gc_pause_ms.train_device"),
           "seg_w48_train_b3": ("step_host_ms.train", "gc_pause_ms.train")}


@pytest.mark.parametrize("cell", sorted(READERS))
def test_a_traced_cell_reads_the_window_steps(cell):
    from vae2_tpu_torch.utils import spans

    mark = spans.recorded()
    result = runner.execute(cell, 2**31 + 77, 0.5, True, device=CPU, parts=tiny.parts(cell))
    held = spans.steps(mark)
    n = result["attempted"]
    # set-up's checked steps, the window's, then the profiled units
    assert [r["profiled"] for r in held] == [False] * (3 + n) + [True] * (len(held) - 3 - n)
    host_ms, gc_ms = (result["metrics"][m]["value"] for m in READERS[cell])
    window = held[3:3 + n]
    assert sorted(r["host_s"] for r in window)[0] <= host_ms / 1e3 <= max(
        r["host_s"] for r in window)
    assert math.isfinite(gc_ms) and gc_ms >= 0
    assert [result["metrics"][m]["unit"] for m in READERS[cell]] == ["ms", "ms"]


def _ctx(attempted):
    return {"work": {"kind": "train", "attempted": attempted, "samples": 2 * attempted,
                     "seconds": 1.0}}


@pytest.mark.parametrize("name", sorted(sum(READERS.values(), ())))
def test_no_records_read_as_nothing(name, monkeypatch):
    read = manifest.reader(name).read
    assert read(_ctx(10**6)) is None  # more steps than the ring holds
    monkeypatch.delattr(vae2_tpu_torch.utils, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "vae2_tpu_torch.utils.spans", None)
    assert read(_ctx(1)) is None
