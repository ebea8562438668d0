"""On the card (marker ``gpu``; skips elsewhere): each cell's harness at a
tiny size, bf16, through the port's CUDA kernels, for a second: the run
ends, reports its metrics and prints its checks. Run with
``python -m pytest benchmark/tests/test_bench_gpu.py -m gpu``."""

import pytest
import torch

from benchmark import manifest
from benchmark import run as runner

from . import tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in tiny.BENCH["workloads"]])
def test_tiny_cell_on_the_card(cell, card):
    parts = tiny.parts(cell)
    parts["config"]["recipe"]["TPU"]["DTYPE"] = "bfloat16"
    result = runner.execute(cell, 7, 1.0, True, device=card, parts=parts)
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    assert set(result["checks"]) == set(parts["workload"]["limits"])


DEVICE_E2E = [w["name"] for w in tiny.BENCH["workloads"]
              if any(m["source"] == "device_trace"
                     for m in manifest.end_to_end(tiny.BENCH, w["name"]))]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", DEVICE_E2E)
def test_device_traced_window_on_the_card(cell, card):
    """A ``--trace 0`` run of a cell with an end-to-end metric from the
    device trace traces its window and reports that metric."""
    parts = tiny.parts(cell)
    parts["config"]["recipe"]["TPU"]["DTYPE"] = "bfloat16"
    result = runner.execute(cell, 7, 1.0, False, device=card, parts=parts)
    names = {m["name"] for m in manifest.end_to_end(tiny.BENCH, cell)}
    assert set(result["metrics"]) == names
    assert all(v["value"] > 0 for v in result["metrics"].values())
