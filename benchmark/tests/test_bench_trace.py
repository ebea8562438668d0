"""The reduction of a trace to busy time, and the end-to-end metric taken
from a trace of the whole window."""

import pytest

from benchmark import manifest, trace


def test_busy_counts_overlaps_once():
    ns = 1_000_000_000
    ivs = [(0, ns), (ns // 2, 2 * ns), (3 * ns, 4 * ns), (3 * ns, 3 * ns + 10)]
    assert trace.busy_s(ivs) == pytest.approx(3.0)
    assert trace.busy_s([]) == 0


def _ctx(kind="train", window_trace=None, samples=16):
    return {"work": {"kind": kind, "samples": samples, "seconds": 30.0, "attempted": 2},
            "window_trace": window_trace}


def test_device_ms_per_sample_reads_the_window_trace():
    read = manifest.reader("train_device_ms_per_sample").read
    assert read(_ctx(window_trace={"busy_s": 2.4, "launches": 9})) == pytest.approx(150.0)


@pytest.mark.parametrize("ctx", [_ctx(), _ctx(kind="sample", window_trace={"busy_s": 1.0}),
                                 _ctx(window_trace={"busy_s": 0.0, "launches": 0})],
                         ids=["no trace", "not training", "no device activity"])
def test_device_ms_per_sample_finds_nothing(ctx):
    assert manifest.reader("train_device_ms_per_sample").read(ctx) is None
