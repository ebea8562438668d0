"""The reduction of a trace to busy time, and the end-to-end metrics taken
from a trace of the whole window: one card's, and several ranks' with the
collectives' own time taken from each rank's NCCL kernels."""

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


MS = 1_000_000


def test_split_at_the_collectives():
    device = [("gemm", 0, 4 * MS), ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 5 * MS, 7 * MS),
              ("elementwise", 3 * MS, 6 * MS), ("ncclDevKernel_AllReduce", 8 * MS, 9 * MS)]
    got = trace.split(device)
    assert got["other_busy_s"] == pytest.approx(6e-3)
    assert got["collective_ns"] == [2 * MS, 1 * MS]


def test_exchange_is_each_collectives_shortest_kernel():
    # rank 1 came last to the first collective, rank 0 to the second
    assert trace.exchange_s([[9 * MS, 1 * MS], [2 * MS, 8 * MS]]) == pytest.approx(3e-3)
    assert trace.exchange_s([[MS], [MS, MS]]) is None  # ranks that disagree
    assert trace.exchange_s([[], []]) is None
    assert trace.exchange_s([[MS], None]) is None


def _ranked(name, parts, samples=64, units=1):
    return {"work": {"kind": "train", "samples": samples, "seconds": 30.0, "attempted": 2},
            "trace": {"units": units}, "peaks": {"bf16_flops": 1e15},
            "workload": {"counts": {"flops": 1e12}}, "ranks": [{name: p} for p in parts]}


def test_ddp_device_ms_per_sample_leaves_out_the_wait():
    read = manifest.reader("ddp_device_ms_per_sample").read
    window = {"busy_s": 9.0, "launches": 9, "other_busy_s": 2.0,
              "collective_ns": [900 * MS, 5 * MS]}
    mine = read(dict(_ctx(window_trace=window), trace=None))
    assert mine == {"other_busy_s": 2.0, "collective_ns": [900 * MS, 5 * MS]}
    other = {"other_busy_s": 2.2, "collective_ns": [100 * MS, 700 * MS]}
    # (2.0 + 2.2 + 2 cards x (100 + 5) ms) over 64 clip triples
    assert read(_ranked("ddp_device_ms_per_sample", [mine, other])) == pytest.approx(
        1e3 * (4.2 + 0.21) / 64)
    assert read(_ranked("ddp_device_ms_per_sample", [mine, None])) is None
    assert read(_ctx(window_trace={"busy_s": 1.0, "launches": 1})) is None  # one card


def test_ddp_step_readers_merge_the_ranks():
    parts = [{"other_busy_s": 1.0, "collective_ns": [3 * MS, 40 * MS]},
             {"other_busy_s": 3.0, "collective_ns": [30 * MS, 4 * MS]}]
    ctx = _ranked("mfu.train_ddp", parts, units=2)
    # 2 steps of 1e12 FLOPs over (the mean 2.0 s + 7 ms), against 1e15 FLOP/s
    assert manifest.reader("mfu.train_ddp").read(ctx) == pytest.approx(
        100 * 2e12 / 2.007 / 1e15)
    ctx = _ranked("nccl_ms.train_ddp", [p["collective_ns"] for p in parts], units=2)
    assert manifest.reader("nccl_ms.train_ddp").read(ctx) == pytest.approx(3.5)
