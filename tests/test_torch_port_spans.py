"""The program's spans and counters (``vae2_tpu_torch/utils/spans.py``) on
the CPU: no ``record_function`` is built without a profiler; under one, a
tiny VAE² train step (REMAT 'stage') shows its G and D phases nested in
``vae2.train_step`` and each checkpointed region twice; a collection shows
as ``py.gc.gen<g>`` inside the span that triggered it; each step appends
one record; ``counters()`` moves as the existing counters do; and the
profiler changes no bit of the step."""

import copy
import gc
import math
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vae2_tpu_torch.config import get_default_config
from vae2_tpu_torch.core.builder import build_system
from vae2_tpu_torch.ops import abn
from vae2_tpu_torch.utils import spans

TINY_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "experiments", "cityscapes", "debug_tiny_32x64.yaml")
PHASES = ("vae2.g_forward", "vae2.g_backward", "vae2.g_update",
          "vae2.d_forward", "vae2.d_backward", "vae2.d_update")
LAUNCHES = {"abn.fwd.launches": abn.abn_rows,
            "abn.bwd_sums.launches": abn.abn_bwd_sums,
            "abn.bwd_dx.launches": abn.abn_bwd_dx}


def _ranges(prof):
    """The trace's ``record_function`` ranges: (name, start, end, thread)."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]


def _inside(ranges, name, outer):
    return [r for r in ranges if r[0] == name and r[3] == outer[3]
            and outer[1] <= r[1] and r[2] <= outer[2]]


class _Counting:
    """``torch.profiler.record_function``, counting what is built."""

    def __init__(self, real):
        self.real, self.built = real, 0

    def __call__(self, name):
        self.built += 1
        return self.real(name)


@pytest.fixture(scope="module")
def two_steps():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny ops: threads cost more than they give
    try:
        return _two_steps()
    finally:
        torch.set_num_threads(threads)


def _two_steps():
    """One tiny step with no profiler, then the same step of a copy of the
    same system under a CPU profiler; every kernel call routed to its plain
    version with the CUDA branch's launch count."""
    cfg = get_default_config()
    cfg.merge_from_file(TINY_CFG)
    cfg.GPU.DTYPE = "float32"
    cfg.TRAIN.OPTIMIZER = "sgd"
    cfg.TRAIN.LR = 0.01
    cfg.TPU.REMAT = "stage"
    off = build_system(cfg, seed=0, train=True)
    on = copy.deepcopy(off)
    rng = np.random.RandomState(22)
    batch = {k: torch.from_numpy(rng.randint(0, 256, (1, 16, 32, 9), dtype=np.uint8))
             for k in ("xt", "x2t", "x3t")}
    counters = {"abn_rows": abn.abn_rows, "fused_abn_infer": abn.abn_rows,
                "abn_fwd_train": abn.abn_rows, "abn_bwd_sums": abn.abn_bwd_sums,
                "abn_bwd_dx": abn.abn_bwd_dx}

    def dispatch(name, x, cuda_fn, plain_fn, *args):
        counters[name].launches += 1
        return plain_fn(*args)

    out = {"mark": spans.recorded(), "launches": [], "viewed": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(abn, "_dispatch", dispatch)
        counting = _Counting(torch.profiler.record_function)
        mp.setattr(torch.profiler, "record_function", counting)
        for system, traced in ((off, False), (on, True)):
            before = {k: c.launches for k, c in LAUNCHES.items()}
            viewed = spans.counters()
            if traced:
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    metrics, _ = system.train_step(batch, torch.Generator().manual_seed(5))
                out.update(prof=prof, metrics_on=metrics)
            else:
                metrics, _ = system.train_step(batch, torch.Generator().manual_seed(5))
                out.update(built_off=counting.built, metrics_off=metrics)
            out["launches"].append({k: c.launches - before[k] for k, c in LAUNCHES.items()})
            now = spans.counters()
            out["viewed"].append({k: now[k] - v for k, v in viewed.items()})
    out.update(off=off, on=on, records=spans.steps(out["mark"]))
    return out


def test_no_record_function_without_a_profiler(two_steps):
    assert not torch.autograd._profiler_enabled()
    assert spans.span("abn.batch_stats") is spans.span("hrnet.remat")
    assert two_steps["built_off"] == 0


def test_phases_nest_under_the_train_step(two_steps):
    ranges = _ranges(two_steps["prof"])
    steps = [r for r in ranges if r[0] == "vae2.train_step"]
    assert len(steps) == 1
    for name in PHASES:
        assert len(_inside(ranges, name, steps[0])) == 1, name
    g_fwd, g_bwd = (_inside(ranges, n, steps[0])[0]
                    for n in ("vae2.g_forward", "vae2.g_backward"))
    # each checkpointed region runs once in the forward and once again as
    # its recompute in the backward, its BNs' statistics with it
    remat = len(_inside(ranges, "hrnet.remat", g_fwd))
    assert remat > 0 and len(_inside(ranges, "hrnet.remat", g_bwd)) == remat
    assert _inside(ranges, "abn.batch_stats", g_bwd)


def test_a_collection_sits_in_the_span_that_made_it():
    before = spans.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("outer"):
            gc.collect()
    gc.collect()  # and with no profiler: counted all the same
    after = spans.counters()
    ranges = _ranges(prof)
    outer = [r for r in ranges if r[0] == "outer"]
    assert len(outer) == 1 and len(_inside(ranges, "py.gc.gen2", outer[0])) == 1
    # the profiler's start or stop may collect too
    assert after["gc.collections.gen2"] - before["gc.collections.gen2"] >= 2
    assert after["gc.pause_s"] > before["gc.pause_s"]


def test_each_step_appends_its_record(two_steps):
    recs = two_steps["records"]
    assert [r["name"] for r in recs] == ["vae2.train_step"] * 2
    assert [r["profiled"] for r in recs] == [False, True]
    assert all(r["host_s"] > 0 and 0 <= r["gc_pause_s"] < r["host_s"] for r in recs)
    for viewed, launched in zip(two_steps["viewed"], two_steps["launches"]):
        assert {k: viewed[k] for k in LAUNCHES} == launched
        assert launched["abn.fwd.launches"] > launched["abn.bwd_sums.launches"] > 0
        assert viewed["sync.all_reduces"] == 0 and viewed["abn.dz_copies"] >= 0
    host_ms, gc_ms = spans.step_costs_ms(two_steps["mark"])
    assert host_ms == pytest.approx(500 * sum(r["host_s"] for r in recs))
    assert gc_ms >= 0
    assert all(map(math.isnan, spans.step_costs_ms(spans.recorded())))  # no step since


def test_the_profiler_changes_no_bit_of_the_step(two_steps):
    off, on = two_steps["metrics_off"], two_steps["metrics_on"]
    assert set(off) == set(on) and all(torch.equal(off[k], on[k]) for k in off)
    a, b = two_steps["off"].modules.state_dict(), two_steps["on"].modules.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_waited_yields_every_item_in_data_wait():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = list(spans.waited(iter([3, 1, 2])))
    assert got == [3, 1, 2]
    assert [r[0] for r in _ranges(prof)].count("loop.data_wait") == 4  # and the end
