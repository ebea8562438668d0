"""A cell of several cards, rehearsed with gloo ranks on the CPU at a tiny
size: the plain data-parallel reference against one process at the global
batch; the launcher's run of a two-rank cell to one result line; a rank
that fails or hangs ending the whole run, with no process left; a planted
fault of the program's collectives failing the check; the JAX guard's
exit code from a rank other than the one that prints."""

import json
import os
import time
from pathlib import Path

import pytest
import torch
import torch.multiprocessing as mp

from benchmark import compare, inputs, ranks, run as runner, weights
from benchmark.drivers import vae2_train, vae2_train_ddp
from benchmark.reference import nets

from . import tiny

CELL = "vae2_train_ddp4_b8"
SEED = 2**31 + 4242


def _dp_rank(rank, world, port, out):
    import torch.distributed as dist

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        run = runner.Run(tiny.parts(CELL), SEED, torch.device("cpu"))
        recipe = run.config["recipe"]
        state0 = weights.make_state(weights.skeleton(lambda: nets.vae2_modules(recipe)),
                                    inputs.sub_seed(SEED, 1), run.device)
        got = vae2_train_ddp.reference_readings(run, recipe, state0,
                                                vae2_train_ddp._pool(run, recipe), 2)
        torch.save(got, Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_dp_reference_is_one_process_at_the_global_batch(tmp_path):
    mp.start_processes(_dp_rank, args=(2, ranks.free_port(), str(tmp_path)), nprocs=2,
                       start_method="spawn")
    parts = tiny.parts(CELL)
    t = parts["traffic"]
    run = runner.Run(parts, SEED, torch.device("cpu"))
    recipe = run.config["recipe"]
    state0 = weights.make_state(weights.skeleton(lambda: nets.vae2_modules(recipe)),
                                inputs.sub_seed(SEED, 1), run.device)
    whole = runner.Run(dict(parts, traffic=dict(t, batch=t["batch"] * t["ranks"])), SEED,
                       run.device)
    pool = vae2_train._pool(whole, recipe)
    one = vae2_train.reference_readings(whole, recipe, state0, pool, 2)
    # the running statistics: dp.py's SyncBN in one process, where it is a
    # plain BN that tracks them (nets.BN keeps none in train mode)
    one_stats = vae2_train_ddp.reference_readings(whole, recipe, state0, pool, 2)["stats"]
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    # each rank's loss is a sum over its rows over its batch: their mean is
    # the global batch's; f32 sums of the same terms in another order
    for step, want in enumerate(one["losses"]):
        for k, v in want.items():
            mean = sum(g["losses"][step][k] for g in got) / 2
            assert abs(mean - v) <= 1e-5 * abs(v), (step, k, mean, v)
    # gradients and the change, on each rank: one process's to the f32
    # rounding of statistics and gradients summed in another order (the
    # median leaf read 1.8e-5); the worst leaf is an identity BN's scale,
    # whose gradient is a small difference of large terms (up to ~1%, as in
    # test_bench_reference_cpu); Adam's first steps move each element by
    # about lr times the sign of its gradient, so an element whose gradient
    # is near 0 turns rounding into a whole step (the median leaf's change
    # read 9.4e-4 after two steps)
    for g in got:
        numbers = compare.train_numbers({"losses": one["losses"], "grad": g["grad"],
                                         "update": g["update"]}, one)
        assert numbers["grad_gap_median"] < 1e-4 and numbers["grad_gap"] < 0.05, numbers
        assert numbers["update_gap_median"] < 1e-2, numbers
        # the running statistics: the global batch's, to the rounding of
        # the summed statistics and, in the second step, of weights that
        # Adam moved by rounding as above (the median leaf read 9.6e-6, the
        # worst 1.9e-4; a planted local_stats reads 1.2e-2 and 0.27)
        stats = compare.stats_numbers(g["stats"], one_stats)
        assert stats["stats_gap_median"] < 1e-4 and stats["stats_gap"] < 2e-3, stats


def launch(capsys, fault="", seconds=1.0, trace=0, **spec):
    argv = ["--workload", CELL, "--seed", str(SEED), "--seconds", str(seconds),
            "--trace", str(trace)]
    marker = f"bench-test-{os.getpid()}-{time.monotonic_ns()}"
    t0 = time.monotonic()
    rc = ranks.launch("benchmark.run", argv, 2,
                      {"started": time.time(), "device": "cpu", "parts": tiny.parts(CELL),
                       "fault": fault, "marker": marker, **spec}, deadline=120)
    out = capsys.readouterr()
    return rc, time.monotonic() - t0, out, marker


def left_behind(marker: str):
    """Processes whose command line holds ``marker``."""
    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            if marker.encode() in Path(f"/proc/{pid}/cmdline").read_bytes():
                found.append(int(pid))
        except OSError:
            pass
    return found


def test_two_ranks_give_one_correct_line(capsys):
    rc, _, out, marker = launch(capsys)
    assert rc == 0, out.err[-3000:]
    lines = out.out.strip().splitlines()
    info, result = json.loads(lines[-2])["info"], json.loads(lines[-1])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["device"]["count"] == 2
    # the cell's other end-to-end metric, ddp_device_ms_per_sample, is read
    # from a trace of the cards' device activity, which a CPU run has not
    assert set(result["metrics"]) == {"setup_s"}
    steps = info["ranks_attempted"]
    assert len(steps) == 2 and steps[0] == steps[1] >= 1
    assert result["attempted"] == sum(steps)
    last = list(tiny.parts(CELL)["workload"]["limits"])[-1]
    assert out.err.strip().splitlines()[-1].startswith(f"check {last} ")
    assert not left_behind(marker)


@pytest.mark.parametrize("fault,spec", [("rank_fails", {}), ("rank_hangs", {"timeout_s": 5})])
def test_a_failing_rank_ends_the_run(capsys, fault, spec):
    rc, seconds, out, marker = launch(capsys, fault, **spec)
    assert rc != 0 and not out.out.strip()
    assert seconds < 90 and "were ended" in out.err
    assert not left_behind(marker)


def test_local_statistics_fail_the_check(capsys):
    rc, _, out, _ = launch(capsys, "local_stats", seconds=0.1)
    assert rc == 0, out.err[-3000:]
    result = json.loads(out.out.strip().splitlines()[-1])
    assert not result["correct"], result["checks"]
    # the running statistics alone, which nothing but the exchange of the
    # statistics sets, fail it
    stats = {k: c for k, c in result["checks"].items() if k.startswith("stats_gap")}
    assert stats and any(c["value"] > c["limit"] for c in stats.values()), stats


def test_a_rank_that_loads_jax_exits_3(capsys):
    rc, _, out, marker = launch(capsys, "loads_jax", seconds=0.1)
    assert rc == ranks.GUARD_RC == 3, out.err[-3000:]
    assert not out.out.strip()
    assert "loaded after the window: jax" in out.err
    assert not left_behind(marker)
