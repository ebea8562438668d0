"""Spatial (H) sharding of the VAE² train step in vae2_tpu_torch, on the CPU.

Spawned ``gloo`` ranks (rendezvous through files in ``tmp_path``) in a
(data x spatial) layout: rank r holds data shard r // S and block r % S of
each image's H rows (``parallel/mesh.py``). Against the whole tensor:

- the halo'd ops on 2 and 4 spatial ranks (1x2, 1x4), concatenated in rank
  order, at heights that split evenly and at the branches of a 24- and a
  20-row image, which do not, against the JAX package's ops on the whole
  tensor: the 3x3
  convolutions of stride 1 and 2 and the 1x1 one against
  ``jax.lax.conv_general_dilated`` with the explicit (1, 1) padding of
  vae2_tpu/models/hrnet.py:88-99, and the 2x, 4x and 8x upsample against
  ``vae2_tpu.ops.image.resize_bilinear``; forward and input gradient (the
  vector-Jacobian product of a seeded cotangent) to 1e-5 * (1 + max|ref|);
- two G/D steps of the tiny debug spec (f32, REMAT 'stage', Adam 1e-3) on
  1x2 and 2x2 layouts, and an HD_Z-false case on 1x2, against one process
  at the same global batch of 4 clips, by ``ddp_check.check_tiny`` with the
  bounds of tests/test_torch_port_ddp.py: forward values to 1e-5, per
  network the gradient within 2x the control's distance, updates and Adam
  moments within 2x the largest network's control, the ranks bitwise
  equal, the generator's draws those of the global batch (a map's H rows
  sliced by spatial index). The control is the one-ulp move of the clips;
  for HD_Z False, each network's larger distance of two controls: that
  move, and the one process with its global pool summed in two blocks of
  rows (``spatial_check.pool_in_blocks``), because that network's BN over
  the pooled batch amplifies the pool's rounding (the order alone moves
  its G gradient by 2.7-4.2%, the one-ulp move by 0.6%).
  The halo exchanges and all-reduces per step equal the counts derived
  from the model;
- the same steps at 24 rows on 1x2 and 1x4 (the 1x2 group's ranks, and
  the 2x2 group's four as one spatial group), where the branches split
  unequally (``parallel/sync.py`` ``row_range``: 3 rows over 4 ranks as
  1/1/1/0), against one process at 24 rows and its control; the calls
  that reach kernels 1-3 per rank as the model derives them for a rank
  that owns no rows of a branch; the BN statistics divided by the rank
  count (``spatial_check.UNEVEN_FAULTS``) caught on 1x4;
- each planted fault of ``spatial_check.FAULTS`` (the faults that
  chip_smoke.py's spatial fault phase plants) on the 1x2 ranks must break
  that comparison, held on one step (losses, running statistics,
  gradients, the ranks' state, the draws); each of
  ``spatial_check.POOLED_FAULTS`` (the pool's gradient not summed over the
  group) on the HD_Z-false 1x2 ranks must break its gradients, under the
  bound that the pooled case's second control widens.

The workers run at the top level of this file and import only the port.
The chain to the JAX package for the steps is the one-process step parity
of tests/test_torch_port_step.py. Beside it: the mesh checks and the
loader's row shards.
"""

import contextlib
import datetime
import functools
import json
import os
import time
import unittest.mock

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vae2_tpu_torch.config import get_default_config
from vae2_tpu_torch.core.builder import build_system
from vae2_tpu_torch.data.loader import ClipLoader
from vae2_tpu_torch.data.video import make_dataset
from vae2_tpu_torch.parallel import mesh
from vae2_tpu_torch.tools import ddp_check, spatial_check

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the process groups: name -> ranks; every group's steps at 16 rows run with
# S = 2; the 1x2 ranks then take the steps at UNEVEN_H rows on 1x2, and the
# 2x2 group's four ranks those on 1x4 (then once more with each of
# spatial_check.UNEVEN_FAULTS planted)
GROUPS = {"1x2": 2, "2x2": 4, "1x2_pooled": 2, "1x2_faults": 2}
# 24 rows: branches of 24/12/6/3 rows, which split 12/12, 6/6, 3/3, 2/1 on
# two ranks and 6/6/6/6, 3/3/3/3, 2/2/2/0, 1/1/1/0 on four
UNEVEN_H = 24
# the one-process runs, two processes of them in turn: name -> (hd_z,
# perturb, pool in blocks, height)
SINGLES = ({"one": (True, False, False, 16),
            "control": (True, True, False, 16),
            "one_h24": (True, False, False, UNEVEN_H)},
           {"one_pooled": (False, False, False, 16),
            "control_pooled": (False, True, False, 16),
            "blocks_pooled": (False, False, True, 16),
            "control_h24": (True, True, False, UNEVEN_H)})


# ---- the workers (top level: a spawned process imports this file) -----------


def _layout(spatial, world):
    cfg = ddp_check.tiny_config()
    cfg.TPU.MESH.SPATIAL = spatial
    mesh.init_layout(cfg, world)


@contextlib.contextmanager
def _count_kernel_calls(counts):
    """Count, by kernel, the calls that reach a kernel or (on the CPU) its
    plain version: ``abn._dispatch``, which a call on an empty tensor never
    reaches."""
    from vae2_tpu_torch.ops import abn

    real = abn._dispatch
    names = {"abn_fwd_train": "abn_rows", "fused_abn_infer": "abn_rows",
             "abn_rows": "abn_rows", "abn_bwd_sums": "abn_bwd_sums",
             "abn_bwd_dx": "abn_bwd_dx"}

    def dispatch(name, *args):
        counts[names[name]] = counts.get(names[name], 0) + 1
        return real(name, *args)

    with unittest.mock.patch.object(abn, "_dispatch", dispatch):
        yield


def _uneven_steps(rank, world):
    """The two steps at UNEVEN_H rows on a 1 x ``world`` layout, the
    kernels' calls counted, then on 1x4 one step with each fault of
    spatial_check.UNEVEN_FAULTS planted."""
    _layout(world, world)
    counts = {}
    with _count_kernel_calls(counts):
        out = {"steps": ddp_check.tiny_steps("cpu", rank, world,
                                             height=UNEVEN_H)}
    out["kernel_calls"] = counts
    for fault in spatial_check.UNEVEN_FAULTS if world == 4 else ():
        with spatial_check.plant(fault):
            out[fault] = ddp_check.tiny_steps("cpu", rank, world, steps=1,
                                              height=UNEVEN_H)
    return out


def _group_worker(name, rank, init_file, out_dir):
    """One rank of group ``name``: the ops (1x2 and 2x2, every rank of the
    group one spatial group) and the two steps, or (1x2_faults) one step
    with each planted fault in turn."""
    world = GROUPS[name]
    dist.init_process_group("gloo", init_method=f"file://{init_file}_{name}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        out = {}
        if name in ("1x2", "2x2"):
            _layout(world, world)
            out["ops"] = {op: spatial_check.op_outputs(op)
                          for op in spatial_check.OPS}
        _layout(2, world)  # 1x2, or 2x2 on four ranks
        if name == "1x2_faults":
            for fault in spatial_check.FAULTS:
                with spatial_check.plant(fault):
                    out[fault] = ddp_check.tiny_steps("cpu", rank, world,
                                                      steps=1)
        else:
            out["steps"] = ddp_check.tiny_steps("cpu", rank, world,
                                                hd_z=name != "1x2_pooled")
        if name == "1x2_pooled":
            for fault in spatial_check.POOLED_FAULTS:
                with spatial_check.plant(fault):
                    out[fault] = ddp_check.tiny_steps("cpu", rank, world,
                                                      hd_z=False, steps=1)
        if name in ("1x2", "2x2"):
            out["uneven"] = _uneven_steps(rank, world)
        torch.save(out, os.path.join(out_dir, f"{name}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_all(i, procs, init_file, out_dir):
    torch.set_num_threads(1)
    name, rank = procs[i]
    if name in GROUPS:
        _group_worker(name, rank, init_file, out_dir)
        return
    for single, (hd_z, perturb, blocks, height) in SINGLES[rank].items():
        with (spatial_check.pool_in_blocks() if blocks
              else contextlib.nullcontext()):
            out = {"steps": ddp_check.tiny_steps("cpu", 0, 1, perturb, hd_z,
                                                 height=height)}
        torch.save(out, os.path.join(out_dir, f"{single}_0.pt"))


@pytest.fixture(scope="module")
def spatial(tmp_path_factory):
    """{run name: [rank results]}, from every process at once (12)."""
    root = tmp_path_factory.mktemp("spatial")
    procs = [(g, r) for g, n in GROUPS.items() for r in range(n)] + \
        [("singles", r) for r in range(len(SINGLES))]
    ctx = mp.start_processes(run_all, args=(procs, str(root / "rendezvous"),
                                            str(root)),
                             nprocs=len(procs), join=False,
                             start_method="spawn")
    deadline = time.monotonic() + 400
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail("the spatial workers did not finish within 400 s")
    out = {}
    for name, n in GROUPS.items():
        out[name] = [torch.load(root / f"{name}_{r}.pt", weights_only=True)
                     for r in range(n)]
    for single in (k for group in SINGLES for k in group):
        out[single] = [torch.load(root / f"{single}_0.pt", weights_only=True)]
    return out


@contextlib.contextmanager
def _one_thread():
    """The checks' many small tensor ops on one thread: the tier-1 run
    has several test workers at once, and a pool of threads per op
    thrashes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# ---- the halo'd ops against the JAX package ---------------------------------


@functools.lru_cache(maxsize=None)
def _jax_op(name):
    """(y, dx) of op ``name`` on the whole tensor, in the JAX package."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from vae2_tpu.ops.image import resize_bilinear

    kind, k, stride, image, _, b_out = spatial_check.OPS[name]
    a = spatial_check.op_inputs(name)
    if kind == "up":
        h, w = spatial_check.branch_size(image, b_out)

        def f(x):
            nhwc = jnp.transpose(x, (0, 2, 3, 1))
            y = resize_bilinear(nhwc, h, w)
            return jnp.transpose(y, (0, 3, 1, 2))
    else:
        p = (k - 1) // 2

        def f(x):
            return lax.conv_general_dilated(
                x, jnp.asarray(a["weight"]), (stride, stride),
                ((p, p), (p, p)), dimension_numbers=("NCHW", "OIHW", "NCHW"))
    y, vjp = jax.vjp(f, jnp.asarray(a["x"]))
    (dx,) = vjp(jnp.asarray(a["dy"]))
    return np.asarray(y), np.asarray(dx)


def _close(got, want, what):
    want = torch.from_numpy(want)
    tol = 1e-5 * (1.0 + float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=0, atol=tol,
                               msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("group", ["1x2", "2x2"])
@pytest.mark.parametrize("op", sorted(spatial_check.OPS))
def test_halo_ops_match_jax_on_the_whole_tensor(spatial, group, op):
    """On 2 ranks (the 1x2 group) and 4 (the 2x2 group's ranks as one
    spatial group of 4), each rank's rows concatenated: forward and input
    gradient to 1e-5 * (1 + max|ref|). The ``uneven_`` ops split their
    rows unequally, with a rank of no rows on 4 ranks (spatial_check.OPS);
    the first six split evenly."""
    ranks = spatial[group]
    y, dx = _jax_op(op)
    with _one_thread():
        _close(torch.cat([r["ops"][op]["y"] for r in ranks], 2), y,
               f"{op} y")
        _close(torch.cat([r["ops"][op]["dx"] for r in ranks], 2), dx,
               f"{op} dx")


# ---- the tiny G/D steps against one process ---------------------------------

# case -> (the one process, its controls, HD_Z, S)
STEP_CASES = {"1x2": ("one", ("control",), True, 2),
              "2x2": ("one", ("control",), True, 2),
              "1x2_pooled": ("one_pooled", ("control_pooled",
                                            "blocks_pooled"), False, 2),
              "1x2_h24": ("one_h24", ("control_h24",), True, 2),
              "1x4_h24": ("one_h24", ("control_h24",), True, 4)}


def _steps(spatial, case):
    """Each rank's steps of STEP_CASES[case]: the uneven cases ran in the
    1x2 group's ranks (1x2) and the 2x2 group's (1x4)."""
    if case.endswith("_h24"):
        group = {"1x2_h24": "1x2", "1x4_h24": "2x2"}[case]
        return [r["uneven"]["steps"] for r in spatial[group]]
    return [r["steps"] for r in spatial[case]]


def _check(spatial, ranks, case):
    """``ddp_check.check_tiny`` of ``ranks``' steps against the one process
    and the controls of STEP_CASES[case]."""
    one, controls, hd_z, s = STEP_CASES[case]
    with _one_thread():
        return ddp_check.check_tiny(
            ranks, spatial[one][0]["steps"],
            [spatial[c][0]["steps"] for c in controls], "cpu",
            spatial=s, hd_z=hd_z)


@pytest.mark.parametrize("group", sorted(STEP_CASES))
def test_spatial_steps_match_one_process(spatial, group):
    """Two steps on the layout against one process at the same global
    batch (``ddp_check.check_tiny``); at 24 rows on 1x2 and 1x4 every
    branch but the first splits unequally, and on 1x4 one rank holds no
    rows of branches 2 and 3."""
    out = _check(spatial, _steps(spatial, group), group)
    assert out["failed"] == [], out
    assert out["ranks_bitwise_equal"]


@pytest.mark.parametrize("group", sorted(STEP_CASES))
def test_collectives_per_step_match_the_model(spatial, group):
    """Halo exchanges (one per convolution taller than a row and per
    upsample, forward, recompute and backward) and all-reduces (those of
    data parallelism, and the pooled posterior's spatial sum) per step, as
    chip_smoke.py derives them at full width."""
    system = build_system(ddp_check.tiny_config(group != "1x2_pooled"),
                          train=True)
    halos = spatial_check.model_halo_exchanges(system)
    reduces = ddp_check.model_train_collectives(system, spatial=2)
    for r in _steps(spatial, group):
        assert r["halo_exchanges"] == [halos, halos]
        assert r["all_reduces"] == [reduces, reduces]
    assert spatial["one"][0]["steps"]["halo_exchanges"] == [0, 0]


def test_empty_shards_launch_no_kernel(spatial):
    """On the 1x4 layout at 24 rows the last rank owns no rows of branches
    2 and 3: its ABN calls there reach no kernel (nor, on the CPU, its
    plain version), and the calls that do are those that
    spatial_check.model_train_launches_on_rank derives from the model, on
    every rank."""
    system = build_system(ddp_check.tiny_config(), train=True)
    full = spatial_check.model_train_launches_on_rank(
        system, (UNEVEN_H, ddp_check.TINY_W), 1, 0)
    for rank, r in enumerate(spatial["2x2"]):
        fwd, bwd = spatial_check.model_train_launches_on_rank(
            system, (UNEVEN_H, ddp_check.TINY_W), 4, rank)
        assert r["uneven"]["kernel_calls"] == {  # two steps
            "abn_rows": 2 * fwd, "abn_bwd_sums": 2 * bwd,
            "abn_bwd_dx": 2 * bwd}, rank
        assert (fwd, bwd) < full if rank == 3 else (fwd, bwd) == full


@pytest.mark.parametrize("fault", sorted(spatial_check.UNEVEN_FAULTS))
def test_spatial_check_catches_uneven_faults(spatial, fault):
    """Each fault that only unequal shards show (the BN statistics divided
    by the rank count), planted in the 1x4 ranks at 24 rows, breaks the
    comparison of test_spatial_steps_match_one_process, with the
    collectives of the correct code."""
    ranks = [r["uneven"][fault] for r in spatial["2x2"]]
    out = _check(spatial, ranks, "1x4_h24")
    print(json.dumps({"fault": fault, "failed": out["failed"]}))
    assert out["failed"], out
    clean = _steps(spatial, "1x4_h24")[0]
    for r in ranks:
        assert r["halo_exchanges"] == clean["halo_exchanges"][:1]
        assert r["all_reduces"] == clean["all_reduces"][:1]


@pytest.mark.parametrize("fault", sorted(spatial_check.FAULTS))
def test_spatial_check_catches_planted_faults(spatial, fault):
    """Each fault planted in the 1x2 ranks breaks the comparison of
    test_spatial_steps_match_one_process, while the collectives per step
    stay those of the correct code."""
    out = _check(spatial, [r[fault] for r in spatial["1x2_faults"]], "1x2")
    print(json.dumps({"fault": fault, "failed": out["failed"]}))
    assert out["failed"], out
    clean = spatial["1x2"][0]["steps"]
    for r in spatial["1x2_faults"]:
        assert r[fault]["halo_exchanges"] == clean["halo_exchanges"][:1]
        assert r[fault]["all_reduces"] == clean["all_reduces"][:1]


@pytest.mark.parametrize("fault", sorted(spatial_check.POOLED_FAULTS))
def test_spatial_check_catches_pooled_faults(spatial, fault):
    """Each fault of the pooled posterior, planted in the HD_Z-false 1x2
    ranks, breaks the comparison of the 1x2_pooled case, whose gradient
    bound the pool's rounding control widens: the G gradients of the
    networks that the pool feeds leave that bound. Prints the readings
    (``pytest -rP``)."""
    out = _check(spatial, [r[fault] for r in spatial["1x2_pooled"]],
                 "1x2_pooled")
    grads = out["gaps_vs_control"]["grads"]
    print(json.dumps({"fault": fault, "failed": out["failed"],
                      "grads_rank0": grads["rank0"],
                      "grads_bound": {net: ddp_check.CONTROL_FACTOR * max(
                          gap, ddp_check.TINY_GAP_FLOOR)
                          for net, gap in grads["control"].items()}}))
    assert "grads" in out["failed"], out
    clean = spatial["1x2_pooled"][0]["steps"]
    for r in spatial["1x2_pooled"]:
        assert r[fault]["halo_exchanges"] == clean["halo_exchanges"][:1]
        assert r[fault]["all_reduces"] == clean["all_reduces"][:1]


# ---- the mesh checks, the loader's rows -------------------------------------


@pytest.mark.parametrize("spatial_,data,world,match", [
    (2, -1, 2, None), (2, 1, 2, None), (4, -1, 4, None), (2, 2, 4, None),
    (4, 2, 8, None), (2, -1, 3, "SPATIAL"), (4, -1, 2, "SPATIAL"),
    (2, 2, 2, "WORLD_SIZE"), (2, 1, 4, "WORLD_SIZE")])
def test_mesh_accepts_spatial_layouts(spatial_, data, world, match):
    cfg = get_default_config()
    cfg.merge_from_file(ddp_check.TINY_CFG)
    cfg.TRAIN.IMAGE_SIZE = [64, 64]
    cfg.TPU.MESH.SPATIAL = spatial_
    cfg.TPU.MESH.DATA = data
    if match is None:
        mesh.check_mesh(cfg, world)
        assert mesh.layout(cfg, world) == (world // spatial_, spatial_)
    else:
        with pytest.raises(ValueError, match=match):
            mesh.check_mesh(cfg, world)


@pytest.mark.parametrize("height,spatial_", [(122, 4), (30, 8), (21, 2)])
def test_mesh_refuses_an_uneven_height(height, spatial_):
    """The image's rows must split over S, as jax.device_put's
    ``P('data', 'spatial')`` requires: H % S == 0."""
    cfg = get_default_config()
    cfg.merge_from_file(ddp_check.TINY_CFG)
    cfg.TRAIN.IMAGE_SIZE = [64, height]
    cfg.TPU.MESH.SPATIAL = spatial_
    with pytest.raises(ValueError, match="divisible"):
        mesh.check_mesh(cfg, spatial_)


@pytest.mark.parametrize("height,spatial_", [(120, 2), (120, 4), (24, 4),
                                             (20, 4), (32, 8)])
def test_mesh_accepts_every_height_that_splits(height, spatial_):
    """Any H % S == 0, though a deeper branch then splits unequally (120
    rows on 4 ranks: branches of 120/60/30/15 rows, 30 and 15 unequally;
    24 on 4: 3 rows as 1/1/1/0)."""
    cfg = get_default_config()
    cfg.merge_from_file(ddp_check.TINY_CFG)
    cfg.TRAIN.IMAGE_SIZE = [64, height]
    cfg.TPU.MESH.SPATIAL = spatial_
    mesh.check_mesh(cfg, spatial_)


class _Rows:
    clip_length, clip_num = 1, 3

    def __len__(self):
        return 4

    def __getitem__(self, i):
        rows = np.arange(8, dtype=np.uint8)[:, None, None] + 10 * i
        return np.broadcast_to(rows, (8, 2, 9)).copy(), str(i)


@pytest.mark.parametrize("spatial_", [2, 4])
def test_loader_keeps_each_ranks_rows(spatial_):
    """The S row blocks of one batch, in rank order, are the whole batch."""
    whole = [b for b, _ in ClipLoader(_Rows(), 2, shuffle=False,
                                      num_threads=1)]
    parts = [[b for b, _ in ClipLoader(_Rows(), 2, shuffle=False,
                                       num_threads=1, row_index=j,
                                       row_count=spatial_)]
             for j in range(spatial_)]
    for i, batch in enumerate(whole):
        for k, v in batch.items():
            assert all(p[i][k].shape[1] == 8 // spatial_ for p in parts)
            np.testing.assert_array_equal(
                np.concatenate([p[i][k] for p in parts], axis=1), v)
    with pytest.raises(ValueError, match="split evenly"):
        next(iter(ClipLoader(_Rows(), 2, num_threads=1, row_index=0,
                             row_count=3)))


def test_loader_ranks_pick_the_same_frames():
    """Train clips (random starts) of batches of 2 decoded by 4 threads,
    4 batches in flight: over three epochs the two ranks' row blocks, in
    rank order, are the one process's batches, so both ranks took the same
    frames of each clip. (Drawn in the decode threads, the starts of one
    batch's second clip and another batch's first interleave.)"""
    cfg = get_default_config()
    cfg.DATASET.ROOT = os.path.join(REPO, "data", "synthetic64")
    cfg.TRAIN.IMAGE_SIZE = [256, 128]
    train_list = os.path.join(cfg.DATASET.ROOT, "train_list.txt")

    def loader(**rows):
        ds = make_dataset(cfg, train_list, random_pos=True, num_samples=8,
                          seed=3)
        return ClipLoader(ds, 2, num_threads=4, seed=3, prefetch=3, **rows)

    loaders = [loader()] + [loader(row_index=j, row_count=2)
                            for j in range(2)]
    batches = 0
    for epoch in range(3):
        for ld in loaders:
            ld.set_epoch(epoch)
        for (whole, names), *parts in zip(*loaders):
            assert all(p[1] == names for p in parts)
            for k, v in whole.items():
                np.testing.assert_array_equal(
                    np.concatenate([p[0][k] for p in parts], axis=1), v,
                    err_msg=f"epoch {epoch} {names} {k}")
            batches += 1
    assert batches == 12
