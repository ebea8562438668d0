"""Data-parallel training of vae2_tpu_torch across processes, on the CPU.

Two ``gloo`` ranks (spawned processes that rendezvous through a file in
``tmp_path``) against one process at the doubled batch, on the same weights,
clips and noise:

- ``BatchNormAct`` with act None (the fused-ABN autograd op, plain kernel
  versions on the CPU) and act 'relu' (the plain path, 4-d and the
  posterior's (N, C)), forward and backward over the concatenated batch:
  y, dx, dgamma and dbeta (the sum over ranks of each rank's local ones,
  which the gradient all-reduce averages), and the running statistics with
  the global Bessel n. Tolerance 1e-5 * (1 + max|ref|): the same f32
  arithmetic, summed in another order.
- two adversarial G/D steps (``VAE2System.train_step``) of the tiny debug
  spec in float32 with REMAT 'stage' and Adam (lr 1e-3): the first on
  injected noise, the second on noise drawn from the shared generator
  (each rank keeps its rows of the global draw). After the first step, the
  forward values hold to 1e-5: the losses averaged over the ranks (1e-5
  relative; the KL, which cancels near 0, 1e-5 * (1 + |KL|)) and every
  running statistic (1e-5 * (1 + max|ref|)). What follows from a gradient
  is held to a control instead: this random tiny network amplifies
  rounding, and the one process's own G gradient moves by ~0.5% (L2) when
  its input clips move by one f32 ulp (the control, run here; the D
  gradient by ~0.04%). Per network, the two ranks' averaged gradient of the
  first step lies within 2x the control's distance from the one process,
  or 2x 1e-4 where the control moves a network less (f32 sums in another
  order; the ratio measured 0.9-1.0x on a CPU); their updates after two
  steps and their Adam moments within 2x the largest network's control
  distance (after two Adam steps these vary between card runs whose first
  step is the same bit for bit). The ranks' parameters are
  bitwise equal; the generator's draws are the global batch's, bitwise; the
  all-reduces per step equal the count derived from the model. The steps
  and these checks are ``vae2_tpu_torch/tools/ddp_check.py``'s, which
  chip_smoke.py runs on the card at the same size.
- the SyncBN cases again with each planted fault that concerns a BN
  (``ddp_check.FAULTS``: local statistics, local kernel-2 sums handed to
  kernel 3, the ReLU statistics' gradient not summed): each must break the
  comparison above.

The worker runs at the top level of this file and imports only the port.
The chain to the JAX package is the one-process step parity of
tests/test_torch_port_step.py (the same train step against JAX, piece by
piece) and tests/test_torch_port_train.py (``BatchNormAct`` against the
JAX module).

Beside it: the sharded loader, the refusals of a misconfigured run, poly LR
and bf16 Adam moments against optax, and the train CLI under ``torchrun``
with two CPU ranks, one epoch then a resume.
"""

import datetime
import glob
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vae2_tpu_torch.config import get_default_config
from vae2_tpu_torch.core import optim as port_optim
from vae2_tpu_torch.core import system as port_system
from vae2_tpu_torch.core.builder import build_system
from vae2_tpu_torch.data.loader import ClipLoader
from vae2_tpu_torch.ops.norm import BatchNormAct
from vae2_tpu_torch.parallel import dist as port_dist
from vae2_tpu_torch.parallel import mesh, sync
from vae2_tpu_torch.tools import ddp_check

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "experiments", "cityscapes",
                        "debug_tiny_32x64.yaml")
DATA = os.path.join(REPO, "data", "synthetic64")
WORLD = ddp_check.RANKS
BN_CASES = {"none": (4, 6, 3, 5), "relu": (4, 6, 3, 5), "relu_2d": (4, 6)}
# the planted faults that concern a BN, and the cases each reaches
BN_FAULTS = {"local_stats": ("none", "relu", "relu_2d"),
             "local_abn_sums": ("none",),
             "local_relu_stats_grad": ("relu", "relu_2d")}


# ---- the worker (top level: a spawned process imports this file) -----------


def _rows(a, rank, world):
    n = a.shape[0] // world
    return a[rank * n:(rank + 1) * n]


def _bn_case(name, rank, world):
    """One BatchNormAct forward and backward on this rank's rows of a
    seeded global batch of (4, 6[, 3, 5])."""
    shape = BN_CASES[name]
    rng = np.random.RandomState(len(name))
    x = rng.randn(*shape).astype(np.float32) * 2 + 0.5
    dy = rng.randn(*shape).astype(np.float32)
    c = shape[1]
    bn = BatchNormAct(c, act=None if name == "none" else "relu")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
        bn.bias.copy_(torch.from_numpy(rng.randn(c) * 0.3))
        bn.running_mean.copy_(torch.from_numpy(rng.randn(c) * 0.2))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
    xt = torch.from_numpy(_rows(x, rank, world))
    dyt = torch.from_numpy(_rows(dy, rank, world))
    if xt.dim() == 4:
        xt = xt.contiguous(memory_format=torch.channels_last)
        dyt = dyt.contiguous(memory_format=torch.channels_last)
    xt.requires_grad_(True)
    bn.train()
    y = bn(xt)
    y.backward(dyt)
    return {"y": y.detach(), "dx": xt.grad, "dgamma": bn.weight.grad,
            "dbeta": bn.bias.grad, "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone()}


def run_worker(rank, world, init_file, out_dir, perturb=False):
    """One rank: the BN cases, then the train steps; saved to out_dir."""
    torch.set_num_threads(1)
    if world > 1:
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=180))
    try:
        out = {"bn": {name: _bn_case(name, rank, world) for name in BN_CASES},
               "steps": ddp_check.tiny_steps("cpu", rank, world, perturb)}
        if world > 1:
            out["bn_faults"] = {}
            for fault, cases in BN_FAULTS.items():
                with ddp_check.plant(fault):
                    out["bn_faults"][fault] = {
                        name: _bn_case(name, rank, world) for name in cases}
        torch.save(out, os.path.join(out_dir, f"rank{rank}_{world}_{perturb}"
                                              ".pt"))
    finally:
        if world > 1:
            dist.destroy_process_group()


def run_all(i, init_file, out_dir):
    """Process i: ranks 0 and 1 of the two-rank group, then the one process
    and its control."""
    if i < WORLD:
        run_worker(i, WORLD, init_file, out_dir)
    else:
        run_worker(0, 1, None, out_dir, perturb=i > WORLD)


# ---- two ranks against one process ------------------------------------------


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    """(the two ranks' results, the one process's, its control's), from
    four spawned processes at once."""
    root = tmp_path_factory.mktemp("ddp")
    ctx = mp.start_processes(run_all, args=(str(root / "rendezvous"),
                                            str(root)),
                             nprocs=WORLD + 2, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + 400
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail("the DDP workers did not finish within 400 s")

    def load(rank, world, perturb=False):
        return torch.load(root / f"rank{rank}_{world}_{perturb}.pt",
                          weights_only=True)

    return ([load(r, WORLD) for r in range(WORLD)], load(0, 1),
            load(0, 1, True))


def _close(got, want, rel=1e-5, what=""):
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=rel,
                               atol=rel * (1.0 + float(want.abs().max())),
                               msg=lambda m: f"{what}: {m}")


def _sync_bn_close(got, want):
    """The ranks' BN case against the one process's on the concatenated
    batch: y and dx concatenated, dgamma and dbeta summed over the ranks,
    every rank's running statistics."""
    for k in ("y", "dx"):
        _close(torch.cat([g[k] for g in got]), want[k], what=k)
    for k in ("dgamma", "dbeta"):
        _close(sum(g[k] for g in got), want[k], what=k)
    for g in got:
        for k in ("running_mean", "running_var"):
            _close(g[k], want[k], what=k)


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_sync_bn_matches_the_concatenated_batch(ddp, case):
    ranks, ref, _ = ddp
    _sync_bn_close([r["bn"][case] for r in ranks], ref["bn"][case])


@pytest.mark.parametrize("fault,case", [(f, c) for f, cases in BN_FAULTS.items()
                                        for c in cases])
def test_sync_bn_check_catches_planted_faults(ddp, fault, case):
    """The comparison of test_sync_bn_matches_the_concatenated_batch fails
    when a fault is planted in the ranks (ddp_check.plant), each of which
    issues the same collectives as the correct code."""
    ranks, ref, _ = ddp
    with pytest.raises(AssertionError):
        _sync_bn_close([r["bn_faults"][fault][case] for r in ranks],
                       ref["bn"][case])


def test_two_ranks_match_one_process(ddp):
    """Two steps of the tiny spec, ``ddp_check.check_tiny`` (the card run's
    check of the same steps): forward values to 1e-5, gradients within 2x
    the one-ulp control, updates and Adam moments within 2x the largest
    network's control, the ranks' state bitwise equal, the draws those of
    the global batch."""
    ranks, one, control = ddp
    out = ddp_check.check_tiny([r["steps"] for r in ranks], one["steps"],
                               control["steps"], "cpu")
    assert out["failed"] == [], out
    assert out["ranks_bitwise_equal"]
    assert set(out["gaps_vs_control"]) == {"grads", "updates", "moments"}


def test_all_reduces_per_step_match_the_model(ddp):
    """One all-reduce per BN forward (recomputes included), per ABN
    backward and per ReLU-BN backward, and one gradient bucket per
    optimizer, as chip_smoke asserts at full width; none on one process."""
    ranks, ref, _ = ddp
    want = ddp_check.model_train_collectives(
        build_system(ddp_check.tiny_config(), train=True))
    for r in ranks:
        assert r["steps"]["all_reduces"] == [want, want]
    assert ref["steps"]["all_reduces"] == [0, 0]


# ---- the loader, the refusals ------------------------------------------------


class _Indexed:
    clip_length, clip_num = 1, 3

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((1, 1, 9), i, np.uint8), str(i)


@pytest.mark.parametrize("n,world", [(9, 2), (10, 2), (11, 4), (12, 3)])
def test_loader_shards_are_equal_and_disjoint(n, world):
    """Every rank has the same len(); the shards are disjoint and their
    union is the shuffled list cut to a multiple of the ranks."""
    ds = _Indexed(n)
    loaders = [ClipLoader(ds, batch_size=1, num_threads=1, seed=3,
                          process_index=r, process_count=world)
               for r in range(world)]
    one = ClipLoader(ds, batch_size=1, num_threads=1, seed=3)
    for ld in loaders + [one]:
        ld.set_epoch(2)
    shards = [[int(names[0]) for _, names in ld] for ld in loaders]
    assert {len(s) for s in shards} == {n // world}
    assert {len(ld) for ld in loaders} == {n // world}
    order = [int(names[0]) for _, names in one]
    cut = order[: n - n % world]
    assert sorted(sum(shards, [])) == sorted(cut)
    for r, s in enumerate(shards):
        assert s == cut[r::world]


_ENV = {"MASTER_ADDR": "localhost", "MASTER_PORT": "1", "WORLD_SIZE": "2",
        "RANK": "0", "LOCAL_RANK": "1"}


def test_refuses_a_half_set_environment(monkeypatch):
    for k in port_dist.ENV_VARS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.delenv("VAE2_TPU_ALLOW_SINGLE_PROCESS", raising=False)
    assert port_dist.initialize_distributed("", "cpu") == (0, 1, 0)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="half-set"):
        port_dist.initialize_distributed("", "cpu")
    monkeypatch.setenv("VAE2_TPU_ALLOW_SINGLE_PROCESS", "1")
    assert port_dist.initialize_distributed("", "cpu") == (0, 1, 0)


def test_refuses_nccl_with_more_local_ranks_than_cards(monkeypatch):
    """Two local ranks, and fewer cards than that (none here; one on the
    card's machine): refused before NCCL starts."""
    for k, v in _ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one CUDA device per local rank"):
        port_dist.initialize_distributed("nccl", "cuda")
    assert not dist.is_initialized()
    assert port_dist.resolve_backend("", "cuda") == "nccl"
    assert port_dist.resolve_backend("", "cpu") == "gloo"
    with pytest.raises(ValueError, match="DIST_BACKEND"):
        port_dist.resolve_backend("mpi", "cpu")


@pytest.mark.parametrize("knob,value,world,match", [
    ("SPATIAL", 2, 1, "SPATIAL"), ("DATA", 4, 2, "WORLD_SIZE"),
    ("DATA", 2, 2, None), ("DATA", -1, 2, None)])
def test_mesh_checks(knob, value, world, match):
    cfg = get_default_config()
    cfg.TPU.MESH[knob] = value
    if match is None:
        mesh.check_mesh(cfg, world)
    else:
        with pytest.raises(ValueError, match=match):
            mesh.check_mesh(cfg, world)


def test_one_process_collectives_are_identities():
    x = torch.randn(3, 2, requires_grad=True)
    assert sync.world_size() == 1 and sync.rank() == 0
    assert sync.all_reduce_sum(x) is x
    y = x.detach().clone()
    assert sync.all_reduce_(y) is y
    sync.average_([y])
    assert torch.equal(y, x.detach())
    g = torch.Generator().manual_seed(1)
    want = torch.randn((4, 3), generator=torch.Generator().manual_seed(1))
    assert torch.equal(sync.randn_rows((4, 3), g), want)


# ---- poly LR and bf16 Adam moments against optax -----------------------------


def _train_cfg(**over):
    cfg = get_default_config()
    for k, v in over.items():
        cfg.TRAIN[k] = v
    return cfg.TRAIN


@pytest.mark.parametrize("name,moment,schedule", [
    ("sgd", "float32", "poly"), ("adam", "float32", "poly"),
    ("adam", "bfloat16", ""), ("adam", "bfloat16", "poly")])
def test_optimizer_matches_optax(name, moment, schedule):
    """Six updates of the port's make_optimizer against the JAX package's
    (optax, its ``scale_by_adam_lowp`` for bf16 moments) on the same
    gradients over max_iters 4, so that the poly lr reaches 0: the lr of
    each update equal to 1e-12, parameters rtol 1e-6 / atol 1e-6, the
    moments after the bf16 store equal to one bf16 ulp (the f32 update
    rounds in another order before the store)."""
    import jax.numpy as jnp
    import optax
    from vae2_tpu.core import system as jax_system

    rng = np.random.RandomState(7)
    p0 = rng.randn(5, 3).astype(np.float32)
    grads = [rng.randn(5, 3).astype(np.float32) for _ in range(6)]
    cfg = _train_cfg(OPTIMIZER=name, LR=0.01, LR_SCHEDULE=schedule,
                     LR_POWER=0.9)
    tx = jax_system.make_optimizer(cfg, moment, max_iters=4)
    params = {"w": jnp.asarray(p0)}
    state = tx.init(params)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = port_system.make_optimizer([p], cfg, moment, max_iters=4)
    for i, g in enumerate(grads):
        upd, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, upd)
        p.grad = torch.from_numpy(g)
        opt.step()
        want_lr = (0.01 * (1 - min(i / 4, 1.0)) ** 0.9 if schedule == "poly"
                   else 0.01)
        assert abs(opt.param_groups[0]["lr"] - want_lr) <= 1e-12
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(params["w"]), rtol=1e-6,
                                   atol=1e-6, err_msg=f"update {i}")
    if moment == "bfloat16":
        lowp = state[0]
        st = opt.state[p]
        assert st["exp_avg"].dtype == torch.bfloat16 == st["exp_avg_sq"].dtype
        for got, want in ((st["exp_avg"], lowp.mu["w"]),
                          (st["exp_avg_sq"], lowp.nu["w"])):
            want = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
            torch.testing.assert_close(got.float(), want, rtol=2.0**-7,
                                       atol=0)


def test_poly_and_bf16_state_resume(tmp_path):
    """The poly count and the bf16 moments go through utils/checkpoint.py:
    a resumed optimizer continues where the saved one stopped, with its
    moments back in bf16."""
    from vae2_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = _train_cfg(OPTIMIZER="adam", LR=0.01, LR_SCHEDULE="poly")
    torch.manual_seed(0)
    a = torch.nn.Parameter(torch.randn(4))
    b = torch.nn.Parameter(a.detach().clone())
    opt_a = port_system.make_optimizer([a], cfg, "bfloat16", max_iters=5)
    for _ in range(2):
        a.grad = torch.ones(4)
        opt_a.step()
    path = str(tmp_path / "c.pt")
    save_checkpoint(path, {"w": a.detach()}, 1, optimizer=opt_a)
    opt_b = port_system.make_optimizer([b], cfg, "bfloat16", max_iters=5)
    opt_b.load_state_dict(torch.load(path, weights_only=True)["optimizer"])
    b.data.copy_(a.detach())
    assert opt_b.state[b]["exp_avg"].dtype == torch.bfloat16
    for p, o in ((a, opt_a), (b, opt_b)):
        p.grad = torch.full((4,), 0.5)
        o.step()
    assert opt_b.param_groups[0]["poly_count"] == 3
    assert opt_b.param_groups[0]["lr"] == opt_a.param_groups[0]["lr"]
    assert opt_b.param_groups[0]["lr"] == pytest.approx(
        port_optim.poly_lr(0.01, 0.9, 5, 2), rel=1e-12)
    assert torch.equal(a, b)


# ---- the train CLI under torchrun ---------------------------------------------


def test_train_cli_under_torchrun_trains_and_resumes(tmp_path):
    """``python -m torch.distributed.run --standalone --nproc_per_node 2``
    with --device cpu at the tiny spec, poly LR and bf16 moments: one epoch
    (3 clips, cut to 2: one per rank, one step), then TRAIN.RESUME for a
    second. Rank 0 alone writes checkpoint.pt, the log and vis/."""
    lst = tmp_path / "train.txt"
    zips = sorted(glob.glob(os.path.join(DATA, "*.zip")))[:3]
    lst.write_text("\n".join(zips) + "\n")
    out, log = tmp_path / "o", tmp_path / "l"

    def run(epochs, *extra):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "2", "-m", "vae2_tpu_torch.tools.train",
               "--cfg", TINY_CFG, "--device", "cpu",
               "DATASET.ROOT", "/", "DATASET.TRAIN_SET", str(lst),
               "TRAIN.END_EPOCH", str(epochs), "TRAIN.BATCH_SIZE_PER_GPU", "1",
               "TPU.REMAT", "none",
               "TRAIN.IMAGE_SIZE", "[32, 16]", "GPU.DTYPE", "float32",
               "TRAIN.OPTIMIZER", "adam", "TRAIN.LR", "0.0001",
               "TRAIN.LR_SCHEDULE", "poly", "TPU.ADAM_MOMENT_DTYPE",
               "bfloat16", "OUTPUT_DIR", str(out), "LOG_DIR", str(log),
               "PRINT_FREQ", "1", "WORKERS", "1", *extra]
        env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
        proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=240)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return proc

    run(1)
    final = out / "cityscapessequence" / "debug_tiny_32x64"
    logs = sorted(final.glob("*_train.log"))
    assert len(logs) == 1  # rank 0's only
    text = logs[0].read_text()
    assert "rank 0 of 2" in text and "Iter:[0/1]" in text
    ckpt = torch.load(final / "checkpoint.pt", weights_only=True)
    assert ckpt["epoch"] == 1
    assert ckpt["optimizer_g"]["param_groups"][0]["poly_count"] == 1
    assert glob.glob(str(final / "vis" / "epoch0" / "*" / "*.png"))
    assert not glob.glob(str(final / "*.tmp"))

    run(2, "TRAIN.RESUME", "True")
    logs = sorted(final.glob("*_train.log"))
    text = "".join(p.read_text() for p in logs)
    assert "=> loaded checkpoint (epoch 1)" in text
    ckpt = torch.load(final / "checkpoint.pt", weights_only=True)
    assert ckpt["epoch"] == 2
    assert ckpt["optimizer_g"]["param_groups"][0]["poly_count"] == 2
