"""Checks of data-parallel training: two ranks against one process.

Shared by ``tests/test_torch_port_ddp.py`` (gloo ranks on the CPU) and
``chip_smoke.py`` (gloo ranks that share one card), which run the same
steps and hold them to the same tolerances:

- :func:`tiny_steps`: two G/D steps of the tiny debug spec in f32 (TF32
  off) on this rank's rows of a seeded global batch, the first on injected
  noise, the second on noise from a generator that every rank holds alike;
- :func:`check_tiny`: the ranks against one process at the global batch
  and against its one-ulp control;
- :func:`model_train_collectives`: the all-reduces of one train step,
  counted from the model;
- :data:`FAULTS` and :func:`plant`: the faults that the design guards
  against, each planted so that the number of collectives stays the same
  (only the checks of values can catch it). ``chip_smoke.py`` runs the
  data-parallel checks again with each of them planted and fails unless
  each is caught.
"""

from __future__ import annotations

import contextlib
import os
import unittest.mock
from typing import Dict, Iterator, List

import numpy as np
import torch

from ..parallel import sync

RANKS = 2
TINY_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "experiments", "cityscapes",
    "debug_tiny_32x64.yaml")
TINY_B, TINY_H, TINY_W, TINY_Z = 2, 16, 32, 4  # the tiny step, per rank
NETS = ("encdec", "encz", "d_seq", "d_frame")
# A network's first-step gradient may lie CONTROL_FACTOR times as far from
# the one process as the one-ulp control moves it: on the H100 clean runs
# read at most 1.14x their control, and each planted fault at least 56x in
# one network's gradient (PERF.md). Below TINY_GAP_FLOOR a gap is the
# rounding of f32 sums taken in another order, whatever the control shows
# (the two ranks' d_seq gradient was 1.7e-5 from one process's where the
# control moved it 8.3e-6). After the second step a network's update and
# Adam moments are held to CONTROL_FACTOR x the largest of the networks'
# controls: on the card they vary between runs whose first step is bit
# for bit the same (d_seq's update gap 0.08 then 0.15, its control 0.14
# then 0.04, where the largest control was 0.31 in both runs)
CONTROL_FACTOR = 2.0
TINY_GAP_FLOOR = 1e-4
# first-step losses (relative; the KL, which cancels near 0, 1e-5 * (1 +
# |KL|)) and running statistics (1e-5 * (1 + max|ref|)): forward values,
# the same f32 arithmetic summed in another order
FORWARD_RTOL = 1e-5


def tiny_config(hd_z: bool = True):
    """The tiny debug spec in f32, REMAT 'stage', Adam lr 1e-3 (``hd_z``
    False: the pooled posterior)."""
    from ..config import get_default_config

    cfg = get_default_config()
    cfg.merge_from_file(TINY_CFG)
    cfg.GPU.DTYPE = "float32"
    cfg.TPU.REMAT = "stage"
    cfg.TRAIN.OPTIMIZER = "adam"
    cfg.TRAIN.LR = 1e-3
    cfg.MODEL.EXTRA.HD_Z = hd_z
    return cfg


def tiny_steps(device, rank: int, world: int, perturb: bool = False,
               hd_z: bool = True, steps: int = 2, height: int = TINY_H
               ) -> dict:
    """Two G/D steps (or ``steps``) of the tiny spec (f32, TF32 off) on this
    rank's rows of a seeded global batch of ``TINY_B * RANKS`` clips of
    ``height`` x TINY_W: the first on injected noise, the second on noise
    from a generator that every rank holds alike. Under a spatial layout of
    S ranks (``sync.spatial_size``) the rank takes its data shard's clips
    (of world / S shards) and its rows of them and of each branch's noise
    map (``sync.row_range``: a branch may split unevenly). With ``perturb``
    the first step's clips move by one f32 ulp (the rounding control of a
    one-process run). Returns, on
    the CPU, the losses, all-reduces and halo exchanges of each step, the
    gradients and running statistics after the first, the state and Adam
    moments after the second, the generator's next draw and this rank's
    ``randn_rows`` of a vector and of a map."""
    from ..core.builder import build_system
    from ..data.loader import normalize_clips
    from ..utils.device import exact_f32

    s = sync.spatial_size()
    shard = rank // s

    def rows(a, h_axis=None):
        n = a.shape[0] // (world // s)
        a = a[shard * n:(shard + 1) * n]
        if h_axis is not None and s > 1:
            a = np.take(a, range(*sync.row_range(a.shape[h_axis], rank % s,
                                                 s)), axis=h_axis)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def cpu(named):
        return {k: v.detach().cpu().clone() for k, v in named}

    system = build_system(tiny_config(hd_z), seed=0, device=device,
                          train=True)
    generator = torch.Generator(device=device).manual_seed(5)
    out: Dict[str, list] = {"metrics": [], "all_reduces": [],
                            "halo_exchanges": []}
    n = TINY_B * RANKS
    with exact_f32():
        for step in range(steps):
            rng = np.random.RandomState(100 + step)
            batch = {k: rows(rng.randint(0, 256, (n, height, TINY_W, 9))
                             .astype(np.uint8), 1)
                     for k in ("xt", "x2t", "x3t")}
            eps = [rows(rng.randn(n, TINY_Z, -(-height // 2**b),
                                  TINY_W >> b).astype(np.float32), 2)
                   for b in range(4)]
            rand = rows(rng.randn(n, TINY_Z).astype(np.float32))
            if not hd_z:
                eps = rows(rng.randn(n, TINY_Z).astype(np.float32))
            noise = {} if step else dict(eps=eps, rand_code=rand)
            if perturb and step == 0:
                batch = {k: normalize_clips(v) * (1 + 2.0**-23)
                         for k, v in batch.items()}
            sync.reset_stats()
            metrics, _ = system.train_step(batch, generator, **noise)
            out["all_reduces"].append(sync.STATS["all_reduces"])
            out["halo_exchanges"].append(sync.STATS["halo_exchanges"])
            out["metrics"].append({k: float(v) for k, v in metrics.items()})
            if step == 0:
                out["grads"] = cpu((k, p.grad) for k, p in
                                   system.modules.named_parameters())
                out["stats"] = cpu((k, v) for k, v in
                                   system.modules.state_dict().items()
                                   if "running_" in k)
    out["state"] = cpu(system.modules.state_dict().items())
    out["moments"] = cpu(
        (f"{k}.{m}", v) for opt, nets in (
            (system.optimizer_g, ("encdec", "encz")),
            (system.optimizer_d, ("d_seq", "d_frame")))
        for k, p in system.modules.named_parameters()
        if k.split(".")[0] in nets
        for m, v in opt.state[p].items() if m != "step")
    out["next_draw"] = torch.randn(4, generator=generator,
                                   device=device).cpu()
    out["rows"] = sync.randn_rows(
        (3, 2), torch.Generator(device=device).manual_seed(9),
        device=device).cpu()
    out["map_rows"] = sync.randn_rows(
        MAP_ROWS, torch.Generator(device=device).manual_seed(11),
        device=device).cpu()
    return out


MAP_ROWS = (2, 1, 2, 3)  # a rank's (N, C, h, W) noise map in the draw check


def expected_draws(device, ranks: int, spatial: int = 1):
    """Per rank, the ``rows`` and ``map_rows`` that ``tiny_steps`` draws on
    ``ranks`` ranks in a layout of ``spatial`` ranks per spatial group: its
    data shard's rows of the global vector draw, and its data shard's rows
    and its own H block of the global map draw."""
    shards = ranks // spatial
    vec = torch.randn((3 * shards, 2), device=device, generator=torch
                      .Generator(device=device).manual_seed(9)).cpu()
    n, c, h, w = MAP_ROWS
    full = torch.randn((n * shards, c, h * spatial, w), device=device,
                       generator=torch.Generator(device=device)
                       .manual_seed(11)).cpu()
    out = []
    for r in range(ranks):
        d, j = r // spatial, r % spatial
        out.append((vec[3 * d:3 * d + 3],
                    full[n * d:n * (d + 1), :, h * j:h * (j + 1)]))
    return out


@contextlib.contextmanager
def stats_in_blocks(data_blocks: int, row_blocks: int = 1) -> Iterator[None]:
    """One process's BN statistics reduced as ``data_blocks`` x
    ``row_blocks`` ranks reduce them (``abn.batch_stats`` across ranks):
    the sums of x and x^2 of each rank's block (its batch chunk and, for a
    map, its rows by ``sync.row_range``; an (N, C) tensor whole on every
    rank of a row group) added in rank order and divided by the count. The
    rounding control of the statistics' reduction order, which the one-ulp
    move of the clips does not measure: on the CPU four blocks move the
    tiny step's d_frame gradient by 2.9e-4, as four ranks do, where the
    one-ulp move moves it by 4.2e-5 and the convolutions run in four batch
    blocks by 4.3e-7 (PERF.md)."""
    from ..ops import abn

    def stats(x):
        dims = (0,) + tuple(range(2, x.dim()))
        xf = x.float()
        total, count = None, 0
        for xd in xf.chunk(data_blocks):
            for j in range(row_blocks):
                blk = (xd[:, :, slice(*sync.row_range(x.shape[2], j,
                                                      row_blocks))]
                       if x.dim() == 4 else xd)
                part = torch.stack([blk.sum(dims), (blk * blk).sum(dims)])
                total = part if total is None else total + part
                count += blk.numel() // x.shape[1]
        mean, mean2 = (total / count).unbind(0)
        return mean, torch.clamp(mean2 - mean * mean, min=0.0)

    with unittest.mock.patch.object(abn, "batch_stats", stats):
        yield


def net_gaps(got, want, base=None) -> Dict[str, float]:
    """Per network: |got - want|_2 / |want - base|_2 over its tensors."""
    out = {}
    for net in NETS:
        keys = [k for k in want if k.split(".")[0] == net]
        d2 = sum(float(((got[k] - want[k]).float() ** 2).sum()) for k in keys)
        w2 = sum(float(((want[k] - (0 if base is None else base[k])).float()
                        ** 2).sum()) for k in keys)
        out[net] = (d2 / w2) ** 0.5
    return out


def check_tiny(ranks: List[dict], one: dict, control: dict, device,
               spatial: int = 1, hd_z: bool = True) -> dict:
    """The tiny multi-rank steps (``spatial`` ranks per spatial group)
    against one process and its one-ulp control: first-step losses (summed
    over each spatial group, averaged over the data shards) and running
    statistics to FORWARD_RTOL; per network, the first step's gradient
    within CONTROL_FACTOR x the control's distance from the one process (or
    x TINY_GAP_FLOOR where the control moves a network less), the two
    steps' updates and the Adam moments within CONTROL_FACTOR x the largest
    network's control distance (not held for ranks that ran one step); the
    ranks' state bitwise equal; the generator's draws those of the global
    batch (its next draw only after as many steps as the one process ran).
    ``control`` may be a list of controls: each network's distance is then
    the largest of theirs. Returns the readings and ``failed``, the checks
    that did not hold."""
    from ..core.builder import build_system

    controls = control if isinstance(control, list) else [control]

    failed = []
    loss_err, loss_bad = 0.0, []
    shards = len(ranks) // spatial
    for k, w in one["metrics"][0].items():
        got = sum(r["metrics"][0][k] for r in ranks) / shards
        tol = FORWARD_RTOL * ((1 + abs(w)) if k == "loss_z_KL" else abs(w))
        if not abs(got - w) <= tol:
            loss_bad.append(f"{k}: {got} vs {w}")
        loss_err = max(loss_err, abs(got - w) / (abs(w) + 1e-6))
    if loss_bad:
        failed.append("losses")
    stats_err, stats_ok = 0.0, True
    for r in ranks:
        for k, w in one["stats"].items():
            diff = (r["stats"][k] - w).abs()
            atol = FORWARD_RTOL * (1.0 + float(w.abs().max()))
            stats_ok = stats_ok and bool(
                (diff <= atol + FORWARD_RTOL * w.abs()).all())
            stats_err = max(stats_err, float(diff.max()))
    if not stats_ok:
        failed.append("running_stats")
    init = build_system(tiny_config(hd_z), seed=0).modules.state_dict()
    picks = {
        "grads": (lambda o: o["grads"], None),
        "updates": (lambda o: {k: v for k, v in o["state"].items()
                               if "running_" not in k}, init),
        "moments": (lambda o: o["moments"], None)}
    if len(ranks[0]["metrics"]) == 1:
        del picks["updates"], picks["moments"]
    gaps = {}
    for what, (pick, base) in picks.items():
        floor = {net: max(net_gaps(pick(c), pick(one), base)[net]
                          for c in controls) for net in NETS}
        got = [net_gaps(pick(r), pick(one), base) for r in ranks]
        widest = 0.0 if what == "grads" else max(floor.values())
        if not all(g[net] <= CONTROL_FACTOR * max(floor[net], widest,
                                                  TINY_GAP_FLOOR)
                   for g in got for net in NETS):
            failed.append(what)
        gaps[what] = {"rank0": got[0], "control": floor}
    a = ranks[0]["state"]
    equal = all(b.keys() == a.keys() and all(torch.equal(a[k], b[k])
                                             for k in a)
                for b in (r["state"] for r in ranks[1:]))
    if not equal:
        failed.append("bitwise")
    want = expected_draws(device, len(ranks), spatial)
    same_steps = len(ranks[0]["metrics"]) == len(one["metrics"])
    if not ((not same_steps or all(torch.equal(r["next_draw"],
                                               one["next_draw"])
                                   for r in ranks))
            and all(torch.equal(r["rows"], v) and torch.equal(r["map_rows"], m)
                    for r, (v, m) in zip(ranks, want))):
        failed.append("draws")
    return {"loss_max_rel_err": loss_err, "loss_errors": loss_bad,
            "stats_max_abs_err": stats_err, "gaps_vs_control": gaps,
            "control_factor": CONTROL_FACTOR, "gap_floor": TINY_GAP_FLOOR,
            "ranks_bitwise_equal": equal,
            "all_reduces_per_step": ranks[0]["all_reduces"],
            "halo_exchanges_per_step": ranks[0]["halo_exchanges"],
            "failed": failed}


def train_passes(system):
    """The networks one train step runs, a pass each: the G step's encz,
    encdec, d_seq and d_frame, then the D step's d_seq and d_frame on real
    and on fake."""
    m = system.modules
    return [m["encz"], m["encdec"], m["d_seq"], m["d_frame"]] + \
        [m["d_seq"], m["d_frame"]] * 2


def recomputed(net, count) -> int:
    """``count`` summed over the regions of ``net`` that a backward
    recomputes: each HRModule of a trunk under TPU.REMAT 'stage', the whole
    trunk under 'trunk'."""
    from ..models.hrnet import HRModule, HRNetTrunk

    n = 0
    for trunk in net.modules():
        if isinstance(trunk, HRNetTrunk):
            if trunk.remat == "trunk":
                n += count(trunk)
            elif trunk.remat == "stage":
                n += sum(count(m) for m in trunk.modules()
                         if isinstance(m, HRModule))
    return n


def model_train_collectives(system, spatial: int = 1) -> int:
    """All-reduces of one train step on each rank of a multi-process run,
    counted from the model: one per BN forward of any act (the batch
    statistics; the REMAT recompute of a BN runs it again), one per BN
    backward (kernel 2's sums for an ABN BN, the statistics' gradient for a
    ReLU BN), and one gradient bucket per optimizer; under a spatial layout
    a pooled posterior's global pool adds one forward and one backward."""
    from ..ops.norm import BatchNormAct

    def bns(net):
        return sum(isinstance(m, BatchNormAct) for m in net.modules())

    passes = train_passes(system)
    once = sum(bns(net) for net in passes)
    rec = sum(recomputed(net, bns) for net in passes)
    pool = 2 if spatial > 1 and not system.modules["encz"].hd_z else 0
    return (once + rec) + once + 2 + pool


# ---- planted faults -----------------------------------------------------------


def _local_stats(real):
    """batch_stats keeps this rank's (mean, E[x^2]): R x local, / R."""
    def fault(t):
        return real(t) * 0 + t * sync.world_size()
    return fault


def _local_abn_sums(real):
    """Kernel 3 handed this rank's kernel-2 sums, scaled to the global
    count: each rank's ABN backward as a plain BN's."""
    def fault(t, group=None):
        real(t.clone(), group)
        return t.mul_(sync.world_size())
    return fault


def _local_relu_stats_grad(real):
    """The ReLU BNs' statistics' gradient not summed over ranks (R x this
    rank's)."""
    def fault(ctx, dy):
        real(ctx, dy.clone())
        return dy * sync.world_size(), None
    return fault


def _no_grad_average(real):
    """Gradients summed over ranks, not averaged."""
    def fault(tensors):
        real(tensors)
        for t in tensors:
            t.mul_(sync.world_size())
    return fault


# name -> (the object and attribute the fault replaces, the fault)
FAULTS = {
    "local_stats": (sync, "all_reduce_sum", _local_stats),
    "local_abn_sums": (sync, "all_reduce_", _local_abn_sums),
    "local_relu_stats_grad": (sync._AllReduceSum, "backward",
                              _local_relu_stats_grad),
    "no_grad_average": (sync, "average_", _no_grad_average),
}


@contextlib.contextmanager
def plant(name: str) -> Iterator[None]:
    """Run the block with the fault ``name`` of :data:`FAULTS` planted."""
    owner, attr, make = FAULTS[name]
    real = getattr(owner, attr)
    fault = make(real)
    with unittest.mock.patch.object(
            owner, attr,
            staticmethod(fault) if isinstance(owner, type) else fault):
        yield
