"""Two-host multi-process training rehearsal of the port (counterpart of
tools/multihost_rehearsal.py).

Rehearses the multi-host contract on one machine: two launcher processes,
one per "host", each ``python -m torch.distributed.run --nnodes 2
--node_rank i --nproc_per_node P --master_addr 127.0.0.1 --master_port
<free>`` (static rendezvous, gloo pinned to the loopback interface) on a
worker that joins the group through ``parallel.dist.initialize_distributed``
and lays out TPU.MESH (``parallel.mesh.init_layout``) as the train CLI
does. Each worker checks torchrun's layout (WORLD_SIZE 2P, RANK = i * P +
LOCAL_RANK), takes its device by the train CLI's rule (``cuda:LOCAL_RANK``
for ``--device cuda``: with P = 1, rank 1 lands on cuda:0), its data shard
by ``sync.data_rank`` of a global batch of 8 made of the two hosts' slices
(``np.random.RandomState(host)``, the JAX tool's per-host slices), and
under TPU.MESH.SPATIAL S its rows by ``sync.row_range``, and runs one
adversarial step. Rank 0 then prints ``multihost rehearsal PASSED`` only
if the loss is finite, the ranks' updated states are bitwise equal, and
the step matches one process on the global batch within ``ddp_check``'s
bounds: losses (summed over each spatial group) and running statistics to
FORWARD_RTOL, each network's gradient within CONTROL_FACTOR x the larger
distance of two controls from the one process (or x TINY_GAP_FLOOR), and
the all-reduces and halo exchanges per step those the model counts. The
controls: a one-ulp move of the clips, and the one process with its BN
statistics reduced in the ranks' blocks (``ddp_check.stats_in_blocks``:
the reduction order of SyncBN, which moves d_frame's gradient ~7x as far
as the one-ulp move at four ranks). The one-process step and its controls
run in the launcher before the hosts start.

    python -m vae2_tpu_torch.tools.multihost_rehearsal [--device cpu] \
        [--nproc-per-host P] [--cfg recipe.yaml] [KEY VALUE ...]

Without ``--cfg`` the tiny debug spec of ``ddp_check.tiny_config`` (f32,
REMAT 'stage', Adam 1e-3); with it, the recipe and its overrides (f32
steps compute with TF32 off). ``--fault local_rank`` plants the fault this
rehearsal exists to catch: each worker's rank taken from LOCAL_RANK, so
that both hosts load shard 0.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import unittest.mock
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..parallel import sync
from . import ddp_check

HOSTS = 2
GLOBAL_BATCH = 8
FAULTS = ("none", "local_rank")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="two-host rehearsal (PyTorch)")
    ap.add_argument("--nproc-per-host", default=1, type=int)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (each rank on cuda:LOCAL_RANK), 'cuda:N' "
                         "(every rank on card N; GPU.DIST_BACKEND gloo) or "
                         "'cpu'")
    ap.add_argument("--cfg", default="",
                    help="a recipe (default: ddp_check's tiny spec)")
    ap.add_argument("--fault", default="none", choices=FAULTS)
    ap.add_argument("--workdir", default="",
                    help="where the ranks' results go (default: a new "
                         "temporary directory)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("opts", nargs=argparse.REMAINDER,
                    help="KEY VALUE config overrides")
    return ap.parse_args(argv)


def make_config(args):
    from ..config import update_config

    if not args.cfg:
        config = ddp_check.tiny_config()
        config.defrost()
        config.merge_from_list(list(args.opts))
        config.freeze()
        return config
    from ..config import get_default_config

    return update_config(get_default_config(), argparse.Namespace(
        cfg=args.cfg, opts=list(args.opts)))


def global_batch(config) -> Dict[str, np.ndarray]:
    """The global batch: the hosts' slices in host order."""
    return {k: np.concatenate([host_slice(config, h)[k]
                               for h in range(HOSTS)])
            for k in ("xt", "x2t", "x3t")}


def host_slice(config, host: int) -> Dict[str, np.ndarray]:
    """Host ``host``'s clips of the global batch: GLOBAL_BATCH / HOSTS
    seeded uint8 clips per key, as the JAX tool makes them."""
    w, h = config.TRAIN.IMAGE_SIZE
    rng = np.random.RandomState(host)
    n = GLOBAL_BATCH // HOSTS
    return {k: rng.randint(0, 255, (n, h, w, 9), np.uint8)
            for k in ("xt", "x2t", "x3t")}


def step(config, device, clips: Dict[str, np.ndarray], scale: float = 1.0
         ) -> dict:
    """One adversarial step of a freshly built system (seed 0) on
    ``clips``, noise from a generator seeded 1 (the global batch's draws,
    of which a rank keeps its rows), f32 with TF32 off; ``scale`` moves the
    normalized clips (the one-ulp control). Returns, on the CPU, the
    losses, gradients, state, kernel launches, all-reduces and their count
    from the model."""
    from ..core.builder import build_system
    from ..data.loader import normalize_clips
    from ..ops import abn
    from ..utils.device import exact_f32

    from .spatial_check import model_halo_exchanges

    system = build_system(config, seed=0, device=device, train=True)
    batch = {k: torch.from_numpy(v).to(device) for k, v in clips.items()}
    if scale != 1.0:
        batch = {k: normalize_clips(v) * scale for k, v in batch.items()}
    kernels = ("abn_rows", "abn_bwd_sums", "abn_bwd_dx")
    before = {k: getattr(abn, k).launches for k in kernels}
    sync.reset_stats()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with exact_f32():
        metrics, _ = system.train_step(
            batch, torch.Generator(device=device).manual_seed(1))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    return {
        "seconds": seconds,
        "collective_seconds": sync.STATS["seconds"],
        "halo_seconds": sync.STATS["halo_seconds"],
        "losses": {k: float(v) for k, v in metrics.items()},
        "grads": {k: p.grad.detach().cpu() for k, p in
                  system.modules.named_parameters()},
        "state": {k: v.detach().cpu() for k, v in
                  system.modules.state_dict().items()},
        "launches": {k: getattr(abn, k).launches - before[k]
                     for k in kernels},
        "all_reduces": sync.STATS["all_reduces"],
        "all_reduces_from_model": ddp_check.model_train_collectives(
            system, sync.spatial_size()),
        "halo_exchanges": sync.STATS["halo_exchanges"],
        "halo_exchanges_from_model": (model_halo_exchanges(system)
                                      if sync.spatial_size() > 1 else 0),
    }


def compare(ranks: List[dict], one: dict, control: dict, blocks: dict,
            spatial: int = 1) -> dict:
    """The ranks' step (``spatial`` ranks per spatial group) against one
    process on the global batch, its one-ulp control and its control with
    the statistics reduced in the ranks' blocks, with ``ddp_check``'s
    bounds. Returns the readings and ``failed``, the checks that did not
    hold."""
    failed = []
    if not all(math.isfinite(v) for r in ranks for v in r["losses"].values()):
        failed.append("finite")
    loss_err = 0.0
    for k, w in one["losses"].items():
        got = sum(r["losses"][k] for r in ranks) / (len(ranks) // spatial)
        scale = (1 + abs(w)) if k == "loss_z_KL" else abs(w)
        if not abs(got - w) <= ddp_check.FORWARD_RTOL * scale:
            failed.append(f"loss {k}")
        loss_err = max(loss_err, abs(got - w) / (abs(w) + 1e-6))
    stats_err = 0.0
    for r in ranks:
        for k, w in one["state"].items():
            if "running_" not in k:
                continue
            diff = (r["state"][k] - w).abs()
            stats_err = max(stats_err, float(diff.max()))
            tol = ddp_check.FORWARD_RTOL * (1.0 + float(w.abs().max())
                                            + w.abs())
            if not bool((diff <= tol).all()):
                failed.append(f"running stats {k}")
    ulp = ddp_check.net_gaps(control["grads"], one["grads"])
    order = ddp_check.net_gaps(blocks["grads"], one["grads"])
    gaps = [ddp_check.net_gaps(r["grads"], one["grads"]) for r in ranks]
    bounds = {net: ddp_check.CONTROL_FACTOR * max(
        ulp[net], order[net], ddp_check.TINY_GAP_FLOOR)
        for net in ddp_check.NETS}
    for net in ddp_check.NETS:
        if not all(g[net] <= bounds[net] for g in gaps):
            failed.append(f"grads {net}")
    a = ranks[0]["state"]
    equal = all(r["state"].keys() == a.keys()
                and all(torch.equal(a[k], r["state"][k]) for k in a)
                for r in ranks[1:])
    if not equal:
        failed.append("bitwise")
    if any(r["all_reduces"] != r["all_reduces_from_model"] for r in ranks):
        failed.append("all_reduces")
    if any(r["halo_exchanges"] != r["halo_exchanges_from_model"]
           for r in ranks):
        failed.append("halo_exchanges")
    return {"spatial": spatial, "loss_max_rel_err": loss_err,
            "stats_max_abs_err": stats_err,
            "grad_gaps_rank0": gaps[0], "grad_gaps_control": ulp,
            "grad_gaps_stats_blocks": order, "grad_bounds": bounds,
            "control_factor": ddp_check.CONTROL_FACTOR,
            "ranks_bitwise_equal": equal,
            "losses_rank0": ranks[0]["losses"],
            "launches_per_rank": [r["launches"] for r in ranks],
            "all_reduces_per_rank": [r["all_reduces"] for r in ranks],
            "all_reduces_from_model": ranks[0]["all_reduces_from_model"],
            "step_seconds_per_rank": [r["seconds"] for r in ranks],
            "all_reduce_seconds_per_rank": [r["collective_seconds"]
                                            for r in ranks],
            "halo_seconds_per_rank": [r["halo_seconds"] for r in ranks],
            "one_process_step_seconds": one["seconds"],
            "halo_exchanges_per_rank": [r["halo_exchanges"] for r in ranks],
            "halo_exchanges_from_model": ranks[0][
                "halo_exchanges_from_model"],
            "failed": failed}


def worker(args) -> int:
    """One rank: joins the group, runs its rows of the step, saves them;
    rank 0 compares every rank with the one-process step."""
    import torch.distributed as dist

    from ..parallel.dist import initialize_distributed, shutdown_distributed
    from ..parallel.mesh import init_layout
    from .train import _rank_device

    env = {k: int(os.environ[k]) for k in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "GROUP_RANK", "LOCAL_WORLD_SIZE")}
    p = env["LOCAL_WORLD_SIZE"]
    if not (env["WORLD_SIZE"] == HOSTS * p
            and env["RANK"] == env["GROUP_RANK"] * p + env["LOCAL_RANK"]):
        raise AssertionError(f"torchrun's layout is not {HOSTS} hosts x {p} "
                             f"ranks: {env}")
    config = make_config(args)
    rank, world, local_rank = initialize_distributed(
        config.GPU.DIST_BACKEND, torch.device(args.device).type)
    try:
        device = _rank_device(args.device, local_rank, world)
        if args.device == "cuda" and device.index != local_rank:
            raise AssertionError(f"rank {rank} (local rank {local_rank}) "
                                 f"is on {device}")
        init_layout(config, world)
        patch = (unittest.mock.patch.object(sync, "rank",
                                            lambda: local_rank)
                 if args.fault == "local_rank" else contextlib.nullcontext())
        with patch:
            shard = sync.data_rank()
            n = GLOBAL_BATCH // sync.data_size()
            height = int(config.TRAIN.IMAGE_SIZE[1])
            rows = slice(*sync.own_rows(height))
            clips = {k: v[shard * n:(shard + 1) * n, rows]
                     for k, v in global_batch(config).items()}
            result = step(config, device, clips)
        result.update(rank=rank, device=str(device), shard=shard)
        print(f"[rank {rank} of {world}, host {env['GROUP_RANK']}, local "
              f"rank {local_rank}] on {device}, data shard {shard}: "
              f"loss_encdec {result['losses']['loss_encdec']:.4f}",
              flush=True)
        torch.save(result, os.path.join(args.workdir, f"rank{rank}.pt"))
        dist.barrier()
        ok = True
        if rank == 0:
            load = lambda name: torch.load(  # noqa: E731
                os.path.join(args.workdir, name), weights_only=True)
            line = compare([load(f"rank{r}.pt") for r in range(world)],
                           load("one.pt"), load("control.pt"),
                           load("blocks.pt"), sync.spatial_size())
            line["devices"], line["shards"] = zip(*(
                (r["device"], r["shard"]) for r in
                (load(f"rank{r}.pt") for r in range(world))))
            with open(os.path.join(args.workdir, "verdict.json"), "w") as f:
                json.dump(line, f)
            ok = not line["failed"]
            print(json.dumps(line), flush=True)
            if ok:
                print("multihost rehearsal PASSED", flush=True)
        dist.barrier()
    finally:
        shutdown_distributed()
    return 0 if ok else 1


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Launch the two hosts; returns rank 0's verdict (exits non-zero
    unless the rehearsal passed)."""
    args = parse_args(argv)
    if args.worker:
        raise SystemExit(worker(args))
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    workdir = args.workdir or tempfile.mkdtemp(prefix="vae2_multihost_")
    os.makedirs(workdir, exist_ok=True)
    config = make_config(args)
    whole = global_batch(config)
    p = args.nproc_per_host
    spatial = int(config.TPU.MESH.SPATIAL)
    runs = {"one": step(config, device, whole),
            "control": step(config, device, whole, scale=1.0 + 2.0**-23)}
    with ddp_check.stats_in_blocks(HOSTS * p // spatial, spatial):
        runs["blocks"] = step(config, device, whole)
    for name, run in runs.items():
        torch.save(run, os.path.join(workdir, f"{name}.pt"))
    del runs
    if device.type == "cuda":
        torch.cuda.empty_cache()

    port = free_port()
    # the hosts share this machine's cores: each rank gets its part of them
    # (oversubscribed OpenMP threads slowed a CPU rehearsal 3x)
    threads = max(1, (os.cpu_count() or 1) // (HOSTS * p))
    env = {"OMP_NUM_THREADS": str(threads), **os.environ,
           "GLOO_SOCKET_IFNAME": "lo"}
    passthrough = ["--device", args.device, "--fault", args.fault,
                   "--workdir", workdir]
    if args.cfg:
        passthrough += ["--cfg", args.cfg]
    # where there are cards enough, each host sees its own P of them, as a
    # real host would (its ranks then take cuda:LOCAL_RANK of those)
    own_cards = (args.device == "cuda"
                 and torch.cuda.device_count() >= HOSTS * p)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes",
         str(HOSTS), "--node_rank", str(i), "--nproc_per_node", str(p),
         "--master_addr", "127.0.0.1", "--master_port", str(port), "-m",
         "vae2_tpu_torch.tools.multihost_rehearsal", "--worker",
         *passthrough, *args.opts],
        env={**env, "CUDA_VISIBLE_DEVICES": ",".join(
            str(c) for c in range(i * p, (i + 1) * p))} if own_cards
        else env) for i in range(HOSTS)]
    rcs = [p.wait() for p in procs]
    path = os.path.join(workdir, "verdict.json")
    verdict = {"failed": ["no verdict"]}
    if os.path.isfile(path):
        with open(path) as f:
            verdict = json.load(f)
    verdict["host_exit_codes"] = rcs
    print(json.dumps({"multihost_rehearsal": verdict}), flush=True)
    if rcs != [0] * HOSTS or verdict["failed"]:
        raise SystemExit(f"multihost rehearsal FAILED: exit codes {rcs}, "
                         f"failed checks {verdict['failed']}")
    print("multihost rehearsal PASSED", flush=True)
    return verdict


if __name__ == "__main__":
    main()
