"""VAE² training over several ranks: ``drivers/vae2_train``'s closed loop
on every rank (``VAE2System.train_step`` of ``build_system(...,
train=True)``, one G then one D update a step) in the program's process
group, where its BNs reduce their statistics over the ranks (SyncBN) and
its optimizers average the gradients.

Every rank makes the same seeded pool of ``pool`` global batches of
``batch`` x ``ranks`` clip triples, each with its posterior noise ``eps``
and random code, and keeps rows ``[batch r, batch (r + 1))`` of each. The
same weights load on every rank. Set-up drives the first
``checked_steps`` steps through the window's own call, planted with the
calibration's fault where one is asked for, and keeps their readings
(losses, the first gradient from Adam's first moment, the parameters'
change over them, and the change of every BN's running statistics, which
the exchange of the statistics alone sets); the check holds them against
the plain data-parallel reference (``reference/dp.py``) on the same rows,
weights and noise.

The window: after each step rank 0 reads its clock and broadcasts go on
or stop over the harness's gloo side group, so that every rank runs the
same whole steps; no device synchronise is added. Its samples are the
global batch's clip triples.
"""

from __future__ import annotations

import contextlib
import sys
import time
import types
import unittest.mock
from types import SimpleNamespace
from typing import Dict

import torch
import torch.distributed as dist

from .. import compare, inputs, weights
from ..reference import dp, nets, quant
from . import vae2_train as single

UNIT = single.UNIT
counts = single.counts
traced_unit = single.traced_unit
# faults of the program's collectives that the calibration plants in the
# checked steps: ``local_stats`` and ``no_grad_average`` of
# ``vae2_tpu_torch.tools.ddp_check.FAULTS``, and ``no_exchange``, the
# exchange between cards left out (the statistics of each rank's own rows,
# each rank's own gradient); ``half_batch`` is ``vae2_train``'s own
PROGRAM_FAULTS = ("local_stats", "no_grad_average", "no_exchange")


def _rank():
    """(rank, ranks) of this process in the program's group; (0, 1) alone."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _pool(run, recipe):
    """This rank's rows of the pool of global batches."""
    t, b = run.traffic, run.traffic["batch"]
    r, _ = _rank()
    full = single._pool(SimpleNamespace(traffic=dict(t, batch=b * t["ranks"]),
                                        device=run.device, seed=run.seed), recipe)
    rows = slice(r * b, (r + 1) * b)
    return [{"batch": {k: v[rows].clone() for k, v in item["batch"].items()},
             "eps": [e[rows].clone() for e in item["eps"]],
             "code": item["code"][rows].clone()} for item in full]


def _planted(fault: str):
    stack = contextlib.ExitStack()
    if fault in PROGRAM_FAULTS:
        from vae2_tpu_torch.parallel import sync
        from vae2_tpu_torch.tools import ddp_check

        if fault == "no_exchange":
            stack.enter_context(ddp_check.plant("local_stats"))
            stack.enter_context(unittest.mock.patch.object(sync, "average_", lambda t: None))
        else:
            stack.enter_context(ddp_check.plant(fault))
    return stack


def _barrier(run) -> None:
    if run.group is not None:
        dist.barrier(group=run.group)


def setup(run) -> dict:
    from vae2_tpu_torch.core.builder import build_system

    recipe = run.config["recipe"]
    system = build_system(single._config(recipe), train=True, device=run.device)
    state0 = weights.make_state(weights.skeleton(lambda: nets.vae2_modules(recipe)),
                                inputs.sub_seed(run.seed, 1), run.device)
    system.modules.load_state_dict(state0, strict=True)
    st = {"run": run, "system": system, "state0": state0, "pool": _pool(run, recipe),
          "recipe": recipe}
    losses, grad = [], {}
    with _planted(run.fault):
        for i in range(int(run.traffic["checked_steps"])):
            m = single._step(st, i)
            losses.append({k: m[k] for k in ("loss_encdec", "loss_D")})
            if i == 0:
                grad = single.first_grads(system)
    named = list(system.modules.named_parameters())
    update = single.norms([n for n, _ in named], [p - state0[n] for n, p in named])
    st["prog"] = {"losses": [{k: float(v) for k, v in l.items()} for l in losses],
                  "grad": grad, "update": update,
                  "stats": running_changes(system.modules, state0)}
    st["next"] = len(losses)
    run.sync()
    _barrier(run)  # set-up ends when every rank's has
    return st


def running_changes(module, state0) -> Dict[str, torch.Tensor]:
    """Each BN's running mean and variance less its value in ``state0``,
    by name, on the host (one copy)."""
    named = [(n, b) for n, b in module.named_buffers()
             if n.endswith((".running_mean", ".running_var"))]
    flat = torch.cat([(b.float() - state0[n]).reshape(-1) for n, b in named]).cpu()
    return dict(zip([n for n, _ in named], flat.split([b.numel() for _, b in named])))


def _rank_fault(run) -> None:
    """The harness's own faults of a rank (its tests): the last rank fails,
    hangs, or loads a module named ``jax``, in its first window step."""
    r, n = _rank()
    if r == n - 1 and run.fault == "rank_fails":
        raise RuntimeError("planted: the last rank fails in the window")
    if r == n - 1 and run.fault == "rank_hangs":
        time.sleep(3600)
    if r == n - 1 and run.fault == "loads_jax":
        sys.modules.setdefault("jax", types.ModuleType("jax"))


def window(st, seconds: float) -> dict:
    run = st["run"]
    cuda = run.device.type == "cuda"
    bad = torch.zeros((), dtype=torch.int64, device=run.device)
    stop = torch.zeros(1, dtype=torch.int32)
    marks = []
    run.sync()
    _barrier(run)
    t0 = time.perf_counter()
    n = 0
    while True:
        m = single._step(st, st["next"])
        st["next"] += 1
        n += 1
        bad += (~torch.isfinite(m["loss_encdec"]) | ~torch.isfinite(m["loss_D"])).long()
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        _rank_fault(run)
        stop[0] = int(time.perf_counter() - t0 >= seconds)
        if run.group is not None:
            dist.broadcast(stop, 0, group=run.group)
        if stop[0]:
            break
    run.sync()
    t1 = time.perf_counter()
    unit_s = [a.elapsed_time(b) * 1e-3 for a, b in zip(marks, marks[1:])]
    samples = n * run.traffic["batch"] * _rank()[1]
    return {"kind": "train", "attempted": n, "failed": int(bad), "samples": samples,
            "seconds": t1 - t0, "unit_s": unit_s}


def reference_readings(run, recipe, state0, pool, checked: int) -> dict:
    """``vae2_train.reference_readings`` with every BN synced over the
    ranks and the gradients averaged over them (``reference/dp.py``)."""
    from ..reference import steps

    ref = weights.reference_on(
        run.device, lambda: dp.synced(nets.vae2_modules(recipe, remat=True)), state0)
    lr = recipe["TRAIN"]["LR"]
    gp = [(n, p) for n, p in ref.named_parameters() if n.split(".")[0] in ("encdec", "encz")]
    dq = [(n, p) for n, p in ref.named_parameters() if n.split(".")[0] in ("d_seq", "d_frame")]
    opt_g = dp.Adam([p for _, p in gp], lr)
    opt_d = dp.Adam([p for _, p in dq], lr)
    t = recipe["TRAIN"]
    lam = {"x1": t["X1RECON_LAMBDA"], "x2": t["X2RECON_LAMBDA"],
           "x3": t["X3RECON_LAMBDA"], "gan": t["GAN_LAMBDA"]}
    losses, grad = [], {}
    with quant.exact_f32():
        for i in range(checked):
            item = pool[i]
            losses.append({k: float(v) for k, v in steps.vae2_step(
                ref, opt_g, opt_d, item["batch"], item["eps"], item["code"], lam).items()})
            if i == 0:
                grad.update(single.norms([n for n, _ in gp], opt_g.first_grads()))
                grad.update(single.norms([n for n, _ in dq], opt_d.first_grads()))
    named = list(ref.named_parameters())
    update = single.norms([n for n, _ in named], [p - state0[n] for n, p in named])
    return {"losses": losses, "grad": grad, "update": update,
            "stats": running_changes(ref, state0)}


def control(run) -> Dict[str, float]:
    """The check's numbers for the data-parallel reference in float8 in the
    program's place, against it in float32 (``benchmark.calibrate``)."""
    recipe = run.config["recipe"]
    state0 = weights.make_state(weights.skeleton(lambda: nets.vae2_modules(recipe)),
                                inputs.sub_seed(run.seed, 1), run.device)
    args = (run, recipe, state0, _pool(run, recipe), int(run.traffic["checked_steps"]))
    ref = reference_readings(*args)
    with quant.fp8():
        low = reference_readings(*args)
    return {**numbers(low, ref), "worst_leaves": compare.worst_leaves(low, ref)}


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``compare.train_numbers`` and the running statistics' gaps."""
    return {**compare.train_numbers(prog, ref),
            **compare.stats_numbers(prog["stats"], ref["stats"])}


def check(st) -> Dict[str, float]:
    run = st["run"]
    st.pop("system")
    single._free(run)
    ref = reference_readings(run, st["recipe"], st["state0"], st["pool"],
                             len(st["prog"]["losses"]))
    st["ref"] = ref
    return numbers(st["prog"], ref)
