"""Closed-loop VAE² training: ``VAE2System.train_step`` of
``core.builder.build_system(..., train=True)``, one G then one D update a
step, on a pool of seeded uint8 clip batches with their posterior noise
``eps`` and random code, one batch after another.

Set-up builds the system, loads the benchmark's weights and drives the
first ``checked_steps`` steps (pool batches 0, 1, 2: rows that all differ)
through the window's own call; they are the warm-up, and their readings
(losses, the first gradient from Adam's first moment, the parameters'
change over them) are what the check holds against the reference, which
follows the same steps from the same weights after the window."""

from __future__ import annotations

import time
from typing import Dict

import torch

from .. import compare, inputs, weights
from ..reference import nets, quant, steps

UNIT = "bench.step"


def counts(recipe: dict, traffic: dict) -> dict:
    """The work of one step, from the reference (``benchmark/counts.py``)."""
    from .. import counts as c

    return c.vae2_train(recipe, traffic["batch"])


def _config(recipe: dict):
    from vae2_tpu_torch.config import get_default_config

    cfg = get_default_config()
    cfg.defrost()
    cfg.merge_from_dict(recipe)
    cfg.freeze()
    return cfg


def _pool(run, recipe):
    t = run.traffic
    w, h = recipe["TRAIN"]["IMAGE_SIZE"]
    z_dim = recipe["MODEL"]["EXTRA"]["Z_DIM"]
    frames = recipe["TRAIN"]["CLIP_LENGTH"]
    b, n, dev = t["batch"], t["pool"], run.device
    g = torch.Generator(device=dev).manual_seed(inputs.sub_seed(run.seed, 2))
    data = inputs.clips(g, b * n, h, w, frames, t["coarse"], dev)
    eps = [inputs.normal(g, (b * n, z_dim, h >> k, w >> k), dev) for k in range(4)]
    code = inputs.normal(g, (b * n, z_dim), dev)
    return [{"batch": {k: v[i * b:(i + 1) * b] for k, v in data.items()},
             "eps": [e[i * b:(i + 1) * b] for e in eps],
             "code": code[i * b:(i + 1) * b]} for i in range(n)]


def norms(named, tensors) -> Dict[str, float]:
    """Each tensor's norm by name, read back in one copy."""
    vals = torch.stack([t.detach().float().norm() for t in tensors]).tolist()
    return dict(zip(named, vals))


def _step(state, i: int):
    item = state["pool"][i % len(state["pool"])]
    batch, eps, code = item["batch"], item["eps"], item["code"]
    if state["run"].fault == "half_batch":
        h = batch["xt"].shape[0] // 2
        batch = {k: v[:h] for k, v in batch.items()}
        eps, code = [e[:h] for e in eps], code[:h]
    metrics, _ = state["system"].train_step(batch, eps=eps, rand_code=code)
    return metrics


def setup(run) -> dict:
    from vae2_tpu_torch.core.builder import build_system

    recipe = run.config["recipe"]
    system = build_system(_config(recipe), train=True, device=run.device)
    state0 = weights.make_state(weights.skeleton(lambda: nets.vae2_modules(recipe)),
                                inputs.sub_seed(run.seed, 1), run.device)
    system.modules.load_state_dict(state0, strict=True)
    st = {"run": run, "system": system, "state0": state0, "pool": _pool(run, recipe),
          "recipe": recipe}
    losses, grad = [], {}
    for i in range(int(run.traffic["checked_steps"])):
        m = _step(st, i)
        losses.append({k: m[k] for k in ("loss_encdec", "loss_D")})
        if i == 0:
            grad = first_grads(system)
    named = list(system.modules.named_parameters())
    update = norms([n for n, _ in named], [p - state0[n] for n, p in named])
    st["prog"] = {"losses": [{k: float(v) for k, v in l.items()} for l in losses],
                  "grad": grad, "update": update}
    st["next"] = len(losses)
    return st


def first_grads(system) -> Dict[str, float]:
    """The first step's gradient of every leaf, as Adam holds it: its first
    moment over (1 - beta1); a leaf it has no state for, zero."""
    names = {p: n for n, p in system.modules.named_parameters()}
    leaves, grads = [], []
    for opt in (system.optimizer_g, system.optimizer_d):
        b1 = opt.param_groups[0]["betas"][0]
        for p in opt.param_groups[0]["params"]:
            leaves.append(names[p])
            grads.append(opt.state[p]["exp_avg"] / (1 - b1) if p in opt.state
                         else torch.zeros_like(p))
    return norms(leaves, grads)


def window(st, seconds: float) -> dict:
    run = st["run"]
    cuda = run.device.type == "cuda"
    bad = torch.zeros((), dtype=torch.int64, device=run.device)
    marks = []
    run.sync()
    t0 = time.perf_counter()
    n = 0
    while True:
        m = _step(st, st["next"])
        st["next"] += 1
        n += 1
        bad += (~torch.isfinite(m["loss_encdec"]) | ~torch.isfinite(m["loss_D"])).long()
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        if time.perf_counter() - t0 >= seconds:
            break
    run.sync()
    t1 = time.perf_counter()
    unit_s = [a.elapsed_time(b) * 1e-3 for a, b in zip(marks, marks[1:])]
    b = run.traffic["batch"]
    return {"kind": "train", "attempted": n, "failed": int(bad), "samples": n * b,
            "seconds": t1 - t0, "unit_s": unit_s}


def traced_unit(st) -> None:
    _step(st, st["next"])
    st["next"] += 1


def reference_readings(run, recipe, state0, pool, checked: int) -> dict:
    """The reference's losses, first gradients and change over the checked
    steps, in float32 with TF32 off (or in float8 under ``quant.fp8``)."""
    ref = weights.reference_on(run.device, lambda: nets.vae2_modules(recipe, remat=True),
                               state0)
    lr = recipe["TRAIN"]["LR"]
    gp = [(n, p) for n, p in ref.named_parameters() if n.split(".")[0] in ("encdec", "encz")]
    dp = [(n, p) for n, p in ref.named_parameters() if n.split(".")[0] in ("d_seq", "d_frame")]
    opt_g = steps.Adam([p for _, p in gp], lr)
    opt_d = steps.Adam([p for _, p in dp], lr)
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
                grad.update(norms([n for n, _ in gp], opt_g.first_grads()))
                grad.update(norms([n for n, _ in dp], opt_d.first_grads()))
    named = list(ref.named_parameters())
    update = norms([n for n, _ in named], [p - state0[n] for n, p in named])
    return {"losses": losses, "grad": grad, "update": update}


def control(run) -> Dict[str, float]:
    """The check's numbers for the reference in float8 in the program's
    place, against the reference in float32 (``benchmark.calibrate``)."""
    recipe = run.config["recipe"]
    state0 = weights.make_state(weights.skeleton(lambda: nets.vae2_modules(recipe)),
                                inputs.sub_seed(run.seed, 1), run.device)
    args = (run, recipe, state0, _pool(run, recipe), int(run.traffic["checked_steps"]))
    ref = reference_readings(*args)
    with quant.fp8():
        low = reference_readings(*args)
    return {**compare.train_numbers(low, ref), "worst_leaves": compare.worst_leaves(low, ref)}


def check(st) -> Dict[str, float]:
    run = st["run"]
    st.pop("system")
    _free(run)
    ref = reference_readings(run, st["recipe"], st["state0"], st["pool"],
                             len(st["prog"]["losses"]))
    st["ref"] = ref
    return compare.train_numbers(st["prog"], ref)


def _free(run) -> None:
    import gc

    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
