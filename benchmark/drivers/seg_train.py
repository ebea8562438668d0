"""Closed-loop HRNetV2 segmentation training: the step of
``core.seg_loop.make_seg_train_step`` on the ``SegHRNet`` that
``tools/train_seg.py`` builds (``get_seg_model``, ``make_optimizer`` of
TRAIN: SGD with momentum and weight decay), class-weighted cross entropy,
on a pool of seeded crops (float images, int labels with some pixels at
the ignore label), one batch after another.

Set-up drives the first ``checked_steps`` steps (pool batches 0, 1, 2),
the warm-up; the check holds their losses, the first gradient (from the
momentum buffer after one step, less the weight decay's term) and the
parameters' change over them against the float32 reference."""

from __future__ import annotations

import time
from typing import Dict

import torch

from .. import compare, inputs, weights
from ..reference import nets, quant, steps
from .vae2_train import _config, _free, norms

UNIT = "bench.step"


def counts(recipe: dict, traffic: dict) -> dict:
    """The work of one step, from the reference."""
    from .. import counts as c

    w, h = traffic["crop"]
    return c.seg_train(recipe, traffic["batch"], h, w)


def _pool(run, recipe):
    t, dev = run.traffic, run.device
    w, h = t["crop"]
    b, n = t["batch"], t["pool"]
    g = torch.Generator(device=dev).manual_seed(inputs.sub_seed(run.seed, 2))
    ims = inputs.images(g, b * n, h, w, t["coarse"], dev)
    lab = inputs.labels(g, b * n, h, w, recipe["DATASET"]["NUM_CLASSES"], t["coarse"],
                        t["ignore_share"], recipe["TRAIN"]["IGNORE_LABEL"], dev)
    return [(ims[i * b:(i + 1) * b], lab[i * b:(i + 1) * b]) for i in range(n)]


def _step(st, i: int):
    images, labels = st["pool"][i % len(st["pool"])]
    if st["run"].fault == "half_batch":
        h = images.shape[0] // 2 or 1
        images, labels = images[:h], labels[:h]
    return st["step"](images, labels)


def setup(run) -> dict:
    from vae2_tpu_torch.core.seg_loop import make_seg_train_step
    from vae2_tpu_torch.core.system import make_optimizer
    from vae2_tpu_torch.models.seg_hrnet import get_seg_model

    recipe, dev = run.config["recipe"], run.device
    cfg = _config(recipe)
    model = get_seg_model(cfg)
    model.to(dev)
    optimizer = make_optimizer(model.parameters(), cfg.TRAIN)
    state0 = weights.make_state(weights.skeleton(lambda: nets.seg_module(recipe)),
                                inputs.sub_seed(run.seed, 1), dev)
    model.load_state_dict(state0, strict=True)
    cw = run.config["class_weights"]
    step = make_seg_train_step(model, optimizer, ignore_label=recipe["TRAIN"]["IGNORE_LABEL"],
                               class_weights=cw)
    st = {"run": run, "model": model, "optimizer": optimizer, "step": step,
          "state0": state0, "pool": _pool(run, recipe), "recipe": recipe}
    losses, grad = [], {}
    wd = recipe["TRAIN"]["WD"]
    names = {p: n for n, p in model.named_parameters()}
    for i in range(int(run.traffic["checked_steps"])):
        losses.append({"loss": _step(st, i)})
        if i == 0:
            leaves = [p for p in optimizer.param_groups[0]["params"]]
            grad = norms([names[p] for p in leaves],
                         [optimizer.state[p]["momentum_buffer"] - wd * state0[names[p]]
                          if p in optimizer.state else torch.zeros_like(p)
                          for p in leaves])
    named = list(model.named_parameters())
    update = norms([n for n, _ in named], [p - state0[n] for n, p in named])
    st["prog"] = {"losses": [{k: float(v) for k, v in l.items()} for l in losses],
                  "grad": grad, "update": update}
    st["next"] = len(losses)
    return st


def window(st, seconds: float) -> dict:
    run = st["run"]
    cuda = run.device.type == "cuda"
    bad = torch.zeros((), dtype=torch.int64, device=run.device)
    marks = []
    run.sync()
    t0 = time.perf_counter()
    n = 0
    while True:
        loss = _step(st, st["next"])
        st["next"] += 1
        n += 1
        bad += (~torch.isfinite(loss)).long()
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        if time.perf_counter() - t0 >= seconds:
            break
    run.sync()
    t1 = time.perf_counter()
    return {"kind": "train", "attempted": n, "failed": int(bad),
            "samples": n * run.traffic["batch"], "seconds": t1 - t0,
            "unit_s": [a.elapsed_time(b) * 1e-3 for a, b in zip(marks, marks[1:])]}


def traced_unit(st) -> None:
    _step(st, st["next"])
    st["next"] += 1


def reference_readings(run, recipe, state0, pool, checked: int, class_weights) -> dict:
    t = recipe["TRAIN"]
    net = weights.reference_on(run.device, lambda: nets.seg_module(recipe), state0)
    named = list(net.named_parameters())
    opt = steps.SGD([p for _, p in named], t["LR"], t["MOMENTUM"], t["WD"])
    cw = torch.tensor(class_weights, dtype=torch.float32, device=run.device)
    losses, grad = [], {}
    with quant.exact_f32():
        for i in range(checked):
            images, labels = pool[i]
            losses.append({k: float(v) for k, v in steps.seg_step(
                net, opt, images, labels, cw, t["IGNORE_LABEL"]).items()})
            if i == 0:
                grad = norms([n for n, _ in named],
                             [b - t["WD"] * state0[n] for (n, _), b in zip(named, opt.buf)])
    update = norms([n for n, _ in named], [p - state0[n] for n, p in named])
    return {"losses": losses, "grad": grad, "update": update}


def control(run) -> Dict[str, float]:
    """The check's numbers for the reference in float8 in the program's
    place, against the reference in float32 (``benchmark.calibrate``)."""
    recipe = run.config["recipe"]
    state0 = weights.make_state(weights.skeleton(lambda: nets.seg_module(recipe)),
                                inputs.sub_seed(run.seed, 1), run.device)
    args = (run, recipe, state0, _pool(run, recipe), int(run.traffic["checked_steps"]),
            run.config["class_weights"])
    ref = reference_readings(*args)
    with quant.fp8():
        low = reference_readings(*args)
    return {**compare.train_numbers(low, ref), "worst_leaves": compare.worst_leaves(low, ref)}


def check(st) -> Dict[str, float]:
    run = st["run"]
    for k in ("model", "optimizer", "step"):
        st.pop(k)
    _free(run)
    ref = reference_readings(run, st["recipe"], st["state0"], st["pool"],
                             len(st["prog"]["losses"]), run.config["class_weights"])
    st["ref"] = ref
    return compare.train_numbers(st["prog"], ref)
