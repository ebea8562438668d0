"""Closed-loop HRNetV2-W48 + OCR training: ``core.seg_loop.
make_seg_train_step`` on the ``SegHRNetOCR`` that ``get_seg_model`` builds
for MODEL.NAME 'seg_hrnet_ocr', its two outputs' class-weighted cross
entropy summed with LOSS.BALANCE_WEIGHTS, SGD with momentum and weight
decay, on ``seg_train``'s pool of seeded crops, one batch after another.

Set-up drives the first ``checked_steps`` steps as ``seg_train`` does, and
after each reads the keep mask that the program's ``Dropout2d`` applied
(``ocr_distri_head.dropout.mask``); the float32 reference
(``reference/ocr.py``) takes those masks, so that both drop the same
channels. It also keeps the first step's two logit maps, from the seeded
weights before any update.

The check: ``compare.train_numbers`` and the first step's ``aux_gap`` and
``out_gap``, each output's relative gap ||prog - ref|| / ||ref|| over the
batch (infinite where the program's batch is not the reference's). At the
seeded weights the soft object regions weight most pixels alike, so the
region vectors differ little and the BNs over their B*K rows divide by
that small spread: a rounding of the trunk's features moves the keys,
values and ``out`` far more than it moves ``aux``, and its effect grows
over the steps, so that the losses and the gradients of a bfloat16 run
stray as far as a float8 one's. The limits take ``aux_gap`` (the trunk
and the auxiliary head: it tells the precision apart), ``out_gap`` (the
head) and ``update_gap_median`` (a state left unchanged reads 1).

``run.fault`` plants a fault in the program: ``half_batch``
(``seg_train``'s), ``no_context`` (the object attention's context
zeroed), ``gather_over_classes`` (the gather's softmax over the classes
of each pixel, not over the pixels of each class)."""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from .. import compare, inputs, weights
from ..reference import ocr, quant, steps
from . import seg_train
from .vae2_train import _config, _free, norms

UNIT = seg_train.UNIT
window = seg_train.window
traced_unit = seg_train.traced_unit


def counts(recipe: dict, traffic: dict) -> dict:
    """The work of one step at the traffic's crops, from the reference on
    the meta device: its model FLOPs (forward and backward) and the bytes
    and operations of the trunk's identity-activation BNs (the head's BNs
    all take a ReLU), as ``counts.seg_train`` counts W48's."""
    from torch.utils.flop_counter import FlopCounterMode

    from .. import counts as c

    w, h = traffic["crop"]
    batch, dev = traffic["batch"], torch.device("meta")
    with dev:
        net = ocr.ocr_module(recipe)
    calls, handles = c._record_bns(net)
    images = torch.zeros((batch, 3, h, w), device=dev)
    labels = torch.zeros((batch, h, w), dtype=torch.int32, device=dev)
    mask = torch.ones((batch, recipe["MODEL"]["OCR"]["MID_CHANNELS"], 1, 1), device=dev)
    opt = steps.SGD(net.parameters(), 0.01, 0.9, 5e-4)
    with FlopCounterMode(display=False) as fc:
        ocr.ocr_step(net, opt, images, labels, mask,
                     torch.ones(recipe["DATASET"]["NUM_CLASSES"], device=dev), -1,
                     recipe["LOSS"]["BALANCE_WEIGHTS"])
    for hd in handles:
        hd.remove()
    return {"flops": float(fc.get_total_flops()),
            **c.abn_work(calls, c.DTYPE_BYTES[recipe["TPU"]["DTYPE"]], train=True)}


def program(run, recipe: dict, state0: dict) -> dict:
    """{'run', 'recipe', 'model', 'optimizer', 'step', 'state0'}: the
    program's network of ``recipe`` (``get_seg_model``), loaded with the
    benchmark's weights ``state0``, and its ``make_seg_train_step`` (class
    weights of the configuration, LOSS.BALANCE_WEIGHTS), built as
    ``tools/train_seg.py`` builds them."""
    from vae2_tpu_torch.core.seg_loop import make_seg_train_step
    from vae2_tpu_torch.core.system import make_optimizer
    from vae2_tpu_torch.models.seg_hrnet import get_seg_model

    cfg = _config(recipe)
    model = get_seg_model(cfg)
    model.to(run.device)
    optimizer = make_optimizer(model.parameters(), cfg.TRAIN)
    model.load_state_dict(state0, strict=True)
    step = make_seg_train_step(model, optimizer, ignore_label=recipe["TRAIN"]["IGNORE_LABEL"],
                               class_weights=run.config["class_weights"],
                               balance_weights=recipe["LOSS"]["BALANCE_WEIGHTS"])
    return {"run": run, "recipe": recipe, "model": model, "optimizer": optimizer,
            "step": step, "state0": state0}


def readings(st: dict, checked: int, after: Callable[[], None]) -> dict:
    """Drive ``checked`` steps of the pool (``after()`` runs after each)
    and read them: the losses, the first gradient from the momentum buffer
    after one step less the weight decay's term, the parameters' change
    over the steps."""
    model, optimizer, state0 = st["model"], st["optimizer"], st["state0"]
    wd = st["recipe"]["TRAIN"]["WD"]
    names = {p: n for n, p in model.named_parameters()}
    losses, grad = [], {}
    for i in range(checked):
        losses.append(float(seg_train._step(st, i)))
        after()
        if i == 0:
            leaves = list(optimizer.param_groups[0]["params"])
            grad = norms([names[p] for p in leaves],
                         [optimizer.state[p]["momentum_buffer"] - wd * state0[names[p]]
                          if p in optimizer.state else torch.zeros_like(p) for p in leaves])
    named = list(model.named_parameters())
    update = norms([n for n, _ in named], [p - state0[n] for n, p in named])
    return {"losses": [{"loss": x} for x in losses], "grad": grad, "update": update}


def initial_state(run, recipe: dict) -> dict:
    """The benchmark's weights of the run's seed (``seg_train``'s draw)."""
    return weights.make_state(weights.skeleton(lambda: ocr.ocr_module(recipe)),
                              inputs.sub_seed(run.seed, 1), run.device)


def _over_classes(feats: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """The gather with its softmax over the classes (the planted fault)."""
    b, c = feats.shape[:2]
    w = torch.softmax(probs.float(), dim=1).flatten(2)   # (B, K, HW)
    rows = feats.permute(0, 2, 3, 1).reshape(b, -1, c).float()
    return torch.bmm(w, rows).transpose(1, 2).unsqueeze(3)


def _plant(model, fault: str) -> None:
    if fault == "no_context":
        block = model.ocr_distri_head.object_context_block
        attend = block.forward
        block.forward = lambda x, proxy: torch.zeros_like(attend(x, proxy))
    elif fault == "gather_over_classes":
        model.ocr_gather_head.forward = _over_classes


def setup(run) -> dict:
    recipe = run.config["recipe"]
    st = program(run, recipe, initial_state(run, recipe))
    _plant(st["model"], run.fault)
    st["pool"] = seg_train._pool(run, recipe)
    dropout = st["model"].ocr_distri_head.dropout
    masks, outputs = [], []
    hook = st["model"].register_forward_hook(
        lambda module, args, out: outputs.extend(o.detach().clone() for o in out))

    def after() -> None:
        masks.append(dropout.mask.clone())
        hook.remove()  # the first step's forward alone (an eager call)

    checked = int(run.traffic["checked_steps"])
    st["prog"] = readings(st, checked, after)
    st["prog"]["outputs"] = outputs
    st["masks"] = masks
    st["next"] = checked
    return st


def _full(mask: torch.Tensor, batch: int) -> torch.Tensor:
    """A step's keep mask for the whole batch (a half-batch fault's has
    fewer rows: the rest kept)."""
    if mask.shape[0] == batch:
        return mask
    rest = torch.ones((batch - mask.shape[0],) + tuple(mask.shape[1:]), device=mask.device)
    return torch.cat([mask, rest])


def reference_readings(run, recipe, state0, pool, masks) -> dict:
    t = recipe["TRAIN"]
    net = weights.reference_on(run.device, lambda: ocr.ocr_module(recipe), state0)
    named = list(net.named_parameters())
    opt = steps.SGD([p for _, p in named], t["LR"], t["MOMENTUM"], t["WD"])
    cw = torch.tensor(run.config["class_weights"], dtype=torch.float32, device=run.device)
    losses, grad, outputs = [], {}, []
    with quant.exact_f32():
        for i, mask in enumerate(masks):
            images, labels = pool[i]
            mask = _full(mask, images.shape[0])
            if i == 0:
                with torch.no_grad():
                    outputs = net(images, mask)
            losses.append({k: float(v) for k, v in ocr.ocr_step(
                net, opt, images, labels, mask, cw,
                t["IGNORE_LABEL"], recipe["LOSS"]["BALANCE_WEIGHTS"]).items()})
            if i == 0:
                grad = norms([n for n, _ in named],
                             [b - t["WD"] * state0[n] for (n, _), b in zip(named, opt.buf)])
    update = norms([n for n, _ in named], [p - state0[n] for n, p in named])
    return {"losses": losses, "grad": grad, "update": update, "outputs": outputs}


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``compare.train_numbers``, and the first step's ``aux_gap`` and
    ``out_gap``."""
    gaps = {f"{name}_gap": compare.frame_gap([p], [r]) if p.shape == r.shape else math.inf
            for name, p, r in zip(("aux", "out"), prog["outputs"], ref["outputs"])}
    return {**compare.train_numbers(prog, ref), **gaps}


def drawn_masks(run, recipe, batch: int, steps: int):
    """Seeded keep masks, each (sample, channel) kept with probability
    1 - DROPOUT, for runs that have no program to read them from."""
    ocr_cfg = recipe["MODEL"]["OCR"]
    g = torch.Generator(device=run.device).manual_seed(inputs.sub_seed(run.seed, 3))
    shape = (batch, ocr_cfg["MID_CHANNELS"], 1, 1)
    return [(torch.rand(shape, generator=g, device=run.device) >= ocr_cfg["DROPOUT"]).float()
            for _ in range(steps)]


def control(run) -> Dict[str, float]:
    """The check's numbers for the reference in float8 in the program's
    place, against the reference in float32 (``benchmark.calibrate``)."""
    recipe = run.config["recipe"]
    checked = int(run.traffic["checked_steps"])
    args = (run, recipe, initial_state(run, recipe), seg_train._pool(run, recipe),
            drawn_masks(run, recipe, run.traffic["batch"], checked))
    ref = reference_readings(*args)
    with quant.fp8():
        low = reference_readings(*args)
    return {**numbers(low, ref), "worst_leaves": compare.worst_leaves(low, ref)}


def check(st) -> Dict[str, float]:
    run = st["run"]
    for k in ("model", "optimizer", "step"):
        st.pop(k)
    _free(run)
    st["ref"] = reference_readings(run, st["recipe"], st["state0"], st["pool"], st["masks"])
    return numbers(st["prog"], st["ref"])
