"""The work a cell's unit asks for, counted from the reference at the
cell's shapes on the meta device (no memory, no arithmetic): the model
FLOPs (forward and backward, no recompute) that ``mfu.*`` reads, and the
bytes and operations of the identity-activation BNs that
``abn_roofline.*`` reads. The counts are kept in each cell's file under
``workloads/`` and held to this code by a CPU test, so that a change to
the program never moves the yardstick.

BN work per call on an (N, C, H, W) tensor of n elements in a dtype of b
bytes, each input read once and each output written once: the forward
reads x and writes y (2bn) and reads four f32 vectors (16C), in training
also writes gamma * inv_std (4C); the backward's sums read y and dz (2bn)
and gamma, beta (8C) and write two sums (8C); its dx reads y and dz and
writes dx (3bn) and reads five f32 vectors (20C). Operations: 3 per
element forward, 4 for the sums, 6 for dx.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference import nets, steps

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def _record_bns(module) -> Tuple[List[Tuple[int, int]], list]:
    calls: List[Tuple[int, int]] = []

    def hook(m, args, out):
        calls.append((args[0].numel(), args[0].shape[1]))

    handles = [m.register_forward_hook(hook) for m in nets.identity_bns(module)]
    return calls, handles


def abn_work(calls, dtype_bytes: int, train: bool) -> Dict[str, float]:
    b = dtype_bytes
    nbytes = ops = 0.0
    for n, c in calls:
        nbytes += 2 * b * n + 16 * c + (4 * c if train else 0)
        ops += 3 * n
        if train:
            nbytes += (2 * b * n + 16 * c) + (3 * b * n + 20 * c)
            ops += 10 * n
    return {"abn_bytes": nbytes, "abn_ops": ops, "abn_calls": len(calls)}


def _recipe_shape(recipe):
    w, h = recipe["TRAIN"]["IMAGE_SIZE"]
    return h, w


def vae2_train(recipe: dict, batch: int) -> Dict[str, float]:
    """One G then D step at ``batch`` clips."""
    h, w = _recipe_shape(recipe)
    extra = recipe["MODEL"]["EXTRA"]
    z_dim, frames = extra["Z_DIM"], recipe["TRAIN"]["CLIP_LENGTH"]
    dev = torch.device("meta")
    with dev:
        mods = nets.vae2_modules(recipe)
    calls, handles = _record_bns(mods)
    data = {k: torch.zeros((batch, h, w, 3 * frames), dtype=torch.uint8, device=dev)
            for k in ("xt", "x2t", "x3t")}
    eps = [torch.zeros((batch, z_dim, h >> b, w >> b), device=dev) for b in range(4)]
    code = torch.zeros((batch, z_dim), device=dev)
    opt_g = steps.Adam(steps.g_params(mods), 1e-4)
    opt_d = steps.Adam(steps.d_params(mods), 1e-4)
    lam = {"x1": 1.0, "x2": 0.1, "x3": 1.0, "gan": 1.0}
    with FlopCounterMode(display=False) as fc:
        steps.vae2_step(mods, opt_g, opt_d, data, eps, code, lam)
    for hd in handles:
        hd.remove()
    dtype = recipe["TPU"]["DTYPE"]
    return {"flops": float(fc.get_total_flops()),
            **abn_work(calls, DTYPE_BYTES[dtype], train=True)}


def vae2_prior(recipe: dict, samples: int) -> Dict[str, float]:
    """One test clip: the encoder prefix once, ``samples`` prior samples
    through the rest, and the scores of their x2 and x3 predictions."""
    from .reference import scores

    h, w = _recipe_shape(recipe)
    extra = recipe["MODEL"]["EXTRA"]
    z_dim, frames = extra["Z_DIM"], recipe["TRAIN"]["CLIP_LENGTH"]
    dev = torch.device("meta")
    with dev:
        encdec = nets.vae2_modules(recipe)["encdec"].eval()
    calls, handles = _record_bns(encdec)
    clip = torch.zeros((1, h, w, 3 * frames), dtype=torch.uint8, device=dev)
    z = [torch.zeros((samples, z_dim, h >> b, w >> b), device=dev) for b in range(4)]
    code = torch.zeros((samples, z_dim), device=dev)
    with FlopCounterMode(display=False) as fc:
        _, x2p, x3p = steps.prior_samples(encdec, clip, z, code)
        for p in (x2p, x3p):
            scores.frame_scores(p.permute(0, 2, 3, 1), clip)
    for hd in handles:
        hd.remove()
    dtype = recipe["TPU"]["DTYPE"]
    return {"flops": float(fc.get_total_flops()),
            **abn_work(calls, DTYPE_BYTES[dtype], train=False)}


def seg_train(recipe: dict, batch: int, h: int, w: int) -> Dict[str, float]:
    """One segmentation step at ``batch`` crops of h x w."""
    dev = torch.device("meta")
    classes = recipe["DATASET"]["NUM_CLASSES"]
    with dev:
        net = nets.seg_module(recipe)
    calls, handles = _record_bns(net)
    images = torch.zeros((batch, 3, h, w), device=dev)
    labels = torch.zeros((batch, h, w), dtype=torch.int32, device=dev)
    weights = torch.ones(classes, device=dev)
    opt = steps.SGD(net.parameters(), 0.01, 0.9, 5e-4)
    with FlopCounterMode(display=False) as fc:
        steps.seg_step(net, opt, images, labels, weights, -1)
    for hd in handles:
        hd.remove()
    dtype = recipe["TPU"]["DTYPE"]
    return {"flops": float(fc.get_total_flops()),
            **abn_work(calls, DTYPE_BYTES[dtype], train=True)}
