"""Checks of spatial (H) sharding: ranks that split each image's rows
against one process on the whole image.

Shared by ``tests/test_torch_port_spatial.py`` (gloo ranks on the CPU) and
``chip_smoke.py`` (gloo ranks that share one card):

- :func:`op_outputs`: the halo'd ops of one rank (the 3x3 convolutions of
  stride 1 and 2, the 1x1 one, the 2x, 4x and 8x upsample, and resizes of
  no integer factor) on its rows of a seeded whole tensor, at heights that
  split evenly and at branches that do not (:data:`OPS`), with the input
  gradient of a seeded cotangent;
- :func:`model_halo_exchanges`: the halo exchanges of one train step on
  each rank, and :func:`model_train_launches_on_rank` its kernel launches
  on a rank that may own no rows of some branches, counted from the model;
- :data:`FAULTS`, :data:`POOLED_FAULTS`, :data:`UNEVEN_FAULTS` and
  :func:`plant`: the faults that the design guards against, each planted
  so that the number of collectives stays the same.
  ``chip_smoke.py`` runs the spatial flagship step again with each of
  :data:`FAULTS` planted, and its uneven layout with each of
  :data:`UNEVEN_FAULTS`, and fails unless each is caught; the CPU test
  holds each against the check that it breaks.

The tiny G/D steps and their checks are ``ddp_check.tiny_steps`` and
``ddp_check.check_tiny``, which take the layout from ``parallel/sync.py``.
"""

from __future__ import annotations

import contextlib
import re
import unittest.mock
import zlib
from typing import Dict, Iterator

import numpy as np
import torch

from ..parallel import sync

# the ops: name -> (kind, kernel (a convolution) or None (a resize),
# stride, the image (H, W) that sets the branches' sizes, the input's
# branch, the output's branch). A branch's (H, W) is the image's halved b
# times, rounding up, as the trunk's stride-2 convolutions take it; a rank
# owns ``sync.row_range`` of its rows. The first six split evenly over 2
# and 4 ranks; the rest are at the branches of a 24x40 image (24, 12, 6, 3
# rows: over 4 ranks branch 2 holds 2/2/2/0 rows and branch 3 1/1/1/0,
# over 2 branch 3 holds 2/1) and of a 20x40 one (20, 10, 5, 3 rows: its
# resizes from 3 rows are no integer factor)
OPS = {"conv3x3_s1": ("conv", 3, 1, (16, 5), 0, 0),
       "conv3x3_s2": ("conv", 3, 2, (16, 5), 0, 1),
       "conv1x1": ("conv", 1, 1, (16, 5), 0, 0),
       "up2": ("up", None, 1, (16, 10), 1, 0),
       "up4": ("up", None, 1, (32, 20), 2, 0),
       "up8": ("up", None, 1, (64, 40), 3, 0),
       "uneven_conv3x3_s1_b2": ("conv", 3, 1, (24, 40), 2, 2),
       "uneven_conv3x3_s1_b3": ("conv", 3, 1, (24, 40), 3, 3),
       "uneven_conv3x3_s2_b1": ("conv", 3, 2, (24, 40), 1, 2),
       "uneven_conv3x3_s2_b2": ("conv", 3, 2, (24, 40), 2, 3),
       "uneven_conv1x1_b3": ("conv", 1, 1, (24, 40), 3, 3),
       "uneven_up2_b3": ("up", None, 1, (24, 40), 3, 2),
       "uneven_up4_b3": ("up", None, 1, (24, 40), 3, 1),
       "uneven_up8_b3": ("up", None, 1, (24, 40), 3, 0),
       "uneven_up2_b2": ("up", None, 1, (24, 40), 2, 1),
       "uneven_up4_b2": ("up", None, 1, (24, 40), 2, 0),
       "uneven_conv3x3_s2_b2_h20": ("conv", 3, 2, (20, 40), 2, 3),
       "uneven_up_b3_b2_h20": ("up", None, 1, (20, 40), 3, 2),
       "uneven_up_b3_b0_h20": ("up", None, 1, (20, 40), 3, 0)}
OP_BATCH, OP_CHANNELS, OP_OUT_CHANNELS = 2, 3, 4


def branch_size(image, b: int):
    """(H, W) of branch ``b`` of an image of (H, W)."""
    h, w = image
    for _ in range(b):
        h, w = -(-h // 2), -(-w // 2)
    return h, w


def op_inputs(name: str) -> Dict[str, np.ndarray]:
    """The seeded whole tensors of op ``name``: x, the conv weight (O, C,
    k, k) and the output cotangent."""
    kind, k, stride, image, b_in, b_out = OPS[name]
    n, c = OP_BATCH, OP_CHANNELS
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    x = rng.randn(n, c, *branch_size(image, b_in)).astype(np.float32)
    if kind == "up":
        out = (n, c) + branch_size(image, b_out)
        weight = np.zeros((0,), np.float32)
    else:
        weight = rng.randn(OP_OUT_CHANNELS, c, k, k).astype(np.float32)
        p = (k - 1) // 2
        h, w = x.shape[2:]
        out = (n, OP_OUT_CHANNELS, (h + 2 * p - k) // stride + 1,
               (w + 2 * p - k) // stride + 1)
    return {"x": x, "weight": weight,
            "dy": rng.randn(*out).astype(np.float32)}


def op_outputs(name: str, device="cpu") -> Dict[str, torch.Tensor]:
    """Op ``name`` on this rank's rows (``sync.own_rows``) of
    :func:`op_inputs`, through the port's own modules
    (``models.hrnet.Conv2d``, ``ops.image.resize_bilinear``): y and dx =
    the vector-Jacobian product of this rank's rows of the cotangent, on
    the CPU. Concatenated over a spatial group in rank order, they are the
    whole tensor's."""
    from ..models.hrnet import _conv
    from ..ops.image import resize_bilinear

    kind, k, stride, image, _, b_out = OPS[name]
    arrays = op_inputs(name)
    sync.set_image(*image)

    def rows(a):
        start, stop = sync.own_rows(a.shape[2])
        return torch.from_numpy(
            np.ascontiguousarray(a[:, :, start:stop])).to(device)

    x = rows(arrays["x"]).contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    if kind == "up":
        h, w = branch_size(image, b_out)
        start, stop = sync.own_rows(h)
        y = resize_bilinear(x, stop - start, w)
    else:
        conv = _conv(x.shape[1], OP_OUT_CHANNELS, k, stride).to(device)
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(arrays["weight"]))
        y = conv(x)
    y.backward(rows(arrays["dy"]))
    return {"y": y.detach().cpu(), "dx": x.grad.cpu()}


@contextlib.contextmanager
def pool_in_blocks(blocks: int = 2) -> Iterator[None]:
    """One process's pooled posterior (HD_Z False) with its global pool
    summed in f32 over ``blocks`` blocks of rows, as ``blocks`` spatial
    ranks sum it: the rounding control of that network. Its pooled vectors
    go through a BN over the batch, which amplifies their rounding: on the
    CPU the tiny step's G gradient moves by 2.7% (encdec) and 4.2% (encz)
    between the two orders, where a one-ulp move of the clips moves it by
    0.6%."""
    from ..models import vae2

    def pool(y):
        total = sum(y[:, :, slice(*sync.row_range(y.shape[2], i, blocks))]
                    .sum(dim=(2, 3), dtype=torch.float32)
                    for i in range(blocks))
        return (total / (y.shape[2] * y.shape[3])).to(y.dtype)

    with unittest.mock.patch.object(vae2, "_global_pool", pool):
        yield


# ---- counted from the model ------------------------------------------------


def _halos(mod) -> int:
    """Halo exchanges of one forward of ``mod``'s trunk parts: one per
    convolution taller than one row, one per FuseLayer pair of a lower
    branch into a higher one."""
    from ..models.hrnet import Conv2d, FuseLayer

    return sum(isinstance(m, Conv2d) and m.kernel_size[0] > 1
               for m in mod.modules()) + sum(
        len(m.in_channels) * (len(m.in_channels) - 1) // 2
        for m in mod.modules() if isinstance(m, FuseLayer))


def _forward_halos(net) -> int:
    """Halo exchanges of one forward of ``net``: those of its trunk parts,
    and the heads' upsample of branches 1.. to branch 0 (once for the
    concat or presum head input, once per head for 'multiscale', once for a
    pooled posterior)."""
    from ..models.hrnet import ConvHead
    from ..models.vae2 import (VAE2Discriminator, VAE2Posterior,
                               _TrunkWithHeads)

    total = _halos(net)
    for m in net.modules():
        if isinstance(m, (_TrunkWithHeads, VAE2Discriminator)):
            ups = m.trunk.specs[3].num_branches - 1
            heads = sum(isinstance(c, ConvHead) for c in m.children())
            total += ups * (heads if m.head_dataflow == "multiscale" else 1)
        elif isinstance(m, VAE2Posterior) and not m.hd_z:
            total += m.trunk.specs[3].num_branches - 1
    return total


def model_halo_exchanges(system) -> int:
    """Halo exchanges of one train step on each rank of a spatial layout,
    counted from the model (``ddp_check.train_passes``): each pass's
    forward ones, those of its recomputed regions once more (TPU.REMAT:
    each HRModule under 'stage', the trunk under 'trunk';
    ``ddp_check.recomputed``), and one backward per forward, but for the
    first convolution of the six passes that read clips, which need no
    input gradient (the G step's encz and encoder, the D step's four
    discriminator passes)."""
    from .ddp_check import recomputed, train_passes

    once = rec = 0
    for net in train_passes(system):
        once += _forward_halos(net)
        rec += recomputed(net, _halos)
    return once + rec + once - 6


_BRANCH_OF = (  # a BN's name -> the branch of the map it normalizes
    (re.compile(r"transition(\d+)\.new\d+_(\d+)_bn$"),
     lambda t, j: int(t) + int(j)),
    (re.compile(r"transition\d+\.adapt(\d+)_bn$"), int),
    (re.compile(r"transition3_e\.inject(\d+)_bn$"), int),
    (re.compile(r"fuse\.up_\d+_(\d+)_bn$"), int),
    (re.compile(r"fuse\.down_\d+_(\d+)_(\d+)_bn$"),
     lambda j, k: int(j) + int(k) + 1),
    (re.compile(r"_module\d+\.branch(\d+)\."), int))


def bn_branch(name: str) -> int:
    """The branch whose map the BN ``name`` of a trunk network normalizes:
    a transition's new branch t + j after its j-th stride-2 convolution
    (transition t leaves stage t's t branches), a FuseLayer up-BN branch j
    (before its upsample), a down chain's k-th BN branch j + k + 1, a
    branch's blocks and a transition's adapter or injection their own; the
    stem, stage 1 and the heads branch 0."""
    for pattern, branch in _BRANCH_OF:
        m = pattern.search(name)
        if m:
            return branch(*m.groups())
    return 0


def model_train_launches_on_rank(system, image, spatial: int, rank: int):
    """(kernel 1, kernels 2-3) launches of one train step on spatial rank
    ``rank`` of ``spatial`` of an image of (H, W), counted from the model
    as ``chip_smoke.model_train_launches`` counts them, but for the ABN BNs
    of the branches where this rank owns no rows (``sync.row_range``),
    whose kernels launch nothing."""
    from ..ops.norm import BatchNormAct
    from .ddp_check import recomputed, train_passes

    def live(net):
        out = []
        for name, m in net.named_modules():
            if not isinstance(m, BatchNormAct) or m.act == "relu":
                continue
            h = branch_size(image, bn_branch(name))[0]
            a, b = sync.row_range(h, rank % spatial, spatial)
            out.append(m) if b > a else None
        return out

    passes = train_passes(system)
    bwd = sum(len(live(net)) for net in passes)
    live_ids = {id(m) for net in passes for m in live(net)}
    rec = sum(recomputed(net, lambda mod: sum(
        id(m) in live_ids for m in mod.modules())) for net in passes)
    return bwd + rec, bwd


# ---- planted faults ---------------------------------------------------------


def _borrowed(plan):
    """(window start, length, source) of the runs of a halo plan that come
    from other ranks."""
    out, i = [], 0
    for src, _, n in plan.runs:
        if src >= 0:
            out.append((i, n, src))
        i += n
    return out


def _seam_rows(real, mode, keep):
    """``sync.halo_rows`` with the rows borrowed from other ranks replaced
    by ``keep(t, start, n, own)`` when the window's mode is ``mode``
    (``own``: the window's (first, last) own rows)."""
    def fault(x, height, windows, mode_="zeros"):
        t = real(x, height, windows, mode_)
        if mode_ != mode:
            return t
        plan = sync.halo_plan(height, tuple(tuple(w) for w in windows),
                              mode_, sync.spatial_rank())
        own = [i for i, (src, _, n) in enumerate(plan.runs) if src == -2]
        starts = [sum(n for _, _, n in plan.runs[:k]) for k in own]
        if not own:
            return t
        first = starts[0]
        last = starts[-1] + plan.runs[own[-1]][2] - 1
        t = t.clone()
        for i, n, _ in _borrowed(plan):
            t[:, :, i:i + n] = keep(t, i, n, (first, last))
        return t
    return fault


def _zero_seams(real):
    """A convolution's halo rows from other ranks replaced by zeros: each
    shard convolved as an image of its own."""
    return _seam_rows(real, "zeros", lambda t, i, n, own: 0.0)


def _clamped_upsample(real):
    """The upsample clamped at the shard's edge: each row borrowed from
    another rank is a copy of the shard's own nearest edge row."""
    def keep(t, i, n, own):
        row = own[0] if i < own[0] else own[1]
        return t[:, :, row:row + 1]
    return _seam_rows(real, "edge", keep)


def _dropped_halo_backward(real):
    """The halo backward dropped: the gradient of the borrowed rows never
    reaches their owner (the exchange still runs)."""
    def fault(ctx, dy):
        real(ctx, dy)
        return sync._own_rows_grad(ctx.plan, dy), None
    return fault


def _grads_by_world(real):
    """Gradients divided by the world size, not by the data shards."""
    def fault(tensors):
        real(tensors)
        for t in tensors:
            t.mul_(sync.data_size() / sync.world_size())
    return fault


def _noise_by_world_rank(real):
    """Noise sliced by world rank: the global draw of world-size blocks of
    this rank's shape, of which it keeps block ``rank``."""
    def fault(shape, generator, dtype=None, device=None):
        r, shape = sync.world_size(), tuple(shape)
        full = torch.randn((shape[0] * r,) + shape[1:], generator=generator,
                           dtype=dtype, device=device)
        b = shape[0]
        return full[sync.rank() * b:(sync.rank() + 1) * b].contiguous()
    return fault


class _LocalGradSum(torch.autograd.Function):
    """The spatial SUM with a backward that all-reduces the gradient as the
    correct one does and then keeps this rank's own."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return sync._all_reduce(x.detach().clone(
            memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, dy):
        sync._all_reduce(dy.clone(memory_format=torch.contiguous_format),
                         ctx.group)
        return dy, None


def _pool_grad_local(real):
    """The pooled posterior's global pool with its gradient not summed over
    the spatial group: each rank's pooled rows get only its own loss's
    gradient (the collectives stay the same)."""
    def fault(x):
        return _LocalGradSum.apply(x, sync._LAYOUT["spatial_group"])
    return fault


def _stats_by_rank_count(real):
    """The BN statistics divided by the rank count, not by the global row
    count: each rank's own means, summed over the ranks and divided by R
    (right only where every rank holds as many rows; a rank that holds
    none gives 0/0). The one all-reduce stays."""
    def fault(x):
        dims = (0,) + tuple(range(2, x.dim()))
        xf = x.float()
        mean, mean2 = (sync.all_reduce_sum(torch.stack(
            [xf.mean(dims), (xf * xf).mean(dims)])) / sync.world_size()
        ).unbind(0)
        return mean, torch.clamp(mean2 - mean * mean, min=0.0)
    return fault


# name -> (the object and attribute the fault replaces, the fault)
FAULTS = {
    "zero_seams": (sync, "halo_rows", _zero_seams),
    "clamped_upsample": (sync, "halo_rows", _clamped_upsample),
    "dropped_halo_backward": (sync._HaloRows, "backward",
                              _dropped_halo_backward),
    "grads_by_world": (sync, "average_", _grads_by_world),
    "noise_by_world_rank": (sync, "randn_rows", _noise_by_world_rank),
}
# the faults of the pooled posterior (HD_Z False), which the flagship step
# (HD_Z True) never runs: planted in the CPU test's pooled steps only
POOLED_FAULTS = {"pool_grad_local": (sync, "spatial_sum", _pool_grad_local)}
# the faults that only unequal row shards show: planted in the CPU test's
# steps at 24 rows and in chip_smoke.py's uneven spatial phase
UNEVEN_FAULTS = {"stats_by_rank_count": ("abn", "batch_stats",
                                         _stats_by_rank_count)}


@contextlib.contextmanager
def plant(name: str) -> Iterator[None]:
    """Run the block with the fault ``name`` of :data:`FAULTS`,
    :data:`POOLED_FAULTS` or :data:`UNEVEN_FAULTS` planted."""
    from ..ops import abn

    owner, attr, make = {**FAULTS, **POOLED_FAULTS, **UNEVEN_FAULTS}[name]
    owner = abn if owner == "abn" else owner
    real = getattr(owner, attr)
    fault = make(real)
    with unittest.mock.patch.object(
            owner, attr,
            staticmethod(fault) if isinstance(owner, type) else fault):
        yield
