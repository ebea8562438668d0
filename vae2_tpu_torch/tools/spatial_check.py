"""Checks of spatial (H) sharding: ranks that split each image's rows
against one process on the whole image.

Shared by ``tests/test_torch_port_spatial.py`` (gloo ranks on the CPU) and
``chip_smoke.py`` (gloo ranks that share one card):

- :func:`op_outputs`: the halo'd ops of one rank (the 3x3 convolutions of
  stride 1 and 2, the 1x1 one, the 2x, 4x and 8x upsample) on its rows of
  a seeded whole tensor, with the input gradient of a seeded cotangent;
- :func:`model_halo_exchanges`: the halo exchanges of one train step on
  each rank, counted from the model;
- :data:`FAULTS`, :data:`POOLED_FAULTS` and :func:`plant`: the faults
  that the design guards against, each planted so that the number of
  collectives stays the same.
  ``chip_smoke.py`` runs the spatial flagship step again with each of
  :data:`FAULTS` planted and fails unless each is caught; the CPU test
  holds each of both against the check that it breaks.

The tiny G/D steps and their checks are ``ddp_check.tiny_steps`` and
``ddp_check.check_tiny``, which take the layout from ``parallel/sync.py``.
"""

from __future__ import annotations

import contextlib
import unittest.mock
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ..parallel import sync

# the ops: name -> (kind, kernel or factor, stride); a convolution's whole
# input is OP_SHAPE (N, C, H, W), an upsample's (N, C, UP_ROWS, W): rows
# that split evenly, and evenly again after a stride 2, over 2 and 4 ranks
OP_SHAPE = (2, 3, 16, 5)
UP_ROWS = 8
OPS = {"conv3x3_s1": ("conv", 3, 1), "conv3x3_s2": ("conv", 3, 2),
       "conv1x1": ("conv", 1, 1), "up2": ("up", 2, 1), "up4": ("up", 4, 1),
       "up8": ("up", 8, 1)}
OP_OUT_CHANNELS = 4


def op_inputs(name: str) -> Dict[str, np.ndarray]:
    """The seeded whole tensors of op ``name``: x, the conv weight (O, C,
    k, k) and the output cotangent."""
    kind, k, stride = OPS[name]
    n, c, h, w = OP_SHAPE
    rng = np.random.RandomState(sorted(OPS).index(name))
    if kind == "up":
        x = rng.randn(n, c, UP_ROWS, w).astype(np.float32)
        out = (n, c, UP_ROWS * k, w * k)
        weight = np.zeros((0,), np.float32)
    else:
        x = rng.randn(n, c, h, w).astype(np.float32)
        weight = rng.randn(OP_OUT_CHANNELS, c, k, k).astype(np.float32)
        p = (k - 1) // 2
        out = (n, OP_OUT_CHANNELS, (h + 2 * p - k) // stride + 1,
               (w + 2 * p - k) // stride + 1)
    return {"x": x, "weight": weight,
            "dy": rng.randn(*out).astype(np.float32)}


def op_outputs(name: str, device="cpu") -> Dict[str, torch.Tensor]:
    """Op ``name`` on this rank's block of rows of :func:`op_inputs`,
    through the port's own modules (``models.hrnet.Conv2d``,
    ``ops.image.resize_bilinear``): y and dx = the vector-Jacobian product
    of this rank's rows of the cotangent, on the CPU. Concatenated over a
    spatial group in rank order, they are the whole tensor's."""
    from ..models.hrnet import _conv
    from ..ops.image import resize_bilinear

    kind, k, stride = OPS[name]
    arrays = op_inputs(name)
    s, j = sync.spatial_size(), sync.spatial_rank()

    def rows(a):
        h = a.shape[2] // s
        return torch.from_numpy(
            np.ascontiguousarray(a[:, :, j * h:(j + 1) * h])).to(device)

    x = rows(arrays["x"]).contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    if kind == "up":
        y = resize_bilinear(x, x.shape[2] * k, x.shape[3] * k)
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
        h = y.shape[2] // blocks
        total = sum(y[:, :, i * h:(i + 1) * h].sum(dim=(2, 3),
                                                 dtype=torch.float32)
                    for i in range(blocks))
        return (total / (y.shape[2] * y.shape[3])).to(y.dtype)

    with unittest.mock.patch.object(vae2, "_global_pool", pool):
        yield


# ---- counted from the model ------------------------------------------------


def _forward_halos(net) -> Tuple[int, int]:
    """(halo exchanges of one forward of ``net``, of which inside
    HRModules): one per convolution taller than one row, one per upsample
    (every FuseLayer pair of a lower branch into a higher one, and the
    heads' upsample of branches 1.. to branch 0: once for the concat or
    presum head input, once per head for 'multiscale', once for a pooled
    posterior)."""
    from ..models.hrnet import Conv2d, ConvHead, FuseLayer, HRModule
    from ..models.vae2 import (VAE2Discriminator, VAE2Posterior,
                               _TrunkWithHeads)

    def convs(mod):
        return sum(isinstance(m, Conv2d) and m.kernel_size[0] > 1
                   for m in mod.modules())

    def fuse_ups(mod):
        return sum(len(m.in_channels) * (len(m.in_channels) - 1) // 2
                   for m in mod.modules() if isinstance(m, FuseLayer))

    total = convs(net) + fuse_ups(net)
    for m in net.modules():
        if isinstance(m, (_TrunkWithHeads, VAE2Discriminator)):
            ups = m.trunk.specs[3].num_branches - 1
            heads = sum(isinstance(c, ConvHead) for c in m.children())
            total += ups * (heads if m.head_dataflow == "multiscale" else 1)
        elif isinstance(m, VAE2Posterior) and not m.hd_z:
            total += m.trunk.specs[3].num_branches - 1
    inside = sum(convs(m) + fuse_ups(m) for m in net.modules()
                 if isinstance(m, HRModule))
    return total, inside


def model_halo_exchanges(system) -> int:
    """Halo exchanges of one train step on each rank of a spatial layout,
    counted from the model (``ddp_check.train_passes``): each pass's
    forward ones, those inside HRModules once more (the REMAT 'stage'
    recompute), and one backward per forward, but for the first
    convolution of the six passes that read clips, which need no input
    gradient (the G step's encz and encoder, the D step's four
    discriminator passes)."""
    from .ddp_check import train_passes

    once = rec = 0
    for net in train_passes(system):
        total, inside = _forward_halos(net)
        once, rec = once + total, rec + inside
    return once + rec + once - 6


# ---- planted faults ---------------------------------------------------------


def _seam_rows(t, top, bottom, keep):
    """``t`` (the halo'd rows) with the halo rows that came from another
    rank replaced by ``keep(t, side)``."""
    s, j = sync.spatial_size(), sync.spatial_rank()
    t = t.clone()
    h = t.shape[2] - top - bottom
    if top and j > 0:
        t[:, :, :top] = keep(t, "top")
    if bottom and j < s - 1:
        t[:, :, top + h:] = keep(t, "bottom")
    return t


def _zero_seams(real):
    """A convolution's halo rows at the seam replaced by zeros: each shard
    convolved as an image of its own."""
    def fault(x, top, bottom, mode="zeros"):
        t = real(x, top, bottom, mode)
        if mode != "zeros":
            return t
        return _seam_rows(t, top, bottom, lambda t, side: 0.0)
    return fault


def _clamped_upsample(real):
    """The upsample clamped at the shard's edge: the seam's halo row is a
    copy of the shard's own edge row."""
    def fault(x, top, bottom, mode="zeros"):
        t = real(x, top, bottom, mode)
        if mode != "edge":
            return t
        return _seam_rows(t, top, bottom, lambda t, side: (
            t[:, :, top:top + 1] if side == "top"
            else t[:, :, t.shape[2] - bottom - 1:t.shape[2] - bottom]))
    return fault


def _dropped_halo_backward(real):
    """The halo backward dropped: the gradient of the borrowed rows never
    reaches their owner (the exchange still runs)."""
    def fault(ctx, dy):
        real(ctx, dy)
        h = dy.shape[2] - ctx.top - ctx.bottom
        return dy[:, :, ctx.top:ctx.top + h].clone(), None, None, None
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


@contextlib.contextmanager
def plant(name: str) -> Iterator[None]:
    """Run the block with the fault ``name`` of :data:`FAULTS` or
    :data:`POOLED_FAULTS` planted."""
    owner, attr, make = {**FAULTS, **POOLED_FAULTS}[name]
    real = getattr(owner, attr)
    fault = make(real)
    with unittest.mock.patch.object(
            owner, attr,
            staticmethod(fault) if isinstance(owner, type) else fault):
        yield
