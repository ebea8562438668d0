"""Plain data parallelism over :mod:`nets` and :mod:`steps`: the
mathematics of a training step of several ranks, each on its own rows of
the global batch.

- :class:`SyncBN`: a train-mode BN whose statistics are those of the
  global batch: each rank's sums of x and x^2 over its rows, summed over
  the ranks by ``torch.distributed.nn.functional.all_reduce`` (whose
  gradient is the sum over the ranks of the incoming gradients, as each
  rank's loss depends on every rank's rows), divided once by the global
  count. Each forward of a step, and not a checkpointed region's
  recompute inside the backward pass, moves the running statistics as
  InPlace-ABN's training mode does: momentum 0.01, the variance
  Bessel-corrected by the global count. :func:`synced` puts it in place
  of every BN of a module.
- :class:`Adam`: :class:`steps.Adam` on the gradients summed over the
  ranks and divided by their number, the mean over the ranks of each
  rank's gradient of its own loss (a sum over its rows divided by its
  batch), which is the gradient of the global batch's loss.

With no process group initialised both are their plain counterparts. It
runs in float32 (TF32 off under :func:`quant.exact_f32`), or in float8
under :func:`quant.fp8` as :mod:`nets` does, and takes nothing of the
program: the ranks' group is torch's default one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.nn.functional import all_reduce

from . import nets, quant, steps


# InPlace-ABN's running-statistics momentum (the published model's BNs)
MOMENTUM = 0.01


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def recomputing() -> bool:
    """Inside a backward pass: a checkpointed region's recompute."""
    return torch._C._current_graph_task_id() != -1


class SyncBN(nets.BN):
    """BatchNorm over the global batch's statistics in train mode."""

    def forward(self, x):
        if not self.training or nets._CALIBRATE[0]:
            return super().forward(x)
        dims = [0] + list(range(2, x.dim()))
        sums = torch.stack([x.sum(dims), (x * x).sum(dims)])
        if world_size() > 1:
            sums = all_reduce(sums)
        n = x.numel() // x.shape[1] * world_size()
        mean, mean2 = sums / n
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        if not recomputing():
            with torch.no_grad():
                self.running_mean.mul_(1 - MOMENTUM).add_(MOMENTUM * mean)
                self.running_var.mul_(1 - MOMENTUM).add_(MOMENTUM * n / max(n - 1, 1) * var)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = self.weight * torch.rsqrt(var + nets.EPS)
        add = self.bias - mean * mul
        y = x * quant.store(mul).view(shape) + quant.store(add).view(shape)
        return quant.store(torch.relu(y) if self.relu else y)


def synced(module: nn.Module) -> nn.Module:
    """``module`` with every BN a :class:`SyncBN` (the same parameters)."""
    for m in module.modules():
        if type(m) is nets.BN:
            m.__class__ = SyncBN
    return module


class Adam(steps.Adam):
    """:class:`steps.Adam` on the gradients averaged over the ranks (one
    all-reduce of one flat float32 bucket; a leaf without a gradient
    counts as a zero gradient, as in :class:`steps.Adam`)."""

    @torch.no_grad()
    def step(self):
        n = world_size()
        if n > 1:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat)
            flat /= n
            offset = 0
            for p in self.params:
                p.grad = flat[offset:offset + p.numel()].view_as(p)
                offset += p.numel()
        super().step()
