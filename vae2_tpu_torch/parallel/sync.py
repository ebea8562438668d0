"""The collectives of data-parallel training (the port's counterpart of the
reductions that XLA's SPMD partitioner inserts over the JAX package's
``data`` mesh axis, vae2_tpu/parallel/mesh.py:1-16, ops/norm.py:141-157).

- :func:`all_reduce_sum`: a differentiable SUM all-reduce (a
  ``torch.autograd.Function``: the backward all-reduces the incoming
  gradient with SUM too), for the batch statistics of a BN whose backward
  runs through autograd;
- :func:`all_reduce_`: the same collective in place, without autograd
  (statistics that carry no gradient, kernel 2's sums in the fused-ABN
  backward, logged losses);
- :func:`average_` and :func:`broadcast_`: a list of tensors as one flat
  bucket per dtype, one collective per bucket (gradients, and rank 0's
  parameters after build and resume);
- :func:`randn_rows`: normal draws of the global batch from a generator that
  every rank holds alike, of which each rank keeps its own rows, so that a
  run's noise does not depend on the number of ranks.

With no process group initialized, :func:`world_size` is 1 and every
function here leaves its input as it is: the single-process paths are
unchanged. Every all-reduce goes through one place, which counts it in
``STATS`` and times it on the host clock (on the ``gloo`` backend a call on a
CUDA tensor waits for the device to reach it, so the time includes that
wait).
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

# all-reduces issued and host seconds spent in them, since the last reset
STATS = {"all_reduces": 0, "seconds": 0.0}


def reset_stats() -> None:
    STATS.update(all_reduces=0, seconds=0.0)


def world_size() -> int:
    """The number of ranks; 1 when no process group is initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank; 0 when no process group is initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    t0 = time.perf_counter()
    dist.all_reduce(t)
    STATS["seconds"] += time.perf_counter() - t0
    STATS["all_reduces"] += 1
    return t


class _AllReduceSum(torch.autograd.Function):
    """SUM over ranks; its gradient is the SUM over ranks of the incoming
    gradients (each rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.detach().clone(
            memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy.clone(memory_format=torch.contiguous_format))


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The SUM of ``x`` over ranks, differentiable; ``x`` itself when there
    is one rank."""
    if world_size() == 1:
        return x
    return _AllReduceSum.apply(x)


def all_reduce_(x: torch.Tensor) -> torch.Tensor:
    """SUM over ranks in place, outside autograd; returns ``x``."""
    if world_size() > 1:
        with torch.no_grad():
            _all_reduce(x)
    return x


def _buckets(tensors: Iterable[torch.Tensor]
             ) -> Dict[tuple, List[torch.Tensor]]:
    out: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        out.setdefault((t.dtype, t.device), []).append(t)
    return out


def _scatter(flat: torch.Tensor, group: List[torch.Tensor]) -> None:
    offset = 0
    for t in group:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def average_(tensors: Sequence[torch.Tensor]) -> None:
    """Each tensor replaced by its mean over ranks: one all-reduce of one
    flat bucket per (dtype, device)."""
    r = world_size()
    if r == 1:
        return
    with torch.no_grad():
        for group in _buckets(tensors).values():
            flat = _all_reduce(torch.cat([t.reshape(-1) for t in group]))
            _scatter(flat.div_(r), group)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Each tensor set to rank ``src``'s: one broadcast of one flat bucket
    per (dtype, device)."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for group in _buckets(tensors).values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, src)
            _scatter(flat, group)


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def randn_rows(shape: Sequence[int], generator: Optional[torch.Generator],
               dtype: Optional[torch.dtype] = None,
               device=None) -> torch.Tensor:
    """Standard normal draws of ``shape`` for this rank: the draw of the
    global batch (``shape[0]`` times the number of ranks rows, as one
    process at the global batch draws it), of which this rank keeps its own
    block of rows."""
    r = world_size()
    shape = tuple(shape)
    if r == 1:
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device)
    full = torch.randn((shape[0] * r,) + shape[1:], generator=generator,
                       dtype=dtype, device=device)
    b = shape[0]
    return full[rank() * b:(rank() + 1) * b].contiguous()
