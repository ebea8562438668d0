"""The collectives of data-parallel and spatial training (the port's
counterpart of the reductions and halo exchanges that XLA's SPMD
partitioner inserts over the JAX package's ``(data, spatial)`` mesh,
vae2_tpu/parallel/mesh.py:1-16, ops/norm.py:141-157).

The rank layout (``set_layout``, built by ``parallel/mesh.py``): rank r is
data index ``r // S`` and spatial index ``r % S``, as ``make_mesh``
reshapes its devices to ``(n // S, S)`` (mesh.py:43). The ranks of one
spatial group hold the same clips, each its own block of H rows; the batch
statistics and gradients reduce over every rank.

- :func:`all_reduce_sum`: a differentiable SUM all-reduce over a group of
  ranks (a ``torch.autograd.Function``: the backward all-reduces the
  incoming gradient with SUM too), for the batch statistics of a BN whose
  backward runs through autograd, and for the posterior's global pool
  over a spatial group (:func:`spatial_sum`);
- :func:`all_reduce_`: the same collective in place, without autograd
  (statistics that carry no gradient, kernel 2's sums in the fused-ABN
  backward, logged losses);
- :func:`average_` and :func:`broadcast_`: a list of tensors as one flat
  bucket per dtype, one collective per bucket (gradients, and rank 0's
  parameters after build and resume);
- :func:`halo_rows`: the rows of the neighbouring spatial ranks that a
  convolution or an upsample reads across the seam, differentiable (an
  ``all_gather`` of each rank's edge rows within the spatial group, which
  both ``gloo`` and ``nccl`` take on CUDA tensors);
- :func:`randn_rows`: normal draws of the global batch from a generator that
  every rank holds alike, of which each rank keeps its own rows (and, for
  a map, its own H rows), so that a run's noise does not depend on the
  layout.

With no process group initialized, :func:`world_size` is 1 and every
function here leaves its input as it is: the single-process paths are
unchanged; with no spatial layout set, S is 1 and the halo is never asked
for. Every all-reduce goes through one place, which counts it in ``STATS``
and times it on the host clock (on the ``gloo`` backend a call on a CUDA
tensor waits for the device to reach it, so the time includes that wait);
every halo exchange likewise, forward and backward each one.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

# all-reduces and halo exchanges issued and host seconds spent in them,
# since the last reset
STATS = {"all_reduces": 0, "seconds": 0.0, "halo_exchanges": 0,
         "halo_seconds": 0.0}

# the spatial layout of this process: S, and its spatial and data groups
# (None: the whole world is the data axis)
_LAYOUT = {"spatial": 1, "spatial_group": None, "data_group": None}


def reset_stats() -> None:
    STATS.update(all_reduces=0, seconds=0.0, halo_exchanges=0,
                 halo_seconds=0.0)


def set_layout(spatial: int = 1, spatial_group=None, data_group=None) -> None:
    """This rank's (data, spatial) layout: S ranks per spatial group, with
    the process groups of its spatial and data axes (``mesh.init_layout``);
    ``set_layout()`` returns to data parallelism over the whole world."""
    if spatial > 1 and spatial_group is None:
        raise ValueError("a spatial layout needs its spatial process group")
    _LAYOUT.update(spatial=int(spatial), spatial_group=spatial_group,
                   data_group=data_group)


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


def data_group():
    """The process group of this rank's data axis (None: every rank)."""
    return _LAYOUT["data_group"]


def spatial_size() -> int:
    """S: the ranks that share one clip, each with H / S of its rows."""
    return _LAYOUT["spatial"] if world_size() > 1 else 1


def spatial_rank() -> int:
    """This rank's block of rows within its spatial group: rank % S."""
    return rank() % spatial_size()


def data_size() -> int:
    """D: the data shards, world size / S."""
    return world_size() // spatial_size()


def data_rank() -> int:
    """This rank's data shard: rank // S."""
    return rank() // spatial_size()


def _all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    t0 = time.perf_counter()
    dist.all_reduce(t, group=group)
    STATS["seconds"] += time.perf_counter() - t0
    STATS["all_reduces"] += 1
    return t


class _AllReduceSum(torch.autograd.Function):
    """SUM over the ranks of ``group``; its gradient is the SUM over them of
    the incoming gradients (each rank's loss depends on every rank's
    input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.detach().clone(
            memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The SUM of ``x`` over the ranks of ``group`` (every rank when None),
    differentiable; ``x`` itself when there is one rank."""
    if world_size() == 1:
        return x
    return _AllReduceSum.apply(x, group)


def all_reduce_(x: torch.Tensor, group=None) -> torch.Tensor:
    """SUM over the ranks of ``group`` (every rank when None) in place,
    outside autograd; returns ``x``."""
    if world_size() > 1:
        with torch.no_grad():
            _all_reduce(x, group)
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
    """Each tensor replaced by its sum over ranks divided by D, the data
    shards (its mean over ranks when S is 1): one all-reduce of one flat
    bucket per (dtype, device). A spatial rank's loss is the part of its
    data shard's loss that its rows give (the losses are sums over pixels
    divided by the batch, core/losses.py), so the sum over a spatial group
    is the shard's gradient, and the mean over shards the global batch's."""
    if world_size() == 1:
        return
    d = data_size()
    with torch.no_grad():
        for group in _buckets(tensors).values():
            flat = _all_reduce(torch.cat([t.reshape(-1) for t in group]))
            _scatter(flat.div_(d), group)


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
    global batch (``shape[0]`` times D rows, as one process at the global
    batch draws it), of which this rank keeps its data shard's block of
    rows. A 4-d (N, C, h, W) shape is a map of this rank's H rows: the
    global draw has S times h rows, and the rank keeps its own. A vector
    draw is the same on every rank of a spatial group."""
    shape = tuple(shape)
    if world_size() == 1:
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device)
    s = spatial_size() if len(shape) == 4 else 1
    full_shape = list(shape)
    full_shape[0] *= data_size()
    if s > 1:
        full_shape[2] *= s
    full = torch.randn(full_shape, generator=generator, dtype=dtype,
                       device=device)
    b, i = shape[0], data_rank()
    out = full[i * b:(i + 1) * b]
    if s > 1:
        h, j = shape[2], spatial_rank()
        out = out[:, :, j * h:(j + 1) * h]
    return out.contiguous()


# ---- the spatial axis -------------------------------------------------------


def _spatial_gather(t: torch.Tensor, count: bool = True
                    ) -> List[torch.Tensor]:
    """Every spatial rank's ``t`` (same shape everywhere), in rank order:
    one all_gather within the spatial group, counted as a halo exchange
    when ``count``. bfloat16 travels as the same bits in float16 (a copy,
    no arithmetic), which every backend takes."""
    t = t.contiguous()
    wire = t.view(torch.float16) if t.dtype == torch.bfloat16 else t
    parts = [torch.empty_like(wire) for _ in range(spatial_size())]
    t0 = time.perf_counter()
    dist.all_gather(parts, wire, group=_LAYOUT["spatial_group"])
    if count:
        STATS["halo_seconds"] += time.perf_counter() - t0
        STATS["halo_exchanges"] += 1
    return [p.view(t.dtype) for p in parts]


HALO_MODES = ("zeros", "edge")


class _HaloRows(torch.autograd.Function):
    """(N, C, h, W) -> (N, C, top + h + bottom, W): this rank's rows between
    the last ``top`` rows of the spatial rank above and the first
    ``bottom`` rows of the one below; at the image's top and bottom, zeros
    (``mode`` 'zeros', a convolution's padding) or copies of the edge row
    ('edge', the clamped taps of a bilinear upsample). The backward sends
    the gradient of the halo rows back to the rank that owns them, which
    adds it into its own edge rows (the gradient of an edge copy goes to
    the edge row)."""

    @staticmethod
    def forward(ctx, x, top, bottom, mode):
        s, j = spatial_size(), spatial_rank()
        n, c, h, w = x.shape
        ctx.top, ctx.bottom, ctx.mode = top, bottom, mode
        # what this rank sends: its first `bottom` rows (the halo of the rank
        # above) and its last `top` rows (that of the rank below)
        parts = _spatial_gather(torch.cat(
            [x[:, :, :bottom], x[:, :, h - top:]], dim=2))
        fmt = (torch.channels_last
               if x.is_contiguous(memory_format=torch.channels_last)
               and not x.is_contiguous() else torch.contiguous_format)
        out = torch.empty((n, c, top + h + bottom, w), dtype=x.dtype,
                          device=x.device, memory_format=fmt)
        out[:, :, top:top + h] = x
        if top:
            if j > 0:
                out[:, :, :top] = parts[j - 1][:, :, bottom:bottom + top]
            elif mode == "edge":
                out[:, :, :top] = x[:, :, :1]
            else:
                out[:, :, :top] = 0
        if bottom:
            if j < s - 1:
                out[:, :, top + h:] = parts[j + 1][:, :, :bottom]
            elif mode == "edge":
                out[:, :, top + h:] = x[:, :, h - 1:]
            else:
                out[:, :, top + h:] = 0
        return out

    @staticmethod
    def backward(ctx, dy):
        s, j = spatial_size(), spatial_rank()
        top, bottom = ctx.top, ctx.bottom
        h = dy.shape[2] - top - bottom
        d_top, d_bottom = dy[:, :, :top], dy[:, :, top + h:]
        # each rank sends the gradient of the rows it borrowed to their owner
        parts = _spatial_gather(torch.cat([d_top, d_bottom], dim=2))
        dx = dy[:, :, top:top + h].clone()
        if top and j < s - 1:  # the rank below borrowed my last `top` rows
            dx[:, :, h - top:] += parts[j + 1][:, :, :top]
        if bottom and j > 0:  # the rank above borrowed my first `bottom`
            dx[:, :, :bottom] += parts[j - 1][:, :, top:top + bottom]
        if ctx.mode == "edge":
            if j == 0 and top:
                dx[:, :, :1] += d_top.sum(dim=2, keepdim=True)
            if j == s - 1 and bottom:
                dx[:, :, h - 1:] += d_bottom.sum(dim=2, keepdim=True)
        return dx, None, None, None


def halo_rows(x: torch.Tensor, top: int, bottom: int,
              mode: str = "zeros") -> torch.Tensor:
    """This rank's rows of an (N, C, h, W) map with ``top`` rows of the
    spatial rank above and ``bottom`` rows of the one below (at the image's
    border, ``mode`` 'zeros' or 'edge'), differentiable. Needs a spatial
    layout (S > 1) and ``top, bottom <= h``."""
    if spatial_size() == 1:
        raise RuntimeError("halo_rows needs a spatial layout (S > 1)")
    if mode not in HALO_MODES:
        raise ValueError(f"halo mode must be one of {HALO_MODES}, got "
                         f"{mode!r}")
    if not 0 <= top <= x.shape[2] or not 0 <= bottom <= x.shape[2]:
        raise ValueError(f"a halo of ({top}, {bottom}) rows needs at least "
                         f"that many local rows, got {x.shape[2]}")
    return _HaloRows.apply(x, top, bottom, mode)


def spatial_sum(x: torch.Tensor) -> torch.Tensor:
    """The SUM of ``x`` over the spatial group, differentiable; ``x`` itself
    when S is 1."""
    if spatial_size() == 1:
        return x
    return all_reduce_sum(x, _LAYOUT["spatial_group"])


def gather_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole of a map whose ``dim`` axis holds this rank's H rows: the
    spatial group's blocks concatenated in rank order (f32 on the wire).
    Every rank of the spatial group must call it."""
    if spatial_size() == 1:
        return x
    with torch.no_grad():
        parts = _spatial_gather(x.float(), count=False)
    return torch.cat(parts, dim=dim).to(x.dtype)
