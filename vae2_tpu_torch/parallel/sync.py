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
- :func:`row_range`: which rows of a map of H rows each spatial rank owns,
  at every resolution: ceil(H / S) rows each, in rank order, so that the
  last ranks may hold fewer or none (XLA's padded sharding; the image
  itself splits evenly, H % S == 0, as ``jax.device_put`` requires);
  :func:`set_image` records the image's H and W, from which every
  branch's H follows (each stride-2 convolution halves both, rounding up);
- :func:`halo_rows`: the rows of a map that a rank's convolution or
  upsample reads, its own and those of other spatial ranks, differentiable
  (one ``all_gather`` of each rank's edge rows within the spatial group,
  which both ``gloo`` and ``nccl`` take on CUDA tensors; a rank with fewer
  rows than the halo passes the rest on from the next rank over);
- :func:`randn_rows`: normal draws of the global batch from a generator that
  every rank holds alike, of which each rank keeps its own rows (and, for
  a map, its own H rows), so that a run's noise does not depend on the
  layout.

With no process group initialized, :func:`world_size` is 1 and every
function here leaves its input as it is: the single-process paths are
unchanged; with no spatial layout set, S is 1 and the halo is never asked
for. Every all-reduce goes through one place, which counts it in ``STATS``
and times it on the host clock (on the ``gloo`` backend a call on a CUDA
tensor waits for the device to reach it, so the time includes that wait;
on ``nccl`` a call only enqueues the collective, so the time is the
enqueue's alone); every halo exchange likewise, forward and backward each
one. Under a profiler session each call is also a ``sync.all_reduce`` or
``sync.halo`` span (``utils/spans.py``).
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils import spans

# all-reduces and halo exchanges issued and host seconds spent in their
# calls, since the last reset (under nccl the seconds are the enqueue's)
STATS = {"all_reduces": 0, "seconds": 0.0, "halo_exchanges": 0,
         "halo_seconds": 0.0}
spans.counter("sync.all_reduces", lambda: STATS["all_reduces"])
spans.counter("sync.halo_exchanges", lambda: STATS["halo_exchanges"])

# the spatial layout of this process: S, its spatial and data groups (None:
# the whole world is the data axis), and the global H of a row-sharded map
# by its width (``set_image``)
_LAYOUT = {"spatial": 1, "spatial_group": None, "data_group": None,
           "rows": {}}


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
                   data_group=data_group, rows={})


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


def row_range(height: int, index: int, parts: int) -> Tuple[int, int]:
    """Rows ``[start, stop)`` of block ``index`` of ``parts`` of a map of
    ``height`` rows: the ownership rule of every row-sharded map, at every
    resolution. Each block has ceil(height / parts) rows, in order, so the
    last blocks may hold fewer rows or none (3 rows over 4 ranks: 1, 1, 1,
    0), as XLA pads an uneven shard."""
    c = -(-height // parts)
    return min(index * c, height), min((index + 1) * c, height)


def set_image(height: int, width: int) -> None:
    """Record the global (H, W) of the image that a spatial layout splits
    (H % S == 0), and so the global H of each branch: a 3x3 stride-2
    convolution of padding 1 takes (h, w) to (ceil(h/2), ceil(w/2)). W is
    never split, so a map's width names its resolution
    (:func:`global_rows`)."""
    if height % spatial_size():
        raise ValueError(f"an image of {height} rows does not split evenly "
                         f"over {spatial_size()} spatial ranks")
    rows = {}
    while width not in rows:
        rows[width] = height
        height, width = -(-height // 2), -(-width // 2)
    _LAYOUT["rows"] = rows


def global_rows(local_rows: int, width: int) -> int:
    """The global H of a row-sharded map of ``width`` columns, of which this
    rank holds ``local_rows``: the branch of that width of the image of
    :func:`set_image`; a map of another width was split evenly where it
    was placed (S x its local rows)."""
    return _LAYOUT["rows"].get(width, local_rows * spatial_size())


def own_rows(height: int) -> Tuple[int, int]:
    """This rank's rows ``[start, stop)`` of a map of ``height`` rows."""
    return row_range(height, spatial_rank(), spatial_size())


def _all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    t0 = time.perf_counter()
    with spans.span("sync.all_reduce"):
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
    global draw has the map's global H rows (:func:`global_rows`), and the
    rank keeps its own (:func:`own_rows`). A vector draw is the same on
    every rank of a spatial group."""
    shape = tuple(shape)
    if world_size() == 1:
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device)
    s = spatial_size() if len(shape) == 4 else 1
    full_shape = list(shape)
    full_shape[0] *= data_size()
    if s > 1:
        full_shape[2] = global_rows(shape[2], shape[3])
    full = torch.randn(full_shape, generator=generator, dtype=dtype,
                       device=device)
    b, i = shape[0], data_rank()
    out = full[i * b:(i + 1) * b]
    if s > 1:
        start, stop = own_rows(full_shape[2])
        if stop - start != shape[2]:
            raise ValueError(f"a map of {shape[2]} local rows is not this "
                             f"rank's share of {full_shape[2]}")
        out = out[:, :, start:stop]
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
    with spans.span("sync.halo") if count else contextlib.nullcontext():
        dist.all_gather(parts, wire, group=_LAYOUT["spatial_group"])
    if count:
        STATS["halo_seconds"] += time.perf_counter() - t0
        STATS["halo_exchanges"] += 1
    return [p.view(t.dtype) for p in parts]


HALO_MODES = ("zeros", "edge")


class HaloPlan:
    """How one rank's window of a row-sharded map is exchanged
    (:func:`halo_plan`). Every rank sends its first ``first`` and last
    ``last`` rows (zero-padded where it holds fewer); ``runs`` builds this
    rank's window from runs ``(source, start, length)``: source -1 is zero
    rows, -2 its own rows from local row ``start``, r >= 0 rows ``start``
    of rank r's send buffer. In the backward each rank sends the gradient
    of the rows it borrowed, in window order (``borrowed``: runs
    ``(window row, length)``, ``back`` rows in all, padded to the largest
    rank's ``back_rows``), and adds what the others borrowed of its own
    rows (``receives``: runs ``(rank, row in its message, local row,
    length)``)."""

    def __init__(self, first, last, runs, borrowed, back_rows, receives,
                 own_rows):
        self.first, self.last = first, last
        self.runs, self.borrowed = runs, borrowed
        self.back_rows, self.receives = back_rows, receives
        self.own_rows = own_rows


def _merge(entries):
    """Consecutive (source, start) entries as runs (source, start, length):
    a run goes on while the source stays and its start grows by one (zero
    rows, source -1, always go on)."""
    runs = []
    for src, start in entries:
        if runs and runs[-1][0] == src and (
                src == -1 or runs[-1][1] + runs[-1][2] == start):
            runs[-1][2] += 1
        else:
            runs.append([src, start, 1])
    return [tuple(r) for r in runs]


@functools.lru_cache(maxsize=None)
def halo_plan(height: int, windows: Tuple[Tuple[int, int], ...], mode: str,
              rank: int) -> HaloPlan:
    """The exchange that gives each spatial rank r the global rows
    ``windows[r] = (lo, hi)`` of a map of ``height`` rows owned by
    :func:`row_range`, seen from rank ``rank``. Rows outside the image are
    zeros (``mode`` 'zeros', a convolution's padding) or the edge row
    ('edge', the clamped tap of a bilinear upsample)."""
    s = len(windows)
    owned = [row_range(height, r, s) for r in range(s)]
    c = -(-height // s)

    def source(q):
        if not 0 <= q < height:
            if mode == "zeros":
                return None
            q = min(max(q, 0), height - 1)
        return q, q // c

    first = last = 0
    for r, (lo, hi) in enumerate(windows):
        for g in range(lo, hi):
            src = source(g)
            if src is None or src[1] == r:
                continue
            q, o = src
            if o > r:
                first = max(first, q - owned[o][0] + 1)
            else:
                last = max(last, owned[o][1] - q)

    def entries(r):
        out = []
        for g in range(*windows[r]):
            src = source(g)
            if src is None:
                out.append((-1, 0))
                continue
            q, o = src
            if o == r:
                out.append((-2, q - owned[r][0]))
            elif o > r:
                out.append((o, q - owned[o][0]))
            else:
                out.append((o, first + last - (owned[o][1] - q)))
        return out

    def local(pos, h):  # a row of this rank's send buffer, as its local row
        return pos if pos < first else h - (first + last - pos)

    h = owned[rank][1] - owned[rank][0]
    back = [[(i, e) for i, e in enumerate(entries(r)) if e[0] >= 0]
            for r in range(s)]
    receives = []
    for r in range(s):
        hits = [(k, local(e[1], h)) for k, (_, e) in enumerate(back[r])
                if e[0] == rank]
        receives += [(r, k, row, n) for k, row, n in
                     _merge_pairs(hits)]
    borrowed = [(i, n) for _, i, n in _merge(
        [(0, i) for i, _ in back[rank]])]
    return HaloPlan(first, last, _merge(entries(rank)), borrowed,
                    max(1, max(len(b) for b in back)), receives, h)


def _merge_pairs(hits):
    """Runs (k, row, length) of (k, row) pairs that both grow by one."""
    runs = []
    for k, row in hits:
        if runs and runs[-1][0] + runs[-1][2] == k \
                and runs[-1][1] + runs[-1][2] == row:
            runs[-1][2] += 1
        else:
            runs.append([k, row, 1])
    return [tuple(r) for r in runs]


def _memory_format(x: torch.Tensor):
    return (torch.channels_last
            if x.dim() == 4 and x.is_contiguous(
                memory_format=torch.channels_last)
            and not x.is_contiguous() else torch.contiguous_format)


def _rows_of(t: torch.Tensor, n: int, pad_front: bool) -> torch.Tensor:
    """``t`` zero-padded to ``n`` rows (in front or behind)."""
    if t.shape[2] == n:
        return t
    pad = t.new_zeros(t.shape[:2] + (n - t.shape[2], t.shape[3]))
    return torch.cat([pad, t] if pad_front else [t, pad], dim=2)


class _HaloRows(torch.autograd.Function):
    """(N, C, h, W) -> (N, C, hi - lo, W): this rank's window (lo, hi) of
    the global rows, from its own rows and the send buffers of the others
    (one exchange); the backward sends the gradient of each borrowed row
    back to the rank that owns it, which adds it into that row (the
    gradient of an edge copy goes to the edge row)."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        h = x.shape[2]
        buf = torch.cat([_rows_of(x[:, :, :plan.first], plan.first, False),
                         _rows_of(x[:, :, max(h - plan.last, 0):], plan.last,
                                  True)], dim=2)
        if buf.shape[2] == 0:
            buf = x.new_zeros(x.shape[:2] + (1, x.shape[3]))
        parts = _spatial_gather(buf)
        pieces = []
        for src, start, n in plan.runs:
            if src == -1:
                pieces.append(x.new_zeros(x.shape[:2] + (n, x.shape[3])))
            else:
                t = x if src == -2 else parts[src]
                pieces.append(t[:, :, start:start + n])
        fmt = _memory_format(x)
        if not pieces:
            return x.new_zeros(x.shape[:2] + (0, x.shape[3])).contiguous(
                memory_format=fmt)
        return torch.cat(pieces, dim=2).contiguous(memory_format=fmt)

    @staticmethod
    def backward(ctx, dy):
        plan = ctx.plan
        send = [dy[:, :, i:i + n] for i, n in plan.borrowed]
        sent = sum(n for _, n in plan.borrowed)
        send.append(dy.new_zeros(dy.shape[:2] + (plan.back_rows - sent,
                                                 dy.shape[3])))
        parts = _spatial_gather(torch.cat(send, dim=2))
        dx = _own_rows_grad(plan, dy)
        for r, k, row, n in plan.receives:
            dx[:, :, row:row + n] += parts[r][:, :, k:k + n]
        return dx, None


def _own_rows_grad(plan: HaloPlan, dy: torch.Tensor) -> torch.Tensor:
    """The gradient of this rank's own rows from its own window rows."""
    dx = dy.new_zeros(dy.shape[:2] + (plan.own_rows, dy.shape[3]))
    i = 0
    for src, start, n in plan.runs:
        if src == -2:
            dx[:, :, start:start + n] += dy[:, :, i:i + n]
        i += n
    return dx.contiguous(memory_format=_memory_format(dy))


def halo_rows(x: torch.Tensor, height: int,
              windows: Sequence[Tuple[int, int]],
              mode: str = "zeros") -> torch.Tensor:
    """Global rows ``windows[spatial_rank()] = (lo, hi)`` of an (N, C, h, W)
    map of ``height`` rows, of which this rank holds its own
    (:func:`own_rows`), differentiable: its own rows and those of the other
    spatial ranks, and outside the image zeros (``mode`` 'zeros') or copies
    of the edge row ('edge'). ``windows`` lists every rank's window, which
    the exchange needs on every rank. Needs a spatial layout (S > 1)."""
    if spatial_size() == 1:
        raise RuntimeError("halo_rows needs a spatial layout (S > 1)")
    if mode not in HALO_MODES:
        raise ValueError(f"halo mode must be one of {HALO_MODES}, got "
                         f"{mode!r}")
    windows = tuple((int(lo), int(hi)) for lo, hi in windows)
    if len(windows) != spatial_size():
        raise ValueError(f"{len(windows)} windows for {spatial_size()} "
                         "spatial ranks")
    start, stop = own_rows(height)
    if x.shape[2] != stop - start:
        raise ValueError(f"{x.shape[2]} local rows are not this rank's "
                         f"{stop - start} of {height}")
    return _HaloRows.apply(x, halo_plan(height, windows, mode,
                                        spatial_rank()))


def connected_empty(t: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """A zero-row tensor of ``shape`` (channels_last, t's dtype) that
    autograd connects to ``t``: an op whose output has no rows on this rank
    still hands its input a gradient, so that every rank runs the same
    backward, collectives included."""
    empty = t.new_zeros(tuple(shape)).contiguous(
        memory_format=torch.channels_last)
    return empty + t.sum() * 0


def spatial_sum(x: torch.Tensor) -> torch.Tensor:
    """The SUM of ``x`` over the spatial group, differentiable; ``x`` itself
    when S is 1."""
    if spatial_size() == 1:
        return x
    return all_reduce_sum(x, _LAYOUT["spatial_group"])


def gather_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole of a map whose ``dim`` axis holds this rank's H rows (and
    axis ``dim + 1`` its width): the spatial group's blocks of
    :func:`row_range`, each padded to the largest on the wire and cut back,
    concatenated in rank order (f32 on the wire). Every rank of the spatial
    group must call it."""
    if spatial_size() == 1:
        return x
    s, height = spatial_size(), global_rows(x.shape[dim], x.shape[dim + 1])
    c = -(-height // s)
    with torch.no_grad():
        pad = list(x.shape)
        pad[dim] = c - x.shape[dim]
        wire = torch.cat([x.float(), x.new_zeros(pad, dtype=torch.float32)],
                         dim=dim)
        parts = _spatial_gather(wire, count=False)
    return torch.cat([p.narrow(dim, 0, n) for p, n in zip(
        parts, (b - a for a, b in (row_range(height, r, s)
                                   for r in range(s))))],
        dim=dim).to(x.dtype)
