"""Spans and counters of the program, on the profiler's clock.

- ``span(name)``: while a ``torch.profiler`` session is active, a
  ``torch.profiler.record_function(name)`` range, which lands in the same
  kineto trace as the device's activity, on one clock; otherwise one shared
  no-op context. No ``record_function`` is built then: one costs several
  microseconds even with the profiler off, the check ~0.1 us.
- ``step(name)``: ``span(name)`` around one train step that also appends a
  record to a bounded ring (``steps``, ``recorded``): the name, the host
  seconds inside the call, whether a profiler was active, and the seconds
  Python's garbage collector paused inside it.
- ``counters()``: one flat view of the counts the program keeps where they
  live. A module names its own with ``counter(name, read)`` (the ABN
  kernels' launch counts and ``FusedABN.dz_copies`` in ``ops/abn.py``,
  ``sync.STATS`` in ``parallel/sync.py``, the seg step's captures, replays
  and eager steps in ``core/seg_loop.py``, the OCR net's forwards in
  ``models/seg_hrnet_ocr.py``); this one adds Python's garbage
  collections, which a ``gc.callbacks`` hook counts and times always. While
  a session is active the hook also opens ``py.gc.gen<g>`` around each
  collection, so that a pause sits in the trace inside the span that
  triggered it.

Names are fixed strings, one per layer boundary: ``loop.data_wait``,
``loop.readback``; ``vae2.train_step`` with ``vae2.{g,d}_{forward,backward,
update}`` under it, ``seg.train_step`` with ``seg.{forward,backward,
replay,update}`` (forward and backward only where the step runs eagerly
or captures: a replayed graph runs no Python), ``ocr.{aux,gather,
attention,fuse}`` (inside the OCR net's forward, so likewise),
``seg.next_batch`` (a step record around the seg batcher's assembly of a
batch), ``vae2.prior_sample``,
``vae2.momentum_sample``, ``vae2.score``;
``hrnet.remat`` (a checkpointed region, once in the forward and again as
its recompute in the backward); ``abn.batch_stats``; ``sync.all_reduce``,
``sync.halo``; ``py.gc.gen0|1|2``.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import math
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import torch

RING = 4096  # step records kept, the oldest dropped first

_active = torch.autograd._profiler_enabled
_NOOP = contextlib.nullcontext()
_records = collections.deque(maxlen=RING)
_appended = [0]  # step records appended since the import

_GC_NAMES = ("py.gc.gen0", "py.gc.gen1", "py.gc.gen2")
_gc = {"collections": [0, 0, 0], "pause_s": 0.0, "t0": 0.0, "range": None}
_COUNTERS: Dict[str, Callable[[], float]] = {
    **{f"gc.collections.gen{g}": (lambda g=g: _gc["collections"][g])
       for g in range(3)},
    "gc.pause_s": lambda: _gc["pause_s"]}


def span(name: str):
    """A ``record_function(name)`` range while a profiler session is
    active, else a shared no-op context."""
    return torch.profiler.record_function(name) if _active() else _NOOP


def waited(iterable: Iterable) -> Iterator:
    """The items of ``iterable``, each ``next`` inside ``loop.data_wait``."""
    it = iter(iterable)
    while True:
        with span("loop.data_wait"):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item


def counter(name: str, read: Callable[[], float]) -> None:
    """Name a count kept elsewhere: ``counters()`` gives ``read()``."""
    _COUNTERS[name] = read


# Host-side counts of work inside a training step, as (owner, attribute),
# that a CUDA graph of the step runs again on each replay: the graph's
# owner (``core/seg_loop.py``) adds the capture's change of each on every
# replay. A module names its own with ``replayed(owner, attr)``.
REPLAYED: List[Tuple[object, str]] = []


def replayed(owner: object, attr: str) -> None:
    """Mark ``owner.attr``, a count of work inside a step, as one that each
    replay of a captured step adds to (``REPLAYED``)."""
    if (owner, attr) not in REPLAYED:
        REPLAYED.append((owner, attr))


def counters() -> Dict[str, float]:
    """The program's counters as they stand, by name."""
    return {name: read() for name, read in _COUNTERS.items()}


@contextlib.contextmanager
def step(name: str):
    """``span(name)`` around one step, which appends the step's record."""
    profiled = _active()
    paused, t0 = _gc["pause_s"], time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        _records.append({"name": name, "host_s": time.perf_counter() - t0,
                         "profiled": profiled,
                         "gc_pause_s": _gc["pause_s"] - paused})
        _appended[0] += 1


def recorded() -> int:
    """How many step records were appended since the import."""
    return _appended[0]


def steps(since: Optional[int] = None) -> List[dict]:
    """The step records the ring holds, oldest first; with ``since`` (a
    value of :func:`recorded`), those appended after it."""
    held = list(_records)
    if since is None:
        return held
    new = _appended[0] - since
    return held[-new:] if new > 0 else []


def step_costs_ms(since: int, name: Optional[str] = None
                  ) -> Tuple[float, float]:
    """The mean host ms inside a step and GC pause ms a step over the
    records appended after ``since`` (of the step ``name`` only, where
    given); nan when there are none."""
    held = [r for r in steps(since) if name is None or r["name"] == name]
    if not held:
        return math.nan, math.nan
    return (1e3 * sum(r["host_s"] for r in held) / len(held),
            1e3 * sum(r["gc_pause_s"] for r in held) / len(held))


def _on_gc(phase: str, info: dict) -> None:
    # a collection runs to its end on the thread that triggered it, with no
    # other collection inside it: "start" and "stop" pair up
    if phase == "start":
        _gc["t0"] = time.perf_counter()
        if _active():
            rf = torch.profiler.record_function(_GC_NAMES[info["generation"]])
            rf.__enter__()
            _gc["range"] = rf
        return
    _gc["pause_s"] += time.perf_counter() - _gc["t0"]
    _gc["collections"][info["generation"]] += 1
    rf, _gc["range"] = _gc["range"], None
    if rf is not None:
        rf.__exit__(None, None, None)


gc.callbacks.append(_on_gc)
