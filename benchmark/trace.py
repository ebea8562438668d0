"""Reduce a ``torch.profiler`` trace to numbers: a steady sub-window of
units (``reduce``), or a whole measured window (``device_busy``).

The driver runs whole units (steps or clips) inside ``bench.<unit>``
spans (``record_function``), each ended by a device synchronise, so that
the device work of a span lies inside its host interval. From the trace:

- the sub-window: from the first unit span's start to the last one's end;
- busy: the union of the device activities' intervals (kernels, copies,
  sets) inside it, so that overlapping kernels count once; idle = 1 -
  busy / window;
- launches: device activities that start inside it;
- device time by activity name (all of it, and the top 10);
- device time inside each ``bench.*`` span's intervals (by the midpoint
  of each activity);
- the 10 longest idle gaps, each named by the innermost host event under
  its midpoint (what the host was doing while the device waited);
- in a run of several ranks (``collectives``), the card's busy time
  outside NCCL's kernels and each NCCL kernel's length (:func:`split`),
  from which :func:`exchange_s` takes the collectives' own time.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_KINDS = ("kernel", "memcpy", "memset")
NCCL = "nccl"


def _events(prof):
    """(device, host) lists of (name, start_ns, end_ns). The device's copies
    of host annotations (``record_function`` ranges, an optimizer's step)
    are no device activity and are left out."""
    device, host = [], []
    events = prof.profiler.kineto_results.events()
    annotations = {e.name() for e in events if e.is_user_annotation()}
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        on_device = "CUDA" in str(e.device_type()).upper()
        kind = str(getattr(e, "activity_type", lambda: "")()).lower()
        if on_device:
            if ("annotation" in kind or name in annotations or e.is_user_annotation()
                    or (kind and not any(k in kind for k in DEVICE_KINDS))):
                continue
            device.append((name, start, end))
        else:
            host.append((name, start, end))
    return device, host


def device_busy(prof, collectives: bool = False) -> Dict:
    """Busy seconds of a whole trace (the union of its device activities'
    intervals) and how many activities there were: for a trace of device
    activity alone, taken over every unit of a measured window; with
    ``collectives``, :func:`split`'s numbers too."""
    device, _ = _events(prof)
    out = {"busy_s": busy_s([(s, e) for _, s, e in device]), "launches": len(device)}
    return {**out, **split(device)} if collectives else out


def split(device) -> Dict:
    """A card's device activities split at NCCL's kernels (names that hold
    ``nccl``): ``other_busy_s``, the union of the other activities'
    intervals in seconds; ``collective_ns``, each NCCL kernel's length in
    ns, in the order they start. Every rank makes the same collectives in
    the same order on one stream, so the i-th entry of each rank's list is
    one collective."""
    other, coll = [], []
    for name, s, e in device:
        if NCCL in name.lower():
            coll.append((s, e - s))
        else:
            other.append((s, e))
    return {"other_busy_s": busy_s(other), "collective_ns": [d for _, d in sorted(coll)]}


def exchange_s(lists) -> Optional[float]:
    """The collectives' own time, in seconds, from every rank's
    ``collective_ns``: for each collective the shortest of its kernels over
    the cards. An NCCL kernel runs from when its card reaches the
    collective until every card has; the card that came last waits for no
    one, so its kernel is the exchange alone. None where the ranks' lists
    differ in length or hold nothing."""
    lists = list(lists)
    if not lists or None in lists or len({len(x) for x in lists}) != 1 or not lists[0]:
        return None
    return sum(map(min, zip(*lists))) * 1e-9


def busy_s(intervals: List[Tuple[int, int]]) -> float:
    """Seconds covered by the union of intervals in ns."""
    return sum(e - s for s, e in _merge(intervals)) * 1e-9


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _short(name: str, n: int = 96) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def reduce(prof, unit: str, collectives: bool = False) -> Dict:
    """The sub-window of the ``unit`` spans (module docstring); with
    ``collectives``, :func:`split`'s numbers inside it too."""
    device, host = _events(prof)
    spans = defaultdict(list)
    for name, s, e in host:
        if name.startswith("bench."):
            spans[name].append((s, e))
    units = sorted(spans.get(unit, []))
    if not units or not device:
        return {}
    w0, w1 = units[0][0], units[-1][1]
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
    busy = _merge([(s, e) for _, s, e in inside])
    busy_ns = sum(e - s for s, e in busy)
    by_name: Dict[str, float] = defaultdict(float)
    for n, s, e in inside:
        by_name[n] += (e - s) * 1e-9
    span_device = {}
    for name, ivs in spans.items():
        ivs = sorted(ivs)
        starts = [s for s, _ in ivs]
        total = 0
        for _, s, e in inside:
            mid = (s + e) // 2
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and ivs[i][0] <= mid <= ivs[i][1]:
                total += e - s
        span_device[name] = total * 1e-9
    gaps, prev = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((s - prev, prev, s))
        prev = max(prev, e)
    gaps.sort(reverse=True)
    named = []
    for length, s, e in gaps[:10]:
        mid, best = (s + e) // 2, None
        for name, hs, he in host:
            if hs <= mid <= he and (best is None or he - hs < best[1]):
                best = (name, he - hs)
        named.append([_short(best[0]) if best else "(no host event)", length * 1e-9])
    window_s = (w1 - w0) * 1e-9
    out = {
        "units": len(units),
        "window_s": window_s,
        "busy_s": busy_ns * 1e-9,
        "idle_share": 1.0 - busy_ns / (w1 - w0),
        "launches": sum(1 for n, s, e in device if w0 <= s < w1),
        "device_s": sum(by_name.values()),
        "by_name": dict(by_name),
        "span_device_s": span_device,
        "device_ops": [[_short(n), t] for n, t in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": named,
    }
    return {**out, **split(inside)} if collectives else out
