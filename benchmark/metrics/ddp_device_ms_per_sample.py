"""ddp_device_ms_per_sample: the cards' device time over the whole measured
window per clip triple of the global batch, in ms, with each card's wait
for the slower hosts taken out: each card's busy time outside NCCL's
kernels (the union of its other kernels', copies' and sets' intervals,
from a trace of device activity over every step of the window), plus, for
each collective, the shortest of its NCCL kernels over the cards (the
exchange itself: ``trace.exchange_s``), summed over the cards, over the
clip triples of the window's whole steps. The wait is left out because an
NCCL kernel spins until the last host has dispatched to it, so a card's
busy time carries every host's drift; the wall-clock rate that holds it is
``wall_samples_per_s.train_ddp``. A rank's own reading, before rank 0
merges them, is its parts."""

from benchmark import trace

NAME = "ddp_device_ms_per_sample"


def read(ctx):
    w = ctx["work"]
    if "ranks" in ctx:
        parts = [r.get(NAME) for r in ctx["ranks"]]
        if None in parts or not w["samples"]:
            return None
        exchange = trace.exchange_s(p["collective_ns"] for p in parts)
        other = sum(p["other_busy_s"] for p in parts)
        if exchange is None or other <= 0:
            return None
        return 1e3 * (other + len(parts) * exchange) / w["samples"]
    t = ctx.get("window_trace")
    if w.get("kind") != "train" or not t or "collective_ns" not in t:
        return None
    return {"other_busy_s": t["other_busy_s"], "collective_ns": t["collective_ns"]}
