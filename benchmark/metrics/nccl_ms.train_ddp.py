"""nccl_ms.train_ddp: the collectives' own device milliseconds a step in the
traced steps: for each collective, the shortest of its NCCL kernels over
the cards (``trace.exchange_s``), summed, per step. An NCCL kernel runs
from the moment its card reaches the collective until every rank has, so
each card's own NCCL time holds its wait for the slower hosts too; the
card that came last to a collective waits for no one. A rank's own
reading, before rank 0 merges them, is its list of NCCL kernels."""

from benchmark import trace

NAME = "nccl_ms.train_ddp"


def read(ctx):
    t = ctx["trace"]
    if "ranks" in ctx:
        seconds = trace.exchange_s(r.get(NAME) for r in ctx["ranks"])
        return None if seconds is None or not t else 1e3 * seconds / t["units"]
    if not t or ctx["work"].get("kind") != "train" or "collective_ns" not in t:
        return None
    return t["collective_ns"]
