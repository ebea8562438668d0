"""collective_calls.train_ddp: the program's all-reduces and halo exchanges
a step on rank 0 (its counters ``sync.all_reduces`` and
``sync.halo_exchanges``, their change over the traced steps). None where
the program keeps no such counters or made no collective (one process)."""

COUNTERS = ("sync.all_reduces", "sync.halo_exchanges")


def read(ctx):
    t = ctx["trace"]
    if not t or ctx["work"].get("kind") != "train":
        return None
    made = sum(t.get("counters", {}).get(k, 0) for k in COUNTERS)
    return made / t["units"] if made > 0 else None
