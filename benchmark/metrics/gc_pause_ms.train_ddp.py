"""gc_pause_ms.train_ddp: gc_pause_ms.train's reading for the program's
``vae2.train_step`` (each rank's mean GC pause a window step), the largest
over the ranks: a step of several ranks waits for the slowest host, and a
full collection on any of them holds every card."""

from pathlib import Path

from benchmark import manifest

NAME = "gc_pause_ms.train_ddp"
_train = manifest.reader("gc_pause_ms.train", Path(__file__).resolve().parents[1])


def read(ctx):
    if "ranks" in ctx:
        values = [r.get(NAME) for r in ctx["ranks"]]
        return None if None in values else max(values)
    return _train.read(ctx, "vae2.train_step")
