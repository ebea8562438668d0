"""step_host_ms.train_ddp: the slowest rank's step_host_ms: each rank's
median host milliseconds inside the program's ``vae2.train_step`` over the
window's steps (``step_host_ms.train``'s reading), the largest over the
ranks. A step of several ranks waits for the slowest host."""

from pathlib import Path

from benchmark import manifest

NAME = "step_host_ms.train_ddp"
_train = manifest.reader("step_host_ms.train", Path(__file__).resolve().parents[1])


def read(ctx):
    if "ranks" in ctx:
        values = [r.get(NAME) for r in ctx["ranks"]]
        return None if None in values else max(values)
    return _train.read(ctx, "vae2.train_step")
