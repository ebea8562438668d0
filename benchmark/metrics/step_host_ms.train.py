"""step_host_ms.train: the median host milliseconds inside the program's
``seg.train_step`` over the steps of the measured window, from the
program's own step records (``vae2_tpu_torch.utils.spans.steps()``): the
last ``attempted`` records of the step taken with no profiler active,
which in a ``--trace 1`` run are the window's steps (set-up's checked
steps come before them, the profiled units after). None where the program
keeps no such records."""

import statistics

STEP = "seg.train_step"


def window(ctx, step):
    """The window's records of ``step``, oldest first, or None."""
    try:
        from vae2_tpu_torch.utils import spans
    except ImportError:
        return None
    n = ctx["work"].get("attempted", 0)
    if ctx["work"].get("kind") != "train" or n <= 0:
        return None
    held = [r for r in spans.steps() if r["name"] == step and not r["profiled"]]
    return held[-n:] if len(held) >= n else None


def read(ctx, step=STEP):
    records = window(ctx, step)
    return 1e3 * statistics.median(r["host_s"] for r in records) if records else None
