"""gc_pause_ms.train: the mean milliseconds a step that Python's garbage
collector paused inside the program's ``seg.train_step`` (each step
record's ``gc_pause_s``, the change of the ``gc.pause_s`` counter over the
step) over the window's steps, as ``step_host_ms.train`` finds them. The mean, because a full collection
falls in some steps and not in others."""

from pathlib import Path

from benchmark import manifest

STEP = "seg.train_step"
window = manifest.reader("step_host_ms.train", Path(__file__).resolve().parents[1]).window


def read(ctx, step=STEP):
    records = window(ctx, step)
    if not records:
        return None
    return 1e3 * sum(r["gc_pause_s"] for r in records) / len(records)
