"""device_idle.train_ddp: device_idle.train's reading (the share of the
traced steps in which no device activity ran, in %) on each card, the mean
over the cards: an NCCL kernel that waits for other ranks counts as busy,
so one card's share swings with which host is slowest, and the mean does
not."""

from pathlib import Path

from benchmark import manifest

NAME = "device_idle.train_ddp"
_train = manifest.reader("device_idle.train", Path(__file__).resolve().parents[1])


def read(ctx):
    if "ranks" in ctx:
        values = [r.get(NAME) for r in ctx["ranks"]]
        return None if None in values else sum(values) / len(values)
    return _train.read(ctx)
