"""gc_pause_ms.train_device: gc_pause_ms.train's reading for the program's
``vae2.train_step``, in the cells whose end-to-end metric is the device's
time a sample (``train_device_ms_per_sample``); like the step's host time,
it moves the wall rate ``wall_samples_per_s.train_device``."""

from pathlib import Path

from benchmark import manifest

_train = manifest.reader("gc_pause_ms.train", Path(__file__).resolve().parents[1])


def read(ctx):
    return _train.read(ctx, "vae2.train_step")
