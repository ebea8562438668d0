"""step_host_ms.train_device: step_host_ms.train's reading for the
program's ``vae2.train_step``, in the cells whose end-to-end metric is the
device's time a sample (``train_device_ms_per_sample``). The host's time
moves that cell's wall rate, ``wall_samples_per_s.train_device``, and not
its device time."""

from pathlib import Path

from benchmark import manifest

_train = manifest.reader("step_host_ms.train", Path(__file__).resolve().parents[1])


def read(ctx):
    return _train.read(ctx, "vae2.train_step")
