"""wall_samples_per_s.train_device: train_samples_per_s by the host's clock,
per layer where it is not an end-to-end metric: the window of a
``--trace 1`` run is not traced (its profiled units come after it)."""

from pathlib import Path

from benchmark import manifest

read = manifest.reader("train_samples_per_s", Path(__file__).resolve().parents[1]).read
