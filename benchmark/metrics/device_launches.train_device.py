"""device_launches.train_device: device_launches.train's reading, in the
cells whose end-to-end metric is the device's time a sample
(``train_device_ms_per_sample``)."""

from pathlib import Path

from benchmark import manifest

read = manifest.reader("device_launches.train", Path(__file__).resolve().parents[1]).read
