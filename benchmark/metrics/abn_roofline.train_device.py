"""abn_roofline.train_device: abn_roofline.train's reading, in the cells
whose end-to-end metric is the device's time a sample
(``train_device_ms_per_sample``)."""

from pathlib import Path

from benchmark import manifest

read = manifest.reader("abn_roofline.train", Path(__file__).resolve().parents[1]).read
