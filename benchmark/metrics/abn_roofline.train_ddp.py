"""abn_roofline.train_ddp: abn_roofline.train's reading on rank 0's card in
a run of several ranks (the ABN kernels' work of a rank's step against
their time on its card), for the cell whose end-to-end metric is
ddp_device_ms_per_sample."""

from pathlib import Path

from benchmark import manifest

read = manifest.reader("abn_roofline.train", Path(__file__).resolve().parents[1]).read
