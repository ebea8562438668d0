"""device_launches.train_ddp: device_launches.train's reading on rank 0's
card in a run of several ranks (device activities a traced step, NCCL's
kernels among them), for the cell whose end-to-end metric is
ddp_device_ms_per_sample."""

from pathlib import Path

from benchmark import manifest

read = manifest.reader("device_launches.train", Path(__file__).resolve().parents[1]).read
