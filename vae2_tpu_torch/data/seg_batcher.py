"""Batches of a segmentation dataset for the seg train CLI, assembled in
the calling thread (the JAX package's tools/train_seg.py:27-53)."""

from __future__ import annotations

import numpy as np
import torch

from ..utils import spans


class SegBatcher:
    """Batches of a SegDataset: shuffled by ``RandomState(seed + epoch)``,
    the last partial batch dropped; images as (B, 3, H, W) channels_last
    float32 and labels as (B, H, W) int32, on ``device``. Each batch's
    assembly (the samples' decode and augmentation, the stack, the copy
    to the device) is a ``seg.next_batch`` step record (``utils/spans.py``)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, device: torch.device = torch.device("cpu")):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.device = device
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def __iter__(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        pin = self.device.type == "cuda"
        for i in range(len(self)):
            with spans.step("seg.next_batch"):
                chunk = idx[i * self.batch_size: (i + 1) * self.batch_size]
                samples = [self.dataset[j] for j in chunk]
                images = torch.from_numpy(np.stack([s[0] for s in samples]))
                labels = torch.from_numpy(np.stack([s[1] for s in samples]))
                if pin:
                    images, labels = images.pin_memory(), labels.pin_memory()
                images = images.to(self.device, non_blocking=True)
                batch = (images.permute(0, 3, 1, 2),
                         labels.to(self.device, non_blocking=True), None,
                         [s[3] for s in samples])
            yield batch
