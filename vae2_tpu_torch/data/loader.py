"""Batch loader (threaded decode) and the on-device clip normalization.

Counterpart of ``vae2_tpu/data/loader.py``. Batches leave the loader as
uint8 numpy arrays; the caller copies them to the device, where
``normalize_clips`` turns them into floats (3x less host-to-device traffic
than float32).
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from .video import IMAGENET_MEAN, IMAGENET_STD, split_clips


def _frame_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    frames = x.shape[-1] // 3
    mean = torch.from_numpy(np.tile(IMAGENET_MEAN, frames)).to(x.device)
    std = torch.from_numpy(np.tile(IMAGENET_STD, frames)).to(x.device)
    return mean, std


def normalize_clips(x: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3*F) -> normalized float32 (B, H, W, 3*F), on x's
    device: /255, minus ImageNet mean, over std, tiled per frame
    (reference base_dataset.py:41-46, cityscapes.py:311-316)."""
    mean, std = _frame_stats(x)
    return (x.to(torch.float32) / 255.0 - mean) / std


def denormalize_clips(x: torch.Tensor) -> torch.Tensor:
    """Inverse of normalize_clips, to float32 in [0, 255]; (..., 3*F)
    channels-last like normalize_clips."""
    mean, std = _frame_stats(x)
    return torch.clamp((x.to(torch.float32) * std + mean) * 255.0, 0.0, 255.0)


class ClipLoader:
    """Iterates (batch, names) with a clip_num-way split into xt/x2t/x3t.

    Yields ``{'xt','x2t','x3t'}`` uint8 arrays of (B, H, W, 3*clip_length).
    ``set_epoch`` reshuffles deterministically per epoch (the
    DistributedSampler.set_epoch equivalent, train.py:298-299).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_threads: int = 4, seed: int = 0,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_threads = max(1, num_threads)
        self.seed = seed
        self.prefetch = max(1, prefetch)
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> List[int]:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        return list(idx)

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _load_batch(self, batch_idx: List[int]
                    ) -> Tuple[Dict[str, np.ndarray], List[str]]:
        samples = [self.dataset[i] for i in batch_idx]
        stacked = np.stack([s[0] for s in samples])  # (B, H, W, 3*L*N)
        names = [s[1] for s in samples]
        clips = split_clips(stacked, self.dataset.clip_length,
                            self.dataset.clip_num)
        keys = ["xt", "x2t", "x3t", "x4t", "x5t"][: len(clips)]
        return dict(zip(keys, clips)), names

    def __iter__(self) -> Iterator[Tuple[Dict[str, np.ndarray], List[str]]]:
        indices = self._indices()
        batches = [
            indices[i: i + self.batch_size]
            for i in range(0, len(indices), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if not batches:
            raise ValueError(
                f"Loader yields no batches: {len(indices)} samples "
                f"< batch_size {self.batch_size} (drop_last="
                f"{self.drop_last}). Reduce the batch size or add data.")
        with cf.ThreadPoolExecutor(self.num_threads) as pool:
            window = self.prefetch + 1
            futures = [pool.submit(self._load_batch, b)
                       for b in batches[:window]]
            next_submit = window
            for i in range(len(batches)):
                batch, names = futures[i].result()
                if next_submit < len(batches):
                    futures.append(
                        pool.submit(self._load_batch, batches[next_submit]))
                    next_submit += 1
                yield batch, names
