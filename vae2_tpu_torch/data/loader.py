"""Batch loader (threaded decode), the host-to-device prefetcher and the
on-device clip normalization.

Counterpart of ``vae2_tpu/data/loader.py``. Batches leave the loader as
uint8 numpy arrays; ``DevicePrefetcher`` copies them to the device ahead
of use, where ``normalize_clips`` turns them into floats (3x less
host-to-device traffic than float32).
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..parallel import sync
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

    ``process_index``/``process_count``: this rank's shard, the stride
    slice ``idx[r::R]`` of the shuffled list, as the JAX loader takes it
    (vae2_tpu/data/loader.py:73-80). Here alone the port differs from the
    JAX loader: the shuffled list is first cut to a multiple of R, so that
    every rank has the same ``len()``. Ranks that ran different numbers of
    steps would wait forever in each other's collectives (9 clips at batch
    1 over 2 ranks: 5 and 4 steps).

    ``row_index``/``row_count``: under a spatial layout, the process is one
    of ``row_count`` ranks that share these clips, and keeps block
    ``row_index`` of their H rows (the rows of ``batch_sharding``'s
    ``P('data', 'spatial')``, vae2_tpu/parallel/mesh.py:47-53), before the
    host-to-device copy; H must split evenly. The ranks of a group must
    then pick the same frames for each clip: where the dataset draws its
    clips' starts (``clip_start``), this thread draws them, in batch order,
    before it hands a batch to the decode threads, so that every rank's
    draws follow the same sequence whatever the threads' timing.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_threads: int = 4, seed: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 prefetch: int = 2, row_index: int = 0, row_count: int = 1):
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} outside "
                             f"[0, {process_count})")
        if not 0 <= row_index < row_count:
            raise ValueError(f"row_index {row_index} outside "
                             f"[0, {row_count})")
        self.row_index, self.row_count = row_index, row_count
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_threads = max(1, num_threads)
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
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
        r = self.process_count
        return list(idx[: n - n % r][self.process_index:: r])

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _submit(self, pool: cf.ThreadPoolExecutor,
                batch_idx: List[int]) -> cf.Future:
        """One batch's decode, its clips' starts drawn here first."""
        draw = getattr(self.dataset, "clip_start", None)
        starts = None if draw is None else [draw(i) for i in batch_idx]
        return pool.submit(self._load_batch, batch_idx, starts)

    def _load_batch(self, batch_idx: List[int], starts: Optional[List[int]]
                    ) -> Tuple[Dict[str, np.ndarray], List[str]]:
        if starts is None:
            samples = [self.dataset[i] for i in batch_idx]
        else:
            samples = [self.dataset.load(i, p)
                       for i, p in zip(batch_idx, starts)]
        stacked = np.stack([s[0] for s in samples])  # (B, H, W, 3*L*N)
        names = [s[1] for s in samples]
        if self.row_count > 1:
            h = stacked.shape[1]
            if h % self.row_count:
                raise ValueError(f"{h} rows do not split evenly over "
                                 f"{self.row_count} spatial ranks")
            start, stop = sync.row_range(h, self.row_index, self.row_count)
            stacked = stacked[:, start:stop]
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
            futures = [self._submit(pool, b) for b in batches[:window]]
            next_submit = window
            for i in range(len(batches)):
                batch, names = futures[i].result()
                if next_submit < len(batches):
                    futures.append(self._submit(pool, batches[next_submit]))
                    next_submit += 1
                yield batch, names


class DevicePrefetcher:
    """Wraps a loader and copies ``depth`` batches ahead of their use to
    ``device`` (data/loader.py:126-154 of the JAX package), the rank's own
    device in a multi-process run: from pinned host memory with
    ``non_blocking`` copies on a CUDA device, so that the copies overlap
    the device's work. Yields ({key: uint8 tensor}, names); ``set_epoch``
    forwards to the wrapped loader."""

    def __init__(self, loader, device: torch.device, depth: int = 2):
        self.loader = loader
        self.device = torch.device(device)
        self.depth = max(1, depth)

    def __len__(self) -> int:
        return len(self.loader)

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def _put(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {}
        for key, clip in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(clip))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            elif self.device.type != "cpu":
                raise ValueError(f"DevicePrefetcher: unsupported device "
                                 f"{self.device}")
            out[key] = t
        return out

    def __iter__(self) -> Iterator[Tuple[Dict[str, torch.Tensor], List[str]]]:
        queue = collections.deque()
        for batch, names in self.loader:
            queue.append((self._put(batch), names))
            if len(queue) >= self.depth:
                yield queue.popleft()
        while queue:
            yield queue.popleft()
