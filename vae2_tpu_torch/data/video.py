"""Video clip datasets: zip-of-frames sequences (Cityscapes).

A copy of ``vae2_tpu/data/video.py`` on its PIL decode path (reference
lib/datasets/cityscapes.py:207-326); the UCF-101 dataset is not ported
yet:

- The host only decodes and resizes, and returns **uint8** HWC clips; the
  normalize (/255, ImageNet mean/std) runs on the device
  (``data/loader.py:normalize_clips``).
- A clip sample is (H, W, 3*clip_length*clip_num) channel-stacked uint8,
  split into clip_num arrays of 3*clip_length channels by the loader.
- Corrupt frames fall back to a neighbouring frame with an error log
  (cityscapes.py:290-298).

The JAX package's native C++ decoder (``vae2_tpu/native``) is not ported
yet; PNG decode is lossless, so both give the same bytes wherever PIL's
resize is the identity.
"""

from __future__ import annotations

import logging
import os
import zipfile
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image

logger = logging.getLogger("vae2_tpu_torch")

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class ClipSequenceDataset:
    """Base zip-clip dataset.

    crop_size is (height, width) — reference convention
    (tools/train.py:114: crop = (IMAGE_SIZE[1], IMAGE_SIZE[0])).
    """

    def __init__(
        self,
        root: str,
        list_path: str,
        crop_size: Tuple[int, int] = (128, 256),
        clip_length: int = 3,
        clip_num: int = 3,
        random_pos: bool = True,
        num_samples: Optional[int] = None,
        seed: int = 0,
    ):
        self.root = root
        self.list_path = list_path
        self.crop_size = tuple(crop_size)
        self.clip_length = clip_length
        self.clip_num = clip_num
        self.random_pos = random_pos
        self.rng = np.random.RandomState(seed)
        self.files = self._read_files()
        if num_samples:
            self.files = self.files[:num_samples]

    # subclasses implement
    def _read_files(self) -> List[dict]:
        raise NotImplementedError

    def _zip_path(self, item: dict) -> str:
        raise NotImplementedError

    def _frame_name(self, idx: int) -> str:
        raise NotImplementedError

    def _sequence_length(self, item: dict) -> int:
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self.files)

    def _load_frame(self, zf: zipfile.ZipFile, idx: int) -> Image.Image:
        """Open one frame; fall back to a neighbor on corruption
        (cityscapes.py:290-298)."""
        try:
            return Image.open(zf.open(self._frame_name(idx))).convert("RGB")
        except Exception:
            new_idx = idx - 1 if idx > 0 else idx + 1
            logger.error("Failed to open %s, open %s instead",
                         self._frame_name(idx), self._frame_name(new_idx))
            return Image.open(zf.open(self._frame_name(new_idx))).convert("RGB")

    def sample_position(self, length: int) -> int:
        """Random (train) or fixed-at-end (eval) clip start
        (cityscapes.py:303-304)."""
        span = self.clip_length * self.clip_num
        if self.random_pos:
            return int(self.rng.randint(0, max(1, length - span + 1)))
        return max(0, length - span - 1)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, str]:
        """Returns (clips, name): clips is uint8 (H, W, 3*L*N)."""
        item = self.files[index]
        length = self._sequence_length(item)
        span = self.clip_length * self.clip_num
        h, w = self.crop_size
        pos = self.sample_position(length)
        frames = []
        with zipfile.ZipFile(self._zip_path(item), mode="r") as zf:
            for p in range(pos, pos + span):
                im = self._load_frame(zf, p).resize((w, h))
                frames.append(np.asarray(im, np.uint8))
        return np.concatenate(frames, axis=-1), item["name"]


class CityscapesSequence(ClipSequenceDataset):
    """30-frame Cityscapes driving videos, one zip per video
    (cityscapes.py:207-326). List file: one zip-relative path per line."""

    image_tmpl = "{:06d}_leftImg8bit.png"
    video_length = 30

    def _read_files(self) -> List[dict]:
        with open(self.list_path) as f:
            seqs = [line.strip() for line in f if line.strip()]
        return [
            {"seq": s, "name": os.path.splitext(os.path.basename(s))[0]}
            for s in seqs
        ]

    def _zip_path(self, item: dict) -> str:
        return os.path.join(self.root, item["seq"])

    def _frame_name(self, idx: int) -> str:
        return self.image_tmpl.format(idx)

    def _sequence_length(self, item: dict) -> int:
        return self.video_length


def split_clips(stacked: np.ndarray, clip_length: int, clip_num: int
                ) -> List[np.ndarray]:
    """(..., 3*L*N) -> N arrays of (..., 3*L) (cityscapes.py:324)."""
    c = 3 * clip_length
    return [stacked[..., i * c: (i + 1) * c] for i in range(clip_num)]


def make_dataset(config, list_path: str, random_pos: bool = True,
                 num_samples: Optional[int] = None, seed: int = 0,
                 clip_num: int = 3):
    """Instantiate the configured dataset by its lowercase alias
    (reference lib/datasets/__init__.py:11-15, tools/train.py:115)."""
    name = config.DATASET.DATASET.lower()
    crop = (config.TRAIN.IMAGE_SIZE[1], config.TRAIN.IMAGE_SIZE[0])
    common = dict(
        root=config.DATASET.ROOT,
        list_path=list_path,
        crop_size=crop,
        clip_length=config.TRAIN.CLIP_LENGTH,
        clip_num=clip_num,
        random_pos=random_pos,
        num_samples=num_samples,
        seed=seed,
    )
    if name == "cityscapessequence":
        return CityscapesSequence(**common)
    if name == "ucfsequence":
        raise NotImplementedError("the UCF-101 dataset is not ported yet")
    raise KeyError(f"Unknown sequence dataset: {name}")
