"""Video clip datasets: zip-of-frames sequences (Cityscapes / UCF-101).

A copy of ``vae2_tpu/data/video.py`` (reference
lib/datasets/cityscapes.py:207-326, ucf101.py:16-124):

- The host only decodes and resizes, and returns **uint8** HWC clips; the
  normalize (/255, ImageNet mean/std) runs on the device
  (``data/loader.py:normalize_clips``).
- A clip sample is (H, W, 3*clip_length*clip_num) channel-stacked uint8,
  split into clip_num arrays of 3*clip_length channels by the loader.
- Corrupt frames fall back to a neighbouring frame with an error log
  (cityscapes.py:290-298).

Frames decode through the port's copy of the native C++ decoder
(``vae2_tpu_torch/native``: one batched call per clip, the GIL released),
the JAX package's own resize, so that both packages give the same bytes.
Where it does not build (no g++, or no libpng/libjpeg headers) or
``VAE2_NO_NATIVE=1``, frames decode with PIL and resize with its BILINEAR
filter, named explicitly (PIL's default for RGB is BICUBIC, which the JAX
package's fallback keeps): the antialiased triangle filter that the native
decoder implements (clip_decoder.cpp:138-140), so the two agree to one grey
level where they resize and byte for byte where the resize is the identity.
``frames_by_decoder`` counts the frames each path made.
"""

from __future__ import annotations

import logging
import os
import threading
import zipfile
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image

from .. import native

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
        self.frames_by_decoder = {"native": 0, "pil": 0}
        self._count_lock = threading.Lock()  # loader threads share it

    # subclasses implement
    def _read_files(self) -> List[dict]:
        raise NotImplementedError

    def _zip_path(self, item: dict) -> str:
        raise NotImplementedError

    def _frame_name(self, idx: int) -> str:
        raise NotImplementedError

    def _sequence_length(self, item: dict) -> int:
        raise NotImplementedError

    def _frame_offset(self) -> int:
        return 0

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

    def clip_start(self, index: int) -> int:
        """The first frame of sample ``index``'s clip. A train dataset draws
        it from its one RandomState, so the draws follow the order of the
        calls: ``ClipLoader`` makes them in its own thread, in batch order,
        and hands them to ``load``."""
        length = self._sequence_length(self.files[index])
        return self.sample_position(length) + self._frame_offset()

    def __getitem__(self, index: int) -> Tuple[np.ndarray, str]:
        """Returns (clips, name): clips is uint8 (H, W, 3*L*N)."""
        return self.load(index, self.clip_start(index))

    def load(self, index: int, pos: int) -> Tuple[np.ndarray, str]:
        """Sample ``index``'s clip from frame ``pos`` on: (clips, name)."""
        item = self.files[index]
        span = self.clip_length * self.clip_num
        h, w = self.crop_size
        with zipfile.ZipFile(self._zip_path(item), mode="r") as zf:
            clip = self._native_decode(zf, pos, span, w, h)
            decoder = "native"
            if clip is None:
                frames = []
                for p in range(pos, pos + span):
                    im = self._load_frame(zf, p).resize((w, h), Image.BILINEAR)
                    frames.append(np.asarray(im, np.uint8))
                clip, decoder = np.concatenate(frames, axis=-1), "pil"
        with self._count_lock:
            self.frames_by_decoder[decoder] += span
        return clip, item["name"]

    def _native_decode(self, zf: zipfile.ZipFile, pos: int, span: int,
                       w: int, h: int) -> Optional[np.ndarray]:
        """The clip through the native decoder, or None where it is
        unavailable or a frame and its neighbour are both missing."""
        if not native.available():
            return None
        datas = []
        for p in range(pos, pos + span):
            try:
                datas.append(zf.read(self._frame_name(p)))
            except KeyError:
                new_p = p - 1 if p > 0 else p + 1
                logger.error("Failed to open %s, open %s instead",
                             self._frame_name(p), self._frame_name(new_p))
                try:
                    datas.append(zf.read(self._frame_name(new_p)))
                except KeyError:
                    return None
        out = native.decode_batch(datas, w, h, threads=2)
        # (span, h, w, 3) -> (h, w, 3*span)
        return np.ascontiguousarray(
            np.moveaxis(out, 0, 2).reshape(h, w, 3 * span))


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


class UcfSequence(ClipSequenceDataset):
    """UCF-101 videos: per-video dir with RGB_frames.zip of 1-indexed JPEGs
    (ucf101.py:16-124). List file lines: ``<dir> <length>``."""

    image_tmpl = "image_{:05d}.jpg"

    def __init__(self, *args, fixed_length: bool = False,
                 is_baseline: bool = False, **kwargs):
        self.fixed_length = fixed_length
        self.is_baseline = is_baseline
        super().__init__(*args, **kwargs)

    def _read_files(self) -> List[dict]:
        files = []
        with open(self.list_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    continue
                seq, length = parts[0], int(parts[1])
                files.append({
                    "seq": seq,
                    "name": os.path.splitext(os.path.basename(seq))[0],
                    "length": length,
                })
        return files

    def _zip_path(self, item: dict) -> str:
        return os.path.join(self.root, item["seq"], "RGB_frames.zip")

    def _frame_name(self, idx: int) -> str:
        return self.image_tmpl.format(idx)

    def _frame_offset(self) -> int:
        return 1  # UCF frames are 1-indexed (ucf101.py:103)

    def _sequence_length(self, item: dict) -> int:
        length = item["length"]
        if self.fixed_length:
            length = min(length, 30)
        return max(self.clip_length * self.clip_num, length)

    def sample_position(self, length: int) -> int:
        span = self.clip_length * self.clip_num
        if self.random_pos:
            return int(self.rng.randint(0, max(1, length - span + 1)))
        # eval keeps a margin of 3 for non-baseline (ucf101.py:102)
        return max(0 if self.is_baseline else 3, length - span - 1)


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
        return UcfSequence(
            fixed_length=config.DATASET.FIXED_LENGTH,
            is_baseline=config.MODEL.EXTRA.IS_BASELINE,
            **common,
        )
    raise KeyError(f"Unknown sequence dataset: {name}")
