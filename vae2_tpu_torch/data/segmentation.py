"""Semantic-segmentation datasets (counterpart of
``vae2_tpu/data/segmentation.py:38-328``; reference lib/datasets/
base_dataset.py, cityscapes.py, lip.py, pascal_ctx.py).

Host side, without OpenCV: PIL decodes (RGB, where cv2 gives BGR and the JAX
package's ``input_transform`` flips it, so this one does not), the resizes
and the pad are ``data/resize.py``'s copies of cv2's. /255 + ImageNet
normalize; multi-scale + flip augmentation with pad and random crop. The
random draws come from ``np.random.RandomState(seed)`` in the JAX package's
order (scale, crop x, crop y, flip), so one seed gives both packages the
same crops. Samples are float32 HWC images and int32 label maps with
ignore_label padding.

The multi-scale crop resizes only the window that it keeps: cv2's resize
gives every output pixel from its own coordinates, so resize, pad and crop
equal the crop's own resize and pad.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from .resize import pad_constant, resize_linear, resize_nearest, \
    resize_nearest_by

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# 34-class -> 19-class training id mapping (cityscapes.py:256-267)
CITYSCAPES_LABEL_MAP = {
    -1: -1, 0: -1, 1: -1, 2: -1, 3: -1, 4: -1, 5: -1, 6: -1,
    7: 0, 8: 1, 9: -1, 10: -1, 11: 2, 12: 3, 13: 4, 14: -1, 15: -1,
    16: -1, 17: 5, 18: -1, 19: 6, 20: 7, 21: 8, 22: 9, 23: 10, 24: 11,
    25: 12, 26: 13, 27: 14, 28: 15, 29: -1, 30: -1, 31: 16, 32: 17, 33: 18,
}

# per-class loss weights (cityscapes.py:236-240)
CITYSCAPES_CLASS_WEIGHTS = np.array(
    [0.8373, 0.918, 0.866, 1.0345, 1.0166, 0.9969, 0.9754, 1.0489,
     0.8786, 1.0023, 0.9539, 0.9843, 1.1116, 0.9037, 1.0865, 1.0955,
     1.0865, 1.1529, 1.0507], np.float32)

# left/right paired part labels for flip handling (lip.py:87-99)
LIP_RIGHT_IDX = [15, 17, 19]
LIP_LEFT_IDX = [14, 16, 18]


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB, as cv2.IMREAD_COLOR then BGR -> RGB."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def read_label(path: str) -> np.ndarray:
    """(H, W) uint8, as cv2.IMREAD_GRAYSCALE for an 8-bit grey PNG."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im if im.mode == "L" else im.convert("L"))


class SegDataset:
    """Base segmentation dataset with the reference augmentation pipeline."""

    def __init__(self, root: str, list_path: str, num_classes: int = 19,
                 multi_scale: bool = True, flip: bool = True,
                 ignore_label: int = -1, base_size: int = 2048,
                 crop_size: Tuple[int, int] = (512, 1024),
                 downsample_rate: float = 1, scale_factor: int = 16,
                 num_samples: Optional[int] = None, seed: int = 0):
        self.root = root
        self.list_path = list_path
        self.num_classes = num_classes
        self.multi_scale = multi_scale
        self.flip = flip
        self.ignore_label = ignore_label
        self.base_size = base_size
        self.crop_size = tuple(crop_size)
        self.downsample_rate = downsample_rate
        self.scale_factor = scale_factor
        self.rng = np.random.RandomState(seed)
        self.files = self.read_files()
        if num_samples:
            self.files = self.files[:num_samples]
        self.class_weights: Optional[np.ndarray] = None
        # (left, right) class pairs whose logits swap under flip TTA
        self.flip_pairs: Optional[list] = None

    def read_files(self) -> List[dict]:
        files = []
        with open(self.list_path) as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                item = {"img": parts[0], "name": os.path.splitext(
                    os.path.basename(parts[0]))[0]}
                if len(parts) > 1:
                    item["label"] = parts[1]
                files.append(item)
        return files

    def __len__(self) -> int:
        return len(self.files)

    # -- transforms (base_dataset.py:41-147) --------------------------------

    def input_transform(self, image: np.ndarray) -> np.ndarray:
        """RGB uint8 -> normalized float32 (no channel flip: PIL is RGB)."""
        image = image.astype(np.float32) / 255.0
        return (image - IMAGENET_MEAN) / IMAGENET_STD

    def label_transform(self, label: np.ndarray) -> np.ndarray:
        return np.array(label).astype(np.int32)

    def multi_scale_aug(self, image, label, rand_scale: float):
        """Resize so that the long side is base_size * rand_scale (linear on
        the image, nearest on the label), pad to the crop size (0 and
        ignore_label) and take a random crop: only the crop is resized."""
        long_size = int(self.base_size * rand_scale + 0.5)
        h, w = image.shape[:2]
        if h > w:
            new_h, new_w = long_size, int(w * long_size / h + 0.5)
        else:
            new_w, new_h = long_size, int(h * long_size / w + 0.5)
        ch, cw = self.crop_size
        pad_h, pad_w = max(ch - new_h, 0), max(cw - new_w, 0)
        x = self.rng.randint(0, new_w + pad_w - cw + 1)
        y = self.rng.randint(0, new_h + pad_h - ch + 1)
        rows = (y, min(y + ch, new_h))
        cols = (x, min(x + cw, new_w))
        image = resize_linear(image, new_w, new_h, rows, cols)
        label = resize_nearest(label, new_w, new_h, rows, cols)
        fill_h, fill_w = ch - image.shape[0], cw - image.shape[1]
        return (pad_constant(image, fill_h, fill_w, 0.0),
                pad_constant(label, fill_h, fill_w, self.ignore_label))

    def gen_sample(self, image, label, multi_scale=True, is_flip=True):
        if multi_scale:
            rand_scale = 0.5 + self.rng.randint(0, self.scale_factor) / 10.0
            image, label = self.multi_scale_aug(image, label, rand_scale)
        image = self.input_transform(image)
        label = self.label_transform(label)
        if is_flip:
            flip = self.rng.choice([-1, 1])
            image = image[:, ::flip, :]
            label = label[:, ::flip]
        if self.downsample_rate != 1:
            label = resize_nearest_by(label.astype(np.float32),
                                      self.downsample_rate).astype(np.int32)
        return np.ascontiguousarray(image), np.ascontiguousarray(label)

    def convert_label(self, label, inverse=False):
        return label

    def __getitem__(self, index: int):
        item = self.files[index]
        image = read_image(os.path.join(self.root, item["img"]))
        size = image.shape
        if item.get("label") is None:
            return self.input_transform(image), np.array(size), item["name"]
        label = read_label(os.path.join(self.root, item["label"]))
        label = self.convert_label(label)
        image, label = self.gen_sample(image, label, self.multi_scale,
                                       self.flip)
        return image, label, np.array(size), item["name"]


class CityscapesSeg(SegDataset):
    """19-class Cityscapes segmentation (cityscapes.py:22-204)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.class_weights = CITYSCAPES_CLASS_WEIGHTS

    def convert_label(self, label, inverse=False):
        # int32 working copy: the ignore label is -1, raw labels are uint8
        label = label.astype(np.int32)
        temp = label.copy()
        pairs = CITYSCAPES_LABEL_MAP.items()
        for k, v in pairs:
            label[temp == (v if inverse else k)] = k if inverse else v
        return label

    @staticmethod
    def get_palette(n: int) -> List[int]:
        """Bit-interleaved PASCAL-style palette (cityscapes.py:380-394)."""
        palette = [0] * (n * 3)
        for j in range(n):
            lab, i = j, 0
            while lab:
                palette[j * 3 + 0] |= (((lab >> 0) & 1) << (7 - i))
                palette[j * 3 + 1] |= (((lab >> 1) & 1) << (7 - i))
                palette[j * 3 + 2] |= (((lab >> 2) & 1) << (7 - i))
                i += 1
                lab >>= 3
        return palette

    def save_pred(self, preds: np.ndarray, sv_path: str, names: List[str]):
        """Paletted PNGs of the argmax of (B, H, W, C) logits, in raw ids."""
        from PIL import Image

        palette = self.get_palette(256)
        preds = np.asarray(np.argmax(preds, axis=-1), dtype=np.uint8)
        for i in range(preds.shape[0]):
            pred = self.convert_label(preds[i], inverse=True)
            img = Image.fromarray(np.clip(pred, 0, 255).astype(np.uint8))
            img.putpalette(palette)
            img.save(os.path.join(sv_path, names[i] + ".png"))


class LIP(SegDataset):
    """LIP human parsing (lip.py:16-131): 20 classes, left/right label swap
    when flipping, and the paired logits swapped under flip TTA."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.flip_pairs = list(zip(LIP_LEFT_IDX, LIP_RIGHT_IDX))

    def gen_sample(self, image, label, multi_scale=True, is_flip=True):
        if multi_scale:
            rand_scale = 0.5 + self.rng.randint(0, self.scale_factor) / 10.0
            image, label = self.multi_scale_aug(image, label, rand_scale)
        image = self.input_transform(image)
        label = self.label_transform(label)
        if is_flip and self.rng.choice([0, 1]):
            image = image[:, ::-1, :]
            label = label[:, ::-1]
            tmp = label.copy()  # swap left/right part labels (lip.py:92-97)
            for r, l in zip(LIP_RIGHT_IDX, LIP_LEFT_IDX):
                label[tmp == r] = l
                label[tmp == l] = r
        return np.ascontiguousarray(image), np.ascontiguousarray(label)


class PASCALContext(SegDataset):
    """PASCAL-Context 59/60-class segmentation (pascal_ctx.py); labels are
    59-class-indexed PNGs named in the list file."""

    def __init__(self, *args, mode: int = 59, **kwargs):
        self.mode = mode
        super().__init__(*args, **kwargs)

    def convert_label(self, label, inverse=False):
        if self.mode == 59:
            # class 0 (background of the 60-class set) -> ignore; shift by -1
            label = label.astype(np.int32)
            if inverse:
                return label + 1
            label = label - 1
            label[label == -1] = self.ignore_label
        return label


def make_seg_dataset(config, list_path: str, train: bool = True,
                     num_samples: Optional[int] = None, seed: int = 0):
    """Instantiate by DATASET.DATASET (reference lib/datasets/__init__.py)."""
    name = config.DATASET.DATASET.lower()
    size = config.TRAIN.IMAGE_SIZE if train else config.TEST.IMAGE_SIZE
    common = dict(
        root=config.DATASET.ROOT,
        list_path=list_path,
        num_classes=config.DATASET.NUM_CLASSES,
        multi_scale=config.TRAIN.MULTI_SCALE if train else False,
        flip=config.TRAIN.FLIP if train else False,
        ignore_label=config.TRAIN.IGNORE_LABEL,
        base_size=config.TRAIN.BASE_SIZE if train else config.TEST.BASE_SIZE,
        crop_size=(size[1], size[0]),
        downsample_rate=config.TRAIN.DOWNSAMPLERATE if train else 1,
        scale_factor=config.TRAIN.SCALE_FACTOR,
        num_samples=num_samples,
        seed=seed,
    )
    classes = {"cityscapes": CityscapesSeg, "lip": LIP,
               "pascal_ctx": PASCALContext}
    if name not in classes:
        raise KeyError(f"Unknown segmentation dataset: {name}")
    return classes[name](**common)
