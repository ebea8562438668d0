"""Frame dumps shared with the inference loop (counterpart of
``vae2_tpu/core/train_loop.py:31-50``). The training loop itself comes with
the training slice."""

from __future__ import annotations

import os

import numpy as np

from ..data.video import IMAGENET_MEAN, IMAGENET_STD


def denormalize_to_uint8(x: np.ndarray) -> np.ndarray:
    """(H, W, 3) normalized float -> uint8 image (reference function.py:555-566)."""
    x = x * IMAGENET_STD + IMAGENET_MEAN
    x = np.clip(x * 255.0, 0, 255)
    return x.astype(np.uint8)


def save_frames_png(clip: np.ndarray, save_path: str, prefix: str) -> None:
    """Save each 3-channel frame of an (H, W, 3F) clip as a PNG.

    Accepts either raw uint8 frames (the loader's on-host format) or
    normalized float frames (model predictions), which get denormalized.
    """
    from PIL import Image

    os.makedirs(save_path, exist_ok=True)
    num_frames = clip.shape[-1] // 3
    for f in range(num_frames):
        fr = clip[..., f * 3: f * 3 + 3]
        im = fr if fr.dtype == np.uint8 else denormalize_to_uint8(
            fr.astype(np.float32))
        Image.fromarray(np.ascontiguousarray(im)).save(
            os.path.join(save_path, f"{prefix}_{f}.png"))
