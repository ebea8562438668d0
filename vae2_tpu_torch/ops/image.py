"""Bilinear resize, torch ``F.interpolate`` semantics.

Counterpart of ``resize_bilinear`` (vae2_tpu/ops/image.py:86-101), which
asserts equivalence with ``F.interpolate(mode='bilinear',
align_corners=False)`` — half-pixel centres, clamped taps. Here x is NCHW
(channels_last memory stays channels_last).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear-resize an NCHW batch to (height, width)."""
    if x.shape[2] == height and x.shape[3] == width:
        return x
    return F.interpolate(x, size=(height, width), mode="bilinear",
                         align_corners=False)
