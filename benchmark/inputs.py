"""Seeded inputs made on the device: clips, images, labels and noise.

Frames are smooth random fields (normal draws on a grid ``coarse`` times
coarser than the frame, resized bilinearly and mapped to uint8), so that
SSIM and MS-SSIM read structure and not noise; labels are piecewise
constant class maps on the same kind of grid, with a share of pixels at
the ignore label. Every seed gives the same sizes; only the values move.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .reference.scores import IMAGENET_MEAN, IMAGENET_STD


def sub_seed(seed: int, *keys: int) -> int:
    """A generator seed for one part of a run: a mix of the run's seed and
    the part's keys, within 63 bits."""
    x = seed & (2**64 - 1)
    for k in keys:
        x = (x * 6364136223846793005 + 1442695040888963407 + k) & (2**64 - 1)
        x ^= x >> 29
    return x & (2**63 - 1)


def frames_u8(g, n: int, h: int, w: int, channels: int, coarse: int, device):
    """(n, h, w, channels) uint8 smooth random frames."""
    low = torch.randn((n, channels, max(h // coarse, 1), max(w // coarse, 1)),
                      generator=g, device=device)
    x = F.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
    x = (128.0 + 60.0 * x).clamp(0, 255).round().to(torch.uint8)
    return x.permute(0, 2, 3, 1).contiguous()


def clips(g, n: int, h: int, w: int, frames: int, coarse: int, device):
    """{'xt', 'x2t', 'x3t'}: n clips of ``frames`` RGB frames each, NHWC."""
    return {k: frames_u8(g, n, h, w, 3 * frames, coarse, device)
            for k in ("xt", "x2t", "x3t")}


def images(g, n: int, h: int, w: int, coarse: int, device):
    """(n, 3, h, w) float32 channels_last, normalized with ImageNet's
    statistics as the segmentation loader normalizes."""
    x = frames_u8(g, n, h, w, 3, coarse, device).float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    x = ((x - mean) / std).permute(0, 3, 1, 2)
    return x.contiguous(memory_format=torch.channels_last)


def labels(g, n: int, h: int, w: int, classes: int, coarse: int,
           ignore_share: float, ignore: int, device):
    """(n, h, w) int32 class maps, ``ignore_share`` of the coarse cells at
    ``ignore``."""
    gh, gw = max(h // coarse, 1), max(w // coarse, 1)
    cls = torch.randint(0, classes, (n, 1, gh, gw), generator=g, device=device)
    drop = torch.rand((n, 1, gh, gw), generator=g, device=device) < ignore_share
    cls = torch.where(drop, torch.full_like(cls, ignore), cls)
    return F.interpolate(cls.float(), size=(h, w), mode="nearest")[:, 0].to(torch.int32)


def normal(g, shape, device):
    return torch.randn(shape, generator=g, device=device)
