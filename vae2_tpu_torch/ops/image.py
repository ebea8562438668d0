"""Bilinear resize, torch ``F.interpolate`` semantics.

Counterpart of ``resize_bilinear`` (vae2_tpu/ops/image.py:86-101), which
asserts equivalence with ``F.interpolate(mode='bilinear',
align_corners=False)`` — half-pixel centres, clamped taps. Here x is NCHW
(channels_last memory stays channels_last). Under a spatial layout the
resize reads one row across each seam (``parallel/sync.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import sync


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear-resize an NCHW batch to (height, width). Under a spatial
    layout x holds this rank's rows and ``height`` is the local target:
    :func:`_resize_rows_sharded`."""
    if x.shape[2] == height and x.shape[3] == width:
        return x
    if sync.spatial_size() > 1:
        return _resize_rows_sharded(x, height, width)
    return F.interpolate(x, size=(height, width), mode="bilinear",
                         align_corners=False)


def _resize_rows_sharded(x: torch.Tensor, height: int,
                         width: int) -> torch.Tensor:
    """This rank's rows of the whole image's upsample by an integer H
    factor s, from its h rows and one row of each neighbour (the edge row
    itself at the image's top and bottom: ``sync.halo_rows`` 'edge').

    Resizing the (h + 2)-row padded block to (h + 2) * s rows and cropping
    s rows from each end is exact. In the padded block the scale is
    (h + 2) / ((h + 2) s) = 1 / s, as over the whole image, so output row
    i + s of the block takes source position (i + 0.5) / s - 0.5 + 1: the
    local position shifted by the one padded row, with the same fraction,
    hence the same weights, as the whole image's row of that rank. Its two
    taps lie within rows 0 .. h + 1 of the block (the position lies in
    [0.5 + 0.5/s, h + 0.5 - 0.5/s]), so no tap is clamped inside the
    block: a seam's taps are the neighbour's real row, and at the image's
    border the edge copy gives the whole image's clamped tap. W is never
    sharded, and a separable resize treats it as on the whole image."""
    h = x.shape[2]
    if height % h:
        raise ValueError(f"a spatial upsample needs an integer H factor: "
                         f"{h} local rows to {height}")
    s = height // h
    xp = sync.halo_rows(x, 1, 1, "edge")
    y = F.interpolate(xp, size=((h + 2) * s, width), mode="bilinear",
                      align_corners=False)
    return y[:, :, s:s + height]
