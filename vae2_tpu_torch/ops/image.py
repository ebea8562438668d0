"""Bilinear resize, torch ``F.interpolate`` semantics.

Counterpart of ``resize_bilinear`` (vae2_tpu/ops/image.py:86-101), which
asserts equivalence with ``F.interpolate(mode='bilinear',
align_corners=False)`` — half-pixel centres, clamped taps. Here x is NCHW
(channels_last memory stays channels_last). Under a spatial layout each
rank resizes into the rows it owns, from the rows of other ranks that they
read (``parallel/sync.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import sync


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear-resize an NCHW batch to (height, width). Under a spatial
    layout x holds this rank's rows and ``height`` is its local share of
    the target: :func:`_resize_rows_sharded`."""
    if x.shape[2] == height and x.shape[3] == width:
        return x
    if sync.spatial_size() > 1:
        return _resize_rows_sharded(x, height, width)
    return F.interpolate(x, size=(height, width), mode="bilinear",
                         align_corners=False)


def _resize_rows_sharded(x: torch.Tensor, height: int,
                         width: int) -> torch.Tensor:
    """This rank's rows (``sync.own_rows``) of the whole image's resize
    from H_in to H_out rows (the global heights of x's width and of
    ``width``, ``sync.global_rows``), from the rows of x that they read,
    its own and other ranks' (``sync.halo_rows``).

    An integer factor s = H_out / H_in: the resize of the window of input
    rows [lo, hi) to (hi - lo) * s rows, cropped to this rank's rows. In
    the window the scale is 1 / s, as over the whole image, so window
    output row i - s*lo takes source position (i + 0.5) / s - 0.5 - lo:
    the global position shifted by lo, with the same fraction, hence the
    same weights. The window reaches one row past each tap (an edge copy
    beyond the image: the whole image's clamped tap), so no tap is clamped
    inside it. Any other factor: the taps and weights of
    ``F.interpolate`` (align_corners False: source (i + 0.5) * H_in / H_out
    - 0.5, clamped at 0), computed in f32 for this rank's rows and applied
    to its window after the resize along W, in f32. W is never sharded,
    and a separable resize treats it as on the whole image."""
    s = sync.spatial_size()
    h_in = sync.global_rows(x.shape[2], x.shape[3])
    h_out = sync.global_rows(height, width)
    ranges = [sync.row_range(h_out, r, s) for r in range(s)]
    if h_out % h_in == 0:
        f = h_out // h_in

        def window(a, b):  # the taps of rows a .. b - 1, and one row more
            return ((a + 0.5) / f - 0.5) // 1, ((b - 0.5) / f - 0.5) // 1 + 2

        windows = [tuple(int(v) for v in window(a, b)) if b > a else (0, 0)
                   for a, b in ranges]
        xw = sync.halo_rows(x, h_in, windows, "edge")
        a, b = ranges[sync.spatial_rank()]
        if b == a:
            return sync.connected_empty(xw, x.shape[:2] + (0, width))
        lo, hi = windows[sync.spatial_rank()]
        y = F.interpolate(xw, size=((hi - lo) * f, width), mode="bilinear",
                          align_corners=False)
        return y[:, :, a - f * lo:b - f * lo]
    taps = [_taps(a, b, h_in, h_out) for a, b in ranges]
    windows = [(int(t[0].min()), int(t[1].max()) + 1) if b > a else (0, 0)
               for t, (a, b) in zip(taps, ranges)]
    xw = sync.halo_rows(x, h_in, windows, "edge")
    a, b = ranges[sync.spatial_rank()]
    if b == a:
        return sync.connected_empty(xw, x.shape[:2] + (0, width))
    i0, i1, w1 = taps[sync.spatial_rank()]
    lo = windows[sync.spatial_rank()][0]
    yw = F.interpolate(xw.float(), size=(xw.shape[2], width),
                       mode="bilinear", align_corners=False)
    dev = x.device
    w1 = torch.as_tensor(w1, device=dev).view(1, 1, -1, 1)
    y = (yw.index_select(2, torch.as_tensor(i0 - lo, device=dev)) * (1 - w1)
         + yw.index_select(2, torch.as_tensor(i1 - lo, device=dev)) * w1)
    fmt = (torch.channels_last if x.is_contiguous(
        memory_format=torch.channels_last) else torch.contiguous_format)
    return y.to(x.dtype).contiguous(memory_format=fmt)


def _taps(a: int, b: int, h_in: int, h_out: int):
    """Rows a .. b - 1 of a bilinear resize from h_in to h_out rows, as
    ``F.interpolate`` computes them in f32: (lower tap, upper tap, weight
    of the upper tap)."""
    scale = np.float32(h_in) / np.float32(h_out)
    src = scale * (np.arange(a, b, dtype=np.float32) + np.float32(0.5)) \
        - np.float32(0.5)
    src = np.maximum(src, np.float32(0))
    i0 = src.astype(np.int64)
    i1 = np.minimum(i0 + 1, h_in - 1)
    return i0, i1, (src - i0.astype(np.float32)).astype(np.float32)
