"""OpenCV's ``resize`` and constant-border pad in numpy, for the host-side
segmentation pipeline (the JAX package calls ``cv2`` at
vae2_tpu/data/segmentation.py:99,122-127,143-147 and
vae2_tpu/core/seg_loop.py:176-199,222-224; the port does not depend on
OpenCV).

- ``resize_linear`` is ``cv2.INTER_LINEAR``: source coordinate ``(d + 0.5)
  * src / dst - 0.5``, taps clamped at the left and right edges
  (weight 0 on the outside tap) and clipped at the top and bottom (the
  weights stay, both taps read the edge row), as ``cv::resize`` does. On
  uint8 it reproduces OpenCV's fixed point: the source coordinate in
  float32, weights rounded to 11 bits,
  the horizontal pass in integers, the vertical pass as its SIMD kernel
  computes it, ``((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16) + 2 >> 2``,
  which gives cv2's bytes exactly (tests/test_torch_port_seg_data.py). On
  float32 the weights in float, from a float32 coordinate for more than 4
  channels (cv2's values exactly) and a double one for up to 4 (within
  2e-7 of cv2's, relative: its vector path for those rounds otherwise).
- ``resize_nearest`` is ``cv2.INTER_NEAREST``: ``min(floor(d * src / dst),
  src - 1)``.
- ``pad_constant`` is ``cv2.copyMakeBorder(..., BORDER_CONSTANT)`` on the
  bottom and right, the value saturated to the array's type as OpenCV
  casts it.

Every output pixel depends only on its own coordinates, so a caller may ask
for a window of the output (``rows``, ``cols``): the data pipeline resizes
only the crop that it keeps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS
_ONE = 1 << _BITS


def _taps(dst: int, src: int, clamp: bool, coord32: bool):
    """(first tap, second tap, weight of the second) per output index; the
    source coordinate rounded to float32 with ``coord32``, else kept in
    double until the weight."""
    scale = 1.0 / (dst / src)  # cv2: 1 / inv_scale, inv_scale = dst / src
    f = (np.arange(dst) + 0.5) * scale - 0.5
    if coord32:
        f = f.astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    if clamp:
        lo, hi = s < 0, s >= src - 1
        f[lo], s[lo] = 0.0, 0
        f[hi], s[hi] = 0.0, src - 1
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), f


def _window(n: int, span: Optional[Tuple[int, int]]) -> slice:
    return slice(0, n) if span is None else slice(*span)


def resize_linear(img: np.ndarray, width: int, height: int,
                  rows: Optional[Tuple[int, int]] = None,
                  cols: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)``
    for an (H, W) or (H, W, C) uint8 or float32 array; ``rows``/``cols``
    (start, stop) select a window of the output."""
    if img.dtype not in (np.uint8, np.float32):
        raise TypeError(f"resize_linear takes uint8 or float32, got {img.dtype}")
    h_src, w_src = img.shape[:2]
    fixed = img.dtype == np.uint8
    src = img if img.ndim == 3 else img[..., None]
    coord32 = fixed or src.shape[2] > 4
    x0, x1, fx = (a[_window(width, cols)]
                  for a in _taps(width, w_src, True, coord32))
    y0, y1, fy = (a[_window(height, rows)]
                  for a in _taps(height, h_src, False, coord32))
    if fixed:
        def fixed_point(f):
            return (np.rint((np.float32(1) - f) * np.float32(_ONE)).astype(np.int32),
                    np.rint(f * np.float32(_ONE)).astype(np.int32))

        (a0, a1), (b0, b1) = fixed_point(fx), fixed_point(fy)
        src = src.astype(np.int32)
        hor = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
        out = (((hor[y0] >> 4) * b0[:, None, None]) >> 16) \
            + (((hor[y1] >> 4) * b1[:, None, None]) >> 16)
        out = np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)
    else:
        one = np.float32(1)
        hor = src[:, x0] * (one - fx)[None, :, None] + src[:, x1] * fx[None, :, None]
        out = (hor[y0] * (one - fy)[:, None, None]
               + hor[y1] * fy[:, None, None]).astype(np.float32)
    return out if img.ndim == 3 else out[..., 0]


def resize_nearest(img: np.ndarray, width: int, height: int,
                   rows: Optional[Tuple[int, int]] = None,
                   cols: Optional[Tuple[int, int]] = None,
                   fx: Optional[float] = None,
                   fy: Optional[float] = None) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_NEAREST)``;
    with ``fx``/``fy`` given, the scale OpenCV uses for ``resize(img, None,
    fx=, fy=)`` (its output size is then ``round(W * fx)``)."""
    h_src, w_src = img.shape[:2]
    sx = 1.0 / (fx if fx is not None else width / w_src)
    sy = 1.0 / (fy if fy is not None else height / h_src)
    xs = np.minimum(np.floor(np.arange(width) * sx).astype(np.int64), w_src - 1)
    ys = np.minimum(np.floor(np.arange(height) * sy).astype(np.int64), h_src - 1)
    return img[ys[_window(height, rows)]][:, xs[_window(width, cols)]]


def resize_nearest_by(img: np.ndarray, factor: float) -> np.ndarray:
    """``cv2.resize(img, None, fx=factor, fy=factor, INTER_NEAREST)``."""
    h_src, w_src = img.shape[:2]
    return resize_nearest(img, int(np.rint(w_src * factor)),
                          int(np.rint(h_src * factor)), fx=factor, fy=factor)


def pad_constant(img: np.ndarray, pad_h: int, pad_w: int,
                 value: float) -> np.ndarray:
    """Pad ``pad_h`` rows at the bottom and ``pad_w`` columns at the right
    with ``value``, saturated to img's type (cv2.copyMakeBorder,
    BORDER_CONSTANT)."""
    if pad_h <= 0 and pad_w <= 0:
        return img
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        value = min(max(int(round(value)), info.min), info.max)
    width = ((0, max(pad_h, 0)), (0, max(pad_w, 0))) + ((0, 0),) * (img.ndim - 2)
    return np.pad(img, width, constant_values=np.asarray(value, img.dtype))
