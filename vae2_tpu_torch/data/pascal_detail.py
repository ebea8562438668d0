"""PASCAL-Context mask rasterization without the ``detail`` package and
without cv2 (counterpart of ``vae2_tpu/data/pascal_detail.py``; reference
lib/datasets/pascal_ctx.py:52-96).

From the raw ``trainval_merged.json``: images are filtered by phase, and
each image's mask is painted by its segmentation annotations in file order
(``category_id`` wherever the decoded mask is set; Detail's ``getMask``
for semantic segmentation). Segmentations decode from COCO compressed RLE
strings, uncompressed RLE lists, or polygon lists; ``class_to_index`` maps
the raw ids onto the 59-class subset.

Polygons are filled as ``cv2.fillPoly(mask, polys, 1)`` fills them (8-
connected, no shift): ``fill_poly`` is OpenCV's scan conversion (drawing.cpp:
CollectPolyEdges, FillEdgeCollection, the Bresenham outline of each edge
and clipLine), in Python integers. It gives cv2's pixels for polygons
inside the image and for those that leave it across any border
(tests/test_torch_port_pascal.py). An RLE
mask of another size than the image is resized with cv2's INTER_NEAREST
(``data/resize.resize_nearest``). Masks are written as 8-bit PNGs with PIL.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .resize import resize_nearest

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def decode_rle_counts(counts, h: int, w: int) -> np.ndarray:
    """Decode COCO RLE into an (h, w) uint8 mask.

    ``counts`` is either the uncompressed run-length list or the compressed
    LEB128-style string (pycocotools maskApi rleFrString). Runs are
    column-major and alternate background/foreground starting with
    background.
    """
    if isinstance(counts, (bytes, str)):
        s = counts.encode() if isinstance(counts, str) else counts
        cnts: List[int] = []
        p = 0
        while p < len(s):
            x = 0
            k = 0
            more = True
            while more:
                c = s[p] - 48
                x |= (c & 0x1F) << (5 * k)
                more = bool(c & 0x20)
                p += 1
                k += 1
                if not more and (c & 0x10):
                    x |= -1 << (5 * k)
            if len(cnts) > 2:
                x += cnts[-2]
            cnts.append(x)
    else:
        cnts = list(counts)
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for run in cnts:
        if val:
            flat[pos: pos + run] = 1
        pos += run
        val ^= 1
    return flat.reshape(w, h).T  # column-major


# ---- cv2.fillPoly (LINE_8, shift 0), OpenCV drawing.cpp ----------------------


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv::clipLine: (whether any of the segment is inside, then its end
    points as clipLine leaves them, moved even where it returns False)."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line(img: np.ndarray, x1: int, y1: int, x2: int, y2: int,
          value: int) -> None:
    """cv::Line, 8-connected (cv::LineIterator, left to right)."""
    h, w = img.shape
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:  # leftToRight
        dx, dy = -dx, -dy
        x1, y1, x2, y2 = x2, y2, x1, y1
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - (dy + dy)
    plus_delta, minus_delta = dx + dx, -(dy + dy)
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = value
        step = err < 0
        err += minus_delta + (plus_delta if step else 0)
        if vert:  # the major axis is y
            y += sy
            x += sx if step else 0
        else:
            x += sx
            y += sy if step else 0


def _collect_edges(img: np.ndarray, pts: np.ndarray, value: int,
                   edges: list) -> None:
    """CollectPolyEdges: draws each edge's outline and keeps its
    (y0, y1, x at y0, dx per row) in 16.16 fixed point for the scan fill.
    An edge that leaves the image takes the x of the outline's clipped end
    points, and their y where the clipped segment is not horizontal; its
    slope comes from those points, extrapolated back to its own y0. An
    edge that only touches the image at one row (or misses it), such as
    one that leaves across the left or right border, thus runs along that
    border column, as cv2 5.0 fills it."""
    h, w = img.shape
    n = len(pts)
    x0, y0 = int(pts[-1][0]) << XY_SHIFT, int(pts[-1][1])
    for i in range(n):
        x1, y1 = int(pts[i][0]) << XY_SHIFT, int(pts[i][1])
        tx0 = (x0 + (XY_ONE >> 1)) >> XY_SHIFT
        tx1 = (x1 + (XY_ONE >> 1)) >> XY_SHIFT
        _line(img, tx0, y0, tx1, y1, value)
        c0x, c0y, c1x, c1y = x0, y0, x1, y1
        if not (0 <= tx0 < w and 0 <= tx1 < w and 0 <= y0 < h
                and 0 <= y1 < h):
            _, ex0, ey0, ex1, ey1 = _clip_line(w, h, tx0, y0, tx1, y1)
            if ey0 != ey1:
                c0y, c1y = ey0, ey1
            c0x, c1x = ex0 << XY_SHIFT, ex1 << XY_SHIFT
        if y0 != y1:
            dx = _cdiv(c1x - c0x, c1y - c0y)
            if y0 < y1:
                edges.append([y0, y1, c0x + (y0 - c0y) * dx, dx])
            else:
                edges.append([y1, y0, c1x + (y1 - c1y) * dx, dx])
        x0, y0 = x1, y1


def _fill_edges(img: np.ndarray, edges: list, value: int) -> None:
    """FillEdgeCollection: the active-edge scan fill, each span drawn
    between consecutive pairs of active edges, from the first pixel at or
    right of the left edge to the last at or left of the right edge (the
    outline has drawn the border pixels)."""
    h, w = img.shape
    if len(edges) < 2:
        return
    y_min = min(e[0] for e in edges)
    y_max = max(e[1] for e in edges)
    xs = [e[2] for e in edges] + [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    if y_max < 0 or y_min >= h or max(xs) < 0 or min(xs) >= (w << XY_SHIFT):
        return
    edges = sorted(edges, key=lambda e: (e[0], e[2], e[3]))
    y_max = min(y_max, h)
    active: list = []
    i = 0
    for y in range(edges[0][0], y_max):
        active = [e for e in active if e[1] != y]
        while i < len(edges) and edges[i][0] == y:
            # inserted before the first active edge whose x is not smaller
            e = edges[i]
            k = 0
            while k < len(active) and active[k][2] < e[2]:
                k += 1
            active.insert(k, e)
            i += 1
        for a, b in zip(active[0::2], active[1::2]):
            if y >= 0:
                lo, hi = sorted((a[2], b[2]))
                x1, x2 = (lo + XY_ONE - 1) >> XY_SHIFT, hi >> XY_SHIFT
                if x1 < w and x2 >= 0:
                    img[y, max(x1, 0):min(x2, w - 1) + 1] = value
            a[2] += a[3]
            b[2] += b[3]
        active.sort(key=lambda e: e[2])  # stable, as the bubble sort


def fill_poly(img: np.ndarray, polys: Sequence[np.ndarray],
              value: int = 1) -> None:
    """``cv2.fillPoly(img, polys, value)`` on a 2-d array, in place:
    ``polys`` are (n, 2) integer (x, y) vertex arrays."""
    edges: list = []
    for pts in polys:
        _collect_edges(img, np.asarray(pts), value, edges)
    _fill_edges(img, edges, value)


def _paint_segmentation(mask: np.ndarray, segm, category_id: int) -> None:
    h, w = mask.shape
    if isinstance(segm, dict):  # RLE
        sh, sw = segm["size"]
        m = decode_rle_counts(segm["counts"], sh, sw)
        if (sh, sw) != (h, w):  # defensive; annotations match image size
            m = resize_nearest(m, w, h)
        mask[m > 0] = category_id
    else:  # polygon list [[x0, y0, x1, y1, ...], ...]
        polys = [np.asarray(p, np.float64).reshape(-1, 2).round().astype(
            np.int32) for p in segm if len(p) >= 6]
        if polys:
            m = np.zeros((h, w), np.uint8)
            fill_poly(m, polys, 1)
            mask[m > 0] = category_id


class DetailLite:
    """The part of the ``detail`` API that the reference dataset uses."""

    def __init__(self, annots_json: str, img_folder: str, phase: str):
        self.img_folder = img_folder
        self.phase = phase
        with open(annots_json) as f:
            data = json.load(f)
        self._images = [
            img for img in data["images"]
            if phase in str(img.get("phase", img.get("split", "")))
        ]
        self._annos: Dict[int, list] = {}
        for ann in data.get("annos_segmentation", data.get("annotations", [])):
            self._annos.setdefault(ann["image_id"], []).append(ann)

    def getImgs(self) -> List[dict]:
        return self._images

    def getMask(self, img: dict) -> np.ndarray:
        h, w = int(img["height"]), int(img["width"])
        mask = np.zeros((h, w), np.uint16)  # category ids go up to 459
        for ann in self._annos.get(img["image_id"], []):
            _paint_segmentation(mask, ann["segmentation"],
                                int(ann["category_id"]))
        return mask


# The 60 raw Detail category ids kept by the 59-class PASCAL-Context
# protocol, sorted (reference pascal_ctx.py:65-71). Index 0 is background.
PASCAL_CTX_59_MAPPING = np.sort(np.array([
    0, 2, 259, 260, 415, 324, 9, 258, 144, 18, 19, 22,
    23, 397, 25, 284, 158, 159, 416, 33, 162, 420, 454, 295, 296,
    427, 44, 45, 46, 308, 59, 440, 445, 31, 232, 65, 354, 424,
    68, 326, 72, 458, 34, 207, 80, 355, 85, 347, 220, 349, 360,
    98, 187, 104, 105, 366, 189, 368, 113, 115]))


def class_to_index(mask: np.ndarray) -> np.ndarray:
    """Map raw Detail category ids to 0..59 indices (0 = background;
    reference pascal_ctx.py:78-84 with upstream HRNet's ``_key =
    arange(len(_mapping))``, which the reference never assigns). Ids
    outside the 59-class subset map to background."""
    mapping = PASCAL_CTX_59_MAPPING
    flat = mask.ravel()
    index = np.digitize(flat, mapping, right=True)
    index = np.where(
        (index < len(mapping)) & np.isin(flat, mapping), index, 0)
    return index.astype(np.uint8).reshape(mask.shape)


def preprocess_masks(root: str, phase: str,
                     out_dir: Optional[str] = None) -> str:
    """Rasterize every mask of a split to 59-class-indexed 8-bit PNGs
    (once), returning the directory (the reference caches them to a torch
    .pth, pascal_ctx.py:86-96; PNGs let the list files point at them)."""
    from PIL import Image

    voc = os.path.join(root, "pascal_ctx", "VOCdevkit", "VOC2010")
    detail = DetailLite(os.path.join(voc, "trainval_merged.json"),
                        os.path.join(voc, "JPEGImages"), phase)
    out_dir = out_dir or os.path.join(voc, f"context_masks_{phase}")
    os.makedirs(out_dir, exist_ok=True)
    for img in detail.getImgs():
        stem = os.path.splitext(img["file_name"])[0]
        out = os.path.join(out_dir, stem + ".png")
        if os.path.exists(out):
            continue
        Image.fromarray(class_to_index(detail.getMask(img))).save(out)
    return out_dir
