"""vae2_tpu_torch's PASCAL-Context mask rasterization
(data/pascal_detail.py, tools/gen_pascal_ctx_masks.py) against the JAX
package's, which fills polygons with cv2.fillPoly, resizes with cv2 and
writes with cv2.imwrite; the port does all three without cv2.

- masks from a synthetic trainval_merged.json (compressed and
  uncompressed RLE, an RLE of another size than its image, convex and
  concave polygons inside the image and across its top and bottom,
  overlapping annotations, ids outside the 59 classes) equal the JAX
  package's ``class_to_index(getMask(...))`` pixel for pixel, and so do
  the PNGs both write, read back;
- ``fill_poly`` equals cv2.fillPoly on random polygons inside the image
  or across its top and bottom; across its left or right border the two
  differ only in that border column (0.21% of the pixels of 3,000 random
  polygons crossing every border), which the last test bounds.
"""

import json
import os

import cv2
import numpy as np
import pytest
from PIL import Image

from test_pascal_detail import _encode_rle
from vae2_tpu.data import pascal_detail as jax_pd
from vae2_tpu_torch.data import pascal_detail as pd
from vae2_tpu_torch.tools import gen_pascal_ctx_masks


def _blob(rng, h, w):
    m = np.zeros((h, w), np.uint8)
    for _ in range(3):
        y, x = rng.randint(0, h - 4), rng.randint(0, w - 4)
        m[y:y + rng.randint(2, 9), x:x + rng.randint(2, 9)] = 1
    return m


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    rng = np.random.RandomState(0)
    root = tmp_path_factory.mktemp("pascal")
    images, annos = [], []
    for i, (h, w, phase) in enumerate([(40, 30, "train"), (25, 35, "train"),
                                       (20, 20, "val")]):
        images.append({"image_id": i, "file_name": f"2008_{i:06d}.jpg",
                       "height": h, "width": w, "phase": phase})
        segs = [
            {"size": [h, w], "counts": _encode_rle(_blob(rng, h, w))},
            {"size": [h, w], "counts": [int(c) for c in rng.randint(
                1, 20, 2 * (h * w // 20))][:1] + [h * w // 3, h * w // 4]},
            {"size": [2 * h, 2 * w],
             "counts": _encode_rle(_blob(rng, 2 * h, 2 * w))},
            [[1.2, 2.0, w - 2.6, 1.0, w - 3.0, h - 2.0, 2.0, h - 4.4]],
            [[3.0, 3.0, w / 2, h / 2, w - 4.0, 3.0, w - 4.0, h - 3.0,
              3.0, h - 3.0]],
            [[4.0, -6.0, w - 5.0, h / 3, 6.0, h + 7.0], [1.0, 1.0, 5.0]],
        ]
        for j, seg in enumerate(segs):
            annos.append({"image_id": i, "segmentation": seg,
                          "category_id": [2, 259, 999, 415, 22, 458][j]})
    d = root / "pascal_ctx" / "VOCdevkit" / "VOC2010"
    os.makedirs(d / "JPEGImages")
    with open(d / "trainval_merged.json", "w") as f:
        json.dump({"images": images, "annos_segmentation": annos}, f)
    return root, d


def test_masks_equal_jax(voc, tmp_path):
    root, d = voc
    args = (str(d / "trainval_merged.json"), str(d / "JPEGImages"), "train")
    port, ref = pd.DetailLite(*args), jax_pd.DetailLite(*args)
    assert port.getImgs() == ref.getImgs() and len(port.getImgs()) == 2
    for img in port.getImgs():
        raw = port.getMask(img)
        np.testing.assert_array_equal(raw, ref.getMask(img))
        assert len(np.unique(raw)) >= 5
        np.testing.assert_array_equal(pd.class_to_index(raw),
                                      jax_pd.class_to_index(raw))
    out = gen_pascal_ctx_masks.main(["--root", str(root), "--phase", "train",
                                     "--out", str(tmp_path / "port")])
    want_dir = jax_pd.preprocess_masks(str(root), "train",
                                       str(tmp_path / "jax"))
    for img in port.getImgs():
        name = img["file_name"].replace(".jpg", ".png")
        got = np.asarray(Image.open(os.path.join(out, name)))
        want = cv2.imread(os.path.join(want_dir, name), cv2.IMREAD_UNCHANGED)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _random_polys(rng, h, w, reach):
    polys = []
    for _ in range(rng.randint(1, 4)):
        n = rng.randint(3, 9)
        xs = rng.randint(-reach[0], w + reach[0], n)
        ys = rng.randint(-reach[1], h + reach[1], n)
        polys.append(np.stack([xs, ys], 1).astype(np.int32))
    return polys


def _fills(polys, h, w):
    want = np.zeros((h, w), np.uint8)
    cv2.fillPoly(want, polys, 1)
    got = np.zeros((h, w), np.uint8)
    pd.fill_poly(got, polys, 1)
    return got, want


@pytest.mark.parametrize("reach", [(0, 0), (0, 10)],
                         ids=["inside", "across_top_and_bottom"])
def test_fill_poly_equals_cv2(reach):
    rng = np.random.RandomState(1)
    for _ in range(400):
        h, w = rng.randint(4, 40), rng.randint(4, 40)
        got, want = _fills(_random_polys(rng, h, w, reach), h, w)
        np.testing.assert_array_equal(got, want)


def test_fill_poly_across_left_and_right_differs_only_there():
    rng = np.random.RandomState(7)
    differ = total = 0
    for _ in range(500):
        h, w = rng.randint(6, 30), rng.randint(6, 30)
        got, want = _fills(_random_polys(rng, h, w, (10, 10)), h, w)
        np.testing.assert_array_equal(got[:, 1:-1], want[:, 1:-1])
        differ += int((got != want).sum())
        total += h * w
    assert differ / total <= 0.005
