"""vae2_tpu_torch's segmentation host side: its copies of OpenCV's resize
and pad against ``cv2`` itself, its datasets against the JAX package's
(which decode and resize with ``cv2``), its metrics and losses against the
JAX package's.

Tolerances:
- ``resize_nearest`` on labels and the pad: exact;
- ``resize_linear`` on uint8: at most one grey level, and at least 99.9%
  of the bytes exact (OpenCV's fixed point and the rounding of its vector
  path are reproduced: with cv2 5.0 on x86-64 every byte is equal, share
  1.0; the margin is for a cv2 build whose vector width leaves another
  tail to its scalar loop);
- ``resize_linear`` on float32: 1e-5 * (1 + max|cv2|) (cv2's vector path
  computes the coordinate in another precision for up to 4 channels);
- dataset samples over the same synthetic set with the same seed,
  multi-scale and flip on: labels exact; images within one grey level of
  the resize over the smallest std (1 / (255 * 0.224)), and at least
  99.9% of the values equal (all of them with cv2 5.0 on x86-64);
- ``get_confusion_matrix``, ``miou_from_confusion``, ``scores``: exact;
- CE and OHEM with class weights and ignored pixels: rtol 1e-4.
"""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae2_tpu.core import losses as jl
from vae2_tpu.data import segmentation as jseg
from vae2_tpu.utils import metric as jm
from vae2_tpu_torch.core import losses as tl
from vae2_tpu_torch.data import segmentation as tseg
from vae2_tpu_torch.data.resize import (pad_constant, resize_linear,
                                        resize_nearest, resize_nearest_by)
from vae2_tpu_torch.tools.gen_seg_data import write_synthetic_seg
from vae2_tpu_torch.utils import metric as tm

SEG_DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "synthetic_seg")


def _sizes(seed, n=24):
    """Random (H, W, h, w): down- and up-scales, exact x2 and /2."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        h_src, w_src = rng.randint(9, 160, 2)
        h, w = rng.randint(2, 320, 2)
        if i % 4 == 0:
            h, w = 2 * h_src, 2 * w_src
        elif i % 4 == 1:
            h, w = h_src // 2, w_src // 2
        out.append((int(h_src), int(w_src), int(h), int(w)))
    return out


def test_resize_nearest_matches_cv2_on_labels():
    rng = np.random.RandomState(0)
    for h_src, w_src, h, w in _sizes(1):
        lab = rng.randint(0, 34, (h_src, w_src)).astype(np.uint8)
        want = cv2.resize(lab, (w, h), interpolation=cv2.INTER_NEAREST)
        np.testing.assert_array_equal(resize_nearest(lab, w, h), want)
    for factor in (0.5, 0.25, 0.125, 2.0, 0.3):
        lab = rng.randint(0, 34, (37, 91)).astype(np.float32)
        want = cv2.resize(lab, None, fx=factor, fy=factor,
                          interpolation=cv2.INTER_NEAREST)
        np.testing.assert_array_equal(resize_nearest_by(lab, factor), want)


@pytest.mark.parametrize("channels", [1, 3])
def test_resize_linear_uint8_matches_cv2(channels):
    rng = np.random.RandomState(channels)
    exact = total = 0
    for h_src, w_src, h, w in _sizes(2 + channels):
        img = rng.randint(0, 256, (h_src, w_src, channels)).astype(np.uint8)
        img = img[..., 0] if channels == 1 else img
        want = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
        got = resize_linear(img, w, h)
        assert got.shape == want.shape and got.dtype == np.uint8
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1
        exact += int((diff == 0).sum())
        total += diff.size
        # a window of the output is that window of the whole
        r0, c0 = h // 3, w // 4
        np.testing.assert_array_equal(
            resize_linear(img, w, h, rows=(r0, h), cols=(c0, w)),
            got[r0:, c0:])
    assert exact / total >= 0.999, exact / total


@pytest.mark.parametrize("channels", [3, 19])
def test_resize_linear_float32_matches_cv2(channels):
    rng = np.random.RandomState(10 + channels)
    for h_src, w_src, h, w in _sizes(20 + channels, n=12):
        img = (rng.randn(h_src, w_src, channels) * 3).astype(np.float32)
        want = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
        got = resize_linear(img, w, h)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * (1 + np.abs(want).max()))


def test_pad_constant_matches_cv2():
    rng = np.random.RandomState(3)
    for dtype, value in ((np.uint8, -1), (np.int32, -1), (np.uint8, 0),
                         (np.float32, 0.0)):
        img = rng.randint(0, 200, (7, 9)).astype(dtype)
        want = cv2.copyMakeBorder(img, 0, 3, 0, 5, cv2.BORDER_CONSTANT,
                                  value=(value,))
        np.testing.assert_array_equal(pad_constant(img, 3, 5, value), want)
    img = rng.randn(7, 9, 3).astype(np.float32)
    np.testing.assert_array_equal(
        pad_constant(img, 2, 0, 0.0),
        cv2.copyMakeBorder(img, 0, 2, 0, 0, cv2.BORDER_CONSTANT,
                           value=(0.0, 0.0, 0.0)))


@pytest.mark.parametrize("name", ["CityscapesSeg", "LIP", "PASCALContext"])
def test_datasets_match_jax(name):
    """Three passes over data/synthetic_seg's 8 train images with
    multi-scale (scales 0.5 to 2.0: crops padded and cropped) and flip, the
    same seed on both sides."""
    root, train = SEG_DATA, os.path.join(SEG_DATA, "train.lst")
    kw = dict(multi_scale=True, flip=True, base_size=64, crop_size=(32, 48),
              scale_factor=16, seed=7)
    jds = getattr(jseg, name)(root, train, **kw)
    tds = getattr(tseg, name)(root, train, **kw)
    assert len(tds) == len(jds) == 8
    bound = 1.0 / (255.0 * float(tseg.IMAGENET_STD.min()))
    exact = total = 0
    for _ in range(3):
        for i in range(len(tds)):
            jimg, jlab, jsize, jname = jds[i]
            timg, tlab, tsize, tname = tds[i]
            assert tname == jname and list(tsize) == list(jsize)
            assert tlab.dtype == np.int32 and timg.dtype == np.float32
            np.testing.assert_array_equal(tlab, jlab)
            np.testing.assert_allclose(timg, jimg, rtol=0, atol=bound)
            exact += int((timg == jimg).sum())
            total += timg.size
    assert exact / total >= 0.999, exact / total


def test_gen_seg_data_writes_a_set_both_packages_read(tmp_path):
    """The seeded synthetic set: RGB images and raw-id label PNGs that the
    port's and the JAX package's datasets read alike, with labels of the
    19 training classes and the ignore label."""
    train, val = write_synthetic_seg(str(tmp_path), 320, 160, train=2, val=1,
                                     seed=3)
    assert len(open(train).readlines()) == 2
    for lst in (train, val):
        kw = dict(multi_scale=False, flip=False)
        tds = tseg.CityscapesSeg(str(tmp_path), lst, **kw)
        jds = jseg.CityscapesSeg(str(tmp_path), lst, **kw)
        for i in range(len(tds)):
            timg, tlab, tsize, _ = tds[i]
            jimg, jlab, _, _ = jds[i]
            assert timg.shape == (160, 320, 3) and list(tsize) == [160, 320, 3]
            np.testing.assert_array_equal(timg, jimg)
            np.testing.assert_array_equal(tlab, jlab)
            assert set(np.unique(tlab)) <= set(range(-1, 19))
            assert (tlab == -1).any() and (tlab >= 0).any()


def test_cityscapes_save_pred_and_label_map(tmp_path):
    """save_pred writes the raw ids of the argmax through the palette, as
    the JAX package's."""
    ds = tseg.CityscapesSeg.__new__(tseg.CityscapesSeg)
    jds = jseg.CityscapesSeg.__new__(jseg.CityscapesSeg)
    preds = np.random.RandomState(4).randn(2, 8, 12, 19).astype(np.float32)
    for d, sub in ((ds, "port"), (jds, "jax")):
        (tmp_path / sub).mkdir()
        d.save_pred(preds, str(tmp_path / sub), ["a", "b"])
    from PIL import Image

    for n in ("a", "b"):
        got = Image.open(tmp_path / "port" / f"{n}.png")
        want = Image.open(tmp_path / "jax" / f"{n}.png")
        assert got.getpalette() == want.getpalette()
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    raw = np.random.RandomState(5).randint(0, 34, (6, 7)).astype(np.uint8)
    np.testing.assert_array_equal(ds.convert_label(raw),
                                  jds.convert_label(raw))


def test_metrics_match_jax_exactly():
    rng = np.random.RandomState(6)
    labels = rng.randint(-1, 5, (2, 9, 11))
    logits = rng.randn(2, 9, 11, 5).astype(np.float32)
    want = jm.get_confusion_matrix(labels, logits, 5, ignore=-1)
    got = tm.get_confusion_matrix(labels, logits.transpose(0, 3, 1, 2), 5,
                                  ignore=-1)
    np.testing.assert_array_equal(got, want)
    for a, b in zip(tm.miou_from_confusion(got), jm.miou_from_confusion(want)):
        np.testing.assert_array_equal(a, b)
    lt = [rng.randint(0, 5, 50) for _ in range(3)]
    lp = [rng.randint(0, 5, 50) for _ in range(3)]
    s_got, s_want = tm.scores(lt, lp, 5), jm.scores(lt, lp, 5)
    assert s_got.keys() == s_want.keys()
    for k in s_want:
        if k == "Class IoU":
            assert s_got[k] == s_want[k]
        else:
            np.testing.assert_array_equal(s_got[k], s_want[k])


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("ohem", [False, True], ids=["ce", "ohem"])
def test_seg_losses_match_jax(weighted, ohem):
    """Logits at 1/4 of the label size (upsampled in the loss), a quarter
    of the pixels ignored; OHEM with a threshold that keeps some pixels by
    probability and min_kept that decides others."""
    rng = np.random.RandomState(7)
    score = (rng.randn(2, 8, 12, 19) * 2).astype(np.float32)
    target = rng.randint(0, 19, (2, 32, 48)).astype(np.int32)
    target[rng.rand(*target.shape) < 0.25] = -1
    weights = tseg.CITYSCAPES_CLASS_WEIGHTS if weighted else None
    jargs = (jnp.asarray(score), jnp.asarray(target), -1)
    targs = (torch.from_numpy(score).permute(0, 3, 1, 2),
             torch.from_numpy(target), -1)
    for thres, kept in ((0.7, 100), (0.05, 1000), (0.3, 5000)):
        if ohem:
            want = jl.ohem_cross_entropy(
                *jargs, thres, kept,
                None if weights is None else jnp.asarray(weights))
            got = tl.ohem_cross_entropy(
                *targs, thres, kept,
                None if weights is None else torch.from_numpy(weights))
        else:
            want = jl.cross_entropy_loss(
                *jargs, None if weights is None else jnp.asarray(weights))
            got = tl.cross_entropy_loss(
                *targs, None if weights is None else torch.from_numpy(weights))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
