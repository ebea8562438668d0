"""vae2_tpu_torch's data pipeline and config against the JAX package:
clip normalization (float32, atol 1e-6), and ClipLoader batches on the
committed data/synthetic64 fixture, byte-equal to the JAX loader's at the
frames' own 128x256 size (fixed clip positions, one decode thread); frames
resized 2x down by the port's PIL fallback within one grey level of the JAX
package's native decoder, and equal to its PIL path at the identity size."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae2_tpu.config import get_default_config as jax_default_config
from vae2_tpu.data import loader as jax_loader
from vae2_tpu.data.video import make_dataset as jax_make_dataset
from vae2_tpu_torch.config import get_default_config
from vae2_tpu_torch.data import loader as port_loader
from vae2_tpu_torch.data.video import make_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data", "synthetic64")


def test_normalize_and_denormalize_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (2, 4, 6, 9)).astype(np.uint8)
    want = np.asarray(jax_loader.normalize_clips(jnp.asarray(x)))
    got = port_loader.normalize_clips(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    y = (rng.randn(2, 4, 6, 9) * 3).astype(np.float32)  # exercises the clamp
    want = np.asarray(jax_loader.denormalize_clips(jnp.asarray(y)))
    got = port_loader.denormalize_clips(torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def _cfg(get):
    cfg = get()
    cfg.DATASET.ROOT = DATA
    cfg.TRAIN.IMAGE_SIZE = [256, 128]
    return cfg


@pytest.mark.parametrize("batch_size", [1, 2])
def test_clip_loader_byte_equal_to_jax(batch_size):
    test_list = os.path.join(DATA, "test_list.txt")
    kw = dict(random_pos=False, num_samples=3)
    port = port_loader.ClipLoader(
        make_dataset(_cfg(get_default_config), test_list, **kw),
        batch_size=batch_size, shuffle=False, drop_last=False, num_threads=1)
    ref = jax_loader.ClipLoader(
        jax_make_dataset(_cfg(jax_default_config), test_list, **kw),
        batch_size=batch_size, shuffle=False, drop_last=False, num_threads=1)
    assert len(port) == len(ref)
    n = 0
    for (pb, pn), (rb, rn) in zip(port, ref):
        assert pn == rn
        assert sorted(pb) == ["x2t", "x3t", "xt"]
        for k in pb:
            assert pb[k].dtype == np.uint8
            assert pb[k].shape == (len(pn), 128, 256, 9)
            np.testing.assert_array_equal(pb[k], rb[k])
        n += 1
    assert n == len(port)


@pytest.mark.parametrize(
    "recipe", sorted(glob.glob(os.path.join(REPO, "experiments", "*", "*.yaml"))),
    ids=os.path.basename)
def test_every_recipe_loads(recipe):
    cfg = get_default_config()
    cfg.merge_from_file(recipe)
    ref = jax_default_config()
    ref.merge_from_file(recipe)
    assert cfg.TPU.to_dict() == ref.TPU.to_dict()
    assert cfg.MODEL.to_dict() == ref.MODEL.to_dict()
    assert cfg.GPU.DEVICE == "cuda" and cfg.GPU.DTYPE == ""


# ---- frame resizing: the native decoder's filter -----------------------------


@pytest.fixture(scope="module")
def video_512(tmp_path_factory):
    """One 30-frame video at 512x256 in the Cityscapes-sequence layout,
    rendered by tools/gen_synthetic_data.py from its seed 1234."""
    import importlib.util
    import io
    import zipfile

    from PIL import Image

    spec = importlib.util.spec_from_file_location(
        "gen_synthetic_data", os.path.join(REPO, "tools",
                                           "gen_synthetic_data.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    root = tmp_path_factory.mktemp("video512")
    params = gen.make_video_params(seed=1234)
    with zipfile.ZipFile(root / "v.zip", "w") as zf:
        for t in range(30):
            buf = io.BytesIO()
            Image.fromarray(gen.render_frame(t, 256, 512, params)).save(
                buf, format="PNG")
            zf.writestr(f"{t:06d}_leftImg8bit.png", buf.getvalue())
    (root / "list.txt").write_text("v.zip\n")
    return root


def _clip(get, root, w, h):
    cfg = get()
    cfg.DATASET.ROOT = str(root)
    cfg.TRAIN.IMAGE_SIZE = [w, h]
    return cfg


def test_downscaled_frames_within_one_level_of_the_native_decoder(
        video_512, monkeypatch):
    """512x256 -> 256x128 (2x), the port's PIL BILINEAR fallback (its own
    native decoder switched off; where that builds it gives the JAX
    package's bytes, tests/test_torch_port_native.py) against the JAX
    package's native decoder (clip_decoder.cpp's triangle filter): every
    byte within 1 grey level, and at least 90% of the bytes equal (measured
    90.75%: the two filters round their f32 sums apart; PIL's default
    BICUBIC, which the port used before, is up to 17 levels apart here and
    equal on 86.4%)."""
    import zipfile

    from vae2_tpu import native
    from vae2_tpu_torch import native as port_native

    monkeypatch.setattr(port_native, "available", lambda: False)
    ds = make_dataset(_clip(get_default_config, video_512, 256, 128),
                      str(video_512 / "list.txt"), random_pos=False)
    clips, _ = ds[0]
    pos = ds.sample_position(30)
    with zipfile.ZipFile(video_512 / "v.zip") as zf:
        datas = [zf.read(f"{t:06d}_leftImg8bit.png")
                 for t in range(pos, pos + 9)]
    want = [native.decode_frame(d, 256, 128) for d in datas]
    if any(w is None for w in want):
        pytest.skip("the native decoder does not build here")
    want = np.concatenate(want, axis=-1).astype(int)
    assert clips.shape == want.shape == (128, 256, 27)
    diff = np.abs(clips.astype(int) - want)
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.90, (diff == 0).mean()


def test_identity_size_frames_equal_the_jax_pil_path(video_512, monkeypatch):
    """At the frames' own size the port's bytes equal the JAX package's
    PIL path (its native decoder switched off), byte for byte."""
    from vae2_tpu.data import video as jax_video

    monkeypatch.setattr(jax_video.ClipSequenceDataset, "_native_decode",
                        lambda self, *a: None)
    lst = str(video_512 / "list.txt")
    got, _ = make_dataset(_clip(get_default_config, video_512, 512, 256),
                          lst, random_pos=False)[0]
    want, _ = jax_make_dataset(_clip(jax_default_config, video_512, 512, 256),
                               lst, random_pos=False)[0]
    assert got.shape == (256, 512, 27)
    np.testing.assert_array_equal(got, want)
