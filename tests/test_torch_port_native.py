"""The port's copy of the native clip decoder and its UCF-101 dataset
against the JAX package's, byte for byte.

- ``decode_batch`` of PNG and JPEG frames, at the frames' own size and at
  UCF-101's 320x240 -> 176x128 (factors 1.82 and 1.875); both packages
  compile their own copy of clip_decoder.cpp with the same g++ flags.
- ``UcfSequence`` samples on UCF-layout sets written by
  tools/gen_synthetic_data.py --layout ucf: train (random) and eval
  positions, FIXED_LENGTH on and off (36-frame videos, capped at 30),
  clip_num 3 and 5; through the native decoder (320x240 frames resized),
  and with the PIL path forced in both packages at the frames' own size
  (there the JAX package's BICUBIC and the port's BILINEAR resize are the
  identity; at other sizes the two filters differ by design, ROADMAP §3).
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from test_torch_port_ucf import gen_ucf
from vae2_tpu import native as jax_native
from vae2_tpu.config import get_default_config as jax_default_config
from vae2_tpu.data import video as jax_video
from vae2_tpu_torch import native
from vae2_tpu_torch.config import get_default_config
from vae2_tpu_torch.data import video

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UCF_CFG = os.path.join(REPO, "experiments", "ucf101",
                       "debug_ucf_tiny_32x64.yaml")


def _frames(fmt, w=320, h=240, n=4):
    rng = np.random.RandomState(0)
    base = (np.mgrid[0:h, 0:w].sum(0) % 256).astype(np.uint8)
    out = []
    for i in range(n):
        img = np.stack([base, base[::-1], base[:, ::-1]], -1)
        img = (img.astype(int) + rng.randint(0, 40, img.shape) + 20 * i
               ).clip(0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format=fmt)
        out.append(buf.getvalue())
    return out


@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
@pytest.mark.parametrize("size", [(320, 240), (176, 128)],
                         ids=["identity", "320x240_to_176x128"])
def test_decode_batch_equals_jax(fmt, size):
    datas = _frames(fmt)
    assert native.available(), native.build_log()
    got = native.decode_batch(datas, *size, threads=2)
    want = jax_native.decode_batch(datas, *size, threads=2)
    assert want is not None, "the JAX package's decoder did not build"
    assert got.shape == (4, size[1], size[0], 3)
    np.testing.assert_array_equal(got, want)
    one = native.decode_frame(datas[1], *size)
    np.testing.assert_array_equal(one, want[1])


def test_port_compiles_its_own_copy():
    """The port builds vae2_tpu_torch/native/clip_decoder.cpp, whose code
    is the JAX package's line for line (only the comments that name the
    binding differ)."""
    assert str(native.SRC) == os.path.join(REPO, "vae2_tpu_torch", "native",
                                           "clip_decoder.cpp")

    def code(path):
        return [line for line in open(path).read().splitlines()
                if not line.lstrip().startswith("//")]

    assert code(native.SRC) == code(os.path.join(
        REPO, "vae2_tpu", "native", "clip_decoder.cpp"))
    assert native.library_path().parent.parts[-2:] == ("build",
                                                       "vae2_tpu_torch")


def test_corrupt_frame_decodes_to_none_and_zeros():
    assert native.decode_frame(b"not an image", 8, 8) is None
    out = native.decode_batch([b"junk", _frames("PNG", 16, 8, 1)[0]], 16, 8)
    assert not out[0].any() and out[1].any()


def test_forced_pil_path_by_environment():
    """``VAE2_NO_NATIVE=1`` (read at first use) leaves the library
    unloaded, and says why."""
    code = ("from vae2_tpu_torch import native; "
            "print(native.available(), native.build_log())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True,
                         env={**os.environ, "VAE2_NO_NATIVE": "1"})
    assert out.stdout.startswith("False VAE2_NO_NATIVE=1")


@pytest.fixture(scope="module")
def ucf_sets(tmp_path_factory):
    """Two UCF-layout sets of 4 videos of 36 frames: 320x240 (UCF-101's
    frame size) and 64x32 (the debug recipe's crop)."""
    root = tmp_path_factory.mktemp("ucf")
    gen_ucf(root / "full", 4, 320, 240, frames=36)
    gen_ucf(root / "crop", 4, 64, 32, frames=36)
    return root


def _cfg(get, root, size, fixed):
    cfg = get()
    cfg.merge_from_file(UCF_CFG)
    cfg.DATASET.ROOT = str(root)
    cfg.TRAIN.IMAGE_SIZE = list(size)
    cfg.DATASET.FIXED_LENGTH = fixed
    return cfg


def _samples(make, cfg, root, random_pos, clip_num):
    ds = make(cfg, str(root / "train_list.txt"), random_pos=random_pos,
              clip_num=clip_num, seed=3)
    return ds, [ds[i] for i in range(len(ds)) for _ in range(2)]


@pytest.mark.parametrize("clip_num", [3, 5])
@pytest.mark.parametrize("fixed", [True, False], ids=["fixed", "full_length"])
@pytest.mark.parametrize("random_pos", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("decoder", ["native", "pil"])
def test_ucf_samples_equal_jax(ucf_sets, monkeypatch, decoder, random_pos,
                               fixed, clip_num):
    if decoder == "pil":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jax_video.ClipSequenceDataset, "_native_decode",
                            lambda self, *a: None)
        root, size = ucf_sets / "crop", (64, 32)
    else:
        root, size = ucf_sets / "full", (176, 128)
    ds, got = _samples(video.make_dataset,
                       _cfg(get_default_config, root, size, fixed), root,
                       random_pos, clip_num)
    _, want = _samples(jax_video.make_dataset,
                       _cfg(jax_default_config, root, size, fixed), root,
                       random_pos, clip_num)
    assert isinstance(ds, video.UcfSequence) and len(got) == 6
    for (g, gname), (w, wname) in zip(got, want):
        assert gname == wname
        assert g.shape == (size[1], size[0], 9 * clip_num)
        np.testing.assert_array_equal(g, w)
    assert ds.frames_by_decoder[decoder] == 6 * 3 * clip_num
    assert sum(ds.frames_by_decoder.values()) == 6 * 3 * clip_num


def test_ucf_positions():
    """FIXED_LENGTH caps a video at 30 frames; eval starts at the end
    minus the span minus 1, never before frame 3 (ucf101.py:102), or 0 for
    the baseline; frames are 1-indexed."""
    kw = dict(root="", list_path=os.devnull, clip_length=3, clip_num=3,
              random_pos=False)
    ds = video.UcfSequence(fixed_length=True, **kw)
    assert ds._sequence_length({"length": 50}) == 30
    assert ds.sample_position(30) == 30 - 9 - 1
    assert ds.sample_position(9) == 3
    assert ds._frame_offset() == 1 and ds._frame_name(1) == "image_00001.jpg"
    base = video.UcfSequence(fixed_length=False, is_baseline=True, **kw)
    assert base._sequence_length({"length": 50}) == 50
    assert base.sample_position(9) == 0
