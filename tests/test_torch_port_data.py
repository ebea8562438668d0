"""vae2_tpu_torch's data pipeline and config against the JAX package:
clip normalization (float32, atol 1e-6), and ClipLoader batches on the
committed data/synthetic64 fixture, byte-equal to the JAX loader's at the
frames' own 128x256 size (fixed clip positions, one decode thread)."""

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
