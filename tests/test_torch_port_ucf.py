"""The UCF-101 path of vae2_tpu_torch on the CPU: the HRNet trunk where
branch widths do not divide one another (bilinear upsampling by a
non-integer factor) against the JAX package, and one train step of the UCF
debug recipe through the port's train CLI on synthetic UCF-layout data.

At a non-integer factor the JAX package resizes with ``jax.image.resize``
in f32 (``vae2_tpu/ops/image.py:96-101``), at an integer one through its
interpolation matrix; the port uses ``F.interpolate`` for both. The VAE²
trunks' stem has stride 1, so a 16x44 input gives branch widths 44, 22,
11 and 6 (6 -> 44, 6 -> 22, 6 -> 11); the segmentation trunk's stem has
stride 4, so 32x88 gives 22, 11, 6 and 3 (3 -> 22, 6 -> 22, 3 -> 11). The
UCF recipe's own 128x176 gives 176, 88, 44 and 22 in the VAE² trunks:
integer factors only.

Tolerance: |port - jax| <= 1e-4 * (1 + max|jax|), f32, as in
tests/test_torch_port_model.py.
"""

import glob
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_model import (SPECS, T_SPECS, assert_close,
                                   fill_variables, nchw, nhwc, to_torch)
from vae2_tpu.models import hrnet as jh
from vae2_tpu_torch.models import hrnet as th
from vae2_tpu_torch.tools import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UCF_CFG = os.path.join(REPO, "experiments", "ucf101",
                       "debug_ucf_tiny_32x64.yaml")


@pytest.mark.parametrize("stem_stride,h,w,widths", [
    (1, 16, 44, (44, 22, 11, 6)),
    (2, 32, 88, (22, 11, 6, 3)),
], ids=["vae2_16x44", "seg_32x88"])
def test_trunk_non_integer_upsample_matches_jax(stem_stride, h, w, widths):
    x = np.random.RandomState(11).randn(2, h, w, 9).astype(np.float32)
    jmod = jh.HRNetTrunk(specs=SPECS, stem_stride=stem_stride,
                         z_mode="none", dtype=jnp.float32)
    v = fill_variables(jmod, jnp.asarray(x), None, False)
    want = jmod.apply(v, jnp.asarray(x), None, False)
    tmod = to_torch(th.HRNetTrunk(T_SPECS, 9, stem_stride=stem_stride,
                                  z_mode="none", dtype=torch.float32), v)
    with torch.inference_mode():
        got = tmod(nchw(x))
    assert tuple(g.shape[3] for g in got) == widths
    assert any(widths[0] % b for b in widths[1:])  # a non-integer factor
    for g, w_ in zip(got, want):
        assert_close(nhwc(g), w_)


def gen_ucf(out, num_videos, width, height, frames=30):
    """tools/gen_synthetic_data.py --layout ucf into ``out``."""
    subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                 "gen_synthetic_data.py"),
                    "--layout", "ucf", "--out", str(out), "--num-videos",
                    str(num_videos), "--frames", str(frames), "--width",
                    str(width), "--height", str(height)],
                   check=True, capture_output=True)


def test_ucf_debug_recipe_trains_through_the_cli(tmp_path):
    """One epoch of one step (batch 2 of 3 train videos) of the UCF debug
    recipe on the CPU, with TPU.LAYER_SUMMARY's per-layer tables, then a
    resumed epoch: finite losses, both checkpoints, the frame dumps."""
    data = tmp_path / "ucf"
    gen_ucf(data, 4, 80, 40)
    argv = ["--cfg", UCF_CFG, "--device", "cpu",
            "DATASET.ROOT", str(data),
            "DATASET.TRAIN_SET", str(data / "train_list.txt"),
            "DATASET.TEST_SET", str(data / "test_list.txt"),
            "TRAIN.BATCH_SIZE_PER_GPU", "2", "TRAIN.IMAGE_SIZE", "[32, 16]",
            "GPU.DTYPE", "float32", "WORKERS", "1", "PRINT_FREQ", "1",
            "OUTPUT_DIR", str(tmp_path / "o"), "LOG_DIR", str(tmp_path / "l")]
    out = train.main(argv + ["TRAIN.END_EPOCH", "1",
                             "TPU.LAYER_SUMMARY", "True"])
    raw = torch.load(os.path.join(out, "checkpoint.pt"), weights_only=True)
    assert raw["epoch"] == 1
    assert glob.glob(os.path.join(out, "vis", "epoch0", "*", "x2t_predict_0.png"))
    train.main(argv + ["TRAIN.END_EPOCH", "2", "TRAIN.RESUME", "True"])
    log = "".join(open(p).read() for p in glob.glob(os.path.join(
        out, "*_train.log")))
    assert "=> loaded checkpoint (epoch 1)" in log
    assert log.count("per-layer summary of ") == 4  # TPU.LAYER_SUMMARY
    assert "model encdec  :" in log
    losses = [line for line in log.splitlines() if "Loss_encdec_ave" in line]
    assert len(losses) == 2 and "nan" not in " ".join(losses).lower()
