"""vae2_tpu_torch end to end on the CPU: the inference CLI at the tiny
debug spec on data/synthetic64, its metric tree read back by the JAX-free
tools/statistic.py; the checkpoint round trip; from_jax_params' refusals;
and the guard that the port imports nothing of JAX, of OpenCV or of the JAX
package."""

import ast
import glob
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vae2_tpu_torch.config import get_default_config
from vae2_tpu_torch.core.builder import build_system
from vae2_tpu_torch.tools import inference
from vae2_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from vae2_tpu_torch.utils.jax_params import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = "experiments/cityscapes/debug_tiny_32x64.yaml"
DATA = "data/synthetic64"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "cv2", "vae2_tpu"}


def _tiny_config():
    cfg = get_default_config()
    cfg.merge_from_file(os.path.join(REPO, CFG))
    cfg.GPU.DTYPE = "float32"
    return cfg


def test_checkpoint_roundtrip_and_seeded_init(tmp_path):
    a = build_system(_tiny_config(), seed=3)
    b = build_system(_tiny_config(), seed=3)
    sa, sb = a.modules.state_dict(), b.modules.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    conv = sa["encdec.encoder.trunk.conv1.weight"]
    assert conv.shape == (64, 9, 3, 3)
    assert 0.0005 < float(conv.std()) < 0.002  # normal(std 0.001)
    assert torch.equal(sa["encdec.encoder.trunk.bn1.running_var"],
                       torch.ones(64))
    path = str(tmp_path / "c.pt")
    save_checkpoint(path, sa, epoch=7)
    loaded, epoch = load_checkpoint(path)
    assert epoch == 7 and all(torch.equal(loaded[k], sa[k]) for k in sa)


def test_from_jax_params_refuses_what_it_cannot_map():
    conv = {"kernel": np.zeros((3, 3, 2, 4), np.float32)}
    bn = {"scale": np.ones(4, np.float32), "bias": np.zeros(4, np.float32)}
    stats = {"mean": np.zeros(4, np.float32), "var": np.ones(4, np.float32)}
    sd = from_jax_params({"c": conv, "b": bn}, {"b": stats})
    assert sd["c.weight"].shape == (4, 2, 3, 3)  # HWIO -> OIHW
    assert sorted(sd) == ["b.bias", "b.running_mean", "b.running_var",
                          "b.weight", "c.weight"]
    with pytest.raises(KeyError, match="mean/var"):
        from_jax_params({"b": bn}, {})
    with pytest.raises(KeyError, match="left over"):
        from_jax_params({"c": conv}, {"c": stats})
    with pytest.raises(KeyError, match="no parameters"):
        from_jax_params({"c": conv}, {"d": stats})
    with pytest.raises(KeyError, match="cannot map"):
        from_jax_params({"c": {"kernel": conv["kernel"], "w": bn["bias"]}})


def test_inference_cli_on_cpu(tmp_path):
    cfg = _tiny_config()
    system = build_system(cfg, seed=0)
    ckpt = str(tmp_path / "init.pt")
    save_checkpoint(ckpt, system.modules.state_dict(), epoch=0)
    out_dir = inference.main([
        "--cfg", os.path.join(REPO, CFG), "--checkpoint", ckpt,
        "--num-samples", "3", "--device", "cpu", "--seed", "1",
        "OUTPUT_DIR", str(tmp_path / "out"), "LOG_DIR", str(tmp_path / "log"),
        "DATASET.ROOT", os.path.join(REPO, DATA),
        "DATASET.TEST_SET", os.path.join(REPO, DATA, "test_list.txt"),
        "TEST.NUM_SAMPLES", "2", "TEST.BATCH_SIZE_PER_GPU", "1",
        "TPU.INFER_SAMPLE_BATCH", "2", "WORKERS", "1", "GPU.DTYPE", "float32",
        "TRAIN.IMAGE_SIZE", "[64, 32]"])
    root = os.path.join(out_dir, "vis", "epoch0")
    videos = sorted(os.listdir(root))
    assert len(videos) == 2
    for tag in ("x2t", "x3t"):
        txts = glob.glob(os.path.join(root, "*", f"{tag}predict", "*.txt"))
        assert len(txts) == 2 * 3 * 4  # videos x frames x metrics
        for t in txts:
            vals = [float(v) for v in open(t)]
            assert len(vals) == 3  # one line per sample (chunks 2 + 1)
            assert all(math.isfinite(v) for v in vals), t
        pngs = glob.glob(os.path.join(root, "*", f"{tag}predict", "*.png"))
        assert len(pngs) == 2 * 3 * 3  # videos x samples x frames
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "statistic.py"),
         "--root", root, "--mode", "meanvar", "--candidate", "x2t,x3t"],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    stats = json.loads(proc.stdout)
    assert set(stats) == {f"{f}_{m}" for f in range(3) for m in
                          ("msssimloss", "psnrloss", "ssimloss", "reconloss")}
    assert all(math.isfinite(v) for pair in stats.values() for v in pair)


@pytest.mark.parametrize("knob,value", [("HEAD_DATAFLOW", "presum"),
                                        ("HEAD_DATAFLOW", "multiscale"),
                                        ("MULTISCALE_HEAD", True)])
def test_unported_head_dataflows_raise(knob, value):
    """The branch-list head dataflows, once unported, now build into every
    network with a head; a dataflow that does not exist raises."""
    cfg = _tiny_config()
    cfg.TPU[knob] = value
    system = build_system(cfg)
    want = "multiscale" if knob == "MULTISCALE_HEAD" else value
    assert system.modules["encdec"].encoder.head_dataflow == want
    assert system.modules["d_seq"].head_dataflow == want
    cfg = _tiny_config()
    cfg.TPU.HEAD_DATAFLOW = "sum"
    with pytest.raises(ValueError, match="HEAD_DATAFLOW"):
        build_system(cfg)


def test_inference_cli_refuses_momentum_sampling():
    """Momentum sampling needs the 5-clip layout: without --clip-num 5 the
    CLI exits with the JAX package's message, before it builds anything."""
    for argv in ([], ["--clip-num", "3"]):
        with pytest.raises(SystemExit, match="needs --clip-num 5"):
            inference.main(["--sampling-mode", "momentum_sampling",
                            "--device", "cpu", *argv])


def _sources():
    files = glob.glob(os.path.join(REPO, "vae2_tpu_torch", "**", "*.py"),
                      recursive=True)
    return sorted(files) + [os.path.join(REPO, "chip_smoke.py")]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_nothing_of_jax(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{os.path.relpath(path, REPO)}:{node.lineno} imports {name}")
