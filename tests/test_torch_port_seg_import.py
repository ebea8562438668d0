"""vae2_tpu_torch's reference-checkpoint import (``utils/torch_import.py``)
against the JAX package's, and the segmentation CLIs end to end on the CPU.

- the module-name cases of tests/test_torch_import.py, on the port's side;
- a synthetic reference state dict that covers a tiny VAE² system maps back
  onto every entry of the port's state dict with its own values;
- ``import_pretrained_trunk`` (conv1 replicated per network, heads and
  ``transition3_e`` skipped, both decoders cloned) and the seg checkpoint
  import against the JAX package's on the same synthetic ``.pth``: exact;
- ``python -m vae2_tpu_torch.tools.train_seg`` then ``...tools.test`` at the
  tiny seg spec over data/synthetic_seg, with ``--device cpu``.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_model import fill_variables
from tests.test_torch_port_step import _configure, _fill
from vae2_tpu.config import get_default_config as jax_default_config
from vae2_tpu.core.builder import build_system as jax_build_system
from vae2_tpu.models.seg_hrnet import get_seg_model as jax_get_seg_model
from vae2_tpu.utils import torch_import as jti
from vae2_tpu_torch.config import get_default_config
from vae2_tpu_torch.core.builder import build_system
from vae2_tpu_torch.models.seg_hrnet import get_seg_model
from vae2_tpu_torch.tools import test as test_cli
from vae2_tpu_torch.tools import train_seg
from vae2_tpu_torch.utils import torch_import as ti
from vae2_tpu_torch.utils.checkpoint import load_checkpoint
from vae2_tpu_torch.utils.jax_params import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG_CFG = os.path.join(REPO, "experiments", "cityscapes",
                       "debug_seg_tiny_32x64.yaml")


@pytest.mark.parametrize("net,parts,expected", [
    ("encdec", ["encoder", "trunk", "conv1"], "encdec_model.conv1"),
    ("encdec", ["dec_future", "trunk", "stage2_module0", "branch1", "block0",
                "conv1"], "encdec_model.decf_stage2.0.branches.1.0.conv1"),
    ("encdec", ["dec_past", "trunk", "layer1", "block0", "down_conv"],
     "encdec_model.decp_layer1.0.downsample.0"),
    ("encdec", ["encoder", "trunk", "transition1", "new1_0_conv"],
     "encdec_model.transition1.1.0.0"),
    ("encdec", ["encoder", "trunk", "transition2", "adapt0_conv"],
     "encdec_model.transition2.0.0"),
    ("encdec", ["encoder", "trunk", "stage3_module1", "fuse", "up_0_2_conv"],
     "encdec_model.stage3.1.fuse_layers.0.2.0"),
    ("encdec", ["encoder", "trunk", "stage4_module0", "fuse",
                "down_2_0_1_bn"], "encdec_model.stage4.0.fuse_layers.2.0.1.1"),
    ("encdec", ["encoder", "trunk", "transition3_e", "inject2_bn"],
     "encdec_model.transition3_e.2.1"),
    ("encdec", ["encoder", "last_layer_2", "bn"], "encdec_model.last_layer_2.1"),
    ("encdec", ["encoder", "last_layer_1", "conv2"],
     "encdec_model.last_layer_1.3"),
    ("encz", ["trunk", "bn2"], "encz_model.bn2"),
    ("encz", ["z_layer_3"], "encz_model.last_layer.3.0"),
    ("encz", ["z_fc1"], "encz_model.last_layer.1"),
    ("d_seq", ["trunk", "conv2"], "D_model_sequence.conv2"),
    ("d_seq", ["last_layer", "conv1"], "D_model_sequence.last_layer.0"),
    ("d_frame", ["last_layer", "bn"], "D_model_frame.last_layer.1"),
])
def test_torch_module_names(net, parts, expected):
    assert ti._net_torch_module(net, parts) == expected
    assert jti._net_torch_module(net, parts) == expected


def _tiny_port_system():
    cfg = get_default_config()
    cfg.merge_from_file(os.path.join(REPO, "experiments", "cityscapes",
                                     "debug_tiny_32x64.yaml"))
    cfg.GPU.DTYPE = "float32"
    return build_system(cfg, seed=0)


def test_reference_checkpoint_roundtrip(tmp_path):
    """Every entry of the port's state dict has a reference name, and a
    reference checkpoint holding distinct values under those names (with
    the DDP prefix and the historical typo) loads back onto each entry."""
    system = _tiny_port_system()
    state = system.modules.state_dict()
    ref = {}
    for i, (k, v) in enumerate(state.items()):
        name = ti.system_key(k).replace("encdec_model.", "module.encdec_mode.")
        ref[name] = torch.full(v.shape, float(i))
    path = str(tmp_path / "ref.pth.tar")
    torch.save({"epoch": 3, "state_dict": ref}, path)
    missing = ti.import_reference_checkpoint(system, path, strict=True)
    assert missing == []
    for i, (k, v) in enumerate(system.modules.state_dict().items()):
        assert torch.equal(v, torch.full(v.shape, float(i))), k


@pytest.fixture(scope="module")
def jax_state():
    """A tiny JAX VAE² state, shaped by ``jax.eval_shape`` and filled with
    numpy (no init compile)."""
    cfg = _configure(jax_default_config())
    system = jax_build_system(cfg)
    batch = {k: jnp.zeros((1, 16, 32, 9), jnp.float32)
             for k in ("xt", "x2t", "x3t")}
    shapes = jax.eval_shape(lambda: system.init(jax.random.PRNGKey(0), batch))
    params, stats = _fill(shapes.params, shapes.batch_stats, seed=2)
    return shapes.replace(params=params, batch_stats=stats)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_import_pretrained_trunk_matches_jax(jax_state, tmp_path):
    """A plain HRNet checkpoint (3-channel stem, a 'model.' prefix, a head
    and a transition3_e that are skipped) seeds every trunk as the JAX
    package's import does, entry for entry."""
    port = _tiny_port_system()
    port.modules.load_state_dict(
        from_jax_params(_np(jax_state.params), _np(jax_state.batch_stats)),
        strict=True)
    rng = np.random.RandomState(3)
    sd = {}
    for k, v in port.modules["encdec"].encoder.state_dict().items():
        parts = k.split(".")
        name = ti.seg_key(k) if parts[0] != "trunk" else \
            "model." + ti.seg_key(k)
        shape = (v.shape[0], 3) + tuple(v.shape[2:]) \
            if name == "model.conv1.weight" else tuple(v.shape)
        sd[name] = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    path = str(tmp_path / "hrnet_imagenet.pth")
    torch.save(sd, path)

    new_state, jmissing = jti.import_pretrained_trunk(jax_state, path,
                                                      clip_length=3)
    missing = ti.import_pretrained_trunk(port, path, clip_length=3)
    want = from_jax_params(_np(new_state.params), _np(new_state.batch_stats))
    got = port.modules.state_dict()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    assert len(missing) == len(jmissing) > 0
    enc = got["encdec.encoder.trunk.conv1.weight"]
    assert enc.shape[1] == 9
    assert torch.equal(enc[:, 3:6], sd["model.conv1.weight"])
    assert torch.equal(got["encdec.dec_past.trunk.bn1.weight"],
                       sd["model.bn1.weight"])


def test_seg_checkpoint_import_matches_jax(tmp_path):
    """A reference segmentation checkpoint (no composite prefix) onto
    SegHRNet, against the JAX CLI's import of the same file: exact."""
    cfg = jax_default_config()
    cfg.merge_from_file(SEG_CFG)
    cfg.TPU.DTYPE = "float32"
    jmodel = jax_get_seg_model(cfg)
    variables = fill_variables(jmodel, jnp.zeros((1, 32, 64, 3)), False)
    tcfg = get_default_config()
    tcfg.merge_from_file(SEG_CFG)
    tcfg.GPU.DTYPE = "float32"
    model = get_seg_model(tcfg)
    rng = np.random.RandomState(4)
    ref = {ti.seg_key(k): torch.from_numpy(rng.randn(*v.shape).astype(
        np.float32)) for k, v in model.state_dict().items()}
    path = str(tmp_path / "seg.pth")
    torch.save({"state_dict": ref}, path)
    assert ti.import_seg_checkpoint(model, path, strict=True) == []
    # the JAX CLI's route (tools/test.py:51-63)
    sd = {f"D_model_sequence.{k}": v
          for k, v in jti.load_torch_state_dict(path).items()}
    params, stats, missing = jti.import_params(
        {"d_seq": variables["params"]},
        {"d_seq": variables["batch_stats"]}, sd)
    assert missing == []
    want = from_jax_params(_np(params["d_seq"]), _np(stats["d_seq"]))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)


def test_train_seg_then_test_cli_on_cpu(tmp_path):
    """The tiny seg spec over data/synthetic_seg (8 train and 4 val images
    of 64x32): two epochs of two steps, then the test CLI on the result."""
    root = os.path.join(REPO, "data", "synthetic_seg")
    common = ["--cfg", SEG_CFG, "--device", "cpu", "DATASET.ROOT", root,
              "DATASET.TRAIN_SET", os.path.join(root, "train.lst"),
              "DATASET.TEST_SET", os.path.join(root, "val.lst"),
              "OUTPUT_DIR", str(tmp_path / "out"),
              "LOG_DIR", str(tmp_path / "log"), "GPU.DTYPE", "float32"]
    out_dir = train_seg.main(common[:2] + ["--seed", "0"] + common[2:])
    ckpt = torch.load(os.path.join(out_dir, "seg_checkpoint.pt"),
                      weights_only=True)
    assert ckpt["epoch"] == 2 and "optimizer" in ckpt
    final = os.path.join(out_dir, "seg_final_state.pt")
    state, epoch = load_checkpoint(final)
    assert epoch == 2
    result = test_cli.main(common + ["TEST.MODEL_FILE", final])
    assert len(result) == 3 and all(map(math.isfinite, result))
    log = "".join(open(os.path.join(out_dir, f)).read()
                  for f in os.listdir(out_dir) if f.endswith("_test.log"))
    assert "loaded " + final in log and "MeanIU" in log


def test_seg_clis_refuse_a_missing_card():
    """Without --device cpu the CLIs ask for CUDA and say so when there is
    none (this CPU-only build), before they build anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cli in (train_seg, test_cli):
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(["--cfg", SEG_CFG])
