"""vae2_tpu_torch's segmentation model and engine against the JAX package,
at the widths of experiments/cityscapes/debug_seg_tiny_32x64.yaml, 32x64
inputs, float32, the same weights (``from_jax_params`` of a numpy-filled
flax tree) and the same inputs (numpy, seeded).

- ``SegHRNet`` logits in eval and train mode (and the running statistics
  train mode leaves) under the head dataflows 'concat', 'presum' and
  'multiscale';
- ``ConvHead`` on a branch list against the concat, inside the port;
- one ``make_seg_train_step`` step (SGD with WD and momentum, class weights,
  ignored pixels) against the JAX step: loss, updated parameters and
  running statistics;
- ``flip_tta`` with LIP's flip pairs, ``whole_image_logits`` on a shape
  that is not a multiple of 32, ``multi_scale_inference`` at scales (0.75,
  1.0) with flip, and ``seg_testval``'s mIoU over two images of
  data/synthetic_seg.

The JAX side runs on its 'xla' BN backend (the Pallas kernels' math,
tests/test_torch_port_train.py holds them to it), each function jitted
once per module fixture. Tolerance 1e-4 * (1 + max|jax|) elementwise
unless stated: both sides compute in f32 with their own convolution
algorithms and summation orders.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_model import assert_close, fill_variables, nhwc
from vae2_tpu.config import get_default_config as jax_default_config
from vae2_tpu.core import seg_loop as jsl
from vae2_tpu.core.system import make_optimizer as jax_make_optimizer
from vae2_tpu.data.segmentation import CityscapesSeg as JaxCityscapes
from vae2_tpu.models.seg_hrnet import get_seg_model as jax_get_seg_model
from vae2_tpu_torch.config import get_default_config
from vae2_tpu_torch.core import seg_loop as tsl
from vae2_tpu_torch.core.system import make_optimizer
from vae2_tpu_torch.data.segmentation import (CITYSCAPES_CLASS_WEIGHTS,
                                              LIP_LEFT_IDX, LIP_RIGHT_IDX,
                                              CityscapesSeg)
from vae2_tpu_torch.models import hrnet as th
from vae2_tpu_torch.models.seg_hrnet import get_seg_model
from vae2_tpu_torch.utils.jax_params import from_jax_params

WEIGHTS = np.append(CITYSCAPES_CLASS_WEIGHTS, np.float32(1.1))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "experiments", "cityscapes",
                   "debug_seg_tiny_32x64.yaml")
B, H, W, CLASSES = 2, 32, 64, 20  # LIP's class count: its flip pairs fit
DATAFLOWS = ("concat", "presum", "multiscale")


def _configure(cfg, dataflow="concat"):
    cfg.merge_from_file(CFG)
    cfg.TPU.DTYPE = "float32"
    cfg.TPU.HEAD_DATAFLOW = dataflow
    cfg.DATASET.NUM_CLASSES = CLASSES
    cfg.TRAIN.OPTIMIZER = "sgd"
    cfg.TRAIN.LR = 0.01
    return cfg


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_model(variables, dataflow="concat"):
    cfg = _configure(get_default_config(), dataflow)
    model = get_seg_model(cfg)
    model.load_state_dict(from_jax_params(_np(variables["params"]),
                                          _np(variables["batch_stats"])),
                          strict=True)
    return model


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def case():
    """One tiny JAX SegHRNet with numpy-filled weights, its port twin per
    dataflow, an input batch and labels with ignored pixels."""
    rng = np.random.RandomState(0)
    x = rng.randn(B, H, W, 3).astype(np.float32)
    labels = rng.randint(-1, CLASSES, (B, H, W)).astype(np.int32)
    jmodels = {d: jax_get_seg_model(_configure(jax_default_config(), d))
               for d in DATAFLOWS}
    variables = fill_variables(jmodels["concat"], jnp.asarray(x), False,
                               seed=1)
    return jmodels, variables, x, labels


@pytest.fixture(scope="module")
def jax_logits(case):
    """Eval logits, train logits and the train-mode batch statistics per
    dataflow, one jit each."""
    jmodels, variables, x, _ = case
    out = {}
    for d, jm in jmodels.items():
        @jax.jit
        def both(v, x_, jm=jm):
            ev = jm.apply(v, x_, False)
            tr, upd = jm.apply(v, x_, True, mutable=["batch_stats"])
            return ev, tr, upd["batch_stats"]

        out[d] = _np(both(variables, jnp.asarray(x)))
    return out


@pytest.mark.parametrize("dataflow", DATAFLOWS)
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_seg_hrnet_matches_jax(case, jax_logits, dataflow, train):
    _, variables, x, _ = case
    ev, tr, stats = jax_logits[dataflow]
    model = _port_model(variables, dataflow).train(train)
    with torch.no_grad():
        got = model(_nchw(x))
    assert got.dtype == torch.float32 and got.shape == (B, CLASSES, H // 4,
                                                        W // 4)
    assert_close(nhwc(got), tr if train else ev)
    if train:
        want = from_jax_params(_np(variables["params"]), stats)
        for k, v in model.state_dict().items():
            if "running_" in k:
                assert_close(v.numpy(), want[k])


def test_conv_head_presum_matches_concat():
    """A branch list through ConvHead (per-branch slices of conv1) against
    the upsample-concat, in the port alone: within 1e-5."""
    torch.manual_seed(0)
    widths = (4, 8, 16, 32)
    xs = [torch.randn(2, c, 16 // 2**b, 32 // 2**b).contiguous(
        memory_format=torch.channels_last) for b, c in enumerate(widths)]
    head = th.ConvHead(sum(widths), 5).eval()
    with torch.no_grad():
        for p in head.parameters():  # fan-in scale: outputs of order 1
            p.normal_(0.0, 1.0 / max(p[0].numel(), 1) ** 0.5)
        head.bn.running_mean.normal_()
        head.bn.running_var.uniform_(0.5, 1.5)
        want = head(th.concat_upsampled(xs))
        for got in (head(th.upsampled_branches(xs)), head(xs)):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_step(case):
    """The JAX package's seg train step (SGD lr 1e-2, momentum 0.9, WD 5e-4,
    class weights) once from the filled weights."""
    jmodels, variables, x, labels = case
    cfg = _configure(jax_default_config())
    tx = jax_make_optimizer(cfg.TRAIN)
    step = jsl.make_seg_train_step(jmodels["concat"], tx,
                                   class_weights=WEIGHTS)
    params = variables["params"]
    new_p, new_s, _, loss = step(params, variables["batch_stats"],
                                 tx.init(params), jnp.asarray(x),
                                 jnp.asarray(labels))
    return float(loss), from_jax_params(_np(new_p), _np(new_s))


def test_seg_train_step_matches_jax(case, jax_step):
    _, variables, x, labels = case
    loss_want, want = jax_step
    model = _port_model(variables)
    cfg = _configure(get_default_config())
    step = tsl.make_seg_train_step(
        model, make_optimizer(model.parameters(), cfg.TRAIN),
        class_weights=WEIGHTS)
    loss = step(_nchw(x), torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), loss_want, rtol=1e-4)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert_close(got[k].numpy(), v.numpy())


@pytest.fixture(scope="module")
def infer_pair(case):
    """JAX's jitted infer and the port's, on the same eval-mode weights."""
    jmodels, variables, _, _ = case
    return (jsl.make_infer_fn(jmodels["concat"], variables),
            tsl.make_infer_fn(_port_model(variables)))


def test_flip_tta_with_lip_flip_pairs(case, infer_pair):
    jinfer, tinfer = infer_pair
    x = case[2][:1]
    pairs = list(zip(LIP_LEFT_IDX, LIP_RIGHT_IDX))
    want = np.asarray(jsl.flip_tta(jinfer, jnp.asarray(x), pairs))
    got = tsl.flip_tta(tinfer, _nchw(x), pairs)
    assert_close(nhwc(got), want)


def test_whole_image_logits_not_multiple_of_32(infer_pair):
    jinfer, tinfer = infer_pair
    image = np.random.RandomState(3).randn(40, 72, 3).astype(np.float32)
    want = jsl.whole_image_logits(jinfer, image)
    got = tsl.whole_image_logits(tinfer, image)
    assert got.shape == (40, 72, CLASSES)
    assert_close(got, want)


def test_multi_scale_inference_with_flip(infer_pair):
    jinfer, tinfer = infer_pair
    image = np.random.RandomState(4).randn(40, 72, 3).astype(np.float32)
    kw = dict(crop_size=(H, W), num_classes=CLASSES, scales=(0.75, 1.0),
              flip=True)
    want = jsl.multi_scale_inference(jinfer, image, **kw)
    got = tsl.multi_scale_inference(tinfer, image, **kw)
    assert got.shape == (40, 72, CLASSES)
    assert_close(got, want)


def test_seg_testval_miou_matches_jax(case, infer_pair):
    """mIoU, pixel and mean accuracy over the first two val images of
    data/synthetic_seg (64x32): within 1e-6."""
    jmodels, variables, _, _ = case
    root = os.path.join(REPO, "data", "synthetic_seg")
    val = os.path.join(root, "val.lst")
    kw = dict(multi_scale=False, flip=False, crop_size=(H, W), base_size=64,
              num_samples=2)
    cfg = _configure(get_default_config())
    jcfg = _configure(jax_default_config())
    got = tsl.seg_testval(cfg, CityscapesSeg(root, val, **kw),
                          _port_model(variables))
    want = jsl.seg_testval(jcfg, JaxCityscapes(root, val, **kw),
                           jmodels["concat"], variables)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[2:], want[2:], rtol=0, atol=1e-6)
