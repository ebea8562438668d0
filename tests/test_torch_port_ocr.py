"""HRNetV2 + OCR in vae2_tpu_torch (``models/seg_hrnet_ocr.py``) on the CPU,
at the widths of experiments/cityscapes/debug_seg_tiny_32x64.yaml with
MODEL.OCR MID_CHANNELS 16 and KEY_CHANNELS 8, float32:

- both outputs, the balanced loss and every gradient of the port against
  the benchmark's plain reference (``benchmark/reference/ocr.py``) on the
  benchmark's seeded weights, the reference given the dropout masks the
  port applied; in train and in eval mode;
- ``ocr.forwards`` and the ``ocr.*`` spans of a seg train step;
- ``LOSS.BALANCE_WEIGHTS`` [1] over one output is the W48 loss, bit for
  bit, with cross entropy and with OHEM;
- ``seg_testval`` scores output TEST.OUTPUT_INDEX (``out``, not ``aux``);
- the seg batcher's ``seg.next_batch`` records;
- a tiny ``train_seg`` run of the OCR recipe, then ``test`` on it.

Tolerance 1e-4 * (1 + max|reference|) elementwise, that of
tests/test_torch_port_seg_model.py: both sides compute in float32 with
their own convolution algorithms and summation orders (the port's batched
products run on channels_last views, the reference's on NCHW). Crops of
64x128, so that the last branch's BNs see 16 values a channel: at 32x64
they see 4, and the backward's cancellation there magnifies round-off
past any tolerance that would still mean something.
"""

import os

import numpy as np
import pytest
import torch

from benchmark import inputs, weights
from benchmark.reference import ocr as ref_ocr
from benchmark.reference import steps as ref_steps
from vae2_tpu_torch.config import get_default_config
from vae2_tpu_torch.core import seg_loop
from vae2_tpu_torch.core.losses import (balanced_seg_loss, cross_entropy_loss,
                                        ohem_cross_entropy)
from vae2_tpu_torch.core.system import make_optimizer
from vae2_tpu_torch.data.seg_batcher import SegBatcher
from vae2_tpu_torch.data.segmentation import (CITYSCAPES_CLASS_WEIGHTS,
                                              CityscapesSeg)
from vae2_tpu_torch.models.seg_hrnet import get_seg_model
from vae2_tpu_torch.models.seg_hrnet_ocr import SegHRNetOCR
from vae2_tpu_torch.utils import spans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "experiments", "cityscapes", "debug_seg_tiny_32x64.yaml")
DATA = os.path.join(REPO, "data", "synthetic_seg")
OCR_OPTS = ["MODEL.NAME", "seg_hrnet_ocr", "MODEL.NUM_OUTPUTS", "2",
            "MODEL.OCR.MID_CHANNELS", "16", "MODEL.OCR.KEY_CHANNELS", "8",
            "LOSS.BALANCE_WEIGHTS", "[0.4, 1.0]"]
B, H, W, CLASSES = 2, 64, 128, 19
BALANCE = [0.4, 1.0]


def tiny_config(dropout=0.05):
    cfg = get_default_config()
    cfg.merge_from_file(TINY)
    cfg.merge_from_list(OCR_OPTS)
    cfg.MODEL.OCR.DROPOUT = dropout
    cfg.GPU.DTYPE = "float32"
    cfg.TRAIN.OPTIMIZER = "sgd"
    cfg.TRAIN.LR = 0.01
    return cfg


def recipe_of(cfg) -> dict:
    """The reference's view of a config: its stages, classes and OCR node."""
    return {"MODEL": {"EXTRA": cfg.MODEL.EXTRA.to_dict(), "OCR": cfg.MODEL.OCR.to_dict()},
            "DATASET": {"NUM_CLASSES": cfg.DATASET.NUM_CLASSES}}


def assert_close(got, want):
    tol = 1e-4 * (1.0 + float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.fixture(scope="module")
def pair():
    """The port's tiny OCR net and the reference, on one seeded state."""
    cfg = tiny_config(dropout=0.3)  # some of 32 (sample, channel) pairs dropped
    recipe = recipe_of(cfg)
    state = weights.make_state(weights.skeleton(lambda: ref_ocr.ocr_module(recipe)),
                               inputs.sub_seed(5, 1), torch.device("cpu"))
    model = get_seg_model(cfg)
    model.load_state_dict(state, strict=True)
    return model, recipe, state


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_ocr_matches_reference(pair, train):
    model, recipe, state = pair
    g = torch.Generator().manual_seed(11)
    images = torch.randn(B, H, W, 3, generator=g).permute(0, 3, 1, 2)
    labels = torch.randint(-1, CLASSES, (B, H, W), generator=g)
    cw = torch.as_tensor(CITYSCAPES_CLASS_WEIGHTS, dtype=torch.float32)
    model.load_state_dict(state)  # the running statistics too
    model.train(train).zero_grad(set_to_none=True)
    outs = model(images)
    loss = balanced_seg_loss(outs, labels, BALANCE, -1, cw)
    loss.backward()
    net = weights.reference_on(torch.device("cpu"), lambda: ref_ocr.ocr_module(recipe), state)
    net.train(train)
    mask = model.ocr_distri_head.dropout.mask.clone() if train else None
    if train:
        assert mask.shape == (B, 16, 1, 1) and 0 < int(mask.sum()) < mask.numel()
    want = net(images, mask)
    want_loss = sum(b * ref_steps.seg_loss(o, labels, cw, -1) for b, o in zip(BALANCE, want))
    want_loss.backward()
    for got, w in zip(outs, want):
        assert got.dtype == torch.float32 and got.shape == (B, CLASSES, H // 4, W // 4)
        assert_close(got.detach(), w.detach())
    np.testing.assert_allclose(loss.item(), want_loss.item(), rtol=1e-5)
    ref = dict(net.named_parameters())
    for name, p in model.named_parameters():
        assert_close(p.grad, ref[name].grad)


def test_step_counts_ocr_forwards_and_opens_its_spans():
    cfg = tiny_config()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = get_seg_model(cfg)
    step = seg_loop.make_seg_train_step(model, make_optimizer(model.parameters(), cfg.TRAIN),
                                        balance_weights=cfg.LOSS.BALANCE_WEIGHTS)
    images, labels = torch.randn(1, 3, 32, 64), torch.randint(-1, CLASSES, (1, 32, 64))
    before = spans.counters()["ocr.forwards"]
    with torch.profiler.profile() as prof:
        for _ in range(2):
            step(images, labels)
    assert spans.counters()["ocr.forwards"] - before == 2 == SegHRNetOCR.forwards - before
    names = {e.name for e in prof.events()}
    assert {"ocr.aux", "ocr.gather", "ocr.attention", "ocr.fuse"} <= names


@pytest.mark.parametrize("use_ohem", [False, True], ids=["ce", "ohem"])
def test_one_output_of_weight_one_is_the_w48_loss(use_ohem):
    g = torch.Generator().manual_seed(2)
    logits = torch.randn(2, CLASSES, 8, 16, generator=g, requires_grad=True)
    labels = torch.randint(-1, CLASSES, (2, 32, 64), generator=g)
    cw = torch.as_tensor(CITYSCAPES_CLASS_WEIGHTS, dtype=torch.float32)
    got = balanced_seg_loss(logits, labels, [1.0], -1, cw, use_ohem, 0.7, 500)
    (got_grad,) = torch.autograd.grad(got, logits)
    want = (ohem_cross_entropy(logits, labels, -1, 0.7, 500, cw) if use_ohem
            else cross_entropy_loss(logits, labels, -1, cw))
    (want_grad,) = torch.autograd.grad(want, logits)
    assert torch.equal(got, want) and torch.equal(got_grad, want_grad)


class _Output(torch.nn.Module):
    """One output of a net of several, as a net of one."""

    def __init__(self, net, index):
        super().__init__()
        self.net, self.index = net, index

    def forward(self, x):
        return self.net(x)[self.index]


def test_seg_testval_scores_the_output_index():
    """Each output predicts one class everywhere (its last convolution
    zeroed, its bias on that class): ``out`` the labels' commonest class,
    ``aux`` the next, so that their pixel accuracies differ."""
    cfg = tiny_config()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(4)
        model = get_seg_model(cfg)
    data = CityscapesSeg(DATA, os.path.join(DATA, "val.lst"), multi_scale=False, flip=False,
                         crop_size=(32, 64), base_size=64, num_samples=2)
    counts = np.bincount(np.concatenate([data[i][1].ravel() for i in range(len(data))]) + 1)
    top = [int(c) - 1 for c in np.argsort(counts[1:])[::-1][:2] + 1]
    with torch.no_grad():
        for conv, cls in ((model.cls_head, top[0]), (model.aux_head.conv2, top[1])):
            conv.weight.zero_()
            conv.bias.zero_()
            conv.bias[cls] = 1.0
    got = seg_loop.seg_testval(cfg, data, model)
    out = seg_loop.seg_testval(cfg, data, _Output(model, 1))
    aux = seg_loop.seg_testval(cfg, data, _Output(model, 0))
    assert got[2] == out[2] > aux[2] > 0  # pixel accuracy
    np.testing.assert_array_equal(got[1], out[1])
    cfg.TEST.OUTPUT_INDEX = 0
    assert seg_loop.seg_testval(cfg, data, model)[2] == aux[2]


def test_seg_batcher_records_each_batch():
    data = CityscapesSeg(DATA, os.path.join(DATA, "train.lst"), crop_size=(32, 64),
                         base_size=64, scale_factor=11)
    mark = spans.recorded()
    batches = list(SegBatcher(data, 3, seed=1))
    assert len(batches) == len(data) // 3
    assert [r["name"] for r in spans.steps(mark)] == ["seg.next_batch"] * len(batches)
    images, labels = batches[0][:2]
    assert images.shape == (3, 3, 32, 64) and labels.shape == (3, 32, 64)
    assert images.is_contiguous(memory_format=torch.channels_last)


def test_train_seg_ocr_recipe_runs(tmp_path):
    from vae2_tpu_torch.tools import test as seg_test_cli
    from vae2_tpu_torch.tools import train_seg

    opts = OCR_OPTS + ["OUTPUT_DIR", str(tmp_path / "o"), "LOG_DIR", str(tmp_path / "l"),
                       "GPU.DTYPE", "float32", "TRAIN.END_EPOCH", "1",
                       "TRAIN.NUM_SAMPLES", "4", "TEST.NUM_SAMPLES", "1"]
    out = train_seg.main(["--cfg", TINY, "--device", "cpu"] + opts)
    state = os.path.join(out, "seg_final_state.pt")
    assert os.path.isfile(state)
    miou, pixel_acc, _ = seg_test_cli.main(["--cfg", TINY, "--device", "cpu"] + opts
                                           + ["TEST.MODEL_FILE", state])
    assert 0.0 <= miou <= 1.0 and 0.0 <= pixel_acc <= 1.0
