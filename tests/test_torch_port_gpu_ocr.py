"""Card tests of HRNetV2 + OCR's train step (``models/seg_hrnet_ocr.py``
through ``core/seg_loop.make_seg_train_step``): the step replayed from CUDA
graphs against the same step kept eager, and the dropout masks that the
replays draw. They need an NVIDIA GPU, carry the ``gpu`` marker, and skip
elsewhere; this file imports nothing of JAX:

    python -m pytest tests/test_torch_port_gpu_ocr.py -m gpu
"""

import os

import pytest
import torch

from vae2_tpu_torch.config import get_default_config
from vae2_tpu_torch.utils.device import exact_f32

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _randomize(modules, seed):
    """Conv kernels normal(1/sqrt(fan_in)), so that signal propagates, and
    seeded non-trivial BN statistics and affine parameters (as in
    tests/test_torch_port_gpu.py)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in modules.modules():
            if isinstance(m, torch.nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               / fan_in**0.5)
            elif hasattr(m, "running_var"):
                c = m.weight.shape[0]
                m.weight.copy_(torch.rand(c, generator=g) + 0.5)
                m.bias.copy_(torch.randn(c, generator=g) * 0.2)
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.2)
                m.running_var.copy_(torch.rand(c, generator=g) + 0.5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100)")
    return torch.device("cuda")


def ocr_config(dropout, mid=16, key=8):
    """The tiny seg recipe's trunk with an OCR head of ``mid`` and ``key``
    channels, f32, SGD with momentum and WD at a constant lr."""
    cfg = get_default_config()
    cfg.merge_from_file(os.path.join(
        REPO, "experiments", "cityscapes", "debug_seg_tiny_32x64.yaml"))
    cfg.merge_from_list(["MODEL.NAME", "seg_hrnet_ocr", "MODEL.NUM_OUTPUTS", "2",
                         "MODEL.OCR.MID_CHANNELS", str(mid),
                         "MODEL.OCR.KEY_CHANNELS", str(key),
                         "MODEL.OCR.DROPOUT", str(dropout),
                         "LOSS.BALANCE_WEIGHTS", "[0.4, 1.0]"])
    cfg.GPU.DTYPE = "float32"
    cfg.TRAIN.OPTIMIZER = "sgd"
    cfg.TRAIN.LR = 0.01
    return cfg


def ocr_model(cfg, device):
    from vae2_tpu_torch.core.system import make_optimizer
    from vae2_tpu_torch.models.seg_hrnet import get_seg_model

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = get_seg_model(cfg)
    _randomize(model, seed=5)
    model.to(device)
    return model, make_optimizer(model.parameters(), cfg.TRAIN)


def batches(shapes, seed):
    g = torch.Generator().manual_seed(seed)
    return [(torch.randn(n, 64, 128, 3, generator=g).permute(0, 3, 1, 2),
             torch.randint(-1, 19, (n, 64, 128), generator=g)) for n in shapes]


def test_graphed_ocr_steps_match_eager_steps(cuda):
    """Seven tiny OCR steps at DROPOUT 0, two of another batch shape in the
    middle, through ``make_seg_train_step`` (each shape eager once, then
    captured and replayed: two captures, five replays), each against the
    eager step written out by hand from the same state (weights, running
    statistics, momentum), so that no step inherits another's round-off:
    each loss and the state after each step within 1e-6 relative (f32,
    TF32 off). Step by step because training this tiny OCR net is chaotic:
    on the CPU a 1e-7 change of the weights after the first of these steps
    grows to 3e-6-3e-4 of the loss by the seventh, and on CUDA the bilinear
    upsampling's backward adds with atomics in an order that differs from
    run to run. Every step counts one ``ocr.forwards``."""
    from vae2_tpu_torch.core import seg_loop
    from vae2_tpu_torch.core.losses import balanced_seg_loss
    from vae2_tpu_torch.core.seg_loop import make_seg_train_step
    from vae2_tpu_torch.data.segmentation import CITYSCAPES_CLASS_WEIGHTS
    from vae2_tpu_torch.utils import spans

    cfg = ocr_config(0.0)
    model, optimizer = ocr_model(cfg, cuda)
    twin, twin_opt = ocr_model(cfg, cuda)
    step = make_seg_train_step(model, optimizer, class_weights=CITYSCAPES_CLASS_WEIGHTS,
                               balance_weights=cfg.LOSS.BALANCE_WEIGHTS)
    weights = torch.as_tensor(CITYSCAPES_CLASS_WEIGHTS, device=cuda)
    before = dict(seg_loop.GRAPH_COUNTS)
    with exact_f32():
        for images, labels in batches([2, 2, 2, 3, 3, 2, 2], seed=9):
            images, labels = images.to(cuda), labels.to(cuda)
            twin.load_state_dict(model.state_dict())
            for p, q in zip(optimizer.param_groups[0]["params"], twin_opt.param_groups[0]["params"]):
                if p in optimizer.state:
                    twin_opt.state[q]["momentum_buffer"] = optimizer.state[p]["momentum_buffer"].clone()
            forwards = spans.counters()["ocr.forwards"]
            loss = float(step(images, labels))
            assert spans.counters()["ocr.forwards"] - forwards == 1
            twin.train()
            want = balanced_seg_loss(twin(images), labels, cfg.LOSS.BALANCE_WEIGHTS, -1, weights)
            twin_opt.zero_grad(set_to_none=True)
            want.backward()
            twin_opt.step()
            assert abs(loss - want.item()) <= 1e-6 * abs(want.item())
            got = model.state_dict()
            for k, w in twin.state_dict().items():
                torch.testing.assert_close(got[k], w, rtol=1e-6,
                                           atol=1e-6 * (1.0 + float(w.abs().max())))
    counts = {k: v - before[k] for k, v in seg_loop.GRAPH_COUNTS.items()}
    assert counts == {"captures": 2, "replays": 5, "eager_steps": 2}


def test_replays_draw_new_dropout_masks(cuda):
    """At DROPOUT 0.05 and the published MID 512: a batch key's eager step,
    its capture (which replays) and two more replays each keep their own
    mask, and each keeps 93-97% of its 3 x 512 (sample, channel) pairs
    (95% expected; 2% is 3.6 standard deviations)."""
    from vae2_tpu_torch.core import seg_loop
    from vae2_tpu_torch.core.seg_loop import make_seg_train_step

    cfg = ocr_config(0.05, mid=512, key=256)
    model, optimizer = ocr_model(cfg, cuda)
    step = make_seg_train_step(model, optimizer, balance_weights=cfg.LOSS.BALANCE_WEIGHTS)
    before = dict(seg_loop.GRAPH_COUNTS)
    masks = []
    for images, labels in batches([3] * 4, seed=10):
        step(images.to(cuda), labels.to(cuda))
        masks.append(model.ocr_distri_head.dropout.mask.clone())
    counts = {k: v - before[k] for k, v in seg_loop.GRAPH_COUNTS.items()}
    assert counts == {"captures": 1, "replays": 3, "eager_steps": 1}
    for mask in masks:
        assert mask.shape == (3, 512, 1, 1)
        assert 0.93 <= float(mask.mean()) <= 0.97
    for i in range(len(masks)):
        for j in range(i):
            assert not torch.equal(masks[i], masks[j])
