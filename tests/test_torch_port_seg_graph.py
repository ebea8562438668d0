"""The seg train step's CUDA-graph rule on the CPU (``core/seg_loop.py``):
``step_path`` keeps the step eager off CUDA and across ranks, warms a
batch key up eagerly at its first call and graphs it from the second;
``batch_key`` tells shapes, dtypes and devices apart; a CPU step never
captures, counts an eager step each call, returns a fresh loss each call
and computes, bit for bit, the eager forward, loss, backward and SGD
update written out by hand. The capture and the replays themselves run
on the card (``tests/test_torch_port_gpu.py``)."""

import copy
import os

import pytest
import torch

from vae2_tpu_torch.config import get_default_config
from vae2_tpu_torch.core import seg_loop
from vae2_tpu_torch.core.losses import cross_entropy_loss
from vae2_tpu_torch.core.system import make_optimizer
from vae2_tpu_torch.models.seg_hrnet import get_seg_model
from vae2_tpu_torch.utils import spans

SEG_TINY_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "experiments", "cityscapes", "debug_seg_tiny_32x64.yaml")


@pytest.mark.parametrize("on_cuda,world,spatial,seen,path", [
    (False, 1, 1, False, "eager"),
    (False, 1, 1, True, "eager"),      # the CPU never captures
    (True, 2, 1, True, "eager"),       # data parallel: NCCL stays eager
    (True, 4, 2, True, "eager"),       # a spatial layout
    (True, 2, 2, False, "eager"),
    (True, 1, 1, False, "warm_up"),    # a key's first call
    (True, 1, 1, True, "graph"),
])
def test_step_path(on_cuda, world, spatial, seen, path):
    assert seg_loop.step_path(on_cuda, world, spatial, seen) == path


def test_batch_key_tells_shapes_and_dtypes_apart():
    images = torch.zeros(2, 3, 8, 16)
    labels = torch.zeros(2, 8, 16, dtype=torch.int32)
    key = seg_loop.batch_key(images, labels)
    assert key == seg_loop.batch_key(torch.ones(2, 3, 8, 16), labels + 1)
    assert key == seg_loop.batch_key(
        images.contiguous(memory_format=torch.channels_last), labels)
    assert key != seg_loop.batch_key(images[:1], labels[:1])
    assert key != seg_loop.batch_key(images.double(), labels)
    assert key != seg_loop.batch_key(images, labels.long())


def _tiny_seg():
    cfg = get_default_config()
    cfg.merge_from_file(SEG_TINY_CFG)
    cfg.GPU.DTYPE = "float32"
    cfg.TRAIN.OPTIMIZER = "sgd"
    cfg.TRAIN.LR = 0.01
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = get_seg_model(cfg)
    return cfg, model


@pytest.fixture(scope="module")
def cpu_steps():
    """Three tiny seg steps on the CPU through ``make_seg_train_step``, and
    the same three written out by hand on a copy of the model."""
    cfg, model = _tiny_seg()
    twin = copy.deepcopy(model)
    g = torch.Generator().manual_seed(3)
    batches = [(torch.randn(2, 32, 64, 3, generator=g).permute(0, 3, 1, 2),
                torch.randint(-1, 19, (2, 32, 64), generator=g))
               for _ in range(2)]
    batches.append(batches[0])
    step = seg_loop.make_seg_train_step(model, make_optimizer(model.parameters(), cfg.TRAIN))
    before = dict(seg_loop.GRAPH_COUNTS)
    viewed = spans.counters()
    losses = [step(images, labels) for images, labels in batches]
    counts = {k: v - before[k] for k, v in seg_loop.GRAPH_COUNTS.items()}
    now = spans.counters()
    viewed = {k: now[k] - viewed[k] for k in now if k.startswith("seg.graph.")}
    opt = make_optimizer(twin.parameters(), cfg.TRAIN)
    want = []
    for images, labels in batches:
        twin.train()
        loss = cross_entropy_loss(twin(images), labels)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        want.append(loss.detach())
    return {"losses": losses, "counts": counts, "viewed": viewed, "want": want,
            "model": model, "twin": twin}


def test_cpu_step_never_captures(cpu_steps):
    assert cpu_steps["counts"] == {"captures": 0, "replays": 0, "eager_steps": 3}
    assert cpu_steps["viewed"] == {"seg.graph.captures": 0, "seg.graph.replays": 0,
                                   "seg.graph.eager_steps": 3}


def test_cpu_step_returns_a_fresh_loss_each_call(cpu_steps):
    losses = cpu_steps["losses"]
    assert all(not loss.requires_grad and loss.dim() == 0 for loss in losses)
    assert len({loss.data_ptr() for loss in losses}) == len(losses)
    # the first batch again, after two updates: another loss, in its own tensor
    assert not torch.equal(losses[0], losses[2])


def test_cpu_step_is_the_eager_step(cpu_steps):
    for got, want in zip(cpu_steps["losses"], cpu_steps["want"]):
        assert torch.equal(got, want)
    want = cpu_steps["twin"].state_dict()
    for k, v in cpu_steps["model"].state_dict().items():
        assert torch.equal(v, want[k]), k
