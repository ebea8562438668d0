"""The HRNetV2-W48 + OCR cell ``seg_w48_ocr_train_b3``
(``drivers/seg_ocr_train.py``), driven on the CPU at a tiny cut of its
traffic with the look for a card skipped:

- a sound run is ``correct`` under the cell's own limits;
- the planted faults (``no_context``, ``gather_over_classes``,
  ``half_batch``), an optimizer that leaves the state unchanged
  (``test_bench_faults.frozen``) and the float8 control are not;
- the keep masks that the driver hands to the reference are the ones the
  program's dropout applied, step by step, and the first step's logits
  it compares are the program's.

The OCR cut: the tiny trunk of ``tiny.py``, MODEL.OCR MID 16 and KEY 8,
DROPOUT 0.3 (so that some of 32 channels drop), crops of 128x64: at 64x32
the last branch's BNs see 4 values a channel, and their backward magnifies
round-off from step to step past the cell's limits."""

import pytest
import torch

from benchmark import run as runner
from benchmark.drivers import seg_ocr_train
from vae2_tpu_torch.models import seg_hrnet_ocr

from . import test_bench_faults, tiny

CPU = torch.device("cpu")
SEED = 2**31 + 4242
OCR = "seg_w48_ocr_train_b3"


def parts():
    p = tiny.parts(OCR)
    p["config"]["recipe"]["MODEL"]["OCR"].update(MID_CHANNELS=16, KEY_CHANNELS=8, DROPOUT=0.3)
    p["traffic"].update(crop=[128, 64])
    return p


def drive(fault=""):
    return runner.execute(OCR, SEED, 0.3, False, device=CPU, parts=parts(), fault=fault)


def test_sound_run_is_correct():
    result = drive()
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["no_context", "gather_over_classes", "half_batch"])
def test_fault_is_caught(fault):
    result = drive(fault)
    assert not result["correct"], result["checks"]


def test_frozen_state_is_caught(monkeypatch):
    test_bench_faults.frozen(monkeypatch)
    result = drive()
    assert not result["correct"], result["checks"]
    update = result["checks"]["update_gap_median"]
    assert update["value"] > max(0.9, update["limit"]), update


def test_control_is_caught():
    limits = runner.Run(parts(), SEED, CPU).workload["limits"]
    numbers = seg_ocr_train.control(runner.Run(parts(), SEED, CPU))
    assert any(numbers[k] > v for k, v in limits.items()), numbers


def test_masks_and_logits_compared_are_the_programs(monkeypatch):
    applied = []
    forward = seg_hrnet_ocr.KeptDropout2d.forward

    def recorded(self, x):
        y = forward(self, x)
        applied.append((x.detach().clone(), y.detach().clone(), self.p))
        return y

    outputs = []
    net_forward = seg_hrnet_ocr.SegHRNetOCR.forward

    def kept(self, x):
        out = net_forward(self, x)
        outputs.append([o.detach().clone() for o in out])
        return out

    monkeypatch.setattr(seg_hrnet_ocr.KeptDropout2d, "forward", recorded)
    monkeypatch.setattr(seg_hrnet_ocr.SegHRNetOCR, "forward", kept)
    run = runner.Run(parts(), SEED, CPU)
    st = seg_ocr_train.setup(run)
    assert len(st["masks"]) == len(applied) == run.traffic["checked_steps"]
    for mask, (x, y, p) in zip(st["masks"], applied):
        assert 0 < int(mask.sum()) < mask.numel()
        assert torch.equal(y, x * (mask / (1.0 - p)))
    assert not torch.equal(st["masks"][0], st["masks"][1])
    assert len(st["prog"]["outputs"]) == 2
    assert all(torch.equal(a, b) for a, b in zip(st["prog"]["outputs"], outputs[0]))

