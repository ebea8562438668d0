"""The check has teeth: each cell, driven at a tiny size on the CPU with
the look for a card skipped, comes out ``correct`` with its own limits,
and not correct once the timed path underneath is broken in each way the
cell can be: a step that leaves its state as it was; half of the batch
left out, the mean taken over the rest; an answer altered where it is
produced. (One card: no exchange between chips to leave out.)"""

import pytest
import torch

from benchmark import run as runner

from . import tiny

CPU = torch.device("cpu")
SEED = 2**31 + 12345


def drive(cell):
    return runner.execute(cell, SEED, 0.5, False, device=CPU, parts=tiny.parts(cell))


def frozen(monkeypatch):
    """Every optimizer step leaves the parameters and its state alone."""
    for cls in (torch.optim.Adam, torch.optim.SGD):
        monkeypatch.setattr(cls, "step", lambda self, closure=None: None)


def half_batch(monkeypatch):
    from vae2_tpu_torch.core import seg_loop
    from vae2_tpu_torch.core.system import VAE2System

    step = VAE2System.train_step

    def vae2_half(self, batch, generator=None, multiplier=1.0, eps=None, rand_code=None):
        h = batch["xt"].shape[0] // 2
        return step(self, {k: v[:h] for k, v in batch.items()}, generator, multiplier,
                    [e[:h] for e in eps], rand_code[:h])

    make = seg_loop.make_seg_train_step

    def seg_half(*args, **kwargs):
        inner = make(*args, **kwargs)
        return lambda images, labels: inner(images[:1], labels[:1])

    monkeypatch.setattr(VAE2System, "train_step", vae2_half)
    monkeypatch.setattr(seg_loop, "make_seg_train_step", seg_half)


def half_samples(monkeypatch):
    """The sampler decodes half of each call's samples and repeats them."""
    from vae2_tpu_torch.core import infer_loop

    make = infer_loop.make_prior_sampler

    def sampler(system, chunk, h, w):
        inner = make(system, chunk, h, w)

        def fn(xt, x2t, g):
            out = inner(xt, x2t, g)
            return tuple(torch.cat([o[:chunk // 2]] * 2)[:chunk] for o in out)

        return fn

    monkeypatch.setattr(infer_loop, "make_prior_sampler", sampler)


def altered_score(monkeypatch):
    from vae2_tpu_torch.core import infer_loop

    make = infer_loop.make_metric_fn

    def metric():
        inner = make()

        def fn(pred, gt):
            out = inner(pred, gt)
            out["recon"] = out["recon"] + 1.0
            return out

        return fn

    monkeypatch.setattr(infer_loop, "make_metric_fn", metric)


TRAIN = ["vae2_train_b8", "seg_w48_train_b3"]
CASES = ([(c, f) for c in TRAIN for f in (frozen, half_batch)]
         + [("vae2_eval_prior_k100", f) for f in (half_samples, altered_score)])


@pytest.mark.parametrize("cell", TRAIN + ["vae2_eval_prior_k100"])
def test_sound_run_is_correct(cell):
    result = drive(cell)
    assert result["correct"], result["checks"]
    assert list(result)[-2:] == ["checks", "_info"]


@pytest.mark.parametrize("cell,fault", CASES, ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_caught(cell, fault, monkeypatch):
    fault(monkeypatch)
    result = drive(cell)
    assert not result["correct"], result["checks"]
