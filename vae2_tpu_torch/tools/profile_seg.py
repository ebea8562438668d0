"""Profile the segmentation HRNet on the GPU and say where the time goes
(counterpart of ``profile_train.py`` and ``profile_infer.py`` for the
segmentation path).

Builds the recipe's model (random weights from ``--seed``) and runs, each
after two warm-up calls and under ``torch.profiler``:

- ``--steps`` train steps (``make_seg_train_step``: forward, CE loss,
  backward, ``optimizer.step``) on a random batch of TRAIN.BATCH_SIZE_PER_GPU
  crops of TRAIN.IMAGE_SIZE;
- ``--steps`` whole-image test forwards (``make_infer_fn``: eval logits
  upsampled x4) of one TEST.IMAGE_SIZE image.

For each it prints a JSON line (wall time per call, device busy time and
share, fused-ABN kernel launches per call, all device launches per call,
peak memory), then the top kernels and PyTorch ops by device time.

    python -m vae2_tpu_torch.tools.profile_seg \
        [--cfg experiments/cityscapes/seg_hrnet_w48_train_512x1024.yaml] \
        [--steps 3] [--top 20] [KEY VALUE ...]
"""

from __future__ import annotations

import argparse
import collections
import json
import time
from typing import Callable, Optional, Sequence

import torch

from ..config import get_default_config, update_config
from ..core.seg_loop import make_infer_fn, make_seg_train_step
from ..core.system import make_optimizer
from ..models.seg_hrnet import get_seg_model
from ..ops import abn
from ..utils.device import resolve_device
from .profile_infer import _device_us

_KERNELS = (abn.abn_rows, abn.abn_bwd_sums, abn.abn_bwd_dx)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--cfg",
        default="experiments/cityscapes/seg_hrnet_w48_train_512x1024.yaml")
    ap.add_argument("--steps", default=3, type=int)
    ap.add_argument("--top", default=20, type=int)
    ap.add_argument("--seed", default=0, type=int)
    ap.add_argument("opts", nargs=argparse.REMAINDER,
                    help="yacs-style KEY VALUE config overrides")
    return ap.parse_args(argv)


def profile(name: str, call: Callable[[], object], steps: int, top: int,
            extra: dict) -> None:
    """Two warm-up calls, then ``steps`` calls under torch.profiler; prints
    the summary line and the top kernels and ops."""
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches = [k.launches for k in _KERNELS]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels, ops = collections.Counter(), collections.Counter()
    calls = collections.Counter()
    for e in prof.key_averages():
        us = _device_us(e)
        if not us:
            continue
        if str(getattr(e, "device_type", "")).endswith("CPU"):
            ops[e.key] += us
        else:
            kernels[e.key] += us
            calls[e.key] += e.count
    busy_ms = sum(kernels.values()) / 1e3 / steps
    print(json.dumps({
        "phase": name, "device": torch.cuda.get_device_name(),
        "calls": steps, "wall_ms_per_call": wall_ms,
        "device_busy_ms_per_call": busy_ms, "busy_share": busy_ms / wall_ms,
        "device_launches_per_call": sum(calls.values()) / steps,
        "abn_launches_per_call": {k.__name__: (k.launches - n) // steps
                                  for k, n in zip(_KERNELS, launches)},
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        **extra}), flush=True)
    for kind, table in (("kernel", kernels), ("op", ops)):
        for key, us in table.most_common(top):
            row = {"phase": name, "kind": kind, "name": key[:120],
                   "device_ms_per_call": us / 1e3 / steps,
                   "share_of_busy": us / 1e3 / steps / busy_ms}
            if kind == "kernel":
                row["launches_per_call"] = calls[key] / steps
            print(json.dumps(row), flush=True)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    config = update_config(get_default_config(), args)
    device = resolve_device(config.GPU.DEVICE)
    if device.type != "cuda":
        raise SystemExit("profile_seg measures the GPU; GPU.DEVICE is "
                         f"{config.GPU.DEVICE!r}")
    torch.manual_seed(args.seed)
    model = get_seg_model(config).to(device)
    optimizer = make_optimizer(model.parameters(), config.TRAIN)
    step = make_seg_train_step(model, optimizer,
                               ignore_label=config.TRAIN.IGNORE_LABEL)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    b = int(config.TRAIN.BATCH_SIZE_PER_GPU)
    h, w = config.TRAIN.IMAGE_SIZE[1], config.TRAIN.IMAGE_SIZE[0]
    images = torch.randn((b, h, w, 3), generator=gen,
                         device=device).permute(0, 3, 1, 2)
    labels = torch.randint(0, config.DATASET.NUM_CLASSES, (b, h, w),
                           generator=gen, device=device)
    profile("profile_seg_train", lambda: step(images, labels), args.steps,
            args.top, {"batch": b, "height": h, "width": w})

    infer = make_infer_fn(model)
    th, tw = config.TEST.IMAGE_SIZE[1], config.TEST.IMAGE_SIZE[0]
    image = torch.randn((1, th, tw, 3), generator=gen,
                        device=device).permute(0, 3, 1, 2)
    profile("profile_seg_test", lambda: infer(image), args.steps, args.top,
            {"batch": 1, "height": th, "width": tw})


if __name__ == "__main__":
    main()
