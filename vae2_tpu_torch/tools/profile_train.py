"""Profile the adversarial train step on the GPU and say where the time goes
(counterpart of ``profile_infer.py``, for ``VAE2System.train_step``).

Runs ``--steps`` train steps of the recipe (random weights from ``--seed``,
random uint8 clips, TRAIN.BATCH_SIZE_PER_GPU of them) under
``torch.profiler`` after two warm-up steps, and prints JSON lines: the wall
time per step, the device's busy time and share, the fused-ABN kernel
launches and incoming-gradient copies per step, all device kernel launches
per step, the peak memory, then the
top kernels and the top PyTorch ops by device time per step.

    python -m vae2_tpu_torch.tools.profile_train \
        [--cfg experiments/cityscapes/vae2_hrnet_w18_small_v2_128x256.yaml] \
        [--steps 2] [--top 25] [KEY VALUE ...]
"""

from __future__ import annotations

import argparse
import collections
import json
import time
from typing import Optional, Sequence

import torch

from ..config import get_default_config, update_config
from ..core.builder import build_system
from ..ops import abn
from ..utils.device import resolve_device
from .profile_infer import _device_us

_KERNELS = (abn.abn_rows, abn.abn_bwd_sums, abn.abn_bwd_dx)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--cfg",
        default="experiments/cityscapes/vae2_hrnet_w18_small_v2_128x256.yaml")
    ap.add_argument("--steps", default=2, type=int)
    ap.add_argument("--top", default=25, type=int)
    ap.add_argument("--seed", default=0, type=int)
    ap.add_argument("opts", nargs=argparse.REMAINDER,
                    help="yacs-style KEY VALUE config overrides")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    config = update_config(get_default_config(), args)
    device = resolve_device(config.GPU.DEVICE)
    if device.type != "cuda":
        raise SystemExit("profile_train measures the GPU; GPU.DEVICE is "
                         f"{config.GPU.DEVICE!r}")
    system = build_system(config, seed=args.seed, device=device, train=True)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    b = int(config.TRAIN.BATCH_SIZE_PER_GPU)
    h, w = config.TRAIN.IMAGE_SIZE[1], config.TRAIN.IMAGE_SIZE[0]
    clip_c = 3 * config.TRAIN.CLIP_LENGTH
    batch = {k: torch.randint(0, 256, (b, h, w, clip_c), generator=gen,
                              device=device, dtype=torch.uint8)
             for k in ("xt", "x2t", "x3t")}
    for _ in range(2):  # warm-up: cuDNN heuristics, allocator, kernel build
        system.train_step(batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches = [k.launches for k in _KERNELS]
    copies = abn.FusedABN.dz_copies

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            system.train_step(batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    events = prof.key_averages()
    kernels, ops = collections.Counter(), collections.Counter()
    calls = collections.Counter()
    for e in events:
        us = _device_us(e)
        if not us:
            continue
        if str(getattr(e, "device_type", "")).endswith("CPU"):
            ops[e.key] += us
        else:
            kernels[e.key] += us
            calls[e.key] += e.count
    busy_ms = sum(kernels.values()) / 1e3 / args.steps
    per_step = {k.__name__: (k.launches - n) // args.steps
                for k, n in zip(_KERNELS, launches)}
    print(json.dumps({
        "phase": "profile_train", "device": torch.cuda.get_device_name(device),
        "batch": b, "height": h, "width": w, "steps": args.steps,
        "remat": str(config.TPU.REMAT), "optimizer": config.TRAIN.OPTIMIZER,
        "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
        "busy_share": busy_ms / wall_ms,
        "device_launches_per_step": sum(calls.values()) / args.steps,
        "clips_per_s_profiled": b / wall_ms * 1e3,
        "abn_launches_per_step": per_step,
        "dz_copies_per_step": (abn.FusedABN.dz_copies - copies) / args.steps,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}))
    for kind, table in (("kernel", kernels), ("op", ops)):
        for name, us in table.most_common(args.top):
            row = {"kind": kind, "name": name[:120],
                   "device_ms_per_step": us / 1e3 / args.steps,
                   "share_of_busy": us / 1e3 / args.steps / busy_ms}
            if kind == "kernel":
                row["launches_per_step"] = calls[name] / args.steps
            print(json.dumps(row))


if __name__ == "__main__":
    main()
