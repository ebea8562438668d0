"""Profile the sampling hot path on the GPU and say where the time goes
(counterpart of tools/profile_infer.py).

Runs ``--steps`` chunks of the prior sampler, or of the momentum sampler
with ``--sampling-mode momentum_sampling`` (random weights from
``--seed``, random uint8 clips) under ``torch.profiler`` and prints JSON
lines: the wall time per chunk, the device's busy time and share, all
device kernel launches per chunk, then the top kernels and the top PyTorch
ops by device time per chunk. In momentum mode it first times the
posterior alone at batch 1 (``posterior_wall_ms``, unprofiled).

    python -m vae2_tpu_torch.tools.profile_infer \
        [--cfg experiments/cityscapes/inference_vae2_128x256.yaml] \
        [--sampling-mode momentum_sampling] [--steps 3] [--top 20] \
        [KEY VALUE ...]
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
from ..core.infer_loop import make_momentum_sampler, make_prior_sampler
from ..data.loader import normalize_clips
from ..utils.device import exact_f32, resolve_device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg",
                    default="experiments/cityscapes/inference_vae2_128x256.yaml")
    ap.add_argument("--steps", default=3, type=int)
    ap.add_argument("--top", default=20, type=int)
    ap.add_argument("--seed", default=0, type=int)
    ap.add_argument("--sampling-mode", default="prior_sampling",
                    choices=("prior_sampling", "momentum_sampling"))
    ap.add_argument("opts", nargs=argparse.REMAINDER,
                    help="yacs-style KEY VALUE config overrides")
    return ap.parse_args(argv)


def _device_us(evt) -> float:
    """Self device time of a profiler average, in microseconds."""
    return float(getattr(evt, "self_device_time_total", 0.0)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    config = update_config(get_default_config(), args)
    device = resolve_device(config.GPU.DEVICE)
    if device.type != "cuda":
        raise SystemExit("profile_infer measures the GPU; GPU.DEVICE is "
                         f"{config.GPU.DEVICE!r}")
    system = build_system(config, seed=args.seed)
    system.modules.to(device).eval()
    h, w = config.TRAIN.IMAGE_SIZE[1], config.TRAIN.IMAGE_SIZE[0]
    chunk = int(config.TPU.INFER_SAMPLE_BATCH)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    clip_c = 3 * config.TRAIN.CLIP_LENGTH
    momentum = args.sampling_mode == "momentum_sampling"
    clips = [torch.randint(0, 256, (1, h, w, clip_c), generator=gen,
                           device=device, dtype=torch.uint8)
             for _ in range(4 if momentum else 2)]
    if momentum:
        sampler = make_momentum_sampler(system, chunk)
    else:
        sampler = make_prior_sampler(system, chunk, h, w)
    for _ in range(2):  # warm-up: cuDNN heuristics, allocator, kernel build
        sampler(*clips, gen)
    torch.cuda.synchronize()
    extra = {}
    if momentum:
        last = [normalize_clips(c) for c in clips[2:]]
        with torch.inference_mode(), exact_f32():
            t0 = time.perf_counter()
            for _ in range(args.steps):
                system.momentum_posterior(*last)
            torch.cuda.synchronize()
        extra["posterior_wall_ms"] = ((time.perf_counter() - t0) * 1e3
                                      / args.steps)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            sampler(*clips, gen)
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
    print(json.dumps({
        "phase": "profile", "device": torch.cuda.get_device_name(device),
        "sampling_mode": args.sampling_mode, "chunk": chunk, "height": h, "width": w, "steps": args.steps,
        "wall_ms_per_chunk": wall_ms, "device_busy_ms_per_chunk": busy_ms,
        "busy_share": busy_ms / wall_ms,
        "device_launches_per_chunk": sum(calls.values()) / args.steps,
        "frames_per_s_profiled": chunk * 9 / wall_ms * 1e3, **extra}))
    for kind, table in (("kernel", kernels), ("op", ops)):
        for name, us in table.most_common(args.top):
            row = {"kind": kind, "name": name[:120],
                   "device_ms_per_chunk": us / 1e3 / args.steps,
                   "share_of_busy": us / 1e3 / args.steps / busy_ms}
            if kind == "kernel":
                row["launches_per_chunk"] = calls[name] / args.steps
            print(json.dumps(row))


if __name__ == "__main__":
    main()
