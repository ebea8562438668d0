"""Time the fused-ABN kernels as the main paths call them, and the two
end-to-end metrics, on one NVIDIA GPU, for the ``vae2_tpu_torch`` package of
any checkout — so that two versions can be compared on one machine at once.

    python3 vae2_tpu_torch/tools/bench_abn.py [--repo DIR] [--label NAME]

``--repo`` is the checkout whose ``vae2_tpu_torch`` is imported and timed
(default: the one holding this file); the recipes come from this file's
checkout. At bf16 and act none, on random inputs at every (N, C, H, W) that
the W18-small-v2 paths hand the kernels (read by forward pre-hooks on one
sampling call at chunk 64 and one train step at batch 8, 128x256):

- kernel 1 as inference calls it (``fused_abn_infer``: running statistics
  in, folded wherever that version folds them) and as training calls it
  (``FusedABN.apply`` forward, batch statistics in);
- kernel 2 (``abn_bwd_sums``) and kernel 3 (``abn_bwd_dx``).

Each call is timed: ``ms``, CUDA events around 30 calls issued back to
back from Python (host and device together; best of two turns);
``device_ms``, the device time of the kernel itself per call, and
``device_call_ms``, of every device kernel per call, both from
``torch.profiler`` over a turn of 30 calls after a warm-up turn; and
``device_launches_per_call``, the device kernels one call starts, counted
exactly from a CUDA graph of the call (``profiled_launches_per_call`` is
the profiler's count). Totals are weighted by the launches per sampling
call or per train step. Then the sampler's frames/s (chunk 64, 5 calls
after 2) and the train step's seconds (Adam 1e-4, 5 steps after 2, random
clips), and the host microseconds per call of each wrapper at a small
shape. Prints one JSON line per shape and one of totals. ``--sums-grid``
instead sweeps kernel 2's grid settings over the step's shapes. The
helpers ``time_ms``, ``device_profile`` and ``graph_launches`` also serve
``chip_smoke.py`` and the card tests.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
INFER_CFG = os.path.join(REPO, "experiments", "cityscapes",
                         "inference_vae2_128x256.yaml")
TRAIN_CFG = os.path.join(REPO, "experiments", "cityscapes",
                         "vae2_hrnet_w18_small_v2_128x256.yaml")
L2_BYTES = 50 * 2**20
ITERS = 30
# a substring of each kernel's device name (kernel 2 of earlier versions
# ran as abn_bwd_sums_partial + abn_bwd_sums_final)
KERNEL_NAMES = {"abn_rows": "abn_fwd_kernel", "abn_bwd_sums": "abn_bwd_sums",
                "abn_bwd_dx": "abn_bwd_dx"}


def time_ms(torch, fn, bufs, iters=ITERS):
    """Mean time of one call, CUDA events around ``iters`` calls that cycle
    through ``bufs`` (enough of them to exceed the L2 cache)."""
    for b in bufs[:2]:
        fn(b)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(bufs[i % len(bufs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", 0.0)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def device_profile(torch, fn, bufs, kernel, iters=ITERS):
    """Two turns of ``iters`` calls under ``torch.profiler``, the first a
    warm-up whose events are dropped: per call, the device time of the
    kernels whose name holds ``kernel`` (``device_ms``) and of every device
    kernel (``device_call_ms``), and the device kernels the profiler saw
    (``profiled_launches_per_call``). That count is not exact: in long
    processes the profiler has dropped or added one kernel of a profiled
    turn now and then, so the exact count is ``graph_launches``'s."""
    for b in bufs[:2]:
        fn(b)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        for _ in range(2):
            for i in range(iters):
                fn(bufs[i % len(bufs)])
            torch.cuda.synchronize()
            prof.step()
    own = total = 0.0
    launches = 0
    for e in prof.key_averages():
        us = _device_us(e)
        if (not us or str(getattr(e, "device_type", "")).endswith("CPU")
                or e.key.startswith("ProfilerStep")):
            continue  # host ops, and the step annotation's device span
        launches += e.count
        total += us
        own += us if kernel in e.key else 0.0
    return {"device_ms": own / 1e3 / iters,
            "device_call_ms": total / 1e3 / iters,
            "profiled_launches_per_call": launches / iters}


# CUgraphNodeType values of the nodes that run on the device
_DEVICE_NODES = {0: "kernel", 1: "memcpy", 2: "memset"}


def graph_launches(torch, fn, arg) -> int:
    """The device operations (kernels, copies, fills) that one call of
    ``fn(arg)`` enqueues, counted exactly: the call is captured into a CUDA
    graph, never replayed, on a side stream that ran it once before (so
    that a wrapper's per-stream state exists), and the graph's nodes are
    counted by type through libcuda."""
    import ctypes

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn(arg)
    stream.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="thread_local"):
        fn(arg)
    cuda = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(raw, None, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if count.value and cuda.cuGraphGetNodes(raw, nodes,
                                            ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    n = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                   ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        n += kind.value in _DEVICE_NODES
    del graph
    return n


def timed_call(torch, fn, bufs, kernel):
    """``ms`` (best of two turns), ``device_profile``'s numbers and the
    device launches per call (``graph_launches``)."""
    ms = min(time_ms(torch, fn, bufs) for _ in range(2))
    return {"ms": ms, **device_profile(torch, fn, bufs, kernel),
            "device_launches_per_call": graph_launches(torch, fn, bufs[0])}


def n_bufs(numel, size, tensors=1):
    """Buffers to cycle through so that one turn exceeds the L2 cache."""
    return max(1, min(8, math.ceil(2 * L2_BYTES / (tensors * numel * size))))


def path_shapes(torch, device):
    """(infer, train): (N, C, H, W) -> launches per sampling call, and
    (N, C, H, W) -> [forward launches, of which recomputes] per train step,
    of the fused-ABN kernels, read by forward pre-hooks on the BNs that
    they serve (act other than relu)."""
    from vae2_tpu_torch.config import get_default_config, update_config
    from vae2_tpu_torch.core.builder import build_system
    from vae2_tpu_torch.core.infer_loop import make_prior_sampler
    from vae2_tpu_torch.ops import norm

    def hooked(nets, run):
        seen = {}

        def hook(module, args):
            row = seen.setdefault(tuple(args[0].shape), [0, 0])
            row[0] += 1
            row[1] += int(getattr(norm._frozen, "on", False))

        handles = [m.register_forward_pre_hook(hook) for net in nets
                   for m in net.modules()
                   if isinstance(m, norm.BatchNormAct) and m.act != "relu"]
        try:
            run()
            torch.cuda.synchronize()
        finally:
            for h in handles:
                h.remove()
        return seen

    gen = torch.Generator(device=device).manual_seed(0)
    cfg = update_config(get_default_config(),
                        argparse.Namespace(cfg=INFER_CFG, opts=[]))
    system = build_system(cfg, seed=0)
    system.modules.to(device).eval()
    h, w = cfg.TRAIN.IMAGE_SIZE[1], cfg.TRAIN.IMAGE_SIZE[0]
    sampler = make_prior_sampler(system, int(cfg.TPU.INFER_SAMPLE_BATCH), h, w)
    clip = torch.randint(0, 256, (1, h, w, 9), generator=gen, device=device,
                         dtype=torch.uint8)
    with torch.inference_mode():
        infer = hooked([system.modules["encdec"]],
                       lambda: sampler(clip, clip, gen))
    del system, sampler

    cfg = update_config(get_default_config(), argparse.Namespace(
        cfg=TRAIN_CFG, opts=["TRAIN.OPTIMIZER", "adam", "TRAIN.LR", "0.0001"]))
    system = build_system(cfg, seed=0, device=device, train=True)
    b = int(cfg.TRAIN.BATCH_SIZE_PER_GPU)
    batch = {k: torch.randint(0, 256, (b, h, w, 9), generator=gen,
                              device=device, dtype=torch.uint8)
             for k in ("xt", "x2t", "x3t")}
    train = hooked(list(system.modules.values()),
                   lambda: system.train_step(batch, gen))
    del system
    torch.cuda.empty_cache()
    return {k: v[0] for k, v in infer.items()}, train


def _stats(torch, c, g, device):
    return (torch.randn(c, generator=g, device=device) * 0.2,
            torch.rand(c, generator=g, device=device) + 0.5,
            torch.rand(c, generator=g, device=device) + 0.5,
            torch.randn(c, generator=g, device=device) * 0.2)


def bench_kernels(torch, infer, train, device):
    """Per-shape rows and launch-weighted totals (see the module doc)."""
    from vae2_tpu_torch.ops import abn

    g = torch.Generator(device=device).manual_seed(1)
    bf16 = torch.bfloat16
    rows, totals = [], collections.defaultdict(collections.Counter)

    def add(name, path, shape, launches, t):
        rows.append({"kernel": name, "path": path, "shape": list(shape),
                     "launches": launches, **t})
        tot = totals[f"{name}/{path}"]
        for k in ("ms", "device_ms", "device_call_ms"):
            tot[k] += launches * t[k]
        tot["launches"] += launches
        tot["device_launches"] += launches * t["device_launches_per_call"]

    def rows_of(n, c, h, w, tensors):
        k = n_bufs(n * c * h * w, 2, tensors)
        return [torch.randn((n, h, w, c), generator=g, device=device).to(bf16)
                .permute(0, 3, 1, 2) for _ in range(k)]

    with torch.no_grad():
        for (n, c, h, w), count in sorted(infer.items()):
            mean, var, gam, bet = _stats(torch, c, g, device)
            add("abn_rows", "infer", (n, c, h, w), count, timed_call(
                torch, lambda x: abn.fused_abn_infer(
                    x, mean, var, gam, bet, 1e-5, 1.0, "none"),
                rows_of(n, c, h, w, 1), KERNEL_NAMES["abn_rows"]))
        for (n, c, h, w), (fwd, rec) in sorted(train.items()):
            mean, var, gam, bet = _stats(torch, c, g, device)
            add("abn_rows", "train", (n, c, h, w), fwd, timed_call(
                torch, lambda x: abn.FusedABN.apply(
                    x, gam, bet, mean, var, 1e-5, 1.0, "none"),
                rows_of(n, c, h, w, 1), KERNEL_NAMES["abn_rows"]))
            if fwd == rec:
                continue  # recompute-only shapes take no backward
            ys = rows_of(n, c, h, w, 2)
            pairs = list(zip(ys, rows_of(n, c, h, w, 2)))
            mul = gam * torch.rsqrt(var + 1e-5)
            sums = abn.abn_bwd_sums(*pairs[0], gam, bet, 1.0, "none")
            add("abn_bwd_sums", "train", (n, c, h, w), fwd - rec, timed_call(
                torch, lambda p: abn.abn_bwd_sums(*p, gam, bet, 1.0, "none"),
                pairs, KERNEL_NAMES["abn_bwd_sums"]))
            add("abn_bwd_dx", "train", (n, c, h, w), fwd - rec, timed_call(
                torch, lambda p: abn.abn_bwd_dx(*p, gam, bet, mul, sums, 1.0,
                                                "none", n * h * w),
                pairs, KERNEL_NAMES["abn_bwd_dx"]))
            del ys, pairs
    return rows, {k: dict(v) for k, v in totals.items()}


def end_to_end(torch, device, reps=5):
    """The sampler's ms per call and frames/s (chunk 64, 128x256, bf16) and
    the train step's seconds (batch 8, Adam 1e-4), each after 2 warm-up
    calls, timed to a synchronisation."""
    from vae2_tpu_torch.config import get_default_config, update_config
    from vae2_tpu_torch.core.builder import build_system
    from vae2_tpu_torch.core.infer_loop import make_prior_sampler

    gen = torch.Generator(device=device).manual_seed(2)
    cfg = update_config(get_default_config(),
                        argparse.Namespace(cfg=INFER_CFG, opts=[]))
    system = build_system(cfg, seed=0)
    system.modules.to(device).eval()
    h, w = cfg.TRAIN.IMAGE_SIZE[1], cfg.TRAIN.IMAGE_SIZE[0]
    chunk = int(cfg.TPU.INFER_SAMPLE_BATCH)
    sampler = make_prior_sampler(system, chunk, h, w)
    clip = torch.randint(0, 256, (1, h, w, 9), generator=gen, device=device,
                         dtype=torch.uint8)

    def timed(fn):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps

    with torch.inference_mode():
        sampler_s = timed(lambda: sampler(clip, clip, gen))
    del system, sampler
    cfg = update_config(get_default_config(), argparse.Namespace(
        cfg=TRAIN_CFG, opts=["TRAIN.OPTIMIZER", "adam", "TRAIN.LR", "0.0001"]))
    system = build_system(cfg, seed=0, device=device, train=True)
    b = int(cfg.TRAIN.BATCH_SIZE_PER_GPU)
    batch = {k: torch.randint(0, 256, (b, h, w, 9), generator=gen,
                              device=device, dtype=torch.uint8)
             for k in ("xt", "x2t", "x3t")}
    step_s = timed(lambda: system.train_step(batch, gen))
    del system
    torch.cuda.empty_cache()
    return {"sampler_ms": sampler_s * 1e3,
            "frames_per_s": chunk * 9 / sampler_s,
            "train_s_per_step": step_s, "train_clips_per_s": b / step_s}


def host_costs(torch, device, shape=(8, 36, 16, 32), reps=2000):
    """Host microseconds per call of each wrapper at a small bf16 shape,
    where the device takes a few microseconds and the host sets the pace
    (``reps`` calls on the host clock, then one synchronisation), beside
    the allocations every call makes."""
    from vae2_tpu_torch.ops import abn

    n, c, h, w = shape
    g = torch.Generator(device=device).manual_seed(3)
    x, dz = (torch.randn((n, h, w, c), generator=g, device=device)
             .to(torch.bfloat16).permute(0, 3, 1, 2) for _ in range(2))
    mean, var, gam, bet = _stats(torch, c, g, device)
    mul = gam * torch.rsqrt(var + 1e-5)
    sums = abn.abn_bwd_sums(x, dz, gam, bet, 1.0, "none")

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / reps * 1e6

    with torch.no_grad():
        return {"shape": list(shape), "us": {
            "fused_abn_infer": per_call(lambda: abn.fused_abn_infer(
                x, mean, var, gam, bet, 1e-5, 1.0, "none")),
            "FusedABN.forward": per_call(lambda: abn.FusedABN.apply(
                x, gam, bet, mean, var, 1e-5, 1.0, "none")),
            "abn_bwd_sums": per_call(lambda: abn.abn_bwd_sums(
                x, dz, gam, bet, 1.0, "none")),
            "abn_bwd_dx": per_call(lambda: abn.abn_bwd_dx(
                x, dz, gam, bet, mul, sums, 1.0, "none",
                x.numel() // x.shape[1])),
            "torch.empty_like(x)": per_call(lambda: torch.empty_like(x)),
            "torch.empty((2, C))": per_call(lambda: torch.empty(
                (2, c), dtype=torch.float32, device=device))}}


def sums_grid(torch, train, device):
    """Kernel 2's device time per train step (bf16, act none) for each
    (blocks per SM, minimum vectors per thread) of its grid: more blocks
    stream y and dz with more parallelism, and each adds a row of 2C
    partial sums that the last block reads back alone."""
    from vae2_tpu_torch.ops import abn

    g = torch.Generator(device=device).manual_seed(4)
    grid = [(p, m) for p in (2, 4, 8) for m in (1, 2, 4, 8, 16)]
    totals = collections.Counter()
    saved = abn.SUMS_BLOCKS_PER_SM, abn.SUMS_MIN_ITERS
    rows = []
    try:
        for (n, c, h, w), (fwd, rec) in sorted(train.items()):
            if fwd == rec:
                continue
            y, dz = (torch.randn((n, h, w, c), generator=g, device=device)
                     .to(torch.bfloat16).permute(0, 3, 1, 2) for _ in range(2))
            mean, var, gam, bet = _stats(torch, c, g, device)
            row = {"shape": [n, c, h, w], "launches": fwd - rec}
            for p, m in grid:
                abn.SUMS_BLOCKS_PER_SM, abn.SUMS_MIN_ITERS = p, m
                ms = device_profile(
                    torch, lambda _: abn.abn_bwd_sums(y, dz, gam, bet, 1.0,
                                                      "none"),
                    [None], KERNEL_NAMES["abn_bwd_sums"])["device_ms"]
                row[f"{p}/{m}"] = ms
                totals[f"{p}/{m}"] += (fwd - rec) * ms
            rows.append(row)
            del y, dz
    finally:
        abn.SUMS_BLOCKS_PER_SM, abn.SUMS_MIN_ITERS = saved
    return rows, dict(totals)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=REPO,
                    help="checkout whose vae2_tpu_torch is timed")
    ap.add_argument("--label", default="")
    ap.add_argument("--sums-grid", action="store_true",
                    help="only sweep kernel 2's grid settings (blocks per "
                         "SM / minimum vectors per thread) over the step")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_abn: torch.cuda.is_available() is False; this script "
              "times the GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.repo))
    import vae2_tpu_torch

    device = torch.device("cuda", 0)
    infer, train = path_shapes(torch, device)
    if args.sums_grid:
        rows, totals = sums_grid(torch, train, device)
        for row in rows:
            print(json.dumps({"phase": "sums_grid_shape", **row}), flush=True)
        print(json.dumps({"phase": "sums_grid", "device_ms_per_step": totals,
                          "best": min(totals, key=totals.get)}), flush=True)
        return 0
    rows, totals = bench_kernels(torch, infer, train, device)
    for row in rows:
        print(json.dumps({"phase": "bench_abn_shape", "label": args.label,
                          **row}), flush=True)
    print(json.dumps({
        "phase": "bench_abn", "label": args.label,
        "package": os.path.dirname(vae2_tpu_torch.__file__),
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(),
        "launches_per_sampling_call": sum(infer.values()),
        "launches_per_step": {"forward": sum(v[0] for v in train.values()),
                              "backward": sum(v[0] - v[1]
                                              for v in train.values())},
        "totals": totals, "host": host_costs(torch, device),
        **end_to_end(torch, device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
