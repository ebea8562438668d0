#!/usr/bin/env python3
"""Drive vae2_tpu_torch's main path on one NVIDIA GPU and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py

The main path is prior-sampling inference
(``python -m vae2_tpu_torch.tools.inference``) at the full W18-small-v2
width: 4 branches of 18/36/72/144 channels, HD_Z, Z_DIM 32, 128x256 frames,
64 samples per chunk, encoder and both decoders, on data/synthetic64, with
random weights from a seed. Phases, one JSON line each:

1. device — the card, its power limit, the device count;
2. build — nvcc of every kernel source, with what ``-Xptxas -v`` reports;
3. kernel_check — every (N, C, H, W) that one sampling call hands the
   fused-ABN kernel, in bf16 and f32 with act none/leaky_relu/elu, against
   the plain version; then the kernel's, the plain version's and one
   PyTorch call's time at the path's dtype and act, beside the bytes bound;
4. reference — the tiny debug spec in f32 on the card against the CPU path
   (the path that the CPU tests hold against the JAX package);
5. end_to_end — the inference CLI in this process, the launch count per
   sampling call, the metric tree, throughput and peak memory, and one
   chunk again with the BN path through the plain version.

Then the ``kernels`` line, the nvidia-smi line and the ok line. Without a
CUDA device, or without the repository beside it, it exits non-zero and
prints no result.
"""

import argparse
import collections
import glob
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import unittest.mock

REPO = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(REPO, "experiments", "cityscapes",
                   "inference_vae2_128x256.yaml")
TINY_CFG = os.path.join(REPO, "experiments", "cityscapes",
                        "debug_tiny_32x64.yaml")
DATA = os.path.join(REPO, "data", "synthetic64")
NUM_VIDEOS = 2
NUM_SAMPLES = 64
DATA_OPTS = ["DATASET.ROOT", DATA,
             "DATASET.TEST_SET", os.path.join(DATA, "test_list.txt"),
             "TEST.NUM_SAMPLES", str(NUM_VIDEOS)]
EXPECTED_ABN_PER_SAMPLE = 255  # W18-small-v2: 45 + 40 + 2 * 85 BNs, act None
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
L2_BYTES = 50 * 2**20
ACTS = ("none", "leaky_relu", "elu")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def tolerance(torch, dtype):
    """f32: 1e-6 (elu's expf may differ from torch.exp in the last bit);
    bf16: one bf16 ulp, for the same reason. The multiply and the add round
    alike in kernel and plain version."""
    if dtype == torch.float32:
        return dict(rtol=1e-6, atol=1e-6)
    return dict(rtol=2.0**-7, atol=1e-6)


def randomize(modules, torch, seed, conv_scale=False):
    """Seeded non-trivial BN statistics and affine parameters (so no BN is
    an identity); with ``conv_scale``, conv kernels normal(1/sqrt(fan_in))
    so that signal propagates through a small model."""
    from vae2_tpu_torch.ops.norm import BatchNormAct

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in modules.modules():
            if isinstance(m, BatchNormAct):
                c = m.weight.shape[0]
                m.weight.copy_(torch.rand(c, generator=g) + 0.5)
                m.bias.copy_(torch.randn(c, generator=g) * 0.2)
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.2)
                m.running_var.copy_(torch.rand(c, generator=g) + 0.5)
            elif conv_scale and isinstance(m, torch.nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               / m.weight[0].numel() ** 0.5)


def abn_modules(net):
    """The BNs that go through the fused-ABN kernel (act other than relu)."""
    from vae2_tpu_torch.ops.norm import BatchNormAct

    return [m for m in net.modules()
            if isinstance(m, BatchNormAct) and m.act != "relu"]


def first_clip(config, device, torch):
    from vae2_tpu_torch.data.video import make_dataset

    ds = make_dataset(config, config.DATASET.TEST_SET, random_pos=False,
                      num_samples=1)
    clips = torch.from_numpy(ds[0][0]).to(device)[None]
    return clips[..., 0:9].contiguous(), clips[..., 9:18].contiguous()


def time_ms(torch, fn, bufs, iters=30):
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


def kernel_check(torch, shapes, device):
    """Kernel against plain at every path shape, dtype and act; then times
    at the path's own dtype and act ('none')."""
    from vae2_tpu_torch.ops import abn

    max_err, cases = 0.0, 0
    g = torch.Generator(device=device).manual_seed(0)
    for (n, c, h, w), _ in sorted(shapes.items()):
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn((n, h, w, c), generator=g, device=device) * 2
                 ).to(dtype).permute(0, 3, 1, 2)
            stats = [torch.randn(c, generator=g, device=device),
                     torch.rand(c, generator=g, device=device) + 0.1,
                     torch.rand(c, generator=g, device=device) + 0.5,
                     torch.randn(c, generator=g, device=device)]
            for act in ACTS:
                got = abn.fused_abn_infer(x, *stats, 1e-5, 0.01, act)
                want = abn.fused_abn_infer_plain(x, *stats, 1e-5, 0.01, act)
                torch.testing.assert_close(got, want, **tolerance(torch, dtype))
                max_err = max(max_err, float((got.float() - want.float())
                                             .abs().max()))
                cases += 1
            del x, got, want
    torch.cuda.synchronize()

    rows, totals = [], collections.Counter()
    for (n, c, h, w), (dtype, count) in sorted(shapes.items()):
        numel = n * c * h * w
        size = torch.finfo(dtype).bits // 8
        n_buf = max(1, min(8, math.ceil(2 * L2_BYTES / (numel * size))))
        bufs = [torch.randn((n, h, w, c), device=device).to(dtype)
                .permute(0, 3, 1, 2) for _ in range(n_buf)]
        mul = (torch.rand(c, device=device) + 0.5).to(dtype)
        add = torch.randn(c, device=device).to(dtype)
        mul4, add4 = mul.view(1, -1, 1, 1), add.view(1, -1, 1, 1)
        fns = {
            "ms": lambda x: abn._abn_rows_cuda(x, mul, add, 1.0, "none"),
            "plain_ms": lambda x: abn._abn_rows_plain(x, mul, add, 1.0, "none"),
            "library_ms": lambda x: torch.addcmul(add4, x, mul4),
        }
        t = {k: math.inf for k in fns}
        for order in (list(fns), list(fns)[::-1]):  # in turns, best of two
            for k in order:
                t[k] = min(t[k], time_ms(torch, fns[k], bufs))
        bytes_moved = 2 * numel * size + 2 * c * size
        bound_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        bound_ops = 2 * numel / F32_FLOPS_PER_S * 1e3
        row = {"shape": [n, c, h, w], "dtype": str(dtype).split(".")[-1],
               "launches_per_sample": count, **t,
               "bound_ms": max(bound_bytes, bound_ops),
               "bound_by": "bytes" if bound_bytes >= bound_ops else "operations"}
        rows.append(row)
        for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
            totals[k] += count * row[k]
        del bufs
    return {"cases": cases, "max_abs_err": max_err, "shapes": rows,
            "per_sample": dict(totals)}


def collect_shapes(torch, net, sampler, xt, x2t, device):
    """(N, C, H, W) -> (dtype, launches) of the kernel in one sampling
    call, read by forward hooks on the BNs that it serves."""
    seen = collections.Counter()
    dtypes = {}

    def hook(module, args):
        key = tuple(args[0].shape)
        seen[key] += 1
        dtypes[key] = args[0].dtype

    handles = [m.register_forward_pre_hook(hook) for m in abn_modules(net)]
    try:
        sampler(xt, x2t, torch.Generator(device=device).manual_seed(0))
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return {k: (dtypes[k], seen[k]) for k in seen}


def reference_check(torch, device):
    """Tiny debug spec, f32, TF32 off: card against CPU."""
    from vae2_tpu_torch.config import get_default_config
    from vae2_tpu_torch.core.builder import build_system
    from vae2_tpu_torch.utils.device import exact_f32

    cfg = get_default_config()
    cfg.merge_from_file(TINY_CFG)
    cfg.GPU.DTYPE = "float32"
    system = build_system(cfg, seed=0)
    randomize(system.modules, torch, seed=1, conv_scale=True)
    net = system.modules["encdec"].eval()
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 9, 32, 64, generator=g)
    z = [torch.randn(4, 4, 32 // 2**b, 64 // 2**b, generator=g)
         for b in range(4)]
    rand = torch.randn(4, 4, generator=g)
    with torch.inference_mode(), exact_f32():
        want = net.sample(x, z, rand_code=rand)
        net.to(device)
        got = net.sample(x.to(device), [t.to(device) for t in z],
                         rand_code=rand.to(device))
        torch.cuda.synchronize()
    err = 0.0
    for g_, w_ in zip(got, want):
        tol = 1e-4 * (1.0 + float(w_.abs().max()))
        torch.testing.assert_close(g_.cpu(), w_, rtol=1e-4, atol=tol)
        err = max(err, float((g_.cpu() - w_).abs().max()))
    return {"max_abs_err": err, "rtol": 1e-4,
            "atol": "1e-4 * (1 + max|cpu|)"}


def end_to_end(torch, system, config, sampler, xt, x2t, device, workdir):
    """The inference CLI in this process, counted; the sampler's
    throughput; one chunk through the plain BN path."""
    from vae2_tpu_torch.ops import abn
    from vae2_tpu_torch.tools import inference
    from vae2_tpu_torch.utils.checkpoint import save_checkpoint

    ckpt = os.path.join(workdir, "checkpoint.pt")
    save_checkpoint(ckpt, system.modules.state_dict(), epoch=0)
    argv = ["--cfg", CFG, "--checkpoint", ckpt,
            "--num-samples", str(NUM_SAMPLES), "--no-images",
            "--device", device.type, "--seed", "0",
            "OUTPUT_DIR", os.path.join(workdir, "out"),
            "LOG_DIR", os.path.join(workdir, "log"), *DATA_OPTS]
    chunk = int(config.TPU.INFER_SAMPLE_BATCH)
    h, w = config.TRAIN.IMAGE_SIZE[1], config.TRAIN.IMAGE_SIZE[0]
    # the loop evaluates the last clip of each batch (function.py:222+)
    clips = math.ceil(NUM_VIDEOS / int(config.TEST.BATCH_SIZE_PER_GPU))
    calls = clips * math.ceil(NUM_SAMPLES / chunk)
    per_sample = len(abn_modules(system.modules["encdec"]))

    # --- the main path, counted -------------------------------------------
    torch.cuda.synchronize()
    abn.fused_abn_infer.launches = 0
    t0 = time.perf_counter()
    out_dir = inference.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = abn.fused_abn_infer.launches

    if per_sample != EXPECTED_ABN_PER_SAMPLE:
        raise AssertionError(f"{per_sample} kernel BNs in the model, "
                             f"expected {EXPECTED_ABN_PER_SAMPLE}")
    if launches != calls * per_sample:
        raise AssertionError(f"{launches} kernel launches for {calls} "
                             f"sampling calls, expected {calls * per_sample}")
    txts = glob.glob(os.path.join(out_dir, "vis", "epoch0", "*",
                                  "x?tpredict", "*.txt"))
    if len(txts) != clips * 2 * 3 * 4:  # x2t/x3t, frames, metrics
        raise AssertionError(f"{len(txts)} metric files")
    for path in txts:
        vals = [float(v) for v in open(path)]
        if len(vals) != NUM_SAMPLES or not all(map(math.isfinite, vals)):
            raise AssertionError(f"{path}: {len(vals)} lines or non-finite")

    # --- the sampler alone: throughput and peak memory ----------------------
    sampler(xt, x2t, torch.Generator(device=device).manual_seed(1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 3
    t0 = time.perf_counter()
    for i in range(reps):
        outs = sampler(xt, x2t, torch.Generator(device=device).manual_seed(i))
    torch.cuda.synchronize()
    sampler_s = (time.perf_counter() - t0) / reps
    peak = torch.cuda.max_memory_allocated()
    for o in outs:
        if o.shape != (chunk, 9, h, w) or not bool(torch.isfinite(o).all()):
            raise AssertionError(f"sampler output {tuple(o.shape)} not finite")

    # --- one chunk through the plain BN path, same weights and noise -------
    kernel_out = sampler(xt, x2t, torch.Generator(device=device).manual_seed(7))
    before = abn.fused_abn_infer.launches
    with unittest.mock.patch.object(abn, "fused_abn_infer",
                                    abn.fused_abn_infer_plain):
        plain_out = sampler(xt, x2t,
                            torch.Generator(device=device).manual_seed(7))
    torch.cuda.synchronize()
    if abn.fused_abn_infer.launches != before:
        raise AssertionError("the plain run launched the kernel")
    err, tol = 0.0, 0.0
    for k, p in zip(kernel_out, plain_out):
        # four bf16 ulps of the output scale: the two paths may round a
        # few BN outputs apart, and the convolutions carry that on
        t = 2.0**-6 * (1.0 + float(p.float().abs().max()))
        e = float((k.float() - p.float()).abs().max())
        if not e <= t:
            raise AssertionError(f"kernel vs plain path: {e} > {t}")
        err, tol = max(err, e), max(tol, t)
    frames = chunk * 9  # x1p, x2p, x3p: 3 clips of 3 frames per sample
    return {"phase": "end_to_end", "cli_seconds": cli_s,
            "sampling_calls": calls, "launches": launches,
            "launches_per_sample": per_sample,
            "cli_frames_per_s": calls * frames / cli_s,
            "sampler_ms": sampler_s * 1e3,
            "frames_per_s": frames / sampler_s,
            "peak_memory_gib": peak / 2**30,
            "plain_path_max_abs_err": err, "plain_path_tol": tol}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from vae2_tpu_torch.config import get_default_config, update_config
    from vae2_tpu_torch.core.builder import build_system
    from vae2_tpu_torch.core.infer_loop import make_prior_sampler
    from vae2_tpu_torch.ops import abn
    from vae2_tpu_torch.utils import cuda_build

    device = torch.device("cuda", 0)
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({"phase": "device", "nvidia_smi": smi, "name": name, "count": count,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    cuda_build.build("abn")
    abn._kernel()
    ptxas = [line.strip() for line in cuda_build.build_log("abn").splitlines()
             if "ptxas info" in line or "spill" in line]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "source": "vae2_tpu_torch/csrc/abn.cu", "ptxas": ptxas})

    config = update_config(get_default_config(),
                           argparse.Namespace(cfg=CFG, opts=DATA_OPTS))
    system = build_system(config, seed=0)
    randomize(system.modules, torch, seed=1)
    system.modules.to(device).eval()
    h, w = config.TRAIN.IMAGE_SIZE[1], config.TRAIN.IMAGE_SIZE[0]
    chunk = int(config.TPU.INFER_SAMPLE_BATCH)
    sampler = make_prior_sampler(system, chunk, h, w)
    xt, x2t = first_clip(config, device, torch)
    shapes = collect_shapes(torch, system.modules["encdec"], sampler, xt,
                            x2t, device)
    check = kernel_check(torch, shapes, device)
    emit({"phase": "kernel_check", "cases": check["cases"],
          "max_abs_err": check["max_abs_err"],
          "launches_per_sample": sum(c for _, c in shapes.values()),
          "per_sample": check["per_sample"], "nvidia_smi": smi})
    for row in check["shapes"]:
        emit({"phase": "kernel_shape", **row})

    emit({"phase": "reference", **reference_check(torch, device)})

    workdir = tempfile.mkdtemp(prefix="vae2_chip_smoke_")
    try:
        e2e = end_to_end(torch, system, config, sampler, xt, x2t, device,
                         workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    emit({**e2e, "nvidia_smi": smi})

    per = check["per_sample"]
    emit({"kernels": [{
        "name": "fused_abn_fwd", "route": "cuda",
        "source": "vae2_tpu_torch/csrc/abn.cu",
        "replaces": "vae2_tpu/ops/pallas/abn.py:100",
        "launches": e2e["launches"],
        "launches_per_sample": e2e["launches_per_sample"],
        "max_abs_err": check["max_abs_err"],
        "ms": per["ms"], "kernel_ms": per["ms"], "plain_ms": per["plain_ms"],
        "bound_ms": per["bound_ms"],
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                   for r in check["shapes"]) else "operations"),
        "library_ms": per["library_ms"],
        "timed_as": "one sampling call's launches, bf16, act none",
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
