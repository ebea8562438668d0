#!/usr/bin/env python3
"""Drive vae2_tpu_torch's main paths on one NVIDIA GPU and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py

Two paths, each at the full W18-small-v2 width (4 branches of
18/36/72/144 channels, HD_Z, Z_DIM 32, 128x256 frames, random weights from a
seed, data/synthetic64):

- prior-sampling inference (``python -m vae2_tpu_torch.tools.inference``),
  64 samples per chunk, encoder and both decoders;
- adversarial training (``python -m vae2_tpu_torch.tools.train``) of the
  four networks, batch 8, bf16, TPU.REMAT 'stage', a G then a D update.

Phases, one JSON line each:

1. device — the card, its power limit, the device count;
2. build — nvcc of every kernel source, all at once, with what
   ``-Xptxas -v`` reports;
3. kernel_check — every (N, C, H, W) that one sampling call hands the
   fused-ABN forward kernel (kernel 1, which folds the BN statistics
   itself), in bf16 and f32 with act none/leaky_relu/elu, against the plain
   version; then times at the path's dtype and act: ``ms`` (CUDA events
   around 30 calls issued back to back, host included), ``device_ms`` (the
   kernel's own device time, torch.profiler), ``device_launches_per_call``
   (every device kernel the call starts, counted exactly from a CUDA graph
   of one call; must be 1; ``profiled_launches_per_call`` is the
   profiler's count), the bytes bound, the plain version,
   ``torch.nn.functional.batch_norm`` and ``addcmul``;
4. reference — the tiny debug spec in f32 on the card against the CPU path
   (the path that the CPU tests hold against the JAX package);
5. end_to_end — the inference CLI in this process, counted, its metric
   tree, throughput and peak memory, and one chunk through the plain path;
6. train_kernel_check — every (N, C, H, W) that one flagship train step
   hands the kernels, read by hooks, in bf16 and f32 with every act: kernel
   1's training entry (y and gamma * inv) and the backward kernels (sums,
   dx) against their plain versions; then all three timed at the step's
   shapes, dtype and act as in phase 3, beside the ATen calls;
7. train_reference — one G/D step of the tiny spec in f32 (TF32 off) on the
   card against the CPU path;
8. train_end_to_end — the train CLI in this process for one epoch (6 steps
   of 8 clips), counted per step, then TRAIN.RESUME for a second epoch;
9. train_plain_path — one flagship step with every ABN kernel swapped for
   its plain version, against the same step through the kernels.

Then the ``kernels`` line, the nvidia-smi line and the ok line. Without a
CUDA device, or without the repository beside it, it exits non-zero and
prints no result.
"""

import argparse
import collections
import concurrent.futures
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
TRAIN_CFG = os.path.join(REPO, "experiments", "cityscapes",
                         "vae2_hrnet_w18_small_v2_128x256.yaml")
DATA = os.path.join(REPO, "data", "synthetic64")
NUM_VIDEOS = 2
NUM_SAMPLES = 64
DATA_OPTS = ["DATASET.ROOT", DATA,
             "DATASET.TEST_SET", os.path.join(DATA, "test_list.txt"),
             "TEST.NUM_SAMPLES", str(NUM_VIDEOS)]
EXPECTED_ABN_PER_SAMPLE = 255  # W18-small-v2: 45 + 40 + 2 * 85 BNs, act None
# one flagship train step (the G step runs encz, encdec's 3 trunks, d_seq
# and d_frame; the D step d_seq and d_frame on real and on fake), 85 BNs of
# act None per trunk, 82 of them inside HRModules (recomputed under 'stage')
EXPECTED_BWD_PER_STEP = 6 * 85 + 4 * 85  # kernels 2 and 3: 850
EXPECTED_FWD_PER_STEP = EXPECTED_BWD_PER_STEP + (6 + 4) * 82  # kernel 1: 1670
STEPS_PER_EPOCH = 6  # 48 videos of data/synthetic64 in batches of 8
# the tiny step's KL sums exp(lv) - lv - 1 over 2 x 10,880 latent elements,
# which cancels near lv = 0: ~one ulp of 1 per term, up to ~7e-4 in the sum
KL_ATOL = 1e-3
# The recipe's SGD lr 1e-2 from this random init diverges at its second
# step (NaN), in the JAX package as in the port; the repo's stable setting
# for the same model (experiments/cityscapes/northstar_flagship_128x256.yaml)
# is Adam lr 1e-4, which the end-to-end epochs use.
TRAIN_OPTS = ["DATASET.ROOT", DATA,
              "DATASET.TRAIN_SET", os.path.join(DATA, "train_list.txt"),
              "TRAIN.OPTIMIZER", "adam", "TRAIN.LR", "0.0001",
              "PRINT_FREQ", "1"]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
ACTS = ("none", "leaky_relu", "elu")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


KERNELS = ("abn_rows", "abn_bwd_sums", "abn_bwd_dx")  # the launch counters
# what the training op calls, each with a plain version "<name>_plain"
PATH_FNS = ("abn_fwd_train", "abn_bwd_sums", "abn_bwd_dx")


def reset_counts() -> None:
    from vae2_tpu_torch.ops import abn

    for k in KERNELS:
        getattr(abn, k).launches = 0


def read_counts() -> dict:
    from vae2_tpu_torch.ops import abn

    return {k: getattr(abn, k).launches for k in KERNELS}


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


def exact_or_close(torch, got, want, act, exact):
    """assert_close at ``tolerance``; returns whether act none/leaky_relu
    (which round alike in kernel and plain version) matched bit for bit."""
    torch.testing.assert_close(got, want, **tolerance(torch, got.dtype))
    return exact and (act == "elu" or torch.equal(got, want))


def bn_stats(torch, c, g, device):
    """Seeded f32 (mean, var, gamma, beta) of C channels on the card."""
    return (torch.randn(c, generator=g, device=device),
            torch.rand(c, generator=g, device=device) + 0.1,
            torch.rand(c, generator=g, device=device) + 0.5,
            torch.randn(c, generator=g, device=device))


def timed_kernel(torch, fns, bufs, kernel):
    """``_timed`` of the kernel and its yardsticks, then the kernel's own
    device time (``device_profile``) and the device launches of one call,
    counted exactly (``graph_launches``) and as the profiler saw them."""
    from vae2_tpu_torch.tools.bench_abn import device_profile, graph_launches

    return {**_timed(torch, fns, bufs),
            **device_profile(torch, fns["ms"], bufs, kernel),
            "device_launches_per_call": graph_launches(torch, fns["ms"],
                                                       bufs[0])}


def kernel_check(torch, shapes, device):
    """Kernel 1 (inference entry: the fold inside) against plain at every
    path shape, dtype and act; then times at the path's own dtype and act
    ('none'), beside the bytes bound, the plain version, batch_norm (the one
    ATen call of the same function) and addcmul (the yardstick before)."""
    from vae2_tpu_torch.ops import abn
    from vae2_tpu_torch.tools.bench_abn import KERNEL_NAMES, n_bufs

    max_err, cases, exact = 0.0, 0, True
    g = torch.Generator(device=device).manual_seed(0)
    for (n, c, h, w), _ in sorted(shapes.items()):
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn((n, h, w, c), generator=g, device=device) * 2
                 ).to(dtype).permute(0, 3, 1, 2)
            stats = bn_stats(torch, c, g, device)
            for act in ACTS:
                got = abn.fused_abn_infer(x, *stats, 1e-5, 0.01, act)
                want = abn.fused_abn_infer_plain(x, *stats, 1e-5, 0.01, act)
                exact = exact_or_close(torch, got, want, act, exact)
                max_err = max(max_err, float((got.float() - want.float())
                                             .abs().max()))
                cases += 1
            del x, got, want
    torch.cuda.synchronize()

    rows, totals = [], collections.Counter()
    for (n, c, h, w), (dtype, count) in sorted(shapes.items()):
        numel = n * c * h * w
        size = torch.finfo(dtype).bits // 8
        bufs = [torch.randn((n, h, w, c), device=device).to(dtype)
                .permute(0, 3, 1, 2) for _ in range(n_bufs(numel, size))]
        mean, var, gam, bet = bn_stats(torch, c, g, device)
        mul4 = (gam * torch.rsqrt(var + 1e-5)).to(dtype).view(1, -1, 1, 1)
        add4 = torch.randn(c, device=device).to(dtype).view(1, -1, 1, 1)
        fns = {
            "ms": lambda x: abn._fold_cuda(x, mean, var, gam, bet, 1e-5, 1.0,
                                           "none", False),
            "plain_ms": lambda x: abn.fused_abn_infer_plain(
                x, mean, var, gam, bet, 1e-5, 1.0, "none"),
            "library_ms": _library(torch, lambda x: torch.nn.functional
                                   .batch_norm(x, mean, var, gam, bet, False,
                                               0.0, 1e-5), bufs, "batch_norm"),
            "addcmul_ms": lambda x: torch.addcmul(add4, x, mul4),
        }
        t = timed_kernel(torch, fns, bufs, KERNEL_NAMES["abn_rows"])
        bound, by = _bound(numel, size, 2, 2, 4 * 4 * c)
        row = {"shape": [n, c, h, w], "dtype": str(dtype).split(".")[-1],
               "launches_per_sample": count, **t, "bound_ms": bound,
               "bound_by": by}
        rows.append(row)
        for k in ("ms", "plain_ms", "library_ms", "addcmul_ms", "bound_ms",
                  "device_ms", "device_call_ms"):
            if row[k] is not None:
                totals[k] += count * row[k]
        for k in ("device_launches_per_call", "profiled_launches_per_call"):
            totals[k] = max(totals[k], t[k])
        del bufs
    return {"cases": cases, "max_abs_err": max_err,
            "none_leaky_bit_exact": exact, "shapes": rows,
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
    reset_counts()
    t0 = time.perf_counter()
    out_dir = inference.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["abn_rows"]
    if counts["abn_bwd_sums"] or counts["abn_bwd_dx"]:
        raise AssertionError(f"inference launched backward kernels: {counts}")

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
    before = abn.abn_rows.launches
    with unittest.mock.patch.object(abn, "fused_abn_infer",
                                    abn.fused_abn_infer_plain):
        plain_out = sampler(xt, x2t,
                            torch.Generator(device=device).manual_seed(7))
    torch.cuda.synchronize()
    if abn.abn_rows.launches != before:
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


# ---- training ---------------------------------------------------------------


def train_config(extra=()):
    from vae2_tpu_torch.config import get_default_config, update_config

    return update_config(get_default_config(), argparse.Namespace(
        cfg=TRAIN_CFG, opts=[*TRAIN_OPTS, *extra]))


def first_batch(config, device, torch):
    """The first 8 training clips of data/synthetic64, uint8, on the card."""
    from vae2_tpu_torch.data.video import make_dataset

    import numpy as np

    ds = make_dataset(config, config.DATASET.TRAIN_SET, random_pos=False)
    b = int(config.TRAIN.BATCH_SIZE_PER_GPU)
    clips = torch.from_numpy(np.stack([ds[i][0] for i in range(b)])).to(device)
    return {k: clips[..., 9 * j:9 * j + 9].contiguous()
            for j, k in enumerate(("xt", "x2t", "x3t"))}


def model_train_launches(system):
    """(kernel 1, kernels 2-3) launches of one train step, counted from the
    model: every BN of act None/leaky_relu/elu in the networks each pass
    runs (the G step: encz, encdec, d_seq, d_frame; the D step: d_seq and
    d_frame on real and on fake) has one forward and one backward, and each
    of them inside an HRModule one more forward, its REMAT 'stage'
    recompute."""
    from vae2_tpu_torch.models.hrnet import HRModule

    m = system.modules
    passes = [m["encz"], m["encdec"], m["d_seq"], m["d_frame"]] + \
        [m["d_seq"], m["d_frame"]] * 2
    bwd = sum(len(abn_modules(net)) for net in passes)
    rec = sum(len(abn_modules(mod)) for net in passes
              for mod in net.modules() if isinstance(mod, HRModule))
    return bwd + rec, bwd


def collect_train_shapes(torch, system, batch, device):
    """(N, C, H, W) -> [dtype, forward launches, of which recomputes] of
    the fused-ABN kernels in one train step, read by forward pre-hooks on
    the BNs that they serve; each forward that is not a recompute has one
    backward (kernels 2 and 3)."""
    from vae2_tpu_torch.ops import norm

    seen = {}

    def hook(module, args):
        key = tuple(args[0].shape)
        row = seen.setdefault(key, [args[0].dtype, 0, 0])
        row[1] += 1
        row[2] += int(getattr(norm._frozen, "on", False))

    mods = [m for net in system.modules.values() for m in abn_modules(net)]
    handles = [m.register_forward_pre_hook(hook) for m in mods]
    try:
        system.train_step(batch, torch.Generator(device=device).manual_seed(0))
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return seen


def bwd_tolerance(torch, dtype):
    """Kernel 3 given the same sums: rtol 1e-5 (f32) or one bf16 ulp, atol
    1e-5 * max|dx| (the plain leaky_relu divides through a reciprocal on
    the card, elu's logf may differ in the last bit, and dx cancels)."""
    return 1e-5 if dtype == torch.float32 else 2.0**-7


def check_bwd_case(torch, y, dz, gamma, beta, mul, act):
    """Kernels 2 and 3 against their plain versions; kernel 2's sums within
    1e-5 of the sum of the terms' magnitudes (f32 sums in another order).
    Returns (sums error, dx error)."""
    from vae2_tpu_torch.ops import abn

    sums = abn.abn_bwd_sums(y, dz, gamma, beta, 0.01, act)
    dx = abn.abn_bwd_dx(y, dz, gamma, beta, mul, sums, 0.01, act)
    want = abn.abn_bwd_sums_plain(y, dz, gamma, beta, 0.01, act)
    y_norm, dz_eff = abn._y_norm(y, dz, gamma, beta, 0.01, act)
    mags = torch.stack([dz_eff.abs().sum((0, 2, 3)),
                        (y_norm * dz_eff).abs().sum((0, 2, 3))])
    del y_norm, dz_eff
    s_err = (sums - want).abs()
    if not bool((s_err <= 1e-5 * mags + 1e-30).all()):
        raise AssertionError(f"sums kernel vs plain: {float(s_err.max())} "
                             f"{tuple(y.shape)} {y.dtype} {act}")
    want_dx = abn.abn_bwd_dx_plain(y, dz, gamma, beta, mul, sums, 0.01, act)
    scale = float(want_dx.float().abs().max())
    torch.testing.assert_close(dx.float(), want_dx.float(),
                               rtol=bwd_tolerance(torch, y.dtype),
                               atol=1e-5 * scale)
    return float(s_err.max()), float((dx.float() - want_dx.float())
                                     .abs().max())


def _bwd_case(torch, n, c, h, w, dtype, act, g, device):
    z = torch.randn((n, h, w, c), generator=g, device=device) * 1.5
    y = {"none": z, "leaky_relu": torch.where(z >= 0, z, z * 0.01),
         "elu": torch.where(z >= 0, z, torch.expm1(z))}[act]
    y = y.to(dtype).permute(0, 3, 1, 2)
    dz = torch.randn((n, h, w, c), generator=g, device=device).to(
        dtype).permute(0, 3, 1, 2)
    gamma = (torch.rand(c, generator=g, device=device) + 0.5) * torch.sign(
        torch.randn(c, generator=g, device=device))
    beta = torch.randn(c, generator=g, device=device) * 0.3
    mul = gamma * (torch.rand(c, generator=g, device=device) + 0.5)
    return y, dz, gamma, beta, mul


def _bound(numel, size, bytes_per_elem, ops_per_elem, vector_bytes):
    """(bound ms, what bounds it): the larger of the bytes moved (each input
    read once, each output written once; the per-channel vectors as
    ``vector_bytes``) over HBM rate and the f32 operations over their peak."""
    bound_bytes = ((bytes_per_elem * numel * size + vector_bytes)
                   / HBM_BYTES_PER_S * 1e3)
    bound_ops = ops_per_elem * numel / F32_FLOPS_PER_S * 1e3
    return (max(bound_bytes, bound_ops),
            "bytes" if bound_bytes >= bound_ops else "operations")


def _timed(torch, fns, bufs):
    from vae2_tpu_torch.tools.bench_abn import time_ms

    t = {k: math.inf for k in fns}
    for order in (list(fns), list(fns)[::-1]):  # in turns, best of two
        for k in order:
            if fns[k] is None:
                t[k] = None
                continue
            t[k] = min(t[k], time_ms(torch, fns[k], bufs))
    return t


_REFUSED = set()


def _library(torch, fn, bufs, what):
    """A PyTorch yardstick call, or None where this build refuses it (said
    once per call)."""
    try:
        fn(bufs[0])
        torch.cuda.synchronize()
        return fn
    except (RuntimeError, TypeError) as e:  # recorded, not fatal
        if what not in _REFUSED:
            _REFUSED.add(what)
            emit({"phase": "library_call_refused", "call": what,
                  "error": str(e)[:300]})
        return None


def train_kernel_check(torch, shapes, device):
    """Kernel 1's training entry (the fold inside, and gamma * inv) and
    kernels 2-3 against plain at every shape of the step, in bf16 and f32
    with every act; then kernels 1-3 timed at the step's own shapes, dtype
    and act ('none'), summed over the step's launches."""
    from vae2_tpu_torch.ops import abn
    from vae2_tpu_torch.tools.bench_abn import KERNEL_NAMES, n_bufs

    errs = {k: 0.0 for k in KERNELS}
    errs["gamma_inv"] = 0.0
    cases, exact = 0, True
    g = torch.Generator(device=device).manual_seed(0)
    for (n, c, h, w), (_, fwd, rec) in sorted(shapes.items()):
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn((n, h, w, c), generator=g, device=device) * 2
                 ).to(dtype).permute(0, 3, 1, 2)
            stats = bn_stats(torch, c, g, device)
            want_gi = stats[2] * torch.rsqrt(stats[1] + 1e-5)
            for act in ACTS:
                got, gi = abn.abn_fwd_train(x, *stats, 1e-5, 0.01, act)
                want, _ = abn.abn_fwd_train_plain(x, *stats, 1e-5, 0.01, act)
                exact = exact_or_close(torch, got, want, act, exact)
                exact = exact_or_close(torch, gi, want_gi, "none", exact)
                errs["abn_rows"] = max(errs["abn_rows"], float(
                    (got.float() - want.float()).abs().max()))
                errs["gamma_inv"] = max(errs["gamma_inv"], float(
                    (gi - want_gi).abs().max()))
            del x, got, want
            if fwd == rec:
                continue  # recompute-only shapes take no backward
            for act in ACTS:
                case = _bwd_case(torch, n, c, h, w, dtype, act, g, device)
                e_s, e_dx = check_bwd_case(torch, *case, act)
                errs["abn_bwd_sums"] = max(errs["abn_bwd_sums"], e_s)
                errs["abn_bwd_dx"] = max(errs["abn_bwd_dx"], e_dx)
                cases += 1
                del case
    torch.cuda.synchronize()

    rows, totals = [], collections.defaultdict(collections.Counter)
    for (n, c, h, w), (dtype, fwd, rec) in sorted(shapes.items()):
        numel, size = n * c * h * w, torch.finfo(dtype).bits // 8
        bufs = [_bwd_case(torch, n, c, h, w, dtype, "none", g, device)
                for _ in range(n_bufs(numel, size, 2))]
        mean, var, gam, bet = bn_stats(torch, c, g, device)
        r = n * h * w
        zeros = torch.zeros(c, device=device)
        ones = torch.ones(c, device=device)
        count = torch.tensor([r], dtype=torch.int32, device=device)
        sums = abn.abn_bwd_sums(*bufs[0][:4], 1.0, "none")
        per_kernel = {
            "abn_rows": (fwd, 2, 2, 20 * c, {
                "ms": lambda b: abn._fold_cuda(b[0], mean, var, gam, bet,
                                               1e-5, 1.0, "none", True),
                "plain_ms": lambda b: abn.abn_fwd_train_plain(
                    b[0], mean, var, gam, bet, 1e-5, 1.0, "none"),
                "library_ms": _library(torch, lambda b: torch.nn.functional
                                       .batch_norm(b[0], mean, var, gam, bet,
                                                   False, 0.0, 1e-5), bufs,
                                       "batch_norm")}),
            "abn_bwd_sums": (fwd - rec, 2, 5, 16 * c, {
                "ms": lambda b: abn._sums_cuda(*b[:4], 1.0, "none"),
                "plain_ms": lambda b: abn.abn_bwd_sums_plain(*b[:4], 1.0,
                                                             "none"),
                "library_ms": _library(torch, lambda b: torch.ops.aten
                                       .batch_norm_backward_reduce(
                                           b[1], b[0], zeros, ones, b[2],
                                           True, True, True), bufs,
                                       "batch_norm_backward_reduce")}),
            "abn_bwd_dx": (fwd - rec, 3, 7, 20 * c, {
                "ms": lambda b: abn._dx_cuda(*b, sums, 1.0, "none"),
                "plain_ms": lambda b: abn.abn_bwd_dx_plain(*b, sums, 1.0,
                                                           "none"),
                "library_ms": _library(torch, lambda b: torch.ops.aten
                                       .batch_norm_backward_elemt(
                                           b[1], b[0], zeros, ones, b[2],
                                           sums[0], sums[1], count), bufs,
                                       "batch_norm_backward_elemt")}),
        }
        for name, (launches, nbytes, ops, vbytes, fns) in per_kernel.items():
            if launches == 0:
                continue
            t = timed_kernel(torch, fns, bufs, KERNEL_NAMES[name])
            bound, by = _bound(numel, size, nbytes, ops, vbytes)
            row = {"kernel": name, "shape": [n, c, h, w],
                   "dtype": str(dtype).split(".")[-1],
                   "launches_per_step": launches, **t, "bound_ms": bound,
                   "bound_by": by}
            rows.append(row)
            tot = totals[name]
            for k in ("ms", "plain_ms", "bound_ms", "device_ms",
                      "device_call_ms"):
                tot[k] += launches * row[k]
            if t["library_ms"] is None:
                tot["library_missing"] += launches
            else:
                tot["library_ms"] += launches * t["library_ms"]
            tot["bytes_bound_launches"] += launches * (by == "bytes")
            tot["launches"] += launches
            for k in ("device_launches_per_call",
                      "profiled_launches_per_call"):
                tot[k] = max(tot[k], t[k])
        del bufs
    return {"cases": cases, "max_abs_err": errs,
            "none_leaky_bit_exact": exact, "shapes": rows,
            "per_step": {k: dict(v) for k, v in totals.items()}}


def tiny_train_step(torch, device):
    """One G/D step of the tiny spec in f32, REMAT 'stage', fixed clips and
    noise: (losses, initial state, state after)."""
    from vae2_tpu_torch.config import get_default_config
    from vae2_tpu_torch.core.builder import build_system
    from vae2_tpu_torch.utils.device import exact_f32

    cfg = get_default_config()
    cfg.merge_from_file(TINY_CFG)
    cfg.GPU.DTYPE = "float32"
    cfg.TRAIN.OPTIMIZER = "sgd"
    cfg.TRAIN.LR = 0.01
    cfg.TPU.REMAT = "stage"
    system = build_system(cfg, seed=0, device=device, train=True)
    init = {k: v.detach().cpu().clone()
            for k, v in system.modules.state_dict().items()}
    g = torch.Generator().manual_seed(6)
    batch = {k: torch.randint(0, 256, (2, 32, 64, 9), generator=g,
                              dtype=torch.uint8).to(device)
             for k in ("xt", "x2t", "x3t")}
    eps = [torch.randn(2, 4, 32 >> b, 64 >> b, generator=g).to(device)
           for b in range(4)]
    rand = torch.randn(2, 4, generator=g).to(device)
    with exact_f32():
        metrics, _ = system.train_step(batch, eps=eps, rand_code=rand)
    after = {k: v.detach().cpu() for k, v in system.modules.state_dict().items()}
    return {k: float(v) for k, v in metrics.items()}, init, after


def train_reference(torch, device):
    """The tiny step on the card against the CPU: losses rtol 1e-4 (the KL
    atol KL_ATOL), running statistics 1e-4 * (1 + max), parameter updates
    within 3e-2 (L2 per network; tests/test_torch_port_step.py states
    why)."""
    m_want, init, want = tiny_train_step(torch, "cpu")
    m_got, _, got = tiny_train_step(torch, device)
    torch.cuda.synchronize()
    loss_err = max(abs(m_got[k] - m_want[k]) / (abs(m_want[k]) + 1e-6)
                   for k in m_want if k != "loss_z_KL")
    kl_err = abs(m_got["loss_z_KL"] - m_want["loss_z_KL"])
    if not (loss_err <= 1e-4 and kl_err <= KL_ATOL):
        raise AssertionError(f"tiny train step losses: rel err {loss_err}, "
                             f"KL abs err {kl_err}")
    stats_err, update_err = 0.0, {}
    for net in ("encdec", "encz", "d_seq", "d_frame"):
        d2 = w2 = 0.0
        for k, w_ in want.items():
            if not k.startswith(net + "."):
                continue
            if "running_" in k:
                tol = 1e-4 * (1.0 + float(w_.abs().max()))
                torch.testing.assert_close(got[k], w_, rtol=1e-4, atol=tol)
                stats_err = max(stats_err, float((got[k] - w_).abs().max()))
            elif k.endswith(("weight", "bias")):
                d2 += float((((got[k] - init[k]) - (w_ - init[k])) ** 2).sum())
                w2 += float(((w_ - init[k]) ** 2).sum())
        update_err[net] = (d2 / w2) ** 0.5
        if not update_err[net] <= 3e-2:
            raise AssertionError(f"tiny train step {net} update: "
                                 f"{update_err[net]}")
    return {"loss_max_rel_err": loss_err, "kl_abs_err": kl_err,
            "kl_atol": KL_ATOL, "stats_max_abs_err": stats_err,
            "update_l2_rel_err": update_err, "loss_rtol": 1e-4,
            "update_bound": 3e-2}


class StepRecorder:
    """Wraps VAE2System.train_step: after each step it waits for the card
    and records the time and the losses (this adds one synchronisation per
    step; the loop itself fetches losses at print points)."""

    def __init__(self, torch, system_cls):
        self.torch, self.cls = torch, system_cls
        self.orig = system_cls.train_step
        self.times, self.losses = [], []

    def __enter__(self):
        rec = self

        def step(system, *args, **kwargs):
            metrics, preds = rec.orig(system, *args, **kwargs)
            rec.torch.cuda.synchronize()
            rec.times.append(time.perf_counter())
            rec.losses.append({k: float(v) for k, v in metrics.items()})
            return metrics, preds

        self.start = time.perf_counter()
        self.cls.train_step = step
        return self

    def __exit__(self, *exc):
        self.cls.train_step = self.orig


def run_train_cli(torch, argv, expect_steps):
    """The train CLI in this process, counted; returns (output dir, step
    recorder, kernel counts, peak memory)."""
    from vae2_tpu_torch.core.system import VAE2System
    from vae2_tpu_torch.tools import train

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with StepRecorder(torch, VAE2System) as rec:
        out_dir = train.main(argv)
        torch.cuda.synchronize()
    counts = read_counts()
    want = {"abn_rows": expect_steps * EXPECTED_FWD_PER_STEP,
            "abn_bwd_sums": expect_steps * EXPECTED_BWD_PER_STEP,
            "abn_bwd_dx": expect_steps * EXPECTED_BWD_PER_STEP}
    if counts != want or len(rec.losses) != expect_steps:
        raise AssertionError(f"{len(rec.losses)} steps, launches {counts}, "
                             f"expected {want}")
    for i, m in enumerate(rec.losses):
        if len(m) != 10 or not all(map(math.isfinite, m.values())):
            raise AssertionError(f"step {i}: losses {m}")
    return out_dir, rec, counts, torch.cuda.max_memory_allocated()


def train_end_to_end(torch, workdir):
    """One epoch of the flagship train CLI, then a resumed second one."""
    argv = ["--cfg", TRAIN_CFG, "--seed", "0",
            "OUTPUT_DIR", os.path.join(workdir, "out"),
            "LOG_DIR", os.path.join(workdir, "log"), *TRAIN_OPTS]
    out_dir, rec, counts, peak = run_train_cli(
        torch, argv + ["TRAIN.END_EPOCH", "1"], STEPS_PER_EPOCH)
    ckpt = os.path.join(out_dir, "checkpoint.pt")
    raw = torch.load(ckpt, map_location="cpu", weights_only=True)
    if raw["epoch"] != 1 or "optimizer_g" not in raw:
        raise AssertionError(f"checkpoint.pt: epoch {raw['epoch']}")
    if not glob.glob(os.path.join(out_dir, "vis", "epoch0", "*", "*.png")):
        raise AssertionError("no epoch-end PNGs")
    steady = (len(rec.times) - 1) / (rec.times[-1] - rec.times[0])
    first_s = rec.times[0] - rec.start
    batch = int(train_config().TRAIN.BATCH_SIZE_PER_GPU)

    out2, rec2, counts2, peak2 = run_train_cli(
        torch, argv + ["TRAIN.END_EPOCH", "2", "TRAIN.RESUME", "True"],
        STEPS_PER_EPOCH)
    log = "".join(open(p).read() for p in glob.glob(
        os.path.join(out2, "*_train.log")))
    if "=> loaded checkpoint (epoch 1)" not in log:
        raise AssertionError("the resumed run did not load epoch 1")
    if torch.load(ckpt, map_location="cpu", weights_only=True)["epoch"] != 2:
        raise AssertionError("the resumed run did not write epoch 2")
    steady2 = (len(rec2.times) - 1) / (rec2.times[-1] - rec2.times[0])
    return {"phase": "train_end_to_end", "steps": len(rec.times),
            "first_step_s_with_setup": first_s,
            "steps_per_s": steady, "clips_per_s": steady * batch,
            "resumed_steps_per_s": steady2,
            "peak_memory_gib": max(peak, peak2) / 2**30,
            "launches_per_epoch": counts,
            "launches_per_step": {k: v // STEPS_PER_EPOCH
                                  for k, v in counts.items()},
            "losses_first": rec.losses[0], "losses_last": rec2.losses[-1],
            "resumed": True}


def train_plain_path(torch, config, device):
    """One flagship step of the recipe (SGD) through the kernels, and the
    same step — weights, clips, noise — with every fused-ABN kernel swapped
    for its plain version. The ten losses are forward values, where kernel
    1 and its plain version round alike: rtol 1e-3. The G update's L2
    difference is reported: kernels 2-3 and their plain versions sum in
    other orders, which this network's gradient amplifies."""
    from vae2_tpu_torch.core.builder import build_system
    from vae2_tpu_torch.ops import abn

    batch = first_batch(config, device, torch)
    out = []
    for plain in (False, True):
        system = build_system(config, seed=0, device=device, train=True)
        init = {k: v.detach().clone() for k, v in
                system.modules["encdec"].state_dict().items()}
        patches = [unittest.mock.patch.object(abn, k, getattr(abn, f"{k}_plain"))
                   for k in PATH_FNS] if plain else []
        before = read_counts()
        for p in patches:
            p.start()
        try:
            m, _ = system.train_step(batch, torch.Generator(
                device=device).manual_seed(3))
            torch.cuda.synchronize()
        finally:
            for p in patches:
                p.stop()
        if plain and read_counts() != before:
            raise AssertionError("the plain step launched a kernel")
        upd = {k: (v - init[k]).float() for k, v in
               system.modules["encdec"].state_dict().items()
               if "running_" not in k and "num_batches" not in k}
        out.append(({k: float(v) for k, v in m.items()}, upd))
        del system
    (mk, uk), (mp, up) = out
    err = max(abs(mk[k] - mp[k]) / (abs(mp[k]) + 1e-6) for k in mp)
    if not err <= 1e-3 or not all(map(math.isfinite, mk.values())):
        raise AssertionError(f"kernel vs plain step losses: {err} {mk} {mp}")
    d2 = sum(float(((uk[k] - up[k]) ** 2).sum()) for k in up)
    w2 = sum(float((up[k] ** 2).sum()) for k in up)
    return {"phase": "train_plain_path", "loss_max_rel_err": err,
            "loss_rtol": 1e-3, "encdec_update_l2_rel_diff": (d2 / w2) ** 0.5,
            "losses": mk}



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
    sources = ("abn", "abn_bwd")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        for f in [pool.submit(cuda_build.build, s) for s in sources]:
            f.result()  # one nvcc per source, all at once
    abn._fwd_lib()
    abn._bwd_lib()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": [f"vae2_tpu_torch/csrc/{s}.cu" for s in sources],
          "ptxas": {s: [line.strip() for line in
                        cuda_build.build_log(s).splitlines()
                        if "registers" in line or "spill" in line]
                    for s in sources}})

    # ---- prior-sampling inference ------------------------------------------
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
          "none_leaky_bit_exact": check["none_leaky_bit_exact"],
          "launches_per_sample": sum(c for _, c in shapes.values()),
          "per_sample": check["per_sample"], "nvidia_smi": smi})
    for row in check["shapes"]:
        emit({"phase": "kernel_shape", **row})

    emit({"phase": "reference", **reference_check(torch, device)})

    workdir = tempfile.mkdtemp(prefix="vae2_chip_smoke_")
    try:
        e2e = end_to_end(torch, system, config, sampler, xt, x2t, device,
                         workdir)
        emit({**e2e, "nvidia_smi": smi})
        del system, sampler
        torch.cuda.empty_cache()

        # ---- adversarial training ------------------------------------------
        sgd = train_config(["TRAIN.OPTIMIZER", "sgd", "TRAIN.LR", "0.01"])
        tsys = build_system(sgd, seed=0, device=device, train=True)
        derived = model_train_launches(tsys)
        tshapes = collect_train_shapes(torch, tsys, first_batch(sgd, device,
                                                                torch), device)
        del tsys
        torch.cuda.empty_cache()
        n_fwd = sum(v[1] for v in tshapes.values())
        n_bwd = n_fwd - sum(v[2] for v in tshapes.values())
        want = (EXPECTED_FWD_PER_STEP, EXPECTED_BWD_PER_STEP)
        if not (n_fwd, n_bwd) == derived == want:
            raise AssertionError(f"ABN launches per step (forward, backward): "
                                 f"{(n_fwd, n_bwd)} seen by hooks, {derived} "
                                 f"from the model, {want} expected")
        tcheck = train_kernel_check(torch, tshapes, device)
        emit({"phase": "train_kernel_check", "cases": tcheck["cases"],
              "max_abs_err": tcheck["max_abs_err"],
              "none_leaky_bit_exact": tcheck["none_leaky_bit_exact"],
              "launches_per_step": {"abn_rows": n_fwd, "abn_bwd_sums": n_bwd,
                                    "abn_bwd_dx": n_bwd},
              "launches_from_model": derived,
              "per_step": tcheck["per_step"], "nvidia_smi": smi})
        for row in tcheck["shapes"]:
            emit({"phase": "train_kernel_shape", **row})
        launches = collections.defaultdict(set)
        for row in check["shapes"]:
            launches["abn_rows_inference"].add(row["device_launches_per_call"])
        for row in tcheck["shapes"]:
            launches[row["kernel"]].add(row["device_launches_per_call"])
        if any(v != {1} for v in launches.values()):
            raise AssertionError(f"device launches per kernel call: "
                                 f"{dict(launches)}, expected 1 at every "
                                 f"shape")
        emit({"phase": "train_reference", **train_reference(torch, device)})
        te2e = train_end_to_end(torch, workdir)
        emit({**te2e, "nvidia_smi": smi})
        emit({**train_plain_path(torch, sgd, device), "nvidia_smi": smi})
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    per, inf = tcheck["per_step"], check["per_sample"]
    sources = {"abn_rows": ("fused_abn_fwd", "vae2_tpu_torch/csrc/abn.cu",
                            "vae2_tpu/ops/pallas/abn.py:100"),
               "abn_bwd_sums": ("fused_abn_bwd_sums",
                                "vae2_tpu_torch/csrc/abn_bwd.cu",
                                "vae2_tpu/ops/pallas/abn.py:188"),
               "abn_bwd_dx": ("fused_abn_bwd_dx",
                              "vae2_tpu_torch/csrc/abn_bwd.cu",
                              "vae2_tpu/ops/pallas/abn.py:210")}
    kernels = []
    for k, (kname, source, replaces) in sources.items():
        p = per[k]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": te2e["launches_per_epoch"][k],
            "launches_per_step": te2e["launches_per_step"][k],
            "max_abs_err": tcheck["max_abs_err"][k],
            "ms": p["ms"], "plain_ms": p["plain_ms"],
            "bound_ms": p["bound_ms"],
            "bound_by": ("bytes" if p["bytes_bound_launches"] == p["launches"]
                         else "operations"),
            "library_ms": None if p.get("library_missing") else p["library_ms"],
            "device_ms": p["device_ms"], "device_call_ms": p["device_call_ms"],
            "device_launches_per_call": p["device_launches_per_call"],
            "profiled_launches_per_call": p["profiled_launches_per_call"],
            "timed_as": "the launches of one flagship train step, bf16, "
                        "act none; ms by CUDA events around back-to-back "
                        "calls, device_ms by torch.profiler",
        })
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"],
                                    check["max_abs_err"])
    kernels[0]["launches_by_path"] = {"inference": e2e["launches"],
                                      "train_epoch": kernels[0]["launches"]}
    kernels[0]["inference"] = {
        "launches_per_sample": e2e["launches_per_sample"],
        "ms": inf["ms"], "plain_ms": inf["plain_ms"],
        "bound_ms": inf["bound_ms"], "library_ms": inf.get("library_ms"),
        "addcmul_ms": inf["addcmul_ms"], "device_ms": inf["device_ms"],
        "device_call_ms": inf["device_call_ms"],
        "device_launches_per_call": inf["device_launches_per_call"],
        "profiled_launches_per_call": inf["profiled_launches_per_call"],
        "timed_as": "one sampling call's launches, bf16, act none"}
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
