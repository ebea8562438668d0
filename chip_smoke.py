#!/usr/bin/env python3
"""Drive vae2_tpu_torch's main paths on one NVIDIA GPU and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py

Three VAE² paths, each at the full W18-small-v2 width (4 branches of
18/36/72/144 channels, HD_Z, Z_DIM 32, 128x256 frames, random weights from a
seed, data/synthetic64), and the segmentation path at the full HRNetV2-W48
width and depth (48/96/192/384 channels) on data/synthetic_seg and on
synthetic 2048x1024 test images made from a seed:

- prior-sampling inference (``python -m vae2_tpu_torch.tools.inference``),
  64 samples per chunk, encoder and both decoders;
- the paper's evaluation: momentum-sampling inference over the 5-clip eval
  window (``--clip-num 5 --sampling-mode momentum_sampling``: the posterior
  at batch 1 on the previous window, then the same decode), then FID and
  the Inception Score (``python -m vae2_tpu_torch.tools.fid_score``,
  ``python -m vae2_tpu_torch.tools.inception_score``, InceptionV3 as
  published, random init) over the frames it wrote;
- adversarial training (``python -m vae2_tpu_torch.tools.train``) of the
  four networks, batch 8, bf16, TPU.REMAT 'stage', a G then a D update;
- segmentation: the train CLI (``python -m vae2_tpu_torch.tools.train_seg``)
  then the evaluation CLI (``python -m vae2_tpu_torch.tools.test``) on the
  checkpoint it wrote;
- data-parallel training: the train CLI in two ``gloo`` ranks that share
  this card (spawned processes, each through the CLI's env:// set-up, as
  ``torchrun`` starts them), SyncBN on every BN, gradients averaged.

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
6. momentum_kernel_check — phase 3 at the (N, C, H, W) that one momentum
   call hands kernel 1 through the posterior at batch 1;
7. momentum_end_to_end — the inference CLI with ``--clip-num 5
   --sampling-mode momentum_sampling``, counted (kernel-1 launches per
   call: the encoder's and decoders' 255 and the posterior's 85), its
   metric tree and PNGs, throughput and peak memory, and one chunk through
   the plain path;
8. eval_fid_is — Inception's pool3 features and logits of the first batch
   on the card against the CPU (f32, TF32 off), then the FID CLI between
   the tree's x2t and x3t predictions and the IS CLI over the x3t ones:
   finite, with Inception's images/s and the host's sqrtm seconds;
9. train_kernel_check — every (N, C, H, W) that one flagship train step
   hands the kernels, read by hooks, in bf16 and f32 with every act: kernel
   1's training entry (y and gamma * inv) and the backward kernels (sums,
   dx) against their plain versions; then all three timed at the step's
   shapes, dtype and act as in phase 3, beside the ATen calls;
10. train_reference — one G/D step of the tiny spec in f32 (TF32 off) on the
   card against the CPU path;
11. train_end_to_end — the train CLI in this process for one epoch (6 steps
   of 8 clips), counted per step, then TRAIN.RESUME for a second epoch;
12. train_plain_path — one flagship step (the recipe's SGD) in five legs:
   through the kernels, with every ABN kernel swapped for its plain
   version, through the kernels again (the control: the kernel path's
   floor against itself), and kernel and plain in f32 with TF32 off; the
   losses and the encdec update's L2 gaps, the bf16 gap bounded by
   GAP_FACTOR x max(control, f32 gap), the f32 gap by F32_GAP_BOUND;
13. seg_kernel_check — HRNetV2-W48 segmentation (the recipe
   experiments/cityscapes/seg_hrnet_w48_train_512x1024.yaml, random init):
   every (N, C, H, W) that one train step (batch 3, 1024x512 crops) hands
   kernels 1-3 and one whole-image test forward (2048x1024) hands kernel 1,
   read by hooks, checked and timed as in phase 9; the hooks' count must
   equal the model's 171 ABN BNs per trunk forward;
14. seg_reference — one seg train step of the tiny seg spec in f32 (TF32
   off) on the card against the CPU path;
15. seg_train_end_to_end — the train_seg CLI in this process, the recipe as
   it stands, two epochs over the 8 train images of data/synthetic_seg
   (multi-scale resizes them to the recipe's 2048 base size before the
   crop), counted per step, both checkpoints written;
16. seg_test_end_to_end — the test CLI on that run's seg_final_state.pt over
   2 synthetic 2048x1024 val images written from seed 0, counted, mIoU /
   pixel / mean accuracy finite, then the forward alone;
17. seg_plain_path — one W48 seg step in the five legs of phase 12, bounded
   alike;
18. train_ddp_reference — two gloo ranks on this card, two steps of the
   tiny spec in f32 (TF32 off), against one rank at the doubled batch and
   its one-ulp control (``vae2_tpu_torch/tools/ddp_check.py``, which
   tests/test_torch_port_ddp.py runs on the CPU); the ranks bitwise equal;
19. train_ddp_step — the flagship step of phase 12 in two ranks of batch 4
   against phase 12's one rank of batch 8 (same weights, clips and global
   noise), in bf16 and in f32 with TF32 off, each beside one rank's step
   on clips moved by one ulp of its dtype (the control): losses, in f32
   the update gap within DDP_GAP_FACTOR x max(control, floor) (in bf16 a
   reading: the control moves the update by as much as the whole of it),
   the ranks bitwise equal, and per rank 1670/850/850 kernel launches and
   the all-reduces counted from the model;
20. train_ddp_end_to_end — the train CLI in two ranks (GPU.DIST_BACKEND
   gloo, --device cuda:0, 4 clips per rank) for one 3-step epoch of 24
   clips, then TRAIN.RESUME for a second: steps/s, clips/s, peak memory
   and host seconds in all-reduce per step per rank, launches per rank;
21. train_ddp_faults — phases 18 and 19 (its f32 leg) again for each
   fault of ``ddp_check.FAULTS`` planted in the ranks (local batch
   statistics, local kernel-2 sums handed to kernel 3, the ReLU BNs'
   statistics' gradient not summed, gradients summed and not averaged;
   each issues the same collectives as the correct code): both phases must
   fail on each, or the run fails.

Then the ``kernels`` line, the nvidia-smi line and the ok line. Without a
CUDA device, or without the repository beside it, it exits non-zero and
prints no result.
"""

import argparse
import collections
import concurrent.futures
import contextlib
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
# a momentum call adds the posterior's trunk at batch 1: 85 more
EXPECTED_ABN_PER_MOMENTUM_CALL = EXPECTED_ABN_PER_SAMPLE + 85
FID_BATCH, IS_BATCH, IS_SPLITS = 50, 32, 10
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
SGD_OPTS = ["TRAIN.OPTIMIZER", "sgd", "TRAIN.LR", "0.01"]  # as the recipe
# HRNetV2-W48 segmentation (HRNet-Semantic-Segmentation's Cityscapes
# recipe): train at crop 1024x512, batch 3, SGD lr 1e-2, WD 5e-4, bf16,
# multi-scale and flip; whole-image test at 2048x1024
SEG_CFG = os.path.join(REPO, "experiments", "cityscapes",
                       "seg_hrnet_w48_train_512x1024.yaml")
SEG_TINY_CFG = os.path.join(REPO, "experiments", "cityscapes",
                            "debug_seg_tiny_32x64.yaml")
# BNs of act None in one W48 trunk: stage 1 4 bn3 + 1 down_bn, stage 2
# 8 bn2 + 2 fuse, stage 3 4 x (12 bn2 + 6 fuse), stage 4 3 x (16 + 12)
EXPECTED_SEG_ABN = 5 + 10 + 72 + 84
SEG_DATA = os.path.join(REPO, "data", "synthetic_seg")  # 8 train images
SEG_IMAGE_W, SEG_IMAGE_H = 2048, 1024  # the recipe's TEST.IMAGE_SIZE
SEG_TRAIN_IMAGES, SEG_VAL_IMAGES, SEG_EPOCHS = 8, 2, 2  # 2 steps per epoch
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


def calibrate_bn(torch, modules, call, device):
    """Every BN's running statistics set, in forward order, to those of its
    own input in one sampling call (``call(generator)``): a data-dependent
    init. Each BN then normalizes, so that conv kernels of fan-in scale
    keep the activations finite through the full depth (seeded BN
    statistics alone let bf16 overflow there)."""
    from vae2_tpu_torch.ops.norm import BatchNormAct

    def hook(module, args):
        x = args[0].float()
        dims = [d for d in range(x.dim()) if d != 1]
        module.running_mean.copy_(x.mean(dims))
        module.running_var.copy_(x.var(dims, unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in modules.modules()
               if isinstance(m, BatchNormAct)]
    try:
        call(torch.Generator(device=device).manual_seed(0))
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()


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


def first_window(config, device, torch):
    """The first test video's 5-clip eval window as the momentum sampler
    takes it: (xt, x2t, xt_last, x3t_last), uint8 on the card."""
    from vae2_tpu_torch.core.infer_loop import eval_window
    from vae2_tpu_torch.data.video import make_dataset

    ds = make_dataset(config, config.DATASET.TEST_SET, random_pos=False,
                      num_samples=1, clip_num=5)
    clips = ds[0][0][None]
    window = eval_window({k: clips[..., 9 * j:9 * j + 9] for j, k in
                          enumerate(("xt", "x2t", "x3t", "x4t", "x5t"))})
    return tuple(torch.from_numpy(window[k].copy()).to(device)
                 for k in ("xt", "x2t", "xt_last", "x3t_last"))


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


def collect_shapes(torch, net, call, device):
    """(N, C, H, W) -> (dtype, launches) of the kernel in one sampling
    call (``call(generator)``), read by forward hooks on the BNs of ``net``
    that it serves."""
    seen = collections.Counter()
    dtypes = {}

    def hook(module, args):
        key = tuple(args[0].shape)
        seen[key] += 1
        dtypes[key] = args[0].dtype

    handles = [m.register_forward_pre_hook(hook) for m in abn_modules(net)]
    try:
        call(torch.Generator(device=device).manual_seed(0))
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

    sampler_s, peak = sampler_throughput(
        torch, lambda g: sampler(xt, x2t, g), device, (chunk, 9, h, w))
    err, tol = plain_path_chunk(torch, lambda g: sampler(xt, x2t, g), device)
    frames = chunk * 9  # x1p, x2p, x3p: 3 clips of 3 frames per sample
    return {"phase": "end_to_end", "cli_seconds": cli_s,
            "sampling_calls": calls, "launches": launches,
            "launches_per_sample": per_sample,
            "cli_frames_per_s": calls * frames / cli_s,
            "sampler_ms": sampler_s * 1e3,
            "frames_per_s": frames / sampler_s,
            "peak_memory_gib": peak / 2**30,
            "plain_path_max_abs_err": err, "plain_path_tol": tol}


def sampler_throughput(torch, call, device, shape):
    """Seconds per sampler call (``call(generator)``) after a warm-up call,
    the mean of 3, and the peak memory of those calls; fails on an
    output that is not finite or not of ``shape``."""
    call(torch.Generator(device=device).manual_seed(1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 3
    t0 = time.perf_counter()
    for i in range(reps):
        outs = call(torch.Generator(device=device).manual_seed(i))
    torch.cuda.synchronize()
    sampler_s = (time.perf_counter() - t0) / reps
    for o in outs:
        if o.shape != shape or not bool(torch.isfinite(o).all()):
            raise AssertionError(f"sampler output {tuple(o.shape)} not finite")
    return sampler_s, torch.cuda.max_memory_allocated()


def plain_path_chunk(torch, call, device):
    """One chunk through the kernel and through the plain BN path, same
    weights and noise: (max abs error, tolerance)."""
    from vae2_tpu_torch.ops import abn

    kernel_out = call(torch.Generator(device=device).manual_seed(7))
    before = abn.abn_rows.launches
    with unittest.mock.patch.object(abn, "fused_abn_infer",
                                    abn.fused_abn_infer_plain):
        plain_out = call(torch.Generator(device=device).manual_seed(7))
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
    return err, tol


def momentum_end_to_end(torch, system, config, sampler, window, device,
                        workdir):
    """The inference CLI in momentum mode over the 5-clip window, counted,
    with its PNGs (the FID/IS inputs); the sampler's throughput; one chunk
    through the plain BN path. Returns (phase line, output dir)."""
    from vae2_tpu_torch.tools import inference
    from vae2_tpu_torch.utils.checkpoint import save_checkpoint

    ckpt = os.path.join(workdir, "checkpoint.pt")
    save_checkpoint(ckpt, system.modules.state_dict(), epoch=0)
    argv = ["--cfg", CFG, "--checkpoint", ckpt,
            "--num-samples", str(NUM_SAMPLES), "--clip-num", "5",
            "--sampling-mode", "momentum_sampling",
            "--device", device.type, "--seed", "0",
            "OUTPUT_DIR", os.path.join(workdir, "momentum"),
            "LOG_DIR", os.path.join(workdir, "log"), *DATA_OPTS]
    chunk = int(config.TPU.INFER_SAMPLE_BATCH)
    h, w = config.TRAIN.IMAGE_SIZE[1], config.TRAIN.IMAGE_SIZE[0]
    clips = math.ceil(NUM_VIDEOS / int(config.TEST.BATCH_SIZE_PER_GPU))
    calls = clips * math.ceil(NUM_SAMPLES / chunk)
    per_call = (len(abn_modules(system.modules["encdec"]))
                + len(abn_modules(system.modules["encz"])))

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
    if per_call != EXPECTED_ABN_PER_MOMENTUM_CALL:
        raise AssertionError(f"{per_call} kernel BNs in encdec + encz, "
                             f"expected {EXPECTED_ABN_PER_MOMENTUM_CALL}")
    if launches != calls * per_call:
        raise AssertionError(f"{launches} kernel launches for {calls} "
                             f"momentum calls, expected {calls * per_call}")
    root = os.path.join(out_dir, "vis", "epoch0")
    txts = glob.glob(os.path.join(root, "*", "x?tpredict", "*.txt"))
    pngs = glob.glob(os.path.join(root, "*", "x?tpredict", "*.png"))
    frames = glob.glob(os.path.join(root, "*", "x?t_*.png"))
    if (len(txts), len(pngs), len(frames)) != (
            clips * 2 * 3 * 4, clips * 2 * NUM_SAMPLES * 3, clips * 9):
        raise AssertionError(f"{len(txts)} metric files, {len(pngs)} "
                             f"predicted and {len(frames)} clip PNGs")
    for path in txts:
        vals = [float(v) for v in open(path)]
        if len(vals) != NUM_SAMPLES or not all(map(math.isfinite, vals)):
            raise AssertionError(f"{path}: {len(vals)} lines or non-finite")

    call = lambda g: sampler(*window, g)  # noqa: E731
    sampler_s, peak = sampler_throughput(torch, call, device,
                                         (chunk, 9, h, w))
    err, tol = plain_path_chunk(torch, call, device)
    frames_per_call = chunk * 9
    return {"phase": "momentum_end_to_end", "cli_seconds": cli_s,
            "sampling_calls": calls, "launches": launches,
            "launches_per_call": per_call,
            "cli_frames_per_s": calls * frames_per_call / cli_s,
            "sampler_ms": sampler_s * 1e3,
            "frames_per_s": frames_per_call / sampler_s,
            "peak_memory_gib": peak / 2**30,
            "tree_files": {"metric_txts": len(txts), "predicted_pngs":
                           len(pngs), "clip_pngs": len(frames)},
            "plain_path_max_abs_err": err,
            "plain_path_tol": tol}, out_dir


def inception_check(torch, files, device, fid_variant):
    """The first batch of ``files`` through InceptionV3 (random init, seed
    0) on the card and on the CPU: pool3 features (FID variant) or logits
    (torchvision variant), f32 with TF32 off on the card. Tolerance 1e-4 *
    (1 + max|cpu|), as the card tests. Returns (max abs error, card
    images/s of the forward alone at that batch)."""
    import numpy as np
    from vae2_tpu_torch.eval.fid import imread
    from vae2_tpu_torch.models.inception import get_inception

    batch = FID_BATCH if fid_variant else IS_BATCH
    x = torch.from_numpy(np.stack([imread(f).astype(np.float32) / 255.0
                                   for f in files[:batch]]))
    kw = dict(fid_variant=fid_variant, with_fc=not fid_variant)
    with torch.inference_mode():
        want = get_inception("", device="cpu", **kw)(
            x, with_logits=not fid_variant)
        model = get_inception("", device=device, **kw)
        xd = x.to(device)
        got = model(xd, with_logits=not fid_variant)
        torch.cuda.synchronize()
        tol = 1e-4 * (1.0 + float(want.abs().max()))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=tol)
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            model(xd, with_logits=not fid_variant)
        torch.cuda.synchronize()
        ips = reps * batch / (time.perf_counter() - t0)
    return float((got.cpu() - want).abs().max()), ips


def eval_fid_is(torch, out_dir, want, device):
    """The FID CLI (batch 50) between the tree's x2t and x3t predicted
    frames (``want`` of each) and the IS CLI (batch 32, 10 splits) over the
    x3t ones, on the card; Inception's first batch on the card against the
    CPU."""
    from scipy import linalg

    from vae2_tpu_torch.eval.fid import list_images
    from vae2_tpu_torch.tools import fid_score, inception_score

    root = os.path.join(out_dir, "vis", "epoch0")
    patterns = ("*/x2tpredict/*.png", "*/x3tpredict/*.png")
    sets = [list_images(root, p) for p in patterns]
    if [len(s) for s in sets] != [want, want]:
        raise AssertionError(f"{[len(s) for s in sets]} predicted frames, "
                             f"expected {want} each")
    feat_err, fid_ips = inception_check(torch, sets[0], device, True)
    logit_err, is_ips = inception_check(torch, sets[1], device, False)

    sqrtm_s = []
    sqrtm = linalg.sqrtm

    def timed_sqrtm(*args, **kwargs):
        t = time.perf_counter()
        try:
            return sqrtm(*args, **kwargs)
        finally:
            sqrtm_s.append(time.perf_counter() - t)

    t0 = time.perf_counter()
    with unittest.mock.patch.object(linalg, "sqrtm", timed_sqrtm):
        fid = fid_score.main(["--path", root, root, "--path_patterns",
                              *patterns, "--batch-size", str(FID_BATCH),
                              "--device", device.type])
    fid_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    is_mean, is_std = inception_score.main([
        "--path", root, "--pattern", "x3t_*_trial_*.png",
        "--batch-size", str(IS_BATCH), "--splits", str(IS_SPLITS),
        "--device", device.type])
    is_s = time.perf_counter() - t0
    if not all(map(math.isfinite, (fid, is_mean, is_std))):
        raise AssertionError(f"FID {fid}, IS {is_mean} +/- {is_std}")
    return {"phase": "eval_fid_is", "images_per_set": want,
            "fid": float(fid), "is_mean": is_mean, "is_std": is_std,
            "features_max_abs_err": feat_err, "logits_max_abs_err": logit_err,
            "inception_tol": "1e-4 * (1 + max|cpu|)",
            "fid_inception_images_per_s": fid_ips,
            "is_inception_images_per_s": is_ips,
            "fid_cli_seconds": fid_s, "is_cli_seconds": is_s,
            "sqrtm_seconds": sqrtm_s}


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
    from vae2_tpu_torch.tools.ddp_check import train_passes

    passes = train_passes(system)
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
    count = y.numel() // y.shape[1]
    dx = abn.abn_bwd_dx(y, dz, gamma, beta, mul, sums, 0.01, act, count)
    want = abn.abn_bwd_sums_plain(y, dz, gamma, beta, 0.01, act)
    y_norm, dz_eff = abn._y_norm(y, dz, gamma, beta, 0.01, act)
    mags = torch.stack([dz_eff.abs().sum((0, 2, 3)),
                        (y_norm * dz_eff).abs().sum((0, 2, 3))])
    del y_norm, dz_eff
    s_err = (sums - want).abs()
    if not bool((s_err <= 1e-5 * mags + 1e-30).all()):
        raise AssertionError(f"sums kernel vs plain: {float(s_err.max())} "
                             f"{tuple(y.shape)} {y.dtype} {act}")
    want_dx = abn.abn_bwd_dx_plain(y, dz, gamma, beta, mul, sums, 0.01, act,
                                   count)
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
                "ms": lambda b: abn._dx_cuda(*b, sums, 1.0, "none", r),
                "plain_ms": lambda b: abn.abn_bwd_dx_plain(*b, sums, 1.0,
                                                           "none", r),
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
    and records the time, the losses and the step's all-reduces (their
    count and host seconds; none on one process). This adds one
    synchronisation per step; the loop itself fetches losses at print
    points."""

    def __init__(self, torch, system_cls):
        self.torch, self.cls = torch, system_cls
        self.orig = system_cls.train_step
        self.times, self.losses, self.collectives = [], [], []

    def __enter__(self):
        from vae2_tpu_torch.parallel import sync

        rec = self

        def step(system, *args, **kwargs):
            sync.reset_stats()
            metrics, preds = rec.orig(system, *args, **kwargs)
            rec.torch.cuda.synchronize()
            rec.times.append(time.perf_counter())
            rec.collectives.append(dict(sync.STATS))
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


# The legs of a kernel-vs-plain step (phases 12 and 17): (name, every
# fused-ABN kernel swapped for its plain version, f32 with TF32 off). The
# second kernel leg is the control: the kernel path against itself, from
# cuDNN's nondeterministic backward and the atomics of the upsample
# backward.
LEGS = (("kernel", False, False), ("plain", True, False),
        ("control", False, False), ("kernel_f32", False, True),
        ("plain_f32", True, True))
# The bf16 kernel-vs-plain update gap is held to GAP_FACTOR times the larger
# of the control and the f32 kernel-vs-plain gap, and the f32 gap alone to
# F32_GAP_BOUND. On the H100 the bf16 gap came out at 0.87-1.01x the
# control over 6 pairs (3.2-4.0% against 3.6-4.3%), and the f32 gap at
# 2.6e-6 to 4.6e-6 (PERF.md).
GAP_FACTOR = 2.0
F32_GAP_BOUND = 5e-5


def l2_gap(a, b) -> float:
    """|a - b|_2 / |b|_2 over the tensors of two dicts with b's keys."""
    d2 = sum(float(((a[k].float() - b[k].float()) ** 2).sum()) for k in b)
    w2 = sum(float((b[k].float() ** 2).sum()) for k in b)
    return (d2 / w2) ** 0.5


def run_legs(torch, step):
    """``step(f32)`` -> (losses, update) in each of LEGS; the plain legs
    must launch no kernel. Returns {leg: (losses, update)}."""
    from vae2_tpu_torch.ops import abn
    from vae2_tpu_torch.utils.device import exact_f32

    out = {}
    for leg, plain, f32 in LEGS:
        before = read_counts()
        with contextlib.ExitStack() as stack:
            if plain:
                for k in PATH_FNS:
                    stack.enter_context(unittest.mock.patch.object(
                        abn, k, getattr(abn, f"{k}_plain")))
            if f32:
                stack.enter_context(exact_f32())
            out[leg] = step(f32)
            torch.cuda.synchronize()
        if plain and read_counts() != before:
            raise AssertionError(f"the {leg} step launched a kernel")
        torch.cuda.empty_cache()
    return out


def leg_gaps(legs) -> dict:
    """The losses' largest relative error kernel vs plain in each dtype
    (rtol 1e-3: forward values, where kernel 1 and its plain version round
    alike) and the update gaps, each bounded."""
    errs = {}
    for k, p in (("kernel", "plain"), ("kernel_f32", "plain_f32")):
        mk, mp = legs[k][0], legs[p][0]
        errs[k] = max(abs(mk[n] - mp[n]) / (abs(mp[n]) + 1e-6) for n in mp)
        if not errs[k] <= 1e-3 or not all(map(math.isfinite, mk.values())):
            raise AssertionError(f"{k} vs {p} losses: {errs[k]} {mk} {mp}")
    bf16 = l2_gap(legs["kernel"][1], legs["plain"][1])
    control = l2_gap(legs["kernel"][1], legs["control"][1])
    f32 = l2_gap(legs["kernel_f32"][1], legs["plain_f32"][1])
    bound = GAP_FACTOR * max(control, f32)
    if not (bf16 <= bound and f32 <= F32_GAP_BOUND):
        raise AssertionError(f"update gaps: bf16 {bf16} (bound {bound}), "
                             f"control {control}, f32 {f32} (bound "
                             f"{F32_GAP_BOUND})")
    return {"loss_max_rel_err": errs["kernel"],
            "loss_max_rel_err_f32": errs["kernel_f32"], "loss_rtol": 1e-3,
            "update_l2_gap_bf16": bf16, "update_l2_gap_control": control,
            "update_l2_gap_f32": f32, "control_deterministic": control == 0,
            "gap_factor": GAP_FACTOR, "bf16_gap_bound": bound,
            "f32_gap_bound": F32_GAP_BOUND}


def train_plain_path(torch, opts, device):
    """One flagship step of the recipe (SGD, ``opts``) in each of LEGS, on
    the same weights, clips and noise: the losses and the encdec update's
    L2 gaps, bounded (``leg_gaps``). Returns (phase line, the one-rank
    reference of the DDP step: the bf16 and f32 kernel legs' (losses,
    update) on the CPU and the control's gap)."""
    from vae2_tpu_torch.core.builder import build_system

    batch = first_batch(train_config(opts), device, torch)

    def step(f32):
        config = train_config([*opts, "GPU.DTYPE", "float32"] if f32 else opts)
        system = build_system(config, seed=0, device=device, train=True)
        init = {k: v.detach().clone() for k, v in
                system.modules["encdec"].state_dict().items()}
        m, _ = system.train_step(batch, torch.Generator(
            device=device).manual_seed(3))
        upd = {k: (v - init[k]).float().cpu() for k, v in
               system.modules["encdec"].state_dict().items()
               if "running_" not in k}
        return {k: float(v) for k, v in m.items()}, upd

    legs = run_legs(torch, step)
    gaps = leg_gaps(legs)
    return ({"phase": "train_plain_path", **gaps,
             "losses": legs["kernel"][0]},
            {"bfloat16": legs["kernel"], "float32": legs["kernel_f32"]})


# ---- data-parallel training: two gloo ranks on one card ----------------------

# the DDP train CLI's epoch: the first 24 clips of data/synthetic64's train
# list, a global batch of 8 (4 per rank), 3 steps
DDP_CLIPS = 24
DDP_STEPS_PER_EPOCH = 3


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def flagship_step(torch, device, dtype, rows=None, scale=1.0):
    """One flagship step of the recipe (SGD, as phase 12) in ``dtype`` (f32
    with TF32 off) on phase 12's 8 clips, or on ``rows`` of them in a
    multi-rank run, with the generator of phase 12 (seed 3), whose draws are
    the global batch's; ``scale`` multiplies the normalized clips (a
    control's one-ulp move). Counted: kernel launches, all-reduces and
    their host seconds, the step's seconds and peak memory; returns those,
    the losses and, on the CPU, the encdec update and the whole state."""
    from vae2_tpu_torch.core.builder import build_system
    from vae2_tpu_torch.data.loader import normalize_clips
    from vae2_tpu_torch.parallel import sync
    from vae2_tpu_torch.tools.ddp_check import model_train_collectives
    from vae2_tpu_torch.utils.device import exact_f32

    batch = first_batch(train_config(SGD_OPTS), device, torch)
    if rows is not None:
        batch = {k: v[rows] for k, v in batch.items()}
    if scale != 1.0:
        batch = {k: normalize_clips(v) * scale for k, v in batch.items()}
    f32 = dtype == "float32"
    config = train_config([
        *SGD_OPTS, "GPU.DTYPE", dtype, "TRAIN.BATCH_SIZE_PER_GPU",
        str(next(iter(batch.values())).shape[0])])
    system = build_system(config, seed=0, device=device, train=True)
    init = {k: v.detach().clone() for k, v in
            system.modules["encdec"].state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    sync.reset_stats()
    t0 = time.perf_counter()
    with exact_f32() if f32 else contextlib.nullcontext():
        m, _ = system.train_step(batch, torch.Generator(device=device)
                                 .manual_seed(3))
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out = {"losses": {k: float(v) for k, v in m.items()},
           "launches": read_counts(), "collectives": dict(sync.STATS),
           "collectives_from_model": model_train_collectives(system),
           "seconds": seconds,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "update": {k: (v - init[k]).float().cpu() for k, v in
                      system.modules["encdec"].state_dict().items()
                      if "running_" not in k},
           "state": {k: v.detach().cpu() for k, v in
                     system.modules.state_dict().items()}}
    del system
    torch.cuda.empty_cache()
    return out


def ddp_steps(torch, device, rank, fault="none"):
    """This rank's tiny steps and its rows of the flagship step, with the
    fault ``fault`` of ``ddp_check.FAULTS`` planted: "none" runs the step
    in bf16 and f32, a fault in f32 only (the leg whose update is
    bounded)."""
    from vae2_tpu_torch.tools import ddp_check

    b = int(train_config(SGD_OPTS).TRAIN.BATCH_SIZE_PER_GPU) // ddp_check.RANKS
    rows = slice(rank * b, (rank + 1) * b)
    with (contextlib.nullcontext() if fault == "none"
          else ddp_check.plant(fault)):
        return {"tiny": ddp_check.tiny_steps(device, rank, ddp_check.RANKS),
                "flagship": {dtype: flagship_step(torch, device, dtype, rows)
                             for dtype in (DDP_DTYPES if fault == "none"
                                           else ("float32",))}}


def ddp_cli_run(torch, rank, port, argv):
    """The train CLI in this rank, through its env:// set-up (torchrun's
    variables, set here), counted as run_train_cli counts it."""
    from vae2_tpu_torch.core.system import VAE2System
    from vae2_tpu_torch.tools import train
    from vae2_tpu_torch.tools.ddp_check import RANKS

    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
           "WORLD_SIZE": str(RANKS), "RANK": str(rank),
           "LOCAL_RANK": str(rank)}
    os.environ.update(env)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with StepRecorder(torch, VAE2System) as rec:
            out_dir = train.main(argv)
            torch.cuda.synchronize()
    finally:
        for k in env:
            os.environ.pop(k, None)
    return {"out_dir": out_dir, "start": rec.start, "times": rec.times,
            "losses": rec.losses, "collectives": rec.collectives,
            "launches": read_counts(),
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}


def ddp_worker(rank, device, ports, workdir, argv):
    """Rank ``rank`` of ``ddp_check.RANKS`` ``gloo`` ranks, all on
    ``device``: in a group of its own the tiny steps and the flagship step,
    clean ("none") and with each fault of ``ddp_check.FAULTS`` planted; then
    the train CLI for one epoch and a resumed second, each in the group it
    sets up. Saves what it saw as ddp_rank<rank>.pt in ``workdir``."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from vae2_tpu_torch.tools.ddp_check import FAULTS, RANKS

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{ports[0]}",
                            rank=rank, world_size=RANKS,
                            timeout=datetime.timedelta(minutes=5))
    try:
        out = {"steps": {f: ddp_steps(torch, device, rank, f)
                         for f in ("none", *FAULTS)}}
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    out["cli"] = [ddp_cli_run(torch, rank, ports[1], [
        *argv, "TRAIN.END_EPOCH", "1"])]
    out["cli"].append(ddp_cli_run(torch, rank, ports[2], [
        *argv, "TRAIN.END_EPOCH", "2", "TRAIN.RESUME", "True"]))
    torch.save(out, os.path.join(workdir, f"ddp_rank{rank}.pt"))


# The two-rank flagship step runs in each dtype beside one rank's step on
# clips moved by one ulp of that dtype (the control): in bf16 the step's
# convolutions round per sample, and their rounding depends on the batch
# each rank runs, so the bf16 control moves the input by one bf16 ulp; the
# f32 control by one f32 ulp
DDP_DTYPES = ("bfloat16", "float32")
ULP = {"bfloat16": 2.0**-7, "float32": 2.0**-23}
LOSS_RTOL = {"bfloat16": 1e-3, "float32": 1e-4}
# Two ranks' f32 update is held to DDP_GAP_FACTOR x max(its one-ulp
# control, F32_DDP_FLOOR), F32_DDP_FLOOR being the gap of a step whose
# arithmetic is the same up to rounding. The factor is set from phase 21 on
# the H100 (PERF.md): clean runs read at most 1.14x their control (0.81x
# here: 5.06% against 6.26%), the planted faults 1.83x to 24x (the local
# kernel-2 sums 11.45%, the ReLU-BN gradient 14.6%, no /R 101%, local
# statistics 149%)
DDP_GAP_FACTOR = 1.5
F32_DDP_FLOOR = 5e-5


def ddp_step_line(torch, flagship, reference, controls) -> dict:
    """Phase 19: the ranks' flagship steps (``flagship``: per rank, per
    dtype) against one rank of the 8 clips (``reference``: per dtype, its
    losses and encdec update), in each dtype it holds (bf16, and f32 with
    TF32 off). Per dtype:
    the losses averaged over the ranks within LOSS_RTOL, the ranks bitwise
    equal, per rank 1670/850/850 launches and the model's all-reduces; in
    f32 the encdec update's L2 gap within DDP_GAP_FACTOR x max(the one-ulp
    control's gap, F32_DDP_FLOOR). The bf16 update gap is a reading only:
    a one-bf16-ulp move of the clips moves this random network's update by
    as much as the whole of it (138%, PERF.md), so no bound on it could
    fail. Returns the readings and ``failed``, the checks that did not
    hold."""
    from vae2_tpu_torch.tools.ddp_check import RANKS

    want = {"abn_rows": EXPECTED_FWD_PER_STEP,
            "abn_bwd_sums": EXPECTED_BWD_PER_STEP,
            "abn_bwd_dx": EXPECTED_BWD_PER_STEP}
    per_rank = int(train_config(SGD_OPTS).TRAIN.BATCH_SIZE_PER_GPU) // RANKS
    line, failed = {"ranks": RANKS, "batch_per_rank": per_rank}, []
    for dtype in flagship[0]:
        fl = [f[dtype] for f in flagship]
        one_losses, one_update = reference[dtype]
        control_gap = l2_gap(controls[dtype]["update"], one_update)
        loss_err = max(abs(sum(f["losses"][k] for f in fl) / len(fl) - w)
                       / (abs(w) + 1e-6) for k, w in one_losses.items())
        gap = l2_gap(fl[0]["update"], one_update)
        a, b = (f["state"] for f in fl)
        equal = all(torch.equal(a[k], b[k]) for k in a)
        derived = fl[0]["collectives_from_model"]
        counted = all(f["launches"] == want and f["collectives"]["all_reduces"]
                      == derived for f in fl)
        bound = (DDP_GAP_FACTOR * max(control_gap, F32_DDP_FLOOR)
                 if dtype == "float32" else None)
        failed += [f"{dtype} {what}" for what, ok in (
            ("losses", loss_err <= LOSS_RTOL[dtype]),
            ("update", bound is None or gap <= bound), ("bitwise", equal),
            ("counts", counted)) if not ok]
        line[dtype] = {
            "loss_max_rel_err": loss_err, "loss_rtol": LOSS_RTOL[dtype],
            "update_l2_gap": gap, "control_gap": control_gap,
            "gap_bound": bound, "ranks_bitwise_equal": equal,
            "launches_per_rank": [f["launches"] for f in fl],
            "all_reduces_per_rank": [f["collectives"]["all_reduces"]
                                     for f in fl],
            "all_reduces_from_model": derived,
            "all_reduce_seconds": [f["collectives"]["seconds"] for f in fl],
            "step_seconds": [f["seconds"] for f in fl],
            "one_rank_step_seconds": controls[dtype]["seconds"],
            "peak_memory_gib": [f["peak_memory_gib"] for f in fl],
            "one_rank_peak_memory_gib": controls[dtype]["peak_memory_gib"]}
    line["expected_launches"] = want
    line["failed"] = failed
    return line


def ddp_cli_line(torch, ranks, spawn_s) -> dict:
    """Phase 20: the two ranks' train CLI, one epoch and a resumed one."""
    runs = [[r["cli"][i] for r in ranks] for i in range(2)]
    derived = ranks[0]["steps"]["none"]["flagship"]["bfloat16"][
        "collectives_from_model"]
    per_epoch = {"abn_rows": EXPECTED_FWD_PER_STEP * DDP_STEPS_PER_EPOCH,
                 "abn_bwd_sums": EXPECTED_BWD_PER_STEP * DDP_STEPS_PER_EPOCH,
                 "abn_bwd_dx": EXPECTED_BWD_PER_STEP * DDP_STEPS_PER_EPOCH}

    def steady(c):
        return (len(c["times"]) - 1) / (c["times"][-1] - c["times"][0])

    global_batch = 8
    from vae2_tpu_torch.tools.ddp_check import RANKS

    line = {"ranks": RANKS, "steps_per_epoch": DDP_STEPS_PER_EPOCH,
            "global_batch": global_batch,
            "steps_per_s": [steady(c) for c in runs[0]],
            "clips_per_s": [steady(c) * global_batch for c in runs[0]],
            "resumed_steps_per_s": [steady(c) for c in runs[1]],
            "first_step_s_with_setup": [c["times"][0] - c["start"]
                                        for c in runs[0]],
            "peak_memory_gib": [max(a["peak_memory_gib"], b["peak_memory_gib"])
                                for a, b in zip(*runs)],
            "launches_per_rank_per_epoch": runs[0][0]["launches"],
            "launches_per_rank_per_step": {
                k: v // DDP_STEPS_PER_EPOCH
                for k, v in runs[0][0]["launches"].items()},
            "all_reduces_per_step": [[s["all_reduces"] for s in c["collectives"]]
                                     for c in runs[0]],
            "all_reduce_seconds_per_step": [
                [s["seconds"] for s in c["collectives"]] for c in runs[0]],
            "losses_first_rank0": runs[0][0]["losses"][0],
            "losses_last_rank0": runs[1][0]["losses"][-1],
            "spawn_seconds": spawn_s}
    bad = [f"run {i} rank {r}" for i, run in enumerate(runs)
           for r, c in enumerate(run)
           if len(c["times"]) != DDP_STEPS_PER_EPOCH
           or c["launches"] != per_epoch
           or any(s["all_reduces"] != derived for s in c["collectives"])
           or not all(math.isfinite(v) for m in c["losses"]
                      for v in m.values())]
    out_dir = runs[0][0]["out_dir"]
    ckpt = torch.load(os.path.join(out_dir, "checkpoint.pt"),
                      map_location="cpu", weights_only=True)
    log = "".join(open(p).read() for p in glob.glob(
        os.path.join(out_dir, "*_train.log")))
    line["resumed"] = (ckpt["epoch"] == 2
                       and "=> loaded checkpoint (epoch 1)" in log)
    if (bad or not line["resumed"] or "rank 1 of" in log or not glob.glob(
            os.path.join(out_dir, "vis", "epoch1", "*", "*.png"))):
        raise AssertionError(f"DDP CLI: {bad}, checkpoint epoch "
                             f"{ckpt['epoch']}, rank 0's log or vis/: {line}")
    line["failed"] = []
    return line


def fault_line(torch, device, ranks, one, control, reference,
               controls) -> dict:
    """Phase 21: phases 18 and 19 (the f32 leg) once more for each fault of
    ``ddp_check.FAULTS`` planted in the ranks: the checks that each fails
    and their readings. ``failed`` lists the faults that phase 18 or
    phase 19 let through."""
    from vae2_tpu_torch.tools import ddp_check

    line = {"caught_by": {}, "readings": {}}
    for fault in ddp_check.FAULTS:
        steps = [r["steps"][fault] for r in ranks]
        tiny = ddp_check.check_tiny([s["tiny"] for s in steps], one, control,
                                    device)
        step = ddp_step_line(torch, [s["flagship"] for s in steps],
                             reference, controls)
        line["caught_by"][fault] = {"train_ddp_reference": tiny["failed"],
                                    "train_ddp_step": step["failed"]}
        line["readings"][fault] = {
            "tiny_loss_max_rel_err": tiny["loss_max_rel_err"],
            "tiny_grads": tiny["gaps_vs_control"]["grads"]["rank0"],
            **{f"step_{k}": step["float32"][k] for k in (
                "loss_max_rel_err", "update_l2_gap", "gap_bound",
                "ranks_bitwise_equal")}}
    line["failed"] = [f for f, c in line["caught_by"].items()
                      if not (c["train_ddp_reference"] and c["train_ddp_step"])]
    return line


def train_ddp(torch, device, workdir, reference, smi):
    """Phases 18-21: ``ddp_check.RANKS`` gloo ranks on this one card
    (spawned), held against one rank: the tiny f32 steps, the flagship
    step, the train CLI's epochs, and the first two again with each planted
    fault, each of which both must catch. Each phase's line is printed
    before the run fails on any of them. Returns phase 20's line."""
    from vae2_tpu_torch.tools import ddp_check
    from vae2_tpu_torch.utils.device import exact_f32

    with exact_f32():
        one = ddp_check.tiny_steps(device, 0, 1)
        control = ddp_check.tiny_steps(device, 0, 1, perturb=True)
    controls = {dtype: flagship_step(torch, device, dtype,
                                     scale=1.0 + ULP[dtype])
                for dtype in DDP_DTYPES}
    lst = os.path.join(workdir, f"train{DDP_CLIPS}.txt")
    with open(os.path.join(DATA, "train_list.txt")) as f:
        lines = [line for line in f if line.strip()][:DDP_CLIPS]
    with open(lst, "w") as f:
        f.writelines(lines)
    out = os.path.join(workdir, "ddp_out")
    argv = ["--cfg", TRAIN_CFG, "--seed", "0", "--device", str(device),
            "OUTPUT_DIR", out, "LOG_DIR", os.path.join(workdir, "ddp_log"),
            *TRAIN_OPTS, "DATASET.TRAIN_SET", lst, "GPU.DIST_BACKEND", "gloo",
            "TRAIN.BATCH_SIZE_PER_GPU", str(8 // ddp_check.RANKS)]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    torch.multiprocessing.spawn(ddp_worker, args=(
        str(device), [free_port() for _ in range(3)], workdir, argv),
        nprocs=ddp_check.RANKS)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(workdir, f"ddp_rank{r}.pt"),
                        weights_only=True) for r in range(ddp_check.RANKS)]
    clean = [r["steps"]["none"] for r in ranks]

    phases = (
        ("train_ddp_reference", lambda: {
            "ranks": ddp_check.RANKS, **ddp_check.check_tiny(
                [c["tiny"] for c in clean], one, control, device)}),
        ("train_ddp_step", lambda: ddp_step_line(
            torch, [c["flagship"] for c in clean], reference, controls)),
        ("train_ddp_end_to_end", lambda: ddp_cli_line(torch, ranks,
                                                      spawn_s)),
        ("train_ddp_faults", lambda: fault_line(
            torch, device, ranks, one, control, reference, controls)))
    failed, lines = [], {}
    for name, check in phases:
        try:
            lines[name] = check()
        except AssertionError as e:  # printed, and the run fails below
            lines[name] = {"failed": [str(e)]}
        if lines[name]["failed"]:
            failed.append(name)
        emit({"phase": name, **lines[name], "nvidia_smi": smi})
    if failed:
        raise AssertionError(f"failed phases: {failed}")
    return lines["train_ddp_end_to_end"]


# ---- segmentation (HRNetV2-W48) ---------------------------------------------


def one_launch_per_call(rows_by_path) -> None:
    """Fails unless every timed kernel row (per path, per kernel) made
    exactly one device launch per call."""
    launches = collections.defaultdict(set)
    for path, rows in rows_by_path.items():
        for row in rows:
            launches[row.get("kernel", path)].add(
                row["device_launches_per_call"])
    if any(v != {1} for v in launches.values()):
        raise AssertionError(f"device launches per kernel call: "
                             f"{dict(launches)}, expected 1 at every shape")


def seg_config(opts=()):
    from vae2_tpu_torch.config import get_default_config, update_config

    return update_config(get_default_config(), argparse.Namespace(
        cfg=SEG_CFG, opts=list(opts)))


def seg_data(workdir):
    """CLI options of the two seg cells: training over the tracked
    data/synthetic_seg (8 train images), testing over SEG_VAL_IMAGES
    synthetic images at the recipe's test size (2048x1024) written from
    seed 0; returns (train options, test options, seconds to write)."""
    from vae2_tpu_torch.tools.gen_seg_data import write_synthetic_seg

    root = os.path.join(workdir, "seg_val")
    t0 = time.perf_counter()
    _, val = write_synthetic_seg(root, SEG_IMAGE_W, SEG_IMAGE_H, train=0,
                                 val=SEG_VAL_IMAGES, seed=0)
    out = ["OUTPUT_DIR", os.path.join(workdir, "seg_out"),
           "LOG_DIR", os.path.join(workdir, "log"), "PRINT_FREQ", "1"]
    train = ["DATASET.ROOT", SEG_DATA,
             "DATASET.TRAIN_SET", os.path.join(SEG_DATA, "train.lst"), *out]
    test = ["DATASET.ROOT", root, "DATASET.TEST_SET", val, *out]
    return train, test, time.perf_counter() - t0


def build_seg(torch, config, device):
    """The recipe's SegHRNet from seed 0 on ``device``, its optimizer and
    its train step (CE with the Cityscapes class weights, as the CLI)."""
    from vae2_tpu_torch.core.seg_loop import make_seg_train_step
    from vae2_tpu_torch.core.system import make_optimizer
    from vae2_tpu_torch.data.segmentation import CITYSCAPES_CLASS_WEIGHTS
    from vae2_tpu_torch.models.seg_hrnet import get_seg_model

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = get_seg_model(config)
    model.to(device)
    optimizer = make_optimizer(model.parameters(), config.TRAIN)
    step = make_seg_train_step(model, optimizer,
                               ignore_label=config.TRAIN.IGNORE_LABEL,
                               class_weights=CITYSCAPES_CLASS_WEIGHTS)
    return model, step


def first_seg_batch(torch, config, device):
    """The first batch the train CLI's loader gives at seed 0, on the card."""
    from vae2_tpu_torch.data.segmentation import make_seg_dataset
    from vae2_tpu_torch.tools.train_seg import _SegBatcher

    ds = make_seg_dataset(config, config.DATASET.TRAIN_SET, train=True)
    images, labels, _, _ = next(iter(_SegBatcher(
        ds, config.TRAIN.BATCH_SIZE_PER_GPU, seed=0, device=device)))
    return images, labels


def collect_seg_shapes(torch, model, call):
    """(N, C, H, W) -> [dtype, launches, 0] of the fused-ABN kernels in
    ``call()``, read by forward pre-hooks on the model's ABN BNs (no remat:
    each training forward has one backward)."""
    seen = {}

    def hook(module, args):
        row = seen.setdefault(tuple(args[0].shape), [args[0].dtype, 0, 0])
        row[1] += 1

    handles = [m.register_forward_pre_hook(hook) for m in abn_modules(model)]
    try:
        call()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return seen


def seg_kernel_check(torch, config, device):
    """Kernels 1-3 at every shape one W48 seg train step hands them, and
    kernel 1 (inference entry) at every shape of one whole-image test
    forward (TEST.IMAGE_SIZE): checked in both dtypes with every act, then
    timed at the paths' own shapes. The hooks' launch count must equal the
    model's count of ABN BNs and EXPECTED_SEG_ABN."""
    from vae2_tpu_torch.core.seg_loop import make_infer_fn

    model, step = build_seg(torch, config, device)
    derived = len(abn_modules(model))
    images, labels = first_seg_batch(torch, config, device)
    tshapes = collect_seg_shapes(torch, model, lambda: step(images, labels))
    th, tw = config.TEST.IMAGE_SIZE[1], config.TEST.IMAGE_SIZE[0]
    image = torch.randn((1, th, tw, 3), device=device).permute(0, 3, 1, 2)
    infer = make_infer_fn(model)
    eshapes = collect_seg_shapes(torch, model, lambda: infer(image))
    del model, step, infer, images, labels, image
    torch.cuda.empty_cache()
    n_train = sum(v[1] for v in tshapes.values())
    n_test = sum(v[1] for v in eshapes.values())
    if not n_train == n_test == derived == EXPECTED_SEG_ABN:
        raise AssertionError(
            f"seg ABN launches: {n_train} per train step and {n_test} per "
            f"test forward seen by hooks, {derived} BNs in the model, "
            f"{EXPECTED_SEG_ABN} expected")
    tcheck = train_kernel_check(torch, tshapes, device)
    echeck = kernel_check(torch, {k: (v[0], v[1]) for k, v in eshapes.items()},
                          device)
    return derived, tcheck, echeck


def seg_tiny_step(torch, device):
    """One seg train step of the tiny spec in f32 (TF32 off), SGD lr 1e-2
    with momentum and WD, seeded weights and BN statistics, a fixed batch
    with ignored pixels: (loss, train-mode logits, state before, after)."""
    from vae2_tpu_torch.config import get_default_config
    from vae2_tpu_torch.core.seg_loop import make_seg_train_step
    from vae2_tpu_torch.core.system import make_optimizer
    from vae2_tpu_torch.data.segmentation import CITYSCAPES_CLASS_WEIGHTS
    from vae2_tpu_torch.models.seg_hrnet import get_seg_model
    from vae2_tpu_torch.utils.device import exact_f32

    cfg = get_default_config()
    cfg.merge_from_file(SEG_TINY_CFG)
    cfg.GPU.DTYPE = "float32"
    cfg.TRAIN.OPTIMIZER = "sgd"
    cfg.TRAIN.LR = 0.01
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = get_seg_model(cfg)
    randomize(model, torch, seed=1, conv_scale=True)
    model.to(device)
    step = make_seg_train_step(model, make_optimizer(model.parameters(),
                                                     cfg.TRAIN),
                               class_weights=CITYSCAPES_CLASS_WEIGHTS)
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    g = torch.Generator().manual_seed(4)
    images = torch.randn(2, 32, 64, 3, generator=g).permute(0, 3, 1, 2)
    labels = torch.randint(-1, 19, (2, 32, 64), generator=g)
    logits = []
    hook = model.register_forward_hook(
        lambda m, a, out: logits.append(out.detach().cpu()))
    with exact_f32():
        loss = float(step(images, labels))
    hook.remove()
    after = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return loss, logits[0], init, after


def seg_reference(torch, device):
    """The tiny seg step on the card against the CPU: loss rtol 1e-4,
    logits, updated parameters and running statistics 1e-4 * (1 + max)."""
    l_want, lg_want, init, want = seg_tiny_step(torch, "cpu")
    l_got, lg_got, _, got = seg_tiny_step(torch, device)
    torch.cuda.synchronize()
    loss_err = abs(l_got - l_want) / abs(l_want)
    if not loss_err <= 1e-4:
        raise AssertionError(f"tiny seg step loss: {l_got} vs {l_want}")

    def close(a, b):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * (1.0 + float(b.abs().max())))
        return float((a - b).abs().max())

    logit_err = close(lg_got, lg_want)
    state_err = max(close(got[k], w_) for k, w_ in want.items())
    d2 = sum(float((((got[k] - init[k]) - (w_ - init[k])) ** 2).sum())
             for k, w_ in want.items() if "running_" not in k)
    w2 = sum(float(((w_ - init[k]) ** 2).sum())
             for k, w_ in want.items() if "running_" not in k)
    return {"phase": "seg_reference", "loss": l_want,
            "loss_rel_err": loss_err, "logits_max_abs_err": logit_err,
            "state_max_abs_err": state_err,
            "update_l2_rel_err": (d2 / w2) ** 0.5,
            "tolerance": "loss rtol 1e-4; logits, parameters and running "
                         "statistics 1e-4 * (1 + max|cpu|)"}


def seg_train_end_to_end(torch, opts, derived):
    """The train_seg CLI in this process on the recipe as it stands,
    SEG_EPOCHS epochs over the synthetic set, counted per step; each step
    timed to its end on the card (one synchronisation per step added)."""
    from vae2_tpu_torch.tools import train_seg

    times, step_s, losses = [], [], []
    orig = train_seg.make_seg_train_step

    def timed_maker(*args, **kwargs):
        step = orig(*args, **kwargs)

        def timed(images, labels):
            t = time.perf_counter()
            loss = step(images, labels)
            torch.cuda.synchronize()
            now = time.perf_counter()
            step_s.append(now - t)
            times.append(now)
            losses.append(float(loss))
            return loss

        return timed

    opts = [*opts, "TRAIN.END_EPOCH", str(SEG_EPOCHS)]
    argv = ["--cfg", SEG_CFG, "--seed", "0", *opts]
    config = seg_config(opts)
    batch = int(config.TRAIN.BATCH_SIZE_PER_GPU)
    steps = SEG_EPOCHS * (SEG_TRAIN_IMAGES // batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with unittest.mock.patch.object(train_seg, "make_seg_train_step",
                                    timed_maker):
        out_dir = train_seg.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = read_counts()
    want = {k: steps * derived for k in KERNELS}
    if counts != want or len(losses) != steps:
        raise AssertionError(f"{len(losses)} seg steps, launches {counts}, "
                             f"expected {steps} steps, {want}")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"seg losses {losses}")
    ckpt = torch.load(os.path.join(out_dir, "seg_checkpoint.pt"),
                      map_location="cpu", weights_only=True)
    final = torch.load(os.path.join(out_dir, "seg_final_state.pt"),
                       map_location="cpu", weights_only=True)
    if ckpt["epoch"] != SEG_EPOCHS or "optimizer" not in ckpt or \
            final["epoch"] != SEG_EPOCHS:
        raise AssertionError("seg checkpoints: epochs "
                             f"{ckpt['epoch']}, {final['epoch']}")
    steady = (len(times) - 1) / (times[-1] - times[0])
    return {"phase": "seg_train_end_to_end", "steps": steps,
            "batch": batch, "crop": list(config.TRAIN.IMAGE_SIZE),
            "dtype": config.TPU.DTYPE, "optimizer": config.TRAIN.OPTIMIZER,
            "lr": config.TRAIN.LR, "cli_seconds": cli_s,
            "first_step_s_with_setup": times[0] - t0,
            "steps_per_s": steady, "images_per_s": steady * batch,
            "step_seconds": step_s,
            # the host's batch (PNG decode, crop resize, normalize) before
            # each step after the first
            "loader_seconds": [b - a - s for a, b, s in
                               zip(times, times[1:], step_s[1:])],
            "steps_per_s_step_alone": 1.0 / min(step_s[1:]),
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": counts,
            "launches_per_step": {k: v // steps for k, v in counts.items()},
            "launches_per_step_from_model": derived,
            "losses": losses}, out_dir


def seg_test_end_to_end(torch, opts, out_dir, derived, device):
    """The test CLI on the train run's seg_final_state.pt at TEST.IMAGE_SIZE
    (2048x1024) over the synthetic val images, counted; then the forward
    alone (make_infer_fn) on one image."""
    from vae2_tpu_torch.core.seg_loop import make_infer_fn
    from vae2_tpu_torch.models.seg_hrnet import get_seg_model
    from vae2_tpu_torch.tools import test as test_cli
    from vae2_tpu_torch.utils.checkpoint import load_checkpoint

    final = os.path.join(out_dir, "seg_final_state.pt")
    opts = [*opts, "TEST.MODEL_FILE", final]
    argv = ["--cfg", SEG_CFG, *opts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    result = test_cli.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts()
    want = {"abn_rows": SEG_VAL_IMAGES * derived, "abn_bwd_sums": 0,
            "abn_bwd_dx": 0}
    if counts != want:
        raise AssertionError(f"seg test launches {counts}, expected {want}")
    if result is None or not all(map(math.isfinite, result)):
        raise AssertionError(f"seg test metrics {result}")

    config = seg_config(opts)
    model = get_seg_model(config)
    model.load_state_dict(load_checkpoint(final)[0], strict=True)
    model.to(device)
    infer = make_infer_fn(model)
    th, tw = config.TEST.IMAGE_SIZE[1], config.TEST.IMAGE_SIZE[0]
    image = torch.randn((1, th, tw, 3), device=device).permute(0, 3, 1, 2)
    infer(image)
    torch.cuda.synchronize()
    reps = 5
    t1 = time.perf_counter()
    for _ in range(reps):
        out = infer(image)
    torch.cuda.synchronize()
    fwd_s = (time.perf_counter() - t1) / reps
    if out.shape != (1, config.DATASET.NUM_CLASSES, th, tw) or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError(f"seg test logits {tuple(out.shape)}")
    miou, pixel_acc, mean_acc = result
    return {"phase": "seg_test_end_to_end", "images": SEG_VAL_IMAGES,
            "image_size": list(config.TEST.IMAGE_SIZE),
            "mean_iou": miou, "pixel_acc": pixel_acc, "mean_acc": mean_acc,
            "cli_seconds": cli_s, "cli_images_per_s": SEG_VAL_IMAGES / cli_s,
            "forward_ms": fwd_s * 1e3, "forward_images_per_s": 1.0 / fwd_s,
            "peak_memory_gib": peak / 2**30, "launches": counts,
            "abn_launches_per_image": counts["abn_rows"] // SEG_VAL_IMAGES}


def seg_plain_path(torch, opts, device):
    """One W48 seg step (the recipe with ``opts``) in each of LEGS, on the
    same weights and batch: the loss and the update's L2 gaps, bounded
    (``leg_gaps``)."""
    images, labels = first_seg_batch(torch, seg_config(opts), device)

    def step(f32):
        config = seg_config([*opts, "GPU.DTYPE", "float32"] if f32 else opts)
        model, run = build_seg(torch, config, device)
        init = {k: v.detach().clone() for k, v in model.state_dict().items()}
        loss = float(run(images, labels))
        upd = {k: (v - init[k]).float().cpu() for k, v in
               model.state_dict().items() if "running_" not in k}
        return {"loss": loss}, upd

    legs = run_legs(torch, step)
    return {"phase": "seg_plain_path", **leg_gaps(legs),
            "loss": legs["kernel"][0]["loss"],
            "plain_loss": legs["plain"][0]["loss"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from vae2_tpu_torch.config import get_default_config, update_config
    from vae2_tpu_torch.core.builder import build_system
    from vae2_tpu_torch.core.infer_loop import (make_momentum_sampler,
                                                make_prior_sampler)
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
    shapes = collect_shapes(torch, system.modules["encdec"],
                            lambda g: sampler(xt, x2t, g), device)
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

        # ---- the paper's evaluation: momentum sampling, FID, IS -------------
        # conv kernels of fan-in scale and BNs calibrated on the data, so
        # that the frames differ from one sample to the next and FID and IS
        # have something to measure
        randomize(system.modules, torch, seed=2, conv_scale=True)
        msampler = make_momentum_sampler(system, chunk)
        window = first_window(config, device, torch)
        calibrate_bn(torch, system.modules, lambda g: msampler(*window, g),
                     device)
        mshapes = collect_shapes(torch, system.modules["encz"],
                                 lambda g: msampler(*window, g), device)
        n_post = sum(c for _, c in mshapes.values())
        if n_post != EXPECTED_ABN_PER_MOMENTUM_CALL - EXPECTED_ABN_PER_SAMPLE:
            raise AssertionError(f"{n_post} posterior kernel launches seen "
                                 f"by hooks in one momentum call")
        mcheck = kernel_check(torch, mshapes, device)
        emit({"phase": "momentum_kernel_check", "cases": mcheck["cases"],
              "max_abs_err": mcheck["max_abs_err"],
              "none_leaky_bit_exact": mcheck["none_leaky_bit_exact"],
              "posterior_launches_per_call": n_post,
              "per_call": mcheck["per_sample"], "nvidia_smi": smi})
        for row in mcheck["shapes"]:
            emit({"phase": "momentum_kernel_shape", **row})
        me2e, mout = momentum_end_to_end(torch, system, config, msampler,
                                         window, device, workdir)
        emit({**me2e, "nvidia_smi": smi})
        del system, sampler, msampler, window
        torch.cuda.empty_cache()
        per_set = me2e["tree_files"]["predicted_pngs"] // 2  # x2t, x3t
        emit({**eval_fid_is(torch, mout, per_set, device), "nvidia_smi": smi})
        torch.cuda.empty_cache()

        # ---- adversarial training ------------------------------------------
        sgd = train_config(SGD_OPTS)
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
        one_launch_per_call({"abn_rows_inference": check["shapes"],
                             "abn_rows_posterior": mcheck["shapes"],
                             "train": tcheck["shapes"]})
        emit({"phase": "train_reference", **train_reference(torch, device)})
        te2e = train_end_to_end(torch, workdir)
        emit({**te2e, "nvidia_smi": smi})
        plain_line, reference = train_plain_path(torch, SGD_OPTS, device)
        emit({**plain_line, "nvidia_smi": smi})
        torch.cuda.empty_cache()

        # ---- segmentation: HRNetV2-W48 -------------------------------------
        seg_train_opts, seg_test_opts, data_s = seg_data(workdir)
        scfg = seg_config(seg_train_opts)
        derived, scheck, echeck = seg_kernel_check(torch, scfg, device)
        emit({"phase": "seg_kernel_check", "data_seconds": data_s,
              "cases": scheck["cases"], "test_cases": echeck["cases"],
              "max_abs_err": scheck["max_abs_err"],
              "test_max_abs_err": echeck["max_abs_err"],
              "none_leaky_bit_exact": (scheck["none_leaky_bit_exact"]
                                       and echeck["none_leaky_bit_exact"]),
              "launches_per_step": {k: derived for k in KERNELS},
              "abn_launches_per_test_image": derived,
              "per_step": scheck["per_step"],
              "per_test_image": echeck["per_sample"], "nvidia_smi": smi})
        for row in scheck["shapes"]:
            emit({"phase": "seg_kernel_shape", **row})
        for row in echeck["shapes"]:
            emit({"phase": "seg_test_kernel_shape", **row})
        one_launch_per_call({"seg_train": scheck["shapes"],
                             "abn_rows_seg_test": echeck["shapes"]})
        emit({**seg_reference(torch, device), "nvidia_smi": smi})
        se2e, seg_out = seg_train_end_to_end(torch, seg_train_opts, derived)
        emit({**se2e, "nvidia_smi": smi})
        torch.cuda.empty_cache()
        st2e = seg_test_end_to_end(torch, seg_test_opts, seg_out, derived,
                                   device)
        emit({**st2e, "nvidia_smi": smi})
        torch.cuda.empty_cache()
        emit({**seg_plain_path(torch, seg_train_opts, device),
              "nvidia_smi": smi})
        torch.cuda.empty_cache()

        # ---- data-parallel training: two gloo ranks on this card -----------
        ddp_e2e = train_ddp(torch, device, workdir, reference, smi)
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
                                    check["max_abs_err"],
                                    mcheck["max_abs_err"],
                                    scheck["max_abs_err"]["abn_rows"],
                                    echeck["max_abs_err"])
    for kern, (k, _) in zip(kernels, sources.items()):
        if k != "abn_rows":
            kern["max_abs_err"] = max(kern["max_abs_err"],
                                      scheck["max_abs_err"][k])
            kern["launches_by_path"] = {
                "train_epoch": kern["launches"],
                "seg_train": se2e["launches"][k], "seg_test": 0,
                "train_ddp": ddp_e2e["launches_per_rank_per_epoch"][k]}
        p = scheck["per_step"][k]
        kern["seg_step"] = {
            "launches_per_step": se2e["launches_per_step"][k],
            "ms": p["ms"], "plain_ms": p["plain_ms"],
            "bound_ms": p["bound_ms"],
            "library_ms": None if p.get("library_missing") else
            p["library_ms"],
            "device_ms": p["device_ms"], "device_call_ms": p["device_call_ms"],
            "device_launches_per_call": p["device_launches_per_call"],
            "timed_as": "the launches of one W48 seg train step (batch 3, "
                        "1024x512 crops), bf16, act none"}
    kernels[0]["launches_by_path"] = {"inference": e2e["launches"],
                                      "momentum": me2e["launches"],
                                      "train_epoch": kernels[0]["launches"],
                                      "seg_train": se2e["launches"]["abn_rows"],
                                      "seg_test": st2e["launches"]["abn_rows"],
                                      "train_ddp": ddp_e2e[
                                          "launches_per_rank_per_epoch"][
                                          "abn_rows"]}
    seg_test = echeck["per_sample"]
    kernels[0]["seg_test"] = {
        "launches_per_image": st2e["abn_launches_per_image"],
        "ms": seg_test["ms"], "plain_ms": seg_test["plain_ms"],
        "bound_ms": seg_test["bound_ms"],
        "library_ms": seg_test.get("library_ms"),
        "device_ms": seg_test["device_ms"],
        "device_call_ms": seg_test["device_call_ms"],
        "device_launches_per_call": seg_test["device_launches_per_call"],
        "timed_as": "the launches of one 2048x1024 W48 test forward, bf16, "
                    "act none"}
    kernels[0]["inference"] = {
        "launches_per_sample": e2e["launches_per_sample"],
        "ms": inf["ms"], "plain_ms": inf["plain_ms"],
        "bound_ms": inf["bound_ms"], "library_ms": inf.get("library_ms"),
        "addcmul_ms": inf["addcmul_ms"], "device_ms": inf["device_ms"],
        "device_call_ms": inf["device_call_ms"],
        "device_launches_per_call": inf["device_launches_per_call"],
        "profiled_launches_per_call": inf["profiled_launches_per_call"],
        "timed_as": "one sampling call's launches, bf16, act none"}
    mom = mcheck["per_sample"]
    kernels[0]["momentum_posterior"] = {
        "launches_per_call": me2e["launches_per_call"],
        "posterior_launches_per_call": n_post,
        "ms": mom["ms"], "plain_ms": mom["plain_ms"],
        "bound_ms": mom["bound_ms"], "library_ms": mom.get("library_ms"),
        "addcmul_ms": mom["addcmul_ms"], "device_ms": mom["device_ms"],
        "device_call_ms": mom["device_call_ms"],
        "device_launches_per_call": mom["device_launches_per_call"],
        "profiled_launches_per_call": mom["profiled_launches_per_call"],
        "timed_as": "the posterior's launches of one momentum call (batch "
                    "1), bf16, act none; the rest of the call is "
                    "'inference'"}
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
