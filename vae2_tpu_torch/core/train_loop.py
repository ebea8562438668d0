"""Epoch-level adversarial training loop and the frame dumps (counterpart of
``vae2_tpu/core/train_loop.py``; reference lib/core/function.py:443-604).

Host-side orchestration around ``VAE2System.train_step``: iterate the
loader, log the ten loss components every PRINT_FREQ (and to TensorBoard
when a writer is given), and dump the last batch's frames at epoch end.
Each print line also gives the mean host ms inside a step and the GC pause
ms a step since the last print (``Host_ms``, ``GC_ms``: the step records of
``utils/spans.py``), which say whether the run is host-bound and whether
Python's garbage collector is why; TensorBoard also gets every counter of
``spans.counters()`` as ``counters/<name>``.
Losses leave the device only at print points (and, with DEBUG.DEBUG, at
every step for the NaN/Inf check), so the host does not wait on the card
mid-epoch. ``TPU.PROFILE_DIR`` traces steps [2, 2 + PROFILE_STEPS) of
epoch 0 with ``torch.profiler`` into a Chrome trace there.

In a multi-process run the losses of a print point are summed over the
spatial group and averaged over the data shards (at print points only), so
the log shows the global batch's losses as the JAX loop logs them; only
rank 0 logs, writes TensorBoard, traces and dumps ``vis/`` (whole frames,
gathered from its spatial group's rows).
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Iterable, Optional

import numpy as np
import torch

from ..data.video import IMAGENET_MEAN, IMAGENET_STD
from ..parallel import sync
from ..utils import spans
from ..utils.logging import AverageMeter
from ..utils.schedule import dynamic_coeff

logger = logging.getLogger("vae2_tpu_torch")

_G_TERMS = ("loss_xt_recon", "loss_x2t_recon", "loss_x3t_recon", "loss_z_KL",
            "loss_x2t_gan_sequence", "loss_x2t_gan_frame")


def denormalize_to_uint8(x: np.ndarray) -> np.ndarray:
    """(H, W, 3) normalized float -> uint8 image (reference function.py:555-566)."""
    x = x * IMAGENET_STD + IMAGENET_MEAN
    x = np.clip(x * 255.0, 0, 255)
    return x.astype(np.uint8)


def save_frames_png(clip: np.ndarray, save_path: str, prefix: str) -> None:
    """Save each 3-channel frame of an (H, W, 3F) clip as a PNG.

    Accepts either raw uint8 frames (the loader's on-host format) or
    normalized float frames (model predictions), which get denormalized.
    """
    from PIL import Image

    os.makedirs(save_path, exist_ok=True)
    num_frames = clip.shape[-1] // 3
    for f in range(num_frames):
        fr = clip[..., f * 3: f * 3 + 3]
        im = fr if fr.dtype == np.uint8 else denormalize_to_uint8(
            fr.astype(np.float32))
        Image.fromarray(np.ascontiguousarray(im)).save(
            os.path.join(save_path, f"{prefix}_{f}.png"))


def _start_profile():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _global_metrics(metrics) -> dict:
    """The step's losses as floats of the global batch: each spatial rank's
    are the part that its rows give, so they are summed over the spatial
    group, then averaged over the data shards."""
    keys = sorted(metrics)
    vals = torch.stack([metrics[k].float() for k in keys])
    if sync.world_size() > 1:
        vals = sync.spatial_sum(vals)
        vals = sync.all_reduce_(vals, sync.data_group()) / sync.data_size()
    return dict(zip(keys, vals.tolist()))


def adversarial_train(config, epoch: int, num_epoch: int, system,
                      loader: Iterable, generator: Optional[torch.Generator],
                      writer_dict: Optional[dict] = None,
                      final_output_dir: str = "",
                      use_multiplier: bool = False) -> None:
    """Run one adversarial epoch over ``loader`` (batches of uint8 clips on
    the system's device, as ``DevicePrefetcher`` yields them); the system's
    networks and optimizers update in place."""
    batch_time = AverageMeter()
    ave_loss_d = AverageMeter()
    ave_loss_encdec = AverageMeter()
    multiplier = (dynamic_coeff(max_iters=num_epoch, cur_iters=epoch)
                  if use_multiplier else 1.0)
    # the reference asserts NaN/Inf every step (utils.py:63-65)
    anomaly_check = bool(config.DEBUG.DEBUG)
    main_rank = sync.rank() == 0
    profile_dir = (str(config.TPU.get("PROFILE_DIR", ""))
                   if epoch == 0 and main_rank else "")
    profile_steps = int(config.TPU.get("PROFILE_STEPS", 5))
    prof = None
    epoch_iters = len(loader) if hasattr(loader, "__len__") else 0
    system.modules.train()

    tic = time.time()
    mark = spans.recorded()
    last = None
    for i_iter, (batch, names) in enumerate(spans.waited(loader)):
        if profile_dir and i_iter == 2:
            prof = _start_profile()
        metrics, preds = system.train_step(batch, generator, multiplier)
        last = (batch, preds, names)
        if prof is not None and i_iter == 1 + profile_steps:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            os.makedirs(profile_dir, exist_ok=True)
            path = os.path.join(profile_dir, f"train_steps_2_{2 + profile_steps}"
                                ".json")
            prof.export_chrome_trace(path)
            logger.info("profiler trace written to %s", path)
            prof, profile_dir = None, ""
        if anomaly_check:
            bad = {k: float(v) for k, v in metrics.items()
                   if not math.isfinite(float(v))}
            if bad:
                raise FloatingPointError(
                    f"NaN/Inf losses at iter {i_iter}: {bad}")

        batch_time.update(time.time() - tic)
        tic = time.time()

        if i_iter % config.PRINT_FREQ == 0:
            with spans.span("loop.readback"):
                m = _global_metrics(metrics)
            host_ms, gc_ms = spans.step_costs_ms(mark)
            mark = spans.recorded()
            if not main_rank:
                continue
            ave_loss_d.update(m["loss_D"])
            ave_loss_encdec.update(m["loss_encdec"])
            logger.info(
                "Epoch: [{}/{}] Iter:[{}/{}], Time: {:.2f} Host_ms: {:.1f} "
                "GC_ms: {:.2f}, lr: {:.6f}, "
                "Loss_D_ave: {:.6f}, Loss_D_sequence: {:.6f}, "
                "Loss_D_frame: {:.6f}, Loss_encdec_ave: {:.6f}, "
                "loss_xt_recon: {:.6f}, loss_x2t_recon: {:.6f}, "
                "loss_x3t_recon: {:.6f}, loss_z_KL: {:.6f}, "
                "loss_x2t_gan_sequence: {:.6f}, loss_x2t_gan_frame: {:.6f}"
                .format(epoch, num_epoch, i_iter, epoch_iters,
                        batch_time.average(), host_ms, gc_ms, config.TRAIN.LR,
                        ave_loss_d.average(), m["loss_D_sequence"],
                        m["loss_D_frame"], ave_loss_encdec.average(),
                        *(m[k] for k in _G_TERMS)))
            if writer_dict is not None:
                writer = writer_dict["writer"]
                gs = writer_dict["train_global_steps"]
                writer.add_scalar("train_loss_D", ave_loss_d.average(), gs)
                writer.add_scalar("train_loss_encdec",
                                  ave_loss_encdec.average(), gs)
                for k in ("loss_D_sequence", "loss_D_frame") + _G_TERMS:
                    writer.add_scalar(f"train_{k}", m[k], gs)
                for k, v in spans.counters().items():
                    writer.add_scalar(f"counters/{k}", v, gs)
                writer_dict["train_global_steps"] = gs + 1
    if prof is not None:  # the epoch ended inside the window
        prof.stop()

    if final_output_dir and last is not None and sync.data_rank() == 0:
        batch, preds, names = last
        # rank 0's spatial group gathers its H blocks into whole frames
        batch = {k: sync.gather_rows(v[-1:], 1) for k, v in batch.items()}
        preds = [sync.gather_rows(p[-1:], 2) for p in preds]
        if main_rank:
            _dump_epoch_visuals(final_output_dir, epoch, batch, preds, names)


def _dump_epoch_visuals(final_output_dir: str, epoch: int, batch, preds,
                        names) -> None:
    """End-of-epoch dumps of the last batch's last sample, ground truth and
    predictions (reference function.py:568-604): PNG frames of a clip, or
    ``.npy`` vectors for the toy family (its names hold 'toyexample')."""
    name = names[-1] if names else "batch"
    save_path = os.path.join(final_output_dir, "vis", f"epoch{epoch}", str(name))
    os.makedirs(save_path, exist_ok=True)
    if "toyexample" in str(name):
        for key, prefix in (("xt", "x1t"), ("x2t", "x2t"), ("x3t", "x3t")):
            np.save(os.path.join(save_path, f"{prefix}.npy"),
                    batch[key][-1].float().cpu().numpy())
        for pred, prefix in zip(preds, ("x1t", "x2t", "x3t")):
            np.save(os.path.join(save_path, f"{prefix}_predict.npy"),
                    pred[-1].float().cpu().numpy())
        return
    for key, prefix in (("xt", "x1t"), ("x2t", "x2t"), ("x3t", "x3t")):
        save_frames_png(batch[key][-1].cpu().numpy(), save_path, prefix)
    for pred, prefix in zip(preds, ("x1t", "x2t", "x3t")):
        clip = pred[-1].permute(1, 2, 0).float().cpu().numpy()  # (H, W, 3F)
        save_frames_png(clip, save_path, f"{prefix}_predict")
