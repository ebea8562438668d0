"""Stochastic multi-sample inference loop, prior sampling.

Counterpart of ``vae2_tpu/core/infer_loop.py`` (reference
lib/core/function.py:55-441): for each eval clip, draw NUM_SAMPLES
prior-sampled rollouts and dump per-sample SSIM / MS-SSIM / L1 / PSNR
metrics (vs ground truth) to txt files plus predicted/GT frames as PNGs —
the tree that tools/statistic.py reads.

- Prior sampling never runs the posterior: z ~ N(0, I) shapes follow from
  the encoder geometry.
- Samples are folded into the batch axis in chunks of
  ``TPU.INFER_SAMPLE_BATCH``, and the z-independent encoder prefix is shared
  across a chunk (``VAE2EncDec.sample``).
- The metrics are computed on the device over all frames of a chunk at once.

Momentum sampling needs the posterior network, which is not ported yet.
"""

from __future__ import annotations

import functools
import logging
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..data.loader import denormalize_clips, normalize_clips
from ..ops.ssim import ms_ssim, ssim
from ..utils.device import exact_f32
from .losses import psnr as psnr_fn
from .system import VAE2System

logger = logging.getLogger("vae2_tpu_torch")


def prior_z_shapes(hyper, height: int, width: int) -> Optional[list]:
    """Per-sample latent shapes for prior sampling, channels first.

    hd_z: one (z_dim, h/2^b, w/2^b) map per HRNet branch — the trunk stem
    is stride 1, so branch b sits at 1/2^b resolution. Pooled: (z_dim,).
    """
    if hyper.deterministic:
        return None
    if hyper.hd_z:
        return [(hyper.z_dim, height // 2**b, width // 2**b) for b in range(4)]
    return [(hyper.z_dim,)]


def _decode_samples(system: VAE2System, enc_in: torch.Tensor, z,
                    generator: torch.Generator, chunk: int):
    """Decode ``chunk`` folded latent samples through the encoder/decoders,
    sharing the z-independent prefix when the model is stochastic."""
    encdec = system.modules["encdec"]
    if not system.hyper.deterministic:
        return encdec.sample(enc_in, z, generator=generator)
    return encdec(enc_in.expand(chunk, -1, -1, -1), z, generator=generator)


def make_prior_sampler(system: VAE2System, chunk: int,
                       height: int, width: int) -> Callable:
    """fn(xt, x2t, generator) -> (x1p, x2p, x3p) with ``chunk`` prior samples
    folded into the batch axis. Inputs are single uint8 clips (1, H, W, 3F)
    on the model's device; outputs are (chunk, 3F, H, W) normalized clips in
    the compute dtype, channels_last. z and the random code are drawn from
    ``generator``, in that order."""
    h = system.hyper
    z_shapes = prior_z_shapes(h, height, width)

    def fn(xt: torch.Tensor, x2t: torch.Tensor, generator: torch.Generator):
        with torch.inference_mode(), exact_f32():
            xt = normalize_clips(xt)
            x2t = normalize_clips(x2t)
            enc_in = system._encoder_input(xt, x2t).permute(0, 3, 1, 2)
            draw = functools.partial(torch.randn, generator=generator,
                                     device=xt.device)
            if z_shapes is None:
                z = None
            elif h.hd_z:
                z = [draw((chunk,) + s) for s in z_shapes]
            else:
                z = draw((chunk,) + z_shapes[0])
            return _decode_samples(system, enc_in, z, generator, chunk)

    return fn


def make_metric_fn() -> Callable:
    """fn(pred (S, H, W, 3F) normalized, gt (1, H, W, 3F) uint8) -> dict of
    (S, F) metric tensors [ssim, msssim, recon (L1), psnr], per sample and
    RGB frame.

    MS-SSIM runs in pytorch_msssim parity mode (strict) whenever the image
    is large enough for all 3 levels (>= 44 px on the shorter side);
    smaller debug images drop levels (see ops/ssim.py)."""

    def fn(pred: torch.Tensor, gt_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            s, hh, ww, c = pred.shape
            f = c // 3

            def frames(x):  # (S, H, W, 3F) -> (S*F, H, W, 3)
                return (x.reshape(s, hh, ww, f, 3).permute(0, 3, 1, 2, 4)
                        .reshape(s * f, hh, ww, 3))

            p = frames(denormalize_clips(pred))
            g = frames(gt_u8.to(torch.float32).expand(s, -1, -1, -1))
            strict = min(hh, ww) >= 44
            out = {
                "ssim": ssim(p, g, data_range=255.0, size_average=False),
                "msssim": ms_ssim(p, g, data_range=255.0, strict=strict,
                                  size_average=False),
                "recon": torch.mean(torch.abs(p - g), dim=(1, 2, 3)),
                "psnr": torch.vmap(psnr_fn)(p, g),
            }
            return {k: v.reshape(s, f) for k, v in out.items()}

    return fn


def _append_metric_txts(save_path: str, tag: str, metrics: Dict[str, np.ndarray]
                        ) -> None:
    """Append per-sample per-frame metric lines (function.py:254-261)."""
    os.makedirs(save_path, exist_ok=True)
    s, f = metrics["recon"].shape
    names = {"recon": "reconloss", "ssim": "ssimloss",
             "msssim": "msssimloss", "psnr": "psnrloss"}
    for key, fname in names.items():
        for frame in range(f):
            with open(os.path.join(save_path, f"{tag}_{frame}_{fname}.txt"),
                      "a") as fw:
                for sample in range(s):
                    fw.write(str(float(metrics[key][sample, frame])) + "\n")


def _save_pred_pngs(save_path: str, tag: str, pred255: np.ndarray,
                    metrics: Dict[str, np.ndarray], save_images: bool) -> None:
    from PIL import Image

    if not save_images:
        return
    os.makedirs(save_path, exist_ok=True)
    s, hh, ww, c = pred255.shape
    f = c // 3
    for sample in range(s):
        for frame in range(f):
            im = pred255[sample, ..., frame * 3: frame * 3 + 3].astype(np.uint8)
            fname = "{}_{}_trial_{}_recon{}_ssim{}_msssim{}.png".format(
                tag, frame, sample,
                float(metrics["recon"][sample, frame]),
                float(metrics["ssim"][sample, frame]),
                float(metrics["msssim"][sample, frame]))
            Image.fromarray(im).save(os.path.join(save_path, fname))


def _to_device(clip: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(clip)).to(device)


def run_inference(config, system: VAE2System, loader, final_output_dir: str,
                  epoch: int, generator: torch.Generator,
                  num_samples: int = 100, save_images: bool = True,
                  sampling_mode: str = "prior_sampling") -> None:
    """Full inference sweep (reference function.py:55-441, image branch) on
    the device of ``system``'s parameters."""
    from .train_loop import save_frames_png

    if sampling_mode == "momentum_sampling":
        raise NotImplementedError(
            "momentum_sampling needs the posterior network, which the "
            "PyTorch port does not have yet; use prior_sampling")
    if sampling_mode != "prior_sampling":
        raise ValueError(f"unknown sampling_mode: {sampling_mode}")
    device = next(system.modules.parameters()).device
    h_img = config.TRAIN.IMAGE_SIZE[1]
    w_img = config.TRAIN.IMAGE_SIZE[0]
    chunk = min(int(config.TPU.INFER_SAMPLE_BATCH), num_samples)
    sampler = make_prior_sampler(system, chunk, h_img, w_img)
    metric_fn = make_metric_fn()
    is_baseline = system.hyper.is_baseline

    def host(metrics):
        return {k: v.cpu().numpy() for k, v in metrics.items()}

    for i_iter, (batch, names) in enumerate(loader):
        name = names[-1]
        # Reference evaluates the last batch element only (function.py:222+).
        xt = _to_device(batch["xt"][-1:], device)
        x2t = _to_device(batch["x2t"][-1:], device)
        x3t = _to_device(batch["x3t"][-1:], device)

        base = os.path.join(final_output_dir, "vis", f"epoch{epoch}", str(name))
        os.makedirs(base, exist_ok=True)
        save_frames_png(batch["xt"][-1], base, "x1t")
        save_frames_png(batch["x2t"][-1], base, "x2t")
        save_frames_png(batch["x3t"][-1], base, "x3t")

        done = 0
        while done < num_samples:
            _, x2p, x3p = sampler(xt, x2t, generator)
            take = min(chunk, num_samples - done)
            # NHWC views of the channels_last predictions
            x2p = x2p[:take].permute(0, 2, 3, 1)
            x3p = x3p[:take].permute(0, 2, 3, 1)
            # x2 prediction vs x2t (or x3t for the future-predicting
            # baseline, function.py:242)
            gt2 = x3t if is_baseline else x2t
            m2 = host(metric_fn(x2p, gt2))
            m3 = host(metric_fn(x3p, x3t))
            _append_metric_txts(os.path.join(base, "x2tpredict"), "x2t", m2)
            _append_metric_txts(os.path.join(base, "x3tpredict"), "x3t", m3)
            if save_images:
                for tag, pred, m in (("x2t", x2p, m2), ("x3t", x3p, m3)):
                    _save_pred_pngs(os.path.join(base, f"{tag}predict"), tag,
                                    denormalize_clips(pred).cpu().numpy(), m,
                                    save_images)
            done += take
        logger.info("inference batch %d (%s): %d samples", i_iter, name,
                    num_samples)
