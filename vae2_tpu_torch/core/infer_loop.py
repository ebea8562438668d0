"""Stochastic multi-sample inference loop: prior and momentum sampling.

Counterpart of ``vae2_tpu/core/infer_loop.py`` (reference
lib/core/function.py:55-441): for each eval clip, draw NUM_SAMPLES
prior-sampled rollouts and dump per-sample SSIM / MS-SSIM / L1 / PSNR
metrics (vs ground truth) to txt files plus predicted/GT frames as PNGs —
the tree that tools/statistic.py reads.

- Prior sampling never runs the posterior: z ~ N(0, I) shapes follow from
  the encoder geometry.
- Momentum sampling (reference utils.py:186-207) draws z from the
  posterior of the previous clip window, run once per call at batch 1; it
  needs the 5-clip eval layout (``make_dataset(clip_num=5)``).
- Samples are folded into the batch axis in chunks of
  ``TPU.INFER_SAMPLE_BATCH``, and the z-independent encoder prefix is shared
  across a chunk (``VAE2EncDec.sample``).
- The metrics are computed on the device over all frames of a chunk at once.
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
from .system import VAE2System, reparameterize

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
                    generator: torch.Generator, chunk: int,
                    rand_code: Optional[torch.Tensor] = None):
    """Decode ``chunk`` folded latent samples through the encoder/decoders,
    sharing the z-independent prefix when the model is stochastic."""
    encdec = system.modules["encdec"]
    if not system.hyper.deterministic:
        return encdec.sample(enc_in, z, rand_code=rand_code,
                             generator=generator)
    return encdec(enc_in.expand(chunk, -1, -1, -1), z, rand_code=rand_code,
                  generator=generator)


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


def make_momentum_sampler(system: VAE2System, chunk: int) -> Callable:
    """fn(xt, x2t, xt_last, x3t_last, generator, eps=None, rand_code=None)
    -> (x1p, x2p, x3p) with ``chunk`` posterior draws folded into the batch
    axis (infer_loop.py:108-144; reference utils.py:186-207).

    z = mu + exp(logvar / 2) * eps, with (mu, logvar) = encz(concat(xt_last,
    x3t_last)) run once at batch 1 and broadcast to the chunk. Inputs are
    single uint8 clips (1, H, W, 3F) on the model's device; outputs as
    ``make_prior_sampler``'s.

    Noise, drawn from ``generator`` where not given: first eps, one (chunk,
    z_dim, h_b, w_b) draw per latent in list order (one (chunk, z_dim) draw
    when the latent is pooled), in the dtype of the posterior's mus (the
    JAX package's ``m.dtype``); then the encoder's random code (chunk,
    z_dim). The JAX package splits one key per latent and a key for the
    code instead, so the two give different numbers from one seed; the
    tests inject the JAX draws through ``eps`` (a list or a tensor shaped
    like the draws) and ``rand_code``."""
    if system.hyper.deterministic:
        raise ValueError("momentum_sampling needs a stochastic model (encz)")

    def fn(xt, x2t, xt_last, x3t_last, generator: torch.Generator,
           eps=None, rand_code: Optional[torch.Tensor] = None):
        with torch.inference_mode(), exact_f32():
            xt, x2t, xt_last, x3t_last = (
                normalize_clips(c) for c in (xt, x2t, xt_last, x3t_last))
            enc_in = system._encoder_input(xt, x2t).permute(0, 3, 1, 2)
            mus, logvars = system.momentum_posterior(xt_last, x3t_last)
            if eps is not None:
                z = reparameterize(mus, logvars, eps)
            else:
                def draw(m, v):
                    # z in place of the eps drawn for it (the chunk's z maps
                    # are the call's largest tensors: 268 MB at the
                    # flagship's first branch); e * s + m rounds as m + s * e
                    return torch.randn((chunk,) + m.shape[1:], dtype=m.dtype,
                                       generator=generator, device=m.device
                                       ).mul_(torch.exp(0.5 * v)).add_(m)

                z = ([draw(m, v) for m, v in zip(mus, logvars)]
                     if isinstance(mus, (list, tuple)) else draw(mus, logvars))
            return _decode_samples(system, enc_in, z, generator, chunk,
                                   rand_code)

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


def eval_window(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A 5-clip batch in the momentum-eval layout (reference
    function.py:109-115): the first window (xt, x2t, x3t) conditions the
    posterior through ``xt_last`` = xt and ``x3t_last`` = x3t, and the
    second (x3t, x4t, x5t) is predicted. A 3-clip batch is returned as it
    is."""
    if "x5t" not in batch:
        return batch
    return {"xt_last": batch["xt"], "x3t_last": batch["x3t"],
            "xt": batch["x3t"], "x2t": batch["x4t"], "x3t": batch["x5t"]}


def _to_device(clip: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(clip)).to(device)


def run_inference(config, system: VAE2System, loader, final_output_dir: str,
                  epoch: int, generator: torch.Generator,
                  num_samples: int = 100, save_images: bool = True,
                  sampling_mode: str = "prior_sampling") -> None:
    """Full inference sweep (reference function.py:55-441, image branch) on
    the device of ``system``'s parameters.

    ``sampling_mode``: 'prior_sampling' (z ~ N(0, I)) or 'momentum_sampling'
    (z from the previous window's posterior; needs a 5-clip loader). A
    5-clip batch is remapped in either mode (function.py:109-115)."""
    from .train_loop import save_frames_png

    device = next(system.modules.parameters()).device
    h_img = config.TRAIN.IMAGE_SIZE[1]
    w_img = config.TRAIN.IMAGE_SIZE[0]
    chunk = min(int(config.TPU.INFER_SAMPLE_BATCH), num_samples)
    if sampling_mode == "momentum_sampling":
        sampler = make_momentum_sampler(system, chunk)
    elif sampling_mode == "prior_sampling":
        sampler = make_prior_sampler(system, chunk, h_img, w_img)
    else:
        raise ValueError(f"unknown sampling_mode: {sampling_mode}")
    metric_fn = make_metric_fn()
    is_baseline = system.hyper.is_baseline

    def host(metrics):
        return {k: v.cpu().numpy() for k, v in metrics.items()}

    for i_iter, (batch, names) in enumerate(loader):
        name = names[-1]
        batch = eval_window(batch)
        if sampling_mode == "momentum_sampling" and "xt_last" not in batch:
            raise ValueError(
                "momentum_sampling needs a 5-clip eval batch — run the "
                "inference CLI with --clip-num 5")
        # Reference evaluates the last batch element only (function.py:222+).
        xt = _to_device(batch["xt"][-1:], device)
        x2t = _to_device(batch["x2t"][-1:], device)
        x3t = _to_device(batch["x3t"][-1:], device)
        if sampling_mode == "momentum_sampling":
            # one upload per eval clip, outside the chunk loop
            last = (_to_device(batch["xt_last"][-1:], device),
                    _to_device(batch["x3t_last"][-1:], device))
            draw = functools.partial(sampler, xt, x2t, *last)
        else:
            draw = functools.partial(sampler, xt, x2t)

        base = os.path.join(final_output_dir, "vis", f"epoch{epoch}", str(name))
        os.makedirs(base, exist_ok=True)
        save_frames_png(batch["xt"][-1], base, "x1t")
        save_frames_png(batch["x2t"][-1], base, "x2t")
        save_frames_png(batch["x3t"][-1], base, "x3t")

        done = 0
        while done < num_samples:
            _, x2p, x3p = draw(generator)
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
