"""Wire a config into a VAE2System (counterpart of
``vae2_tpu/core/builder.py``), for the enc_hrnet family."""

from __future__ import annotations

from typing import Optional

import torch

from ..models import vae2 as fam
from .system import Hyper, VAE2System


def build_system(config, seed: Optional[int] = None) -> VAE2System:
    """The encdec network and hypers of ``MODEL.NAME`` enc_hrnet, on the
    CPU, initialised as the JAX package initialises (drawn from ``seed``
    when it is given, without touching the global random state)."""
    name = config.MODEL.NAME
    if name in ("toy_fc", "toyexample"):
        raise NotImplementedError(f"MODEL.NAME {name!r} is not ported yet")
    if name not in ("enc_hrnet", "hrnet", "vae2"):
        raise KeyError(f"Unknown MODEL.NAME: {name}")
    extra = config.MODEL.EXTRA
    if seed is None:
        modules = {"encdec": fam.get_encdec_model(config)}
    else:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            modules = {"encdec": fam.get_encdec_model(config)}
    hyper = Hyper(
        x1recon_lambda=config.TRAIN.X1RECON_LAMBDA,
        x2recon_lambda=config.TRAIN.X2RECON_LAMBDA,
        x3recon_lambda=config.TRAIN.X3RECON_LAMBDA,
        gan_lambda=config.TRAIN.GAN_LAMBDA,
        is_baseline=extra.IS_BASELINE,
        baseline_mode=extra.BASELINE_MODE,
        hd_z=bool(extra.get("HD_Z", True)),
        z_dim=int(extra.get("Z_DIM", 32)),
        clip_length=config.TRAIN.CLIP_LENGTH,
        family="image",
    )
    return VAE2System(modules, hyper)
