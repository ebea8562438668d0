"""Wire a config into a VAE2System (counterpart of
``vae2_tpu/core/builder.py:14-74``): the enc_hrnet family, and the toy
family (``MODEL.NAME`` toy_fc / toyexample: one discriminator, no d_frame,
vectors of 10 and z dim 8)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..models import toy, vae2
from .system import Hyper, VAE2System, make_optimizer

IMAGE_NAMES = ("enc_hrnet", "hrnet", "vae2")
TOY_NAMES = ("toy_fc", "toyexample")


def _modules(config) -> Dict[str, nn.Module]:
    if config.MODEL.NAME in TOY_NAMES:
        modules = {"encdec": toy.get_encdec_model(config),
                   "d_seq": toy.get_D_model(config)}
        fam = toy
    else:
        modules = {"encdec": vae2.get_encdec_model(config),
                   "d_seq": vae2.get_D_sequence_model(config),
                   "d_frame": vae2.get_D_frame_model(config)}
        fam = vae2
    if config.MODEL.EXTRA.BASELINE_MODE != "DETERMINISTIC":
        modules["encz"] = fam.get_encz_model(config)
    return modules


def build_system(config, seed: Optional[int] = None,
                 device: Optional[torch.device] = None,
                 train: bool = False, max_iters: int = 0) -> VAE2System:
    """The networks and the hypers of ``MODEL.NAME`` (enc_hrnet, or the toy
    family), initialised as the JAX package initialises (drawn from
    ``seed`` when it is given, without touching the global random state),
    on ``device`` (the CPU by default). ``train``: also the G optimizer
    (encdec + encz) and the D optimizer (d_seq + d_frame) of
    TRAIN.OPTIMIZER; ``max_iters`` is the run's updates per optimizer,
    which TRAIN.LR_SCHEDULE 'poly' needs."""
    name = config.MODEL.NAME
    if name not in IMAGE_NAMES + TOY_NAMES:
        raise KeyError(f"Unknown MODEL.NAME: {name}")
    is_toy = name in TOY_NAMES
    extra = config.MODEL.EXTRA
    if seed is None:
        modules = _modules(config)
    else:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            modules = _modules(config)
    if device is not None:
        for m in modules.values():
            m.to(device)
    hyper = Hyper(
        x1recon_lambda=config.TRAIN.X1RECON_LAMBDA,
        x2recon_lambda=config.TRAIN.X2RECON_LAMBDA,
        x3recon_lambda=config.TRAIN.X3RECON_LAMBDA,
        gan_lambda=config.TRAIN.GAN_LAMBDA,
        is_baseline=extra.IS_BASELINE,
        baseline_mode=extra.BASELINE_MODE,
        hd_z=False if is_toy else bool(extra.get("HD_Z", True)),
        z_dim=toy.Z_DIM if is_toy else int(extra.get("Z_DIM", 32)),
        clip_length=1 if is_toy else config.TRAIN.CLIP_LENGTH,
        family="toy" if is_toy else "image",
    )
    system = VAE2System(modules, hyper)
    if train:
        moment_dtype = str(config.TPU.get("ADAM_MOMENT_DTYPE", "float32"))
        system.optimizer_g = make_optimizer(system.g_parameters(),
                                            config.TRAIN, moment_dtype,
                                            max_iters)
        system.optimizer_d = make_optimizer(system.d_parameters(),
                                            config.TRAIN, moment_dtype,
                                            max_iters)
    return system
