"""The VAE² system, inference subset (counterpart of
``vae2_tpu/core/system.py``): the loss/model hypers, the networks by role,
the encoder's input, and the posterior split. Training steps and optimizers
come with the training slice."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

BASELINE_MODES = ("VAE_NATIVE", "VAE_ANNEAL", "VAE_GAN", "DETERMINISTIC")


@dataclasses.dataclass(frozen=True)
class Hyper:
    """Static loss/model hyper-parameters (from TRAIN.* / MODEL.EXTRA.*)."""

    x1recon_lambda: float = 1.0
    x2recon_lambda: float = 0.1
    x3recon_lambda: float = 1.0
    gan_lambda: float = 1.0
    is_baseline: bool = False
    baseline_mode: str = "VAE_NATIVE"
    hd_z: bool = True
    z_dim: int = 32
    clip_length: int = 3
    family: str = "image"

    def __post_init__(self):
        if self.baseline_mode not in BASELINE_MODES:
            raise ValueError(f"unknown baseline mode {self.baseline_mode!r}")

    @property
    def deterministic(self) -> bool:
        return self.baseline_mode == "DETERMINISTIC"


def split_muvar(muvars, z_dim: int):
    """Split posterior output into (mus, logvars) along the channel axis
    (axis 1 in the port's NCHW; the JAX package's last axis)."""
    if isinstance(muvars, (list, tuple)):
        return ([m[:, :z_dim] for m in muvars],
                [m[:, z_dim:] for m in muvars])
    return muvars[:, :z_dim], muvars[:, z_dim:]


class VAE2System:
    """The networks by role (``modules['encdec']``; the posterior and the
    discriminators join with later slices) and the hypers."""

    def __init__(self, modules: Dict[str, nn.Module], hyper: Hyper):
        self.modules = nn.ModuleDict(modules)
        self.hyper = hyper

    def _encoder_input(self, xt: torch.Tensor, x2t: torch.Tensor) -> torch.Tensor:
        """The encoder sees the past clip, and the baseline also the middle
        one; clips are (B, H, W, 3F), concatenated on the last axis."""
        if self.hyper.is_baseline:
            return torch.cat([xt, x2t], dim=-1)
        return xt
