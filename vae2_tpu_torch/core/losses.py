"""Losses and frame metrics (counterpart of ``vae2_tpu/core/losses.py``;
reference lib/core/criterion.py).

- ``l1_loss``    == L1Loss: sum-reduction / batch             (:61-69)
- ``kl_loss``    == KLLoss: sum(0.5(mu^2+e^v-v-1)) / batch    (:72-87)
- ``lsgan_loss`` == lsgan_adversarial_loss: MSE vs 1/0, / B   (:90-103)
- ``psnr``       == PSNR over [0, 255] images                 (:106-116)

Every reduction runs in float32 whatever the input dtype. Layout does not
matter: both operands of a loss share it.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

TensorOrList = Union[torch.Tensor, Sequence[torch.Tensor]]


def l1_loss(predict: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Sum of absolute error, normalized by batch size only."""
    diff = torch.abs(predict.to(torch.float32) - target.to(torch.float32))
    return torch.sum(diff) / predict.shape[0]


def kl_loss(mu: TensorOrList, logvar: TensorOrList) -> torch.Tensor:
    """KL(q(z|x) || N(0, I)), summed over all latent dims, / batch; for
    lists (the hd_z per-branch maps) the sum of the per-branch terms."""
    if isinstance(mu, (list, tuple)):
        if not isinstance(logvar, (list, tuple)) or len(mu) != len(logvar):
            raise ValueError("kl_loss: mu and logvar must be lists of the "
                             "same length")
        total = torch.zeros((), dtype=torch.float32, device=mu[0].device)
        for m, v in zip(mu, logvar):
            total = total + _kl_single(m, v)
        return total
    return _kl_single(mu, logvar)


def _kl_single(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    mu = mu.to(torch.float32)
    logvar = logvar.to(torch.float32)
    return torch.sum(0.5 * (mu**2 + torch.exp(logvar) - logvar - 1.0)) \
        / mu.shape[0]


def lsgan_loss(sample: torch.Tensor, real: bool) -> torch.Tensor:
    """Least-squares GAN loss: squared error against an all-ones (real) or
    all-zeros (fake) target map, sum-reduced / batch."""
    s = sample.to(torch.float32)
    target = torch.ones_like(s) if real else torch.zeros_like(s)
    return torch.sum((s - target) ** 2) / sample.shape[0]


def psnr(img1: torch.Tensor, img2: torch.Tensor,
         data_range: float = 255.0) -> torch.Tensor:
    """Peak signal-to-noise ratio for images in [0, data_range]
    (losses.py:63-66, reference criterion.py:106-116)."""
    mse = torch.mean((img1.to(torch.float32) - img2.to(torch.float32)) ** 2)
    return 20.0 * torch.log10(data_range / torch.sqrt(mse))
