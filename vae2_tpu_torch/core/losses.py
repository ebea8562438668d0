"""Losses and frame metrics (counterpart of ``vae2_tpu/core/losses.py``;
reference lib/core/criterion.py).

- ``l1_loss``    == L1Loss: sum-reduction / batch             (:61-69)
- ``kl_loss``    == KLLoss: sum(0.5(mu^2+e^v-v-1)) / batch    (:72-87)
- ``lsgan_loss`` == lsgan_adversarial_loss: MSE vs 1/0, / B   (:90-103)
- ``psnr``       == PSNR over [0, 255] images                 (:106-116)
- ``cross_entropy_loss`` == CrossEntropy (segmentation)       (:11-27)
- ``ohem_cross_entropy`` == OhemCrossEntropy                  (:29-58)

Every reduction runs in float32 whatever the input dtype. Layout does not
matter to the frame losses: both operands share it. The segmentation losses
take (B, C, h, w) logits and (B, H, W) integer labels.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from ..ops.image import resize_bilinear

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


# ---------------------------------------------------------------------------
# Segmentation losses (losses.py:74-147 of the JAX package). Logits NCHW.
# ---------------------------------------------------------------------------


def _pixel_nll(score: torch.Tensor, target: torch.Tensor, ignore_label: int):
    """Logits upsampled bilinearly in f32 to the label size; returns
    (valid mask, label with ignored pixels at 0, per-pixel log p(label))."""
    h, w = target.shape[1:]
    score = resize_bilinear(score.float(), h, w)
    valid = target != ignore_label
    safe = torch.where(valid, target, torch.zeros_like(target)).long()
    logp = torch.log_softmax(score, dim=1)
    return valid, safe, logp.gather(1, safe[:, None])[:, 0]


def cross_entropy_loss(score: torch.Tensor, target: torch.Tensor,
                       ignore_label: int = -1,
                       class_weights: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Pixel-wise softmax cross-entropy with ignore label and class
    weights: ``nn.CrossEntropyLoss(weight, ignore_index)``'s weighted mean
    over the pixels that are not ignored."""
    valid, safe, logp = _pixel_nll(score, target, ignore_label)
    pix_w = (torch.ones_like(logp) if class_weights is None
             else class_weights.float()[safe])
    pix_w = torch.where(valid, pix_w, torch.zeros_like(pix_w))
    return torch.sum(-logp * pix_w) / torch.clamp(torch.sum(pix_w), min=1e-8)


def ohem_cross_entropy(score: torch.Tensor, target: torch.Tensor,
                       ignore_label: int = -1, thres: float = 0.7,
                       min_kept: int = 100000,
                       class_weights: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Online hard-example mining CE (reference criterion.py:29-58): the
    mean (weighted) loss of the pixels whose probability of their label is
    below ``max(thres, the min_kept-th smallest such probability)``;
    ignored pixels sort last and are never kept."""
    valid, safe, logp = _pixel_nll(score, target, ignore_label)
    nll = -logp
    if class_weights is not None:
        nll = nll * class_weights.float()[safe]
    valid, nll = valid.reshape(-1), nll.reshape(-1)
    prob = torch.exp(logp).reshape(-1)
    prob = torch.where(valid, prob, torch.full_like(prob, float("inf")))
    k = min(min_kept, prob.shape[0] - 1)
    min_value = torch.kthvalue(prob.detach(), k + 1).values
    threshold = torch.clamp(min_value, min=thres)
    keep = valid & (prob < threshold)
    kept = torch.where(keep, nll, torch.zeros_like(nll))
    return torch.sum(kept) / torch.clamp(keep.sum(), min=1)
