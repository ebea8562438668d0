"""SSIM / MS-SSIM in PyTorch.

Counterpart of ``vae2_tpu/ops/ssim.py``: gaussian window 11, sigma 1.5,
K1=0.01, K2=0.03, and the reference's MS-SSIM variant with uniform weights
[1/3, 1/3, 1/3] (reference lib/core/function.py:25). Inputs are NHWC in
[0, data_range], the JAX layout.

The JAX blur asks for ``precision=HIGHEST`` (ssim.py:35-47); here the blur
convolutions run in true float32, with TF32 off around them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import exact_f32


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords**2) / (2.0 * sigma**2))
    g /= g.sum()
    return g.astype(np.float32)


def _blur(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable valid-mode gaussian filter over H and W, per channel, on
    NCHW."""
    c = x.shape[1]
    k = kernel.numel()
    with exact_f32():
        x = F.conv2d(x, kernel.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
        x = F.conv2d(x, kernel.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)
    return x


def _ssim_per_channel(x, y, data_range: float, kernel: torch.Tensor,
                      k1: float = 0.01, k2: float = 0.03):
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_x = _blur(x, kernel)
    mu_y = _blur(y, kernel)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_xx = _blur(x * x, kernel) - mu_xx
    sigma_yy = _blur(y * y, kernel) - mu_yy
    sigma_xy = _blur(x * y, kernel) - mu_xy
    cs_map = (2 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    ssim_map = ((2 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs_map
    return ssim_map, cs_map


def _nchw_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).permute(0, 3, 1, 2)


def _kernel_on(x: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(_gaussian_kernel()).to(x.device)


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 255.0,
         size_average: bool = True) -> torch.Tensor:
    """Structural similarity, gaussian-windowed (pytorch_msssim-compatible).
    Per image (shape (B,)) when ``size_average`` is False."""
    x, y = _nchw_f32(x), _nchw_f32(y)
    ssim_map, _ = _ssim_per_channel(x, y, data_range, _kernel_on(x))
    if size_average:
        return torch.mean(ssim_map)
    return torch.mean(ssim_map, dim=(1, 2, 3))


def ms_ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 255.0,
            weights: Sequence[float] = (1.0 / 3, 1.0 / 3, 1.0 / 3),
            size_average: bool = True, strict: bool = False) -> torch.Tensor:
    """Multi-scale SSIM with configurable level weights.

    Levels that the image is too small for are dropped and the weights
    renormalized; ``strict`` refuses such images instead, as pytorch_msssim
    asserts. On images large enough for every level the two agree.
    """
    x, y = _nchw_f32(x), _nchw_f32(y)
    kernel = _kernel_on(x)
    max_levels = 1
    m = min(x.shape[2], x.shape[3])
    while max_levels < len(weights) and (m // 2) >= 11:
        m //= 2
        max_levels += 1
    if strict and max_levels < len(weights):
        raise ValueError(
            f"ms_ssim strict mode: image {x.shape[2]}x{x.shape[3]} too "
            f"small for {len(weights)} levels (supports {max_levels}); "
            "pytorch_msssim would assert here")
    weights = list(weights[:max_levels])
    weights = [w / sum(weights) for w in weights]
    weights_t = torch.tensor(weights, dtype=torch.float32, device=x.device)
    levels = len(weights)
    mcs = []
    for i in range(levels):
        ssim_map, cs_map = _ssim_per_channel(x, y, data_range, kernel)
        if i < levels - 1:
            mcs.append(torch.mean(torch.relu(cs_map), dim=(1, 2, 3)))
            # 2x average-pool downsample; odd edges dropped (pytorch_msssim)
            x = F.avg_pool2d(x, 2)
            y = F.avg_pool2d(y, 2)
    msssim = torch.mean(torch.relu(ssim_map), dim=(1, 2, 3))
    stack = torch.stack(mcs + [msssim], dim=0)  # (levels, B)
    out = torch.prod(stack ** weights_t[:, None], dim=0)
    if size_average:
        return torch.mean(out)
    return out
