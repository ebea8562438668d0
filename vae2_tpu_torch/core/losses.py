"""Losses and frame metrics (counterpart of ``vae2_tpu/core/losses.py``).

Only ``psnr`` is ported: it is the one term on the inference path. The
training losses come with the training slice.
"""

from __future__ import annotations

import torch


def psnr(img1: torch.Tensor, img2: torch.Tensor,
         data_range: float = 255.0) -> torch.Tensor:
    """Peak signal-to-noise ratio for images in [0, data_range]
    (losses.py:63-66, reference criterion.py:106-116)."""
    mse = torch.mean((img1.to(torch.float32) - img2.to(torch.float32)) ** 2)
    return 20.0 * torch.log10(data_range / torch.sqrt(mse))
