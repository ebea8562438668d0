"""Frame scores of the paper's evaluation, plain float32: SSIM (gaussian
window 11, sigma 1.5, K1 0.01, K2 0.03), MS-SSIM over 3 levels with the
reference's uniform weights, L1 and PSNR over [0, 255] images.

Images are (N, H, W, 3) float32 in [0, 255]; each score is per image."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _stats(x: torch.Tensor):
    f = x.shape[-1] // 3
    mean = torch.tensor(IMAGENET_MEAN * f, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD * f, dtype=torch.float32, device=x.device)
    return mean, std


def normalize(clip_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3F) -> normalized float32, ImageNet statistics."""
    mean, std = _stats(clip_u8)
    return (clip_u8.float() / 255.0 - mean) / std


def denormalize(x: torch.Tensor) -> torch.Tensor:
    mean, std = _stats(x)
    return torch.clamp((x.float() * std + mean) * 255.0, 0.0, 255.0)


def _window(x) -> torch.Tensor:
    g = [math.exp(-((i - 5) ** 2) / (2 * 1.5 ** 2)) for i in range(11)]
    s = sum(g)
    return torch.tensor([v / s for v in g], dtype=x.dtype, device=x.device)


def _blur(x, w):
    c = x.shape[1]
    x = F.conv2d(x, w.view(1, 1, 11, 1).expand(c, 1, 11, 1), groups=c)
    return F.conv2d(x, w.view(1, 1, 1, 11).expand(c, 1, 1, 11), groups=c)


def _maps(x, y, w, data_range=255.0):
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    mx, my = _blur(x, w), _blur(y, w)
    sxx = _blur(x * x, w) - mx * mx
    syy = _blur(y * y, w) - my * my
    sxy = _blur(x * y, w) - mx * my
    cs = (2 * sxy + c2) / (sxx + syy + c2)
    return ((2 * mx * my + c1) / (mx * mx + my * my + c1)) * cs, cs


def ssim(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    x, y = p.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    return _maps(x, y, _window(p))[0].mean(dim=(1, 2, 3))


def ms_ssim(p: torch.Tensor, g: torch.Tensor, levels: int = 3) -> torch.Tensor:
    x, y = p.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    w = _window(p)
    out = torch.ones(p.shape[0], dtype=p.dtype, device=p.device)
    for i in range(levels):
        s, cs = _maps(x, y, w)
        if i < levels - 1:
            out = out * torch.relu(cs).mean(dim=(1, 2, 3)) ** (1.0 / levels)
            x, y = F.avg_pool2d(x, 2), F.avg_pool2d(y, 2)
    return out * torch.relu(s).mean(dim=(1, 2, 3)) ** (1.0 / levels)


def frame_scores(pred: torch.Tensor, gt_u8: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> dict:
    """pred (S, H, W, 3F) normalized, gt (1, H, W, 3F) uint8 -> (S, F) per
    sample and frame: ssim, msssim, recon (L1), psnr; computed in
    ``dtype`` (the control computes them in bfloat16)."""
    s, h, w, c = pred.shape
    f = c // 3

    def frames(x):
        return x.reshape(s, h, w, f, 3).permute(0, 3, 1, 2, 4).reshape(s * f, h, w, 3)

    p = frames(denormalize(pred)).to(dtype)
    g = frames(gt_u8.float().expand(s, -1, -1, -1)).to(dtype)
    mse = ((p - g) ** 2).mean(dim=(1, 2, 3))
    out = {"ssim": ssim(p, g), "msssim": ms_ssim(p, g),
           "recon": (p - g).abs().mean(dim=(1, 2, 3)),
           "psnr": 20.0 * torch.log10(255.0 / torch.sqrt(mse))}
    return {k: v.float().reshape(s, f) for k, v in out.items()}
