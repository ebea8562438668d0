"""Seeded weights for both sides, made on the device in a few large draws.

The names and shapes come from the benchmark's reference networks, which
carry the names of ``vae2_tpu_torch``'s modules; the same tensors are
loaded into the program and into the reference. Convolution kernels are
normal with std 1/sqrt(fan-in), so that signal keeps its scale through the
full depth, except the output convolutions that no BN follows (the heads'
last ``conv2`` and the posterior's ``z_layer``), 0.1/sqrt(fan-in), so that
predictions, scores and log-variances start near the scale of the data;
conv biases normal(0, 0.1); the scales of the BNs that feed a ReLU
uniform in [0.5, 1.5), those of the identity-activation BNs (the last of
each residual branch, the fusion's) uniform in [0.05, 0.15), near the
zero-initialised residual scale of large-batch training (Goyal et al.,
arXiv:1706.02677), so that each block starts near the identity and the
eval-mode net does not amplify rounding; shifts normal(0, 0.2); running
statistics 0 and 1 (train-mode BNs do not read them; the evaluation cell
sets them, ``drivers/vae2_prior.calibrated_state``).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from .reference import nets


def _is_output(name: str) -> bool:
    """A convolution that no BN follows: a head's last, a posterior map's."""
    parts = name.split(".")
    return (parts[-2] == "conv2" and parts[-3].startswith("last_layer")) or \
        parts[-2].startswith("z_layer")


def _parts(module: nn.Module):
    kernels, biases, scales, small, shifts, other = [], [], [], [], [], []
    bns = {f"{n}.{p}": m for n, m in module.named_modules()
           if isinstance(m, nets.BN) for p in ("weight", "bias")}
    for name, p in module.named_parameters():
        if p.dim() == 4:
            kernels.append((name, p))
        elif name in bns:
            if not name.endswith(".weight"):
                shifts.append((name, p))
            else:
                (scales if bns[name].relu else small).append((name, p))
        elif name.endswith(".bias"):
            biases.append((name, p))
        else:
            other.append((name, p))
    if other:
        raise ValueError(f"no rule for parameters {[n for n, _ in other]}")
    return kernels, biases, scales, small, shifts


def _fill(parts, draw: Callable, out: Dict[str, torch.Tensor], scale=None):
    total = sum(p.numel() for _, p in parts)
    if total == 0:
        return
    flat = draw(total)
    off = 0
    for name, p in parts:
        t = flat[off:off + p.numel()].view(p.shape)
        out[name] = t * scale(p) if scale else t
        off += p.numel()


def make_state(module: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """A full state dict for ``module`` (parameters and buffers), float32."""
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(n):
        return torch.randn(n, generator=g, device=device)

    def uniform(n):
        return torch.rand(n, generator=g, device=device)

    kernels, biases, scales, small, shifts = _parts(module)
    output_ids = {id(p) for n, p in kernels if _is_output(n)}
    out: Dict[str, torch.Tensor] = {}
    _fill(kernels, normal, out,
          lambda p: p[0].numel() ** -0.5 * (0.1 if id(p) in output_ids else 1.0))
    _fill(biases, normal, out, lambda p: 0.1)
    _fill(scales, lambda n: uniform(n) + 0.5, out)
    _fill(small, lambda n: 0.1 * uniform(n) + 0.05, out)
    _fill(shifts, normal, out, lambda p: 0.2)
    for name, b in module.named_buffers():
        out[name] = (torch.ones if name.endswith("running_var")
                     else torch.zeros)(b.shape, device=device)
    return out


def reference_on(device, build: Callable[[], nn.Module],
                 state: Dict[str, torch.Tensor]) -> nn.Module:
    """``build()`` made on ``device`` and loaded with ``state``."""
    with torch.device("meta"):
        module = build()
    module = module.to_empty(device=device)
    module.load_state_dict(state, strict=True)
    return module


def skeleton(build: Callable[[], nn.Module]) -> nn.Module:
    """The module on the meta device: names and shapes, no memory."""
    with torch.device("meta"):
        return build()
