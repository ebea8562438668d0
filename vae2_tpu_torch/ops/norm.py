"""Batch normalization with a fused activation, inference mode.

Counterpart of ``BatchNormAct`` (vae2_tpu/ops/norm.py:79-189) in eval mode.
Statistics and affine parameters are float32 whatever the compute dtype.
They are folded in f32 into per-channel (mul, add) and cast to the compute
dtype (abn.py:123-125):

- act None, 'leaky_relu' or 'elu': ``ops.abn.fused_abn_infer`` — the CUDA
  kernel on a CUDA tensor. ``TPU.FUSED_ABN`` does not switch this.
- act 'relu': the plain epilogue (norm.py:177-189). ReLU cannot be inverted
  from its output, so the JAX package keeps it off the ABN kernels too.

Train mode (batch statistics, running-stat updates, the activation-inverting
backward) is not ported yet and raises.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import abn

# act name -> (kernel act tag, slope), as norm.py:62-63
_ABN_ACTS = {None: ("none", 1.0), "none": ("none", 1.0),
             "leaky_relu": ("leaky_relu", abn.DEFAULT_SLOPE),
             "elu": ("elu", 1.0)}


class BatchNormAct(nn.Module):
    """BatchNorm over all axes but the channel axis, with optional act.

    Parameters and buffers are named like ``nn.BatchNorm2d``'s (``weight``,
    ``bias``, ``running_mean``, ``running_var``); the JAX package calls them
    ``scale``, ``bias``, ``mean`` and ``var``.
    """

    def __init__(self, num_features: int, act: Optional[str] = None,
                 eps: float = 1e-5):
        super().__init__()
        if act not in _ABN_ACTS and act != "relu":
            raise ValueError(f"Unknown activation: {act}")
        self.act = act
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "BatchNormAct train mode is not ported yet; call .eval()")
        stats = (self.running_mean, self.running_var, self.weight, self.bias)
        if self.act in _ABN_ACTS:
            tag, slope = _ABN_ACTS[self.act]
            return abn.fused_abn_infer(x, *stats, self.eps, slope, tag)
        inv = torch.rsqrt(self.running_var + self.eps)
        mul = inv * self.weight
        add = self.bias - self.running_mean * mul
        shape = (1, -1, 1, 1)
        y = torch.addcmul(add.to(x.dtype).view(shape), x,
                          mul.to(x.dtype).view(shape))
        return torch.relu_(y)
