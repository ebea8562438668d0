"""Batch normalization with a fused activation, train and eval mode.

Counterpart of ``BatchNormAct`` (vae2_tpu/ops/norm.py:79-189). Statistics
and affine parameters are float32 whatever the compute dtype. Inputs are
(N, C, H, W) in ``torch.channels_last`` memory, or (N, C) (the posterior's
pooled MLP).

- Eval: the running statistics and the affine parameters are folded in f32
  into per-channel (mul, add) and cast to the compute dtype (abn.py:123-125).
- Train: f32 batch statistics ``mean`` and ``max(E[x^2] - mean^2, 0)``
  normalize the batch; the running statistics update with momentum 0.01,
  the running variance Bessel-corrected by n / (n - 1), n = N*H*W
  (norm.py:140-157).
- act None, 'leaky_relu' or 'elu': the fused-ABN kernels — ``fused_abn_infer``
  in eval, the ``fused_abn`` autograd op (kernel 1 forward, kernels 2-3
  backward) in train; the CUDA kernels on a CUDA tensor. Both hand kernel 1
  the f32 statistics and affine parameters, and it folds them itself, one
  launch per BN. ``TPU.FUSED_ABN`` does not switch this.
- act 'relu': the plain epilogue (norm.py:177-189), ``x * mul + add`` in the
  compute dtype and a ReLU; in train, autograd runs through the batch
  statistics. ReLU cannot be inverted from its output, so the JAX package
  keeps it off the ABN kernels too.

Under ``torch.utils.checkpoint`` the forward runs twice; the recompute runs
inside :func:`frozen_running_stats`, so that the running statistics update
once per forward, as under the JAX package's functional remat.

Across ranks (``parallel/sync.py``) every BN in train mode has SyncBN
semantics, as the JAX package's BNs over the ``data`` mesh axis: the batch
statistics are those of the global batch (``abn.batch_stats``, one
all-reduce per BN forward, differentiable on the ReLU path), the running
variance is Bessel-corrected with the global n (norm.py:148-157), and a
recompute all-reduces its statistics again, as the JAX remat recomputes the
``pmean``; every rank runs the same BNs in the same order, so the
collectives pair up.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch
from torch import nn

from ..utils import spans
from . import abn

# act name -> (kernel act tag, slope), as norm.py:62-63
_ABN_ACTS = {None: ("none", 1.0), "none": ("none", 1.0),
             "leaky_relu": ("leaky_relu", abn.DEFAULT_SLOPE),
             "elu": ("elu", 1.0)}

_frozen = threading.local()


class frozen_running_stats:
    """Train-mode BNs run inside this context leave their running statistics
    as they are (the recompute of a checkpointed region, on this thread).
    One object may be entered again after it exits: a checkpointed region
    recomputes in each backward through a retained graph, under the context
    object made for its forward."""

    def __init__(self):
        self._prev = []

    def __enter__(self) -> None:
        self._prev.append(getattr(_frozen, "on", False))
        _frozen.on = True

    def __exit__(self, *exc) -> None:
        _frozen.on = self._prev.pop()


class BatchNormAct(nn.Module):
    """BatchNorm over all axes but axis 1, with optional act.

    Parameters and buffers are named like ``nn.BatchNorm2d``'s (``weight``,
    ``bias``, ``running_mean``, ``running_var``); the JAX package calls them
    ``scale``, ``bias``, ``mean`` and ``var``.
    """

    def __init__(self, num_features: int, act: Optional[str] = None,
                 eps: float = 1e-5, momentum: float = 0.01):
        super().__init__()
        if act not in _ABN_ACTS and act != "relu":
            raise ValueError(f"Unknown activation: {act}")
        self.act = act
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 4 and (x.dim() != 2 or self.act != "relu"):
            raise ValueError(
                f"BatchNormAct(act={self.act!r}) takes (N, C, H, W) input"
                f"{' or (N, C)' if self.act == 'relu' else ''}, got "
                f"{tuple(x.shape)}")
        if not self.training:
            mean, var = self.running_mean, self.running_var
        elif self.act in _ABN_ACTS:
            with torch.no_grad(), spans.span("abn.batch_stats"):
                mean, var = abn.batch_stats(x)
            self._update_running(mean, var, x)
        else:
            with spans.span("abn.batch_stats"):
                mean, var = abn.batch_stats(x)
            self._update_running(mean.detach(), var.detach(), x)
        if self.act in _ABN_ACTS:
            tag, slope = _ABN_ACTS[self.act]
            if self.training:
                return abn.fused_abn(x, self.weight, self.bias, self.eps,
                                     slope, tag, stats=(mean, var))
            return abn.fused_abn_infer(x, mean, var, self.weight, self.bias,
                                       self.eps, slope, tag)
        inv = torch.rsqrt(var + self.eps)
        mul = inv * self.weight
        add = self.bias - mean * mul
        shape = (1, -1) + (1,) * (x.dim() - 2)
        y = torch.addcmul(add.to(x.dtype).view(shape), x,
                          mul.to(x.dtype).view(shape))
        return torch.relu_(y)

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor,
                        x: torch.Tensor) -> None:
        if getattr(_frozen, "on", False):
            return
        n = abn.stat_rows(x)
        m = self.momentum
        with torch.no_grad():
            unbiased = var * (n / max(n - 1, 1))
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * unbiased)
