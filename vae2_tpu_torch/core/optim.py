"""Optimizer pieces that ``torch.optim`` lacks (counterparts of
``scale_by_adam_lowp`` and the poly schedule of ``make_optimizer``,
vae2_tpu/core/system.py:79-113, 134-145).

- :class:`AdamLowp`: Adam whose two moment buffers are stored in a low
  precision (bfloat16: TPU.ADAM_MOMENT_DTYPE), with every step's arithmetic
  in float32: the moments are read up to f32, updated, used, and rounded to
  the storage dtype only when they are stored. It halves the optimizer
  state's memory.
- :func:`attach_poly_lr`: per-update poly decay ``lr * (1 - min(i /
  max_iters, 1)) ** power`` (reference utils.py:459-463), i counting this
  optimizer's own updates from 0, as optax's schedule count does. The
  count lives in the optimizer's param groups, so it is saved and resumed
  with the optimizer's state dict.
"""

from __future__ import annotations

from typing import Iterable

import torch


class AdamLowp(torch.optim.Optimizer):
    """Adam (no weight decay, as optax's ``scale_by_adam``) with moments
    stored in ``moment_dtype``: for each parameter p with gradient g,

        mu = b1 * mu + (1 - b1) * g;  nu = b2 * nu + (1 - b2) * g^2
        p -= lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

    in float32, then mu and nu rounded to ``moment_dtype`` and stored."""

    def __init__(self, params: Iterable, lr: float = 1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 moment_dtype: torch.dtype = torch.bfloat16):
        defaults = dict(lr=lr, betas=tuple(betas), eps=eps)
        super().__init__(params, defaults)
        self.moment_dtype = moment_dtype

    def load_state_dict(self, state_dict) -> None:
        # Optimizer.load_state_dict casts floating state to each parameter's
        # dtype (f32); the moments go back to their storage dtype
        super().load_state_dict(state_dict)
        for st in self.state.values():
            for key in ("exp_avg", "exp_avg_sq"):
                if key in st:
                    st[key] = st[key].to(self.moment_dtype)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps = group["lr"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(
                        p, dtype=self.moment_dtype,
                        memory_format=torch.preserve_format)
                    st["exp_avg_sq"] = torch.zeros_like(
                        p, dtype=self.moment_dtype,
                        memory_format=torch.preserve_format)
                g = p.grad.float()
                mu = st["exp_avg"].float().mul_(b1).add_(g, alpha=1 - b1)
                nu = st["exp_avg_sq"].float().mul_(b2).addcmul_(
                    g, g, value=1 - b2)
                st["step"] += 1
                t = st["step"]
                bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
                upd = (mu / bc1) / ((nu / bc2).sqrt_().add_(eps))
                p.add_(upd.to(p.dtype), alpha=-lr)
                st["exp_avg"].copy_(mu)
                st["exp_avg_sq"].copy_(nu)
        return loss


def poly_lr(base_lr: float, power: float, max_iters: int, count: int
            ) -> float:
    """The learning rate of update ``count`` (from 0) under poly decay."""
    frac = min(count / max_iters, 1.0)
    return base_lr * (1.0 - frac) ** power


def attach_poly_lr(optimizer: torch.optim.Optimizer, max_iters: int,
                   power: float) -> torch.optim.Optimizer:
    """Poly decay of every param group's lr (its lr now is the base) over
    ``max_iters`` updates of this optimizer; raises when ``max_iters`` is
    not positive, as the JAX package does. Each group counts its updates in
    ``poly_count``."""
    if max_iters <= 0:
        raise ValueError("TRAIN.LR_SCHEDULE='poly' needs max_iters > 0 "
                         "(END_EPOCH * steps-per-epoch) from the caller")
    base = [group["lr"] for group in optimizer.param_groups]
    for group in optimizer.param_groups:
        group["poly_count"] = 0

    def before(opt, args, kwargs):
        for group, lr in zip(opt.param_groups, base):
            group["lr"] = poly_lr(lr, power, max_iters,
                                  group.setdefault("poly_count", 0))

    def after(opt, args, kwargs):
        for group in opt.param_groups:
            group["poly_count"] += 1

    optimizer.register_step_pre_hook(before)
    optimizer.register_step_post_hook(after)
    return optimizer
