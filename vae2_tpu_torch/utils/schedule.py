"""Training schedules (a copy of ``vae2_tpu/utils/schedule.py:8-19``;
reference lib/utils/utils.py:459-468)."""

from __future__ import annotations

import math


def adjust_learning_rate(base_lr: float, max_iters: int, cur_iters: int,
                         power: float = 0.9) -> float:
    """Poly LR decay (reference utils.py:459-463). The segmentation loop
    logs it and, as the JAX package's, does not apply it."""
    return base_lr * ((1.0 - float(cur_iters) / max_iters) ** power)


def dynamic_coeff(max_iters: int, cur_iters: int) -> float:
    """Sin-ramp anneal multiplier in [0, 1], applied to the KL lambda in
    VAE_ANNEAL mode."""
    return math.sin((math.pi / 2.0) * (float(cur_iters) / float(max_iters)))
