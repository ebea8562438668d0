"""Training schedules (a copy of ``vae2_tpu/utils/schedule.py:16-19``;
reference lib/utils/utils.py:465-468)."""

from __future__ import annotations

import math


def dynamic_coeff(max_iters: int, cur_iters: int) -> float:
    """Sin-ramp anneal multiplier in [0, 1], applied to the KL lambda in
    VAE_ANNEAL mode."""
    return math.sin((math.pi / 2.0) * (float(cur_iters) / float(max_iters)))
