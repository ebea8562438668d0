"""Published peaks of the cards the benchmark knows (NVIDIA's data sheet,
H100 SXM, dense rates without sparsity, at the full 700 W power limit).
A rate read against them is a share of the published peak; the card's
power limit is printed beside every run."""

from __future__ import annotations

from typing import Dict, Optional

PEAKS = {
    "H100": {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def of(kind: str) -> Optional[Dict[str, float]]:
    """The peaks of a card by its name (``torch.cuda.get_device_name``)."""
    for key, peaks in PEAKS.items():
        if key in kind:
            return peaks
    return None
