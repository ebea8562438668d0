"""Map a JAX (flax) parameter tree onto the port's ``state_dict``.

The port's submodules carry the flax names, so the walk is mechanical:
``encoder/trunk/stage4_module0/branch0/block0/conv1/kernel`` becomes
``encoder.trunk.stage4_module0.branch0.block0.conv1.weight``.

- conv kernels HWIO -> OIHW; conv biases as they are;
- BN ``scale``/``bias`` -> ``weight``/``bias``, and BN ``mean``/``var``
  from the batch_stats tree -> ``running_mean``/``running_var``.

Load the result with ``load_state_dict(..., strict=True)``, which raises on
a key that is missing or left over on the port's side; this module raises
on whatever it cannot map on the JAX side.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Optional

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def from_jax_params(params_np: Mapping, batch_stats_np: Optional[Mapping] = None
                    ) -> Dict[str, torch.Tensor]:
    """``{'encoder': {'trunk': ..., 'last_layer_1': ...}, 'dec_future': ...,
    'dec_past': ...}`` of numpy arrays (with the matching batch_stats tree)
    -> a state dict for ``VAE2EncDec``; any subtree maps onto the module at
    that path."""
    out: Dict[str, torch.Tensor] = {}

    def walk(p: Mapping, s: Optional[Mapping], path: str) -> None:
        s = s or {}
        stats = {k: v for k, v in s.items() if not isinstance(v, Mapping)}
        for key, sub in s.items():
            if isinstance(sub, Mapping) and key not in p:
                raise KeyError(f"batch_stats {path}{key} has no parameters")
        leaves = {k: v for k, v in p.items() if not isinstance(v, Mapping)}
        if stats and set(leaves) != {"scale", "bias"}:
            raise KeyError(f"{path[:-1]}: batch_stats {sorted(stats)} left "
                           "over (not a BN)")
        if leaves:
            if "kernel" in leaves and set(leaves) <= {"kernel", "bias"}:
                k = np.asarray(leaves["kernel"])
                if k.ndim != 4:
                    raise ValueError(f"{path}kernel: expected an HWIO conv "
                                     f"kernel, got shape {k.shape}")
                out[path + "weight"] = _tensor(k.transpose(3, 2, 0, 1))
                if "bias" in leaves:
                    out[path + "bias"] = _tensor(leaves["bias"])
            elif set(leaves) == {"scale", "bias"}:
                if set(stats) != {"mean", "var"}:
                    raise KeyError(f"{path[:-1]}: BN needs batch_stats "
                                   f"mean/var, got {sorted(stats)}")
                out[path + "weight"] = _tensor(leaves["scale"])
                out[path + "bias"] = _tensor(leaves["bias"])
                out[path + "running_mean"] = _tensor(stats["mean"])
                out[path + "running_var"] = _tensor(stats["var"])
            else:
                raise KeyError(f"{path[:-1]}: cannot map leaves "
                               f"{sorted(leaves)}")
        for key, sub in p.items():
            if isinstance(sub, Mapping):
                walk(sub, s.get(key), f"{path}{key}.")

    walk(params_np, batch_stats_np, "")
    return out
