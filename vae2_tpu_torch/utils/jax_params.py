"""Map a JAX (flax) parameter tree onto the port's ``state_dict``.

The port's submodules carry the flax names, so the walk is mechanical:
``encoder/trunk/stage4_module0/branch0/block0/conv1/kernel`` becomes
``encoder.trunk.stage4_module0.branch0.block0.conv1.weight``.

- conv kernels HWIO -> OIHW, dense kernels (in, out) -> ``nn.Linear``'s
  (out, in); biases as they are;
- BN ``scale``/``bias`` -> ``weight``/``bias``, and BN ``mean``/``var``
  from the batch_stats tree -> ``running_mean``/``running_var`` (4-d BNs
  and the posterior's 1-d ``z_bn`` alike).

The whole system maps at once: ``{'encdec': ..., 'encz': ..., 'd_seq':
..., 'd_frame': ...}`` gives the keys of ``VAE2System.modules``.

Load the result with ``load_state_dict(..., strict=True)``, which raises on
a key that is missing or left over on the port's side; this module raises
on whatever it cannot map on the JAX side.

``from_jax_inception_params`` maps the JAX package's InceptionV3 parameter
dict (not a flax tree: one flat entry per BasicConv2d) the same way.
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
    """A flax parameter tree of numpy arrays (with the matching batch_stats
    tree) -> a state dict: ``{'encoder': ..., 'dec_future': ...,
    'dec_past': ...}`` for ``VAE2EncDec``, the four networks' trees for
    ``VAE2System.modules``; any subtree maps onto the module at that
    path."""
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
                if k.ndim == 4:  # conv, HWIO -> OIHW
                    out[path + "weight"] = _tensor(k.transpose(3, 2, 0, 1))
                elif k.ndim == 2:  # dense, (in, out) -> (out, in)
                    out[path + "weight"] = _tensor(k.T)
                else:
                    raise ValueError(f"{path}kernel: expected an HWIO conv "
                                     f"or (in, out) dense kernel, got shape "
                                     f"{k.shape}")
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


_INCEPTION_BN = {"bn_scale": "bn.weight", "bn_bias": "bn.bias",
                 "bn_mean": "bn.running_mean", "bn_var": "bn.running_var"}


def from_jax_inception_params(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's flat InceptionV3 parameter dict (numpy arrays,
    ``{conv name: {'w', 'bn_scale', 'bn_bias', 'bn_mean', 'bn_var'}, 'fc':
    {'w', 'b'}}``) -> the state dict of ``models.inception.InceptionV3``:
    ``w`` HWIO -> ``conv.weight`` OIHW, the BN leaves -> ``bn.weight``,
    ``bn.bias``, ``bn.running_mean``, ``bn.running_var``, ``fc.w`` (2048,
    1000) transposed -> ``fc.weight``. Raises on a leaf it cannot map."""
    out: Dict[str, torch.Tensor] = {}
    for name, leaves in params_np.items():
        if name == "fc":
            if set(leaves) != {"w", "b"}:
                raise KeyError(f"fc: cannot map leaves {sorted(leaves)}")
            out["fc.weight"] = _tensor(np.asarray(leaves["w"]).T)
            out["fc.bias"] = _tensor(leaves["b"])
            continue
        if set(leaves) != {"w", *_INCEPTION_BN}:
            raise KeyError(f"{name}: cannot map leaves {sorted(leaves)}")
        w = np.asarray(leaves["w"])
        if w.ndim != 4:
            raise ValueError(f"{name}.w: expected an HWIO conv kernel, got "
                             f"shape {w.shape}")
        out[f"{name}.conv.weight"] = _tensor(w.transpose(3, 2, 0, 1))
        for key, torch_key in _INCEPTION_BN.items():
            out[f"{name}.{torch_key}"] = _tensor(leaves[key])
    return out
