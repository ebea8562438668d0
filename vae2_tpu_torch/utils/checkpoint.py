"""Checkpoints of the port: ``torch.save`` of {epoch, state_dict}.

The state dict is ``VAE2System.modules.state_dict()`` (keys
``encdec.encoder.trunk...``). Reading the JAX package's msgpack checkpoints
is not ported: it needs flax or msgpack. ``utils/jax_params.py`` maps a JAX
parameter tree that is already in memory.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch


def save_checkpoint(path: str, state_dict: Dict[str, torch.Tensor],
                    epoch: int) -> None:
    """Atomically write {epoch, state_dict} to ``path``."""
    tmp = path + ".tmp"
    torch.save({"epoch": int(epoch), "state_dict": state_dict}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location="cpu"
                    ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Read a checkpoint written by ``save_checkpoint``; returns
    (state_dict, epoch). Only tensors and plain values are unpickled."""
    raw = torch.load(path, map_location=map_location, weights_only=True)
    return raw["state_dict"], int(raw["epoch"])
