"""Checkpoints of the port: ``torch.save`` of {epoch, state_dict} and, from
training, the optimizers' state dicts (counterpart of
``vae2_tpu/utils/checkpoint.py:19-79``).

The state dict is ``VAE2System.modules.state_dict()`` (keys
``encdec.encoder.trunk...``, ``encz...``, ``d_seq...``, ``d_frame...``;
optimizers ``optimizer_g`` and ``optimizer_d``) or a ``SegHRNet``'s
(``trunk...``, ``last_layer...``; optimizer ``optimizer``: the segmentation
CLI's ``seg_checkpoint.pt`` and ``seg_final_state.pt``). Inference reads the
state dict alone. Reading the JAX package's msgpack
checkpoints is not ported: it needs flax or msgpack.
``utils/jax_params.py`` maps a JAX parameter tree that is already in memory.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from ..parallel import sync


def save_checkpoint(path: str, state_dict: Dict[str, torch.Tensor],
                    epoch: int, **optimizers) -> None:
    """Atomically write {epoch, state_dict} and, for each keyword
    optimizer that is not None, its state dict under its keyword. In a
    multi-process run rank 0 writes (every rank holds the same state) and
    every rank waits at a barrier until the file is there."""
    if sync.rank() == 0:
        payload = {"epoch": int(epoch), "state_dict": state_dict}
        for key, opt in optimizers.items():
            if opt is not None:
                payload[key] = opt.state_dict()
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
    sync.barrier()


def _read(path: str, map_location) -> dict:
    # only tensors and plain values are unpickled
    return torch.load(path, map_location=map_location, weights_only=True)


def load_checkpoint(path: str, map_location="cpu"
                    ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Read a checkpoint written by ``save_checkpoint``; returns
    (state_dict, epoch) and leaves any optimizer state aside."""
    raw = _read(path, map_location)
    return raw["state_dict"], int(raw["epoch"])


def maybe_resume(path: str, system, map_location="cpu") -> Optional[int]:
    """Restore ``system``'s networks and optimizers from the checkpoint at
    ``path`` if it exists (reference tools/train.py:270-290); returns its
    epoch, or None when there is no checkpoint. The networks load strictly;
    an optimizer whose state the checkpoint lacks raises. In a
    multi-process run every rank reads the same file onto its own device
    (``map_location``)."""
    if not os.path.isfile(path):
        return None
    raw = _read(path, map_location)
    system.modules.load_state_dict(raw["state_dict"], strict=True)
    for key in ("optimizer_g", "optimizer_d"):
        opt = getattr(system, key)
        if opt is not None:
            if key not in raw:
                raise KeyError(f"{path} holds no {key} state to resume")
            opt.load_state_dict(raw[key])
    return int(raw["epoch"])
