"""Checkpoints of the port: ``torch.save`` of {epoch, state_dict} and, from
training, the optimizers' state dicts (counterpart of
``vae2_tpu/utils/checkpoint.py:19-79``).

The state dict is ``VAE2System.modules.state_dict()`` (keys
``encdec.encoder.trunk...``, ``encz...``, ``d_seq...``, ``d_frame...``;
optimizers ``optimizer_g`` and ``optimizer_d``) or a ``SegHRNet``'s
(``trunk...``, ``last_layer...``; optimizer ``optimizer``: the segmentation
CLI's ``seg_checkpoint.pt`` and ``seg_final_state.pt``). Inference reads the
state dict alone.

``load_checkpoint`` also reads the JAX package's msgpack checkpoints
(``checkpoint.msgpack``, ``model_final_state.msgpack``,
``seg_final_state.msgpack``) through the port's own reader
(``utils/msgpack.py``): their epoch, ``state.params`` and
``state.batch_stats``, mapped by ``utils/jax_params.from_jax_params``; the
optax state is skipped.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel import sync
from . import msgpack
from .jax_params import from_jax_params


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


def _f32_numpy(tree):
    """bfloat16 leaves (torch tensors from the reader) as f32 numpy."""
    if isinstance(tree, dict):
        return {k: _f32_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree


def load_jax_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], int]:
    """A JAX package msgpack checkpoint ({epoch, state: {params,
    batch_stats, ...}}) as (the port's state dict, epoch), on the CPU."""
    raw = msgpack.load(path)
    state = raw["state"]
    params = _f32_numpy(state["params"])
    stats = _f32_numpy(state.get("batch_stats") or {})
    return from_jax_params(params, stats or None), int(np.asarray(raw["epoch"]))


def load_checkpoint(path: str, map_location="cpu"
                    ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Read a checkpoint written by ``save_checkpoint``, or the JAX
    package's ``.msgpack``; returns (state_dict, epoch) and leaves any
    optimizer state aside."""
    if path.endswith(".msgpack"):
        state_dict, epoch = load_jax_checkpoint(path)
        return {k: v.to(map_location) for k, v in state_dict.items()}, epoch
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


def resume_training(final_output_dir: str, system, map_location, logger
                    ) -> int:
    """TRAIN.RESUME: restore ``system`` from the output directory's
    ``checkpoint.pt`` (networks and optimizers), or, where there is none,
    from the JAX package's ``checkpoint.msgpack`` there (weights and BN
    statistics only: the optimizers start fresh, and the log says so).
    Returns the epoch to continue from, 0 when there is no checkpoint."""
    epoch = maybe_resume(os.path.join(final_output_dir, "checkpoint.pt"),
                         system, map_location=map_location)
    if epoch is not None:
        logger.info("=> loaded checkpoint (epoch %d)", epoch)
        return epoch
    jax_ckpt = os.path.join(final_output_dir, "checkpoint.msgpack")
    if not os.path.isfile(jax_ckpt):
        return 0
    state_dict, epoch = load_checkpoint(jax_ckpt, map_location=map_location)
    system.modules.load_state_dict(state_dict, strict=True)
    logger.info("=> loaded the JAX package's checkpoint %s (epoch %d): "
                "weights and BN statistics only, the optimizers start fresh",
                jax_ckpt, epoch)
    return epoch
