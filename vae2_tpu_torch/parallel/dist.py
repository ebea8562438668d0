"""Process-group initialization from torch's ``env://`` variables
(counterpart of ``vae2_tpu/parallel/dist.py``; reference tools/train.py:
107-111, which calls ``init_process_group(backend='nccl',
init_method='env://')``).

``torchrun`` (``python -m torch.distributed.run``) sets ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` for each
process it starts. :func:`initialize_distributed` joins the group they
describe, and does nothing when none of them is set. A half-set
environment, or an initialization that fails, raises instead of training
quietly on one process and 1/N of the data; ``VAE2_TPU_ALLOW_SINGLE_PROCESS``
set to anything turns both into warnings, as in the JAX package.

The backend (``GPU.DIST_BACKEND``): '' picks ``nccl`` for CUDA devices and
``gloo`` for the CPU. ``gloo`` also takes CUDA tensors and reduces them
through the host, which is what lets several ranks share one card; ``nccl``
needs a card per local rank and is refused before it starts otherwise.
"""

from __future__ import annotations

import logging
import os
from typing import Tuple

import torch
import torch.distributed as dist

from . import sync

logger = logging.getLogger("vae2_tpu_torch")

ENV_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
BACKENDS = ("nccl", "gloo")


def resolve_backend(backend: str, device_type: str) -> str:
    """GPU.DIST_BACKEND, with '' meaning nccl on cuda and gloo on cpu."""
    backend = (backend or ("nccl" if device_type == "cuda" else "gloo")).lower()
    if backend not in BACKENDS:
        raise ValueError(f"GPU.DIST_BACKEND must be one of {BACKENDS} or '', "
                         f"got {backend!r}")
    return backend


def _check_nccl(local_rank: int) -> None:
    cards = torch.cuda.device_count()
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", local_rank + 1))
    if max(local_world, local_rank + 1) > cards:
        raise RuntimeError(
            f"GPU.DIST_BACKEND nccl needs one CUDA device per local rank: "
            f"{max(local_world, local_rank + 1)} local ranks, {cards} "
            "device(s). To share one device among ranks, set "
            "GPU.DIST_BACKEND gloo and --device cuda:0")


def initialize_distributed(backend: str = "", device_type: str = "cuda"
                           ) -> Tuple[int, int, int]:
    """Join the process group that the env:// variables describe; returns
    (rank, world size, local rank): (0, 1, 0) when none is set.

    A half-set environment or a failed initialization raises; with
    VAE2_TPU_ALLOW_SINGLE_PROCESS set, both warn and the run continues as
    one process. Call it before anything touches CUDA."""
    strict = not os.environ.get("VAE2_TPU_ALLOW_SINGLE_PROCESS")
    env = {k: os.environ.get(k) for k in ENV_VARS}
    have = sorted(k for k, v in env.items() if v is not None)
    if not have:
        return 0, 1, 0
    if len(have) < len(ENV_VARS):
        missing = sorted(k for k, v in env.items() if v is None)
        msg = f"distributed env half-set: missing {missing} (have {have})"
        if strict:
            raise RuntimeError(msg)
        logger.warning("%s; continuing single-process", msg)
        return 0, 1, 0
    rank, world, local_rank = (int(env["RANK"]), int(env["WORLD_SIZE"]),
                               int(env["LOCAL_RANK"]))
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), local_rank
    backend = resolve_backend(backend, device_type)
    if backend == "nccl":
        _check_nccl(local_rank)
    try:
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
    except Exception as e:  # depends on the cluster
        if strict:
            raise RuntimeError(
                "torch.distributed.init_process_group failed for an "
                f"explicitly distributed environment: {e}") from e
        logger.warning("init_process_group failed (%s); continuing "
                       "single-process", e)
        return 0, 1, 0
    logger.info("process group %s: rank %d/%d (local rank %d) @ %s:%s",
                backend, rank, world, local_rank, env["MASTER_ADDR"],
                env["MASTER_PORT"])
    return rank, world, local_rank


def shutdown_distributed() -> None:
    """Leave the process group, if one is initialized, and its layout."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    sync.set_layout()
