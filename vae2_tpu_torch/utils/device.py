"""Device, dtype and float32-precision helpers."""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(name: str) -> torch.device:
    """A torch.device; raises when CUDA is asked for and there is none (the
    entry points never fall back to the CPU on their own)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            "False; pass --device cpu to run on the CPU")
    return device


def compute_dtype(config) -> torch.dtype:
    """GPU.DTYPE, or TPU.DTYPE when GPU.DTYPE is empty."""
    name = config.GPU.DTYPE or config.TPU.DTYPE
    if name not in _DTYPES:
        raise ValueError(f"compute dtype must be one of {list(_DTYPES)}, "
                         f"got {name!r}")
    return _DTYPES[name]


@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    """True float32 convolutions and matmuls: cuDNN runs float32
    convolutions in TF32 by default, which keeps about three decimal
    digits. Restores the previous settings on exit."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
