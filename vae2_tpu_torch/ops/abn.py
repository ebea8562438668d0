"""Inference-mode fused BatchNorm + activation: CUDA kernel and plain version.

Counterpart of ``fused_abn_infer`` (vae2_tpu/ops/pallas/abn.py:116-127),
which reaches the Pallas kernel ``_fwd_kernel`` through ``_abn_rows``
(:86-113). The running statistics and the affine parameters are folded in
f32 into per-channel ``mul``/``add``, cast to x's dtype, and the kernel
computes ``y = act(x * mul + add)`` in f32 and stores it in x's dtype.

Layout: x is NCHW in ``torch.channels_last`` memory — the JAX NHWC layout,
rows (R = N*H*W, C) in memory. The wrapper takes the kernel
(``csrc/abn.cu``) for a CUDA tensor and the plain PyTorch version for a CPU
tensor; nothing falls back from one to the other. The kernel's launches are
counted in ``fused_abn_infer.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

DEFAULT_SLOPE = 0.01  # leaky_relu slope (bn.py ABN default)
ACTS = {"none": 0, "leaky_relu": 1, "elu": 2}  # the kernel's act codes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's dtype codes


def _check(x: torch.Tensor, stats, act: str) -> None:
    if act not in ACTS:
        raise ValueError(f"fused_abn_infer: act must be one of {list(ACTS)}, "
                         f"got {act!r}")
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError("fused_abn_infer: x must be a 4-d float32 or "
                         f"bfloat16 tensor, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("fused_abn_infer: x must be contiguous in "
                         "torch.channels_last memory format")
    c = x.shape[1]
    if c < 1:
        raise ValueError("fused_abn_infer: x has no channels")
    for t in stats:
        if t.shape != (c,) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(
                "fused_abn_infer: mean/var/scale/bias must be float32 vectors "
                f"of length C={c} on {x.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def _fold(x, mean, var, scale, bias, eps) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mul, add) in f32, cast to x's dtype (abn.py:123-125)."""
    inv = torch.rsqrt(var + eps)
    mul = (inv * scale).to(x.dtype)
    add = (bias - mean * inv * scale).to(x.dtype)
    return mul, add


def _abn_rows_plain(x, mul, add, slope: float, act: str) -> torch.Tensor:
    """What ``_fwd_kernel`` computes, in plain PyTorch ops."""
    z = x.float() * mul.float().view(1, -1, 1, 1) + add.float().view(1, -1, 1, 1)
    if act == "elu":
        # exp(min(z, 0)) - 1, as the Pallas kernel spells it (abn.py:58-65)
        z = torch.where(z >= 0, z, torch.exp(torch.clamp(z, max=0.0)) - 1.0)
    elif act == "leaky_relu":
        z = torch.where(z >= 0, z, z * slope)
    return z.to(x.dtype).contiguous(memory_format=torch.channels_last)


@functools.lru_cache(maxsize=None)
def _kernel():
    from ..utils import cuda_build

    fn = cuda_build.load("abn").vae2_abn_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _abn_rows_cuda(x, mul, add, slope: float, act: str) -> torch.Tensor:
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"fused_abn_infer: x is on {x.device}, not on the "
                         "current CUDA device")
    y = torch.empty_like(x)  # channels_last, like x
    err = _kernel()(x.data_ptr(), mul.data_ptr(), add.data_ptr(),
                    y.data_ptr(), x.numel(), x.shape[1], _DTYPES[x.dtype],
                    ACTS[act], float(slope),
                    torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused-ABN kernel launch failed: CUDA error {err}")
    fused_abn_infer.launches += 1
    return y


def fused_abn_infer_plain(x: torch.Tensor, mean: torch.Tensor,
                          var: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, eps: float = 1e-5,
                          slope: float = DEFAULT_SLOPE,
                          act: str = "leaky_relu") -> torch.Tensor:
    """The plain PyTorch version of :func:`fused_abn_infer`, on any device."""
    _check(x, (mean, var, scale, bias), act)
    mul, add = _fold(x, mean, var, scale, bias, eps)
    return _abn_rows_plain(x, mul, add, slope, act)


def fused_abn_infer(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
                    slope: float = DEFAULT_SLOPE,
                    act: str = "leaky_relu") -> torch.Tensor:
    """Inference-mode fused BN + activation (leaky_relu/elu/none) over a
    channels_last NCHW tensor: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    _check(x, (mean, var, scale, bias), act)
    mul, add = _fold(x, mean, var, scale, bias, eps)
    if x.device.type == "cuda":
        return _abn_rows_cuda(x, mul, add, slope, act)
    if x.device.type == "cpu":
        return _abn_rows_plain(x, mul, add, slope, act)
    raise ValueError(f"fused_abn_infer: unsupported device {x.device}")


fused_abn_infer.launches = 0  # kernel launches, for run-level accounting
