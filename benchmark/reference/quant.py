"""The control precision: the reference computed in float8.

The configurations state bfloat16: the program stores every activation
and every BN's folded scale and shift in bfloat16 and computes the batch
statistics in float32. The nearest precision below is float8, and under
:func:`fp8` the reference stores the same values in it: each
convolution's input, kernel and output, each BN's folded scale and shift
and its output, each residual sum, in e4m3, and the gradient that reaches
a convolution's output in e5m2. Each tensor has one scale (its largest
magnitude mapped to the format's largest finite value), as float8
training scales them; arithmetic between the stored values runs in
float32, and the rounding is straight-through for the gradient."""

from __future__ import annotations

import contextlib

import torch

_ON = [False]
E4M3 = (torch.float8_e4m3fn, 448.0)
E5M2 = (torch.float8_e5m2, 57344.0)


@contextlib.contextmanager
def exact_f32():
    """True float32 products (TF32 off) for the reference's arithmetic."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


@contextlib.contextmanager
def fp8():
    _ON[0] = True
    try:
        yield
    finally:
        _ON[0] = False


def rounded(x: torch.Tensor, fmt=E4M3) -> torch.Tensor:
    """x rounded to ``fmt`` (dtype, largest finite value) with one scale
    for the tensor."""
    dtype, top = fmt
    with torch.no_grad():
        scale = top / x.detach().abs().amax().float().clamp(min=1e-30)
        return ((x.detach().float() * scale).to(dtype).float() / scale).to(x.dtype)


class _GradE5M2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, dy):
        return rounded(dy, E5M2)


def store(x: torch.Tensor) -> torch.Tensor:
    """A value as the reference stores it: e4m3 under :func:`fp8`."""
    return x + (rounded(x) - x).detach() if _ON[0] else x


def conv_output(y: torch.Tensor) -> torch.Tensor:
    """A convolution's output: stored, and its gradient e5m2, under
    :func:`fp8`."""
    if not _ON[0]:
        return y
    y = store(y)
    return _GradE5M2.apply(y) if y.requires_grad else y
