"""Fused BatchNorm + activation (InPlace-ABN): CUDA kernels and plain versions.

Counterpart of ``vae2_tpu/ops/pallas/abn.py``. Three kernels, each with a
plain PyTorch version of the same arithmetic and a launch count:

- kernel 1 (``csrc/abn.cu``; Pallas ``_fwd_kernel`` through ``_abn_rows``,
  abn.py:86-113, with the BN fold of its callers, :123-125 and :247-249):
  ``y = act(x * mul + add)`` per channel, computed in f32 and stored in x's
  dtype. The main path hands it the BN statistics and affine parameters,
  and the kernel folds them into (mul, add) itself: ``fused_abn_infer``
  (running statistics) and ``abn_fwd_train`` (batch statistics; it also
  returns ``gamma * inv_std`` for the backward). ``abn_rows`` takes (mul,
  add) already folded. All three count into ``abn_rows.launches``.
- ``abn_bwd_sums`` (kernel 2, ``csrc/abn_bwd.cu``; Pallas ``_sums_kernel``,
  abn.py:135-159): the activation inverted from ``y``, ``y_norm = (z - beta)
  / gamma``, and per channel ``edz = sum(dz_eff)``, ``eydz = sum(y_norm *
  dz_eff)``, in f32. One launch, deterministic.
- ``abn_bwd_dx`` (kernel 3, ``csrc/abn_bwd.cu``; Pallas ``_dx_kernel``,
  abn.py:162-177): ``dx = (dz_eff - edz/N - y_norm * eydz/N) * gamma *
  inv_std``, stored in y's dtype, where N is the count of rows that the
  statistics and the sums cover: the local rows on one process, those of
  every rank under data parallelism (``FusedABN``).

On top of them the training op ``fused_abn``, a ``torch.autograd.Function``
with the InPlace-ABN backward (abn.py:232-267): the forward saves only ``y``
and per-channel vectors, the backward launches kernels 2 then 3. Across
ranks (``parallel/sync.py``) the batch statistics and kernel 2's sums are
all-reduced outside the kernels; the kernels themselves do not change.

Each kernel call on a CUDA tensor is one ctypes call and one launch, and
allocates only its outputs; kernel 2's partial sums live in a scratch buffer
kept per (device, stream). A call on a tensor with no elements (a spatial
rank that owns no rows of a branch) launches nothing, on either device:
kernel 1 returns an empty y, kernel 2 zero sums, kernel 3 an empty dx.

Layout: NCHW tensors in ``torch.channels_last`` memory — the JAX NHWC
layout, rows (R = N*H*W, C) in memory. Each wrapper takes its kernel for a
CUDA tensor and its plain version for a CPU tensor; nothing falls back from
one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from ..parallel import sync
from ..utils import spans

DEFAULT_SLOPE = 0.01  # leaky_relu slope (bn.py ABN default)
ACTS = {"none": 0, "leaky_relu": 1, "elu": 2}  # the kernels' act codes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernels' dtype codes
_CL = torch.channels_last
_DIMS = (0, 2, 3)  # every axis but the channel axis
# Kernel 2's grid: at most SUMS_BLOCKS_PER_SM blocks per SM, and no more
# blocks than give each thread SUMS_MIN_ITERS 16-byte vectors of y and dz:
# each block adds a row of 2C partial sums that the last block reads back
# alone, so a small tensor takes few blocks. The best of a sweep over a
# train step's shapes on the H100 (tools/bench_abn.py --sums-grid).
SUMS_BLOCKS_PER_SM = 2
SUMS_MIN_ITERS = 4


def _vec(t: torch.Tensor) -> torch.Tensor:
    """A per-channel (C,) vector as (1, C, 1, 1)."""
    return t.view(1, -1, 1, 1)


def _check_rows(name: str, x: torch.Tensor, act: str) -> None:
    if act not in ACTS:
        raise ValueError(f"{name}: act must be one of {list(ACTS)}, "
                         f"got {act!r}")
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"{name}: x must be a 4-d float32 or bfloat16 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous(memory_format=_CL):
        raise ValueError(f"{name}: x must be contiguous in "
                         "torch.channels_last memory format")
    if x.shape[1] < 1:
        raise ValueError(f"{name}: x has no channels")


def _check_vectors(name: str, x: torch.Tensor, vectors, dtype=torch.float32,
                   rows: int = 1) -> None:
    c, device = x.shape[1], x.device
    shape = (c,) if rows == 1 else (rows, c)
    for t in vectors:
        if t.shape != shape or t.dtype != dtype or t.device != device:
            kind = str(dtype).replace("torch.", "")
            raise ValueError(
                f"{name}: per-channel values must be {rows} {kind} vectors "
                f"of length C={c} on {device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def _cuda_index(name: str, x: torch.Tensor) -> int:
    """x's CUDA device index, which must be the current device."""
    dev = x.get_device()
    if dev != torch._C._cuda_getDevice():
        raise ValueError(f"{name}: x is on {x.device}, not on the current "
                         "CUDA device")
    return dev


def _stream(dev: int) -> int:
    """The raw handle of the current CUDA stream of device ``dev``."""
    return torch._C._cuda_getCurrentRawStream(dev)


def _dispatch(name: str, x: torch.Tensor, cuda_fn, plain_fn, *args):
    if x.device.type == "cuda":
        return cuda_fn(*args)
    if x.device.type == "cpu":
        return plain_fn(*args)
    raise ValueError(f"{name}: unsupported device {x.device}")


def _launched(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"fused-ABN {what} kernel launch failed: CUDA "
                           f"error {err}")


# ---- kernel 1: y = act(x * mul + add) ------------------------------------


def abn_rows_plain(x, mul, add, slope: float, act: str) -> torch.Tensor:
    """What kernel 1 (``_fwd_kernel``) computes, in plain PyTorch ops."""
    z = x.float() * _vec(mul.float()) + _vec(add.float())
    if act == "elu":
        # exp(min(z, 0)) - 1, as the Pallas kernel spells it (abn.py:58-65),
        # taken in f64 and rounded once, as kernel 1 takes it: the same bits
        # on the card and here, in every call. torch.exp in f32 is not so:
        # on the CPU the first parallel call of a process can give a worker
        # thread's share (3-12% of the elements) other last bits than later
        # calls, and the backward, which inverts elu from y, amplifies one
        # ulp of y near -1 to ~1e-4 of dx.
        e = (torch.exp(torch.clamp(z, max=0.0).double()) - 1.0).float()
        z = torch.where(z >= 0, z, e)
    elif act == "leaky_relu":
        z = torch.where(z >= 0, z, z * slope)
    return z.to(x.dtype).contiguous(memory_format=_CL)


def _fold_plain(x, mean, var, gamma, beta, eps: float, slope: float,
                act: str, train: bool):
    """What kernel 1's fold entry computes: the f32 fold (abn.py:123-125,
    247-249) cast to x's dtype, then ``abn_rows_plain``; with ``train`` also
    the f32 ``gamma * inv_std`` (abn.py:208)."""
    inv = torch.rsqrt(var + eps)
    gamma_inv = inv * gamma
    mul = gamma_inv.to(x.dtype)
    add = (beta - mean * inv * gamma).to(x.dtype)
    y = abn_rows_plain(x, mul, add, slope, act)
    return (y, gamma_inv) if train else y


@functools.lru_cache(maxsize=None)
def _fwd_lib():
    from ..utils import cuda_build

    lib = cuda_build.load("abn")
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.vae2_abn_fwd_fold.argtypes = [p] * 7 + [ll, i, i, i, f, f, p]
    lib.vae2_abn_fwd_fold.restype = i
    lib.vae2_abn_fwd.argtypes = [p] * 4 + [ll, i, i, i, f, p]
    lib.vae2_abn_fwd.restype = i
    return lib


def _fold_cuda(x, mean, var, gamma, beta, eps: float, slope: float,
               act: str, train: bool):
    dev = _cuda_index("abn_rows", x)
    y = torch.empty_like(x)  # channels_last, like x
    gamma_inv = torch.empty_like(mean) if train else None
    _launched(_fwd_lib().vae2_abn_fwd_fold(
        x.data_ptr(), mean.data_ptr(), var.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), y.data_ptr(),
        gamma_inv.data_ptr() if train else None, x.numel(), x.shape[1],
        _DTYPES[x.dtype], ACTS[act], eps, slope, _stream(dev)), "forward")
    abn_rows.launches += 1
    return (y, gamma_inv) if train else y


def _abn_rows_cuda(x, mul, add, slope: float, act: str) -> torch.Tensor:
    dev = _cuda_index("abn_rows", x)
    y = torch.empty_like(x)
    _launched(_fwd_lib().vae2_abn_fwd(
        x.data_ptr(), mul.data_ptr(), add.data_ptr(), y.data_ptr(),
        x.numel(), x.shape[1], _DTYPES[x.dtype], ACTS[act], slope,
        _stream(dev)), "forward")
    abn_rows.launches += 1
    return y


def abn_rows(x: torch.Tensor, mul: torch.Tensor, add: torch.Tensor,
             slope: float, act: str) -> torch.Tensor:
    """Kernel 1 on a CUDA tensor, its plain version on a CPU tensor; ``mul``
    and ``add`` are (C,) vectors in x's dtype."""
    _check_rows("abn_rows", x, act)
    _check_vectors("abn_rows", x, (mul, add), dtype=x.dtype)
    if x.numel() == 0:
        return torch.empty_like(x)
    return _dispatch("abn_rows", x, _abn_rows_cuda, abn_rows_plain,
                     x, mul, add, slope, act)


abn_rows.launches = 0  # kernel-1 launches of all its entries


def fused_abn_infer_plain(x: torch.Tensor, mean: torch.Tensor,
                          var: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, eps: float = 1e-5,
                          slope: float = DEFAULT_SLOPE,
                          act: str = "leaky_relu") -> torch.Tensor:
    """The plain PyTorch version of :func:`fused_abn_infer`, on any device."""
    _check_rows("fused_abn_infer", x, act)
    _check_vectors("fused_abn_infer", x, (mean, var, scale, bias))
    return _fold_plain(x, mean, var, scale, bias, eps, slope, act, False)


def fused_abn_infer(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
                    slope: float = DEFAULT_SLOPE,
                    act: str = "leaky_relu") -> torch.Tensor:
    """Inference-mode fused BN + activation (leaky_relu/elu/none) over a
    channels_last NCHW tensor: kernel 1, folding the f32 statistics itself,
    on a CUDA tensor; the plain version on a CPU tensor."""
    _check_rows("fused_abn_infer", x, act)
    _check_vectors("fused_abn_infer", x, (mean, var, scale, bias))
    if x.numel() == 0:
        return torch.empty_like(x)
    return _dispatch("fused_abn_infer", x, _fold_cuda, _fold_plain,
                     x, mean, var, scale, bias, eps, slope, act, False)


def abn_fwd_train_plain(x, mean, var, gamma, beta, eps: float, slope: float,
                        act: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`abn_fwd_train`."""
    return _fold_plain(x, mean, var, gamma, beta, eps, slope, act, True)


def abn_fwd_train(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                  gamma: torch.Tensor, beta: torch.Tensor, eps: float,
                  slope: float, act: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward of the fused ABN: kernel 1 folding the f32 batch
    statistics on a CUDA tensor, the plain version on a CPU tensor. Returns
    ``y`` and the f32 (C,) vector ``gamma * rsqrt(var + eps)`` that the
    backward's kernel 3 takes as ``mul``."""
    _check_rows("abn_fwd_train", x, act)
    _check_vectors("abn_fwd_train", x, (mean, var, gamma, beta))
    if x.numel() == 0:
        return torch.empty_like(x), torch.rsqrt(var + eps) * gamma
    return _dispatch("abn_fwd_train", x, _fold_cuda, _fold_plain,
                     x, mean, var, gamma, beta, eps, slope, act, True)


# ---- kernels 2 and 3: the activation-inverting backward -------------------


def _act_invert(y, dz, act: str, slope: float):
    """(pre-activation z, effective grad dz_eff) from the output y, in f32
    (abn.py:68-78)."""
    if act == "elu":
        z = torch.where(y >= 0, y, torch.log(torch.clamp(1.0 + y, min=1e-12)))
        return z, torch.where(y >= 0, dz, dz * (y + 1.0))
    if act == "leaky_relu":
        return (torch.where(y >= 0, y, y / slope),
                torch.where(y >= 0, dz, dz * slope))
    return y, dz


def _y_norm(y, dz, gamma, beta, slope: float, act: str):
    z, dz_eff = _act_invert(y.float(), dz.float(), act, slope)
    return (z - _vec(beta)) / _vec(gamma), dz_eff


def abn_bwd_sums_plain(y, dz, gamma, beta, slope: float, act: str
                       ) -> torch.Tensor:
    """What kernel 2 (``_sums_kernel``) computes: (2, C) f32 [edz; eydz]."""
    y_norm, dz_eff = _y_norm(y, dz, gamma, beta, slope, act)
    return torch.stack([dz_eff.sum(_DIMS), (y_norm * dz_eff).sum(_DIMS)])


def abn_bwd_dx_plain(y, dz, gamma, beta, mul, sums, slope: float, act: str,
                     count: int) -> torch.Tensor:
    """What kernel 3 (``_dx_kernel``) computes, in y's dtype; ``mul`` is
    gamma * inv_std, ``sums`` the (2, C) sums of kernel 2 over ``count``
    rows."""
    inv_n = 1.0 / count
    y_norm, dz_eff = _y_norm(y, dz, gamma, beta, slope, act)
    dx = (dz_eff - _vec(sums[0]) * inv_n - y_norm * _vec(sums[1]) * inv_n
          ) * _vec(mul)
    return dx.to(y.dtype).contiguous(memory_format=_CL)


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    from ..utils import cuda_build

    lib = cuda_build.load("abn_bwd")
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.vae2_abn_bwd_sums.argtypes = [p] * 5 + [ll, p, ll, i, i, i, f, i, i,
                                                 p]
    lib.vae2_abn_bwd_sums.restype = ll
    lib.vae2_abn_bwd_dx.argtypes = [p] * 7 + [ll, i, i, i, f, f, p]
    lib.vae2_abn_bwd_dx.restype = i
    return lib


# Kernel 2's scratch (its ticket counters, then the per-block and per-group
# partial sums) per (device, stream): calls on one stream run in order, so
# they can share it; the counters are zeroed when the buffer is made and
# every completed launch leaves them 0.
_sums_scratch: Dict[Tuple[int, int], torch.Tensor] = {}


def sums_scratch(device: int, stream: int) -> Optional[torch.Tensor]:
    """Kernel 2's scratch on CUDA device ``device`` and raw stream
    ``stream``, if made. A CUDA graph captured on that stream holds the
    buffer's address; keeping a reference keeps the buffer alive should a
    later call on the stream replace it by a larger one."""
    return _sums_scratch.get((device, stream))


def _sums_cuda(y, dz, gamma, beta, slope: float, act: str) -> torch.Tensor:
    dev = _cuda_index("abn_bwd_sums", y)
    stream = _stream(dev)
    c = y.shape[1]
    sums = y.new_empty((2, c), dtype=torch.float32)
    head = (y.data_ptr(), dz.data_ptr(), gamma.data_ptr(), beta.data_ptr())
    tail = (sums.data_ptr(), y.numel(), c, _DTYPES[y.dtype], ACTS[act], slope,
            SUMS_BLOCKS_PER_SM, SUMS_MIN_ITERS, stream)
    fn = _bwd_lib().vae2_abn_bwd_sums
    scratch = _sums_scratch.get((dev, stream))
    err = fn(*head, *((None, 0) if scratch is None else
                      (scratch.data_ptr(), scratch.numel())), *tail)
    if err < 0:  # too small, nothing launched: grow to what it asks for
        scratch = torch.zeros(-err, dtype=torch.float32, device=y.device)
        _sums_scratch[(dev, stream)] = scratch
        err = fn(*head, scratch.data_ptr(), scratch.numel(), *tail)
    _launched(err, "sums")
    abn_bwd_sums.launches += 1
    return sums


def _dx_cuda(y, dz, gamma, beta, mul, sums, slope: float, act: str,
             count: int) -> torch.Tensor:
    dev = _cuda_index("abn_bwd_dx", y)
    dx = torch.empty_like(y)
    _launched(_bwd_lib().vae2_abn_bwd_dx(
        y.data_ptr(), dz.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        mul.data_ptr(), sums.data_ptr(), dx.data_ptr(), y.numel(),
        y.shape[1], _DTYPES[y.dtype], ACTS[act], slope, 1.0 / count,
        _stream(dev)), "dx")
    abn_bwd_dx.launches += 1
    return dx


def _check_bwd(name: str, y, dz, act: str) -> None:
    _check_rows(name, y, act)
    if dz.shape != y.shape or dz.dtype != y.dtype or dz.device != y.device:
        raise ValueError(f"{name}: dz must match y, got {dz.dtype} "
                         f"{tuple(dz.shape)} on {dz.device}")
    if not dz.is_contiguous(memory_format=_CL):
        raise ValueError(f"{name}: dz must be contiguous in "
                         "torch.channels_last memory format")


def abn_bwd_sums(y: torch.Tensor, dz: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor, slope: float, act: str) -> torch.Tensor:
    """Kernel 2 on CUDA tensors, its plain version on CPU tensors: the
    (2, C) f32 per-channel sums [edz; eydz] of the ABN backward."""
    _check_bwd("abn_bwd_sums", y, dz, act)
    _check_vectors("abn_bwd_sums", y, (gamma, beta))
    if y.numel() == 0:
        return y.new_zeros((2, y.shape[1]), dtype=torch.float32)
    return _dispatch("abn_bwd_sums", y, _sums_cuda, abn_bwd_sums_plain,
                     y, dz, gamma, beta, slope, act)


def abn_bwd_dx(y: torch.Tensor, dz: torch.Tensor, gamma: torch.Tensor,
               beta: torch.Tensor, mul: torch.Tensor, sums: torch.Tensor,
               slope: float, act: str, count: int) -> torch.Tensor:
    """Kernel 3 on CUDA tensors, its plain version on CPU tensors: dx of
    the ABN backward, in y's dtype. ``count`` is the number of rows that
    ``sums`` and the batch statistics cover (y's own rows on one process,
    N_global under data parallelism)."""
    _check_bwd("abn_bwd_dx", y, dz, act)
    _check_vectors("abn_bwd_dx", y, (gamma, beta, mul))
    _check_vectors("abn_bwd_dx", y, (sums,), rows=2)
    if count < 1:
        raise ValueError(f"abn_bwd_dx: count must be positive, got {count}")
    if y.numel() == 0:
        return torch.empty_like(y)
    return _dispatch("abn_bwd_dx", y, _dx_cuda, abn_bwd_dx_plain,
                     y, dz, gamma, beta, mul, sums, slope, act, count)


abn_bwd_sums.launches = 0
abn_bwd_dx.launches = 0


# ---- the training op --------------------------------------------------------


def stat_rows(x: torch.Tensor) -> int:
    """The rows of the statistics of x: every element of one channel, on
    every rank. Data shards are equal (N_global = N_local x D); under a
    spatial layout a map's rows are its global H (``sync.global_rows``),
    however unequally its ranks hold them, and an (N, C) tensor is the same
    on every rank of a spatial group (counted once per rank, as its sums
    are)."""
    if x.dim() == 4 and sync.spatial_size() > 1:
        h = sync.global_rows(x.shape[2], x.shape[3])
        return x.shape[0] * sync.data_size() * h * x.shape[3]
    return x.numel() // x.shape[1] * sync.world_size()


def batch_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 batch mean and biased variance over every axis but axis 1:
    ``mean``, ``max(E[x^2] - mean^2, 0)`` (abn.py:244-246, norm.py:141-147).

    Across ranks (SyncBN) the local sums of x and x^2 are stacked,
    all-reduced once, differentiably, and divided by the global count
    (:func:`stat_rows`): the JAX package's ``pmean`` over the data axis,
    and over unequal row shards too, where a rank may hold no rows."""
    dims = (0,) + tuple(range(2, x.dim()))
    xf = x.float()
    if sync.world_size() == 1:
        mean, mean2 = xf.mean(dims), (xf * xf).mean(dims)
    else:
        sums = sync.all_reduce_sum(torch.stack([xf.sum(dims),
                                                (xf * xf).sum(dims)]))
        mean, mean2 = (sums / stat_rows(x)).unbind(0)
    return mean, torch.clamp(mean2 - mean * mean, min=0.0)


class FusedABN(torch.autograd.Function):
    """Training-mode fused BN (batch statistics) + activation with the
    InPlace-ABN backward: the forward (kernel 1, :func:`abn_fwd_train`)
    saves ``y``, gamma, beta and ``gamma * inv_std`` — not x — and the
    backward rebuilds the normalized pre-activation from ``y`` (abn.py:
    232-267) with kernels 2 and 3 and no other op of its own. Under
    ``torch.utils.checkpoint`` the saved tensors come from the recompute.

    ``apply(x, weight, bias, mean, var, eps, slope, act)``: mean and var are
    the f32 batch statistics of x (:func:`batch_stats`), passed in so that
    the caller can also update its running statistics; they carry no
    gradient (the backward's formula accounts for them).

    Across R ranks (SyncBN, as ``nn.SyncBatchNorm`` splits it): mean and
    var are global, and rank r's loss L_r is the mean over its own rows.
    The gradient that the optimizer needs is that of L = (1/R) sum_r L_r.
    On rank r, dz = dL_r/dy covers its rows only, but x_i reaches every
    rank's loss through the global statistics, so
    d(sum_r L_r)/dx_i = (dz_i - sum_g(dz)/N - y_norm_i * sum_g(y_norm dz)/N)
    * gamma * inv_std, with sum_g the sum over every rank's rows and N =
    N_global: kernel 3 is handed the all-reduced kernel-2 sums and 1/N.
    dgamma and dbeta of sum_r L_r are the sums over ranks of the local
    kernel-2 sums; the backward returns the local ones, and the gradient
    all-reduce (core/system.py) sums them and divides by R, as it does
    every other gradient of sum_r L_r, which gives dL."""

    dz_copies = 0  # incoming gradients that were not channels_last-dense

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, eps, slope, act):
        y, gamma_inv = abn_fwd_train(x, mean, var, weight, bias, eps, slope,
                                     act)
        ctx.save_for_backward(y, weight, bias, gamma_inv)
        ctx.slope, ctx.act = slope, act
        return y

    @staticmethod
    def backward(ctx, dy):
        y, weight, bias, gamma_inv = ctx.saved_tensors
        dz = dy.to(y.dtype)
        if not dz.is_contiguous(memory_format=_CL):
            dz = dz.contiguous(memory_format=_CL)  # the one copy at most
            FusedABN.dz_copies += 1
        sums = abn_bwd_sums(y, dz, weight, bias, ctx.slope, ctx.act)
        global_sums = (sums if sync.world_size() == 1
                       else sync.all_reduce_(sums.clone()))
        dx = abn_bwd_dx(y, dz, weight, bias, gamma_inv, global_sums,
                        ctx.slope, ctx.act, stat_rows(y))
        # dgamma = eydz, dbeta = edz (abn.py:262-264), this rank's
        return dx, sums[1], sums[0], None, None, None, None, None


def fused_abn(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5, slope: float = DEFAULT_SLOPE,
              act: str = "leaky_relu",
              stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> torch.Tensor:
    """Training-mode fused BN + activation (leaky_relu/elu/none) over a
    channels_last NCHW tensor, differentiable in x, weight and bias.
    ``stats`` is (mean, var) of x when the caller has them already."""
    if stats is None:
        _check_rows("fused_abn", x, act)
        with torch.no_grad():
            stats = batch_stats(x)
    return FusedABN.apply(x, weight, bias, stats[0], stats[1], eps, slope,
                          act)


# the counts under their names in the program's one view (utils/spans.py)
spans.counter("abn.fwd.launches", lambda: abn_rows.launches)
spans.counter("abn.bwd_sums.launches", lambda: abn_bwd_sums.launches)
spans.counter("abn.bwd_dx.launches", lambda: abn_bwd_dx.launches)
spans.counter("abn.dz_copies", lambda: FusedABN.dz_copies)
for _owner, _attr in ((abn_rows, "launches"), (abn_bwd_sums, "launches"),
                      (abn_bwd_dx, "launches"), (FusedABN, "dz_copies")):
    spans.replayed(_owner, _attr)
