"""HRNet multi-resolution trunk in PyTorch.

Counterpart of ``vae2_tpu/models/hrnet.py`` (reference
lib/models/enc_hrnet.py:259-1183). Submodules carry the flax names
(``stage4_module0.branch0.block0.conv1``), so that a JAX parameter tree maps
onto a ``state_dict`` path for path (``utils/jax_params.py``).

Tensors are NCHW in ``torch.channels_last`` memory (NHWC bytes, as in the
JAX package). Convolutions compute in their input's dtype (the trunk casts
its input to the compute dtype, bfloat16 by default) with float32
parameters; BN statistics stay float32 (``ops/norm.py``). Flax infers input
widths; here every module is given them.

Rematerialization (``TPU.REMAT``, vae2.py:55-63 and hrnet.py:341-358 of the
JAX package) is ``torch.utils.checkpoint``: 'stage' wraps each HRModule,
'trunk' the whole trunk. It engages only while autograd records. The
encoder's random code is drawn before any checkpointed region, so that the
recompute sees the same code, and the recompute leaves the BN running
statistics alone (``ops.norm.frozen_running_stats``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.image import resize_bilinear
from ..ops.norm import BatchNormAct, frozen_running_stats
from ..parallel import sync
from ..utils import spans

REMAT_MODES = ("none", "stage", "trunk")


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One HRNet stage (mirrors the MODEL.EXTRA.STAGEn config nodes)."""

    num_modules: int
    num_branches: int
    num_blocks: Tuple[int, ...]
    num_channels: Tuple[int, ...]
    block: str  # 'BASIC' | 'BOTTLENECK'
    fuse_method: str = "SUM"

    @property
    def expansion(self) -> int:
        return 4 if self.block == "BOTTLENECK" else 1

    @property
    def out_channels(self) -> Tuple[int, ...]:
        return tuple(c * self.expansion for c in self.num_channels)


def stage_specs_from_extra(extra) -> Tuple[StageSpec, StageSpec, StageSpec, StageSpec]:
    """Parse MODEL.EXTRA.STAGE1..4 into StageSpecs."""
    out = []
    for i in (1, 2, 3, 4):
        s = extra[f"STAGE{i}"]
        out.append(
            StageSpec(
                num_modules=int(s["NUM_MODULES"]),
                num_branches=int(s["NUM_BRANCHES"]),
                num_blocks=tuple(s["NUM_BLOCKS"]),
                num_channels=tuple(s["NUM_CHANNELS"]),
                block=str(s["BLOCK"]),
                fuse_method=str(s.get("FUSE_METHOD", "SUM")),
            )
        )
    return tuple(out)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in its input's dtype with float32
    parameters, initialised as the JAX package initialises its convs:
    kernel normal(std 0.001) (hrnet.py:47), bias 0.

    Under a spatial layout (``sync.spatial_size() > 1``) a kernel taller
    than one row reads across the seams: :func:`halo_conv2d`."""

    def reset_parameters(self) -> None:
        nn.init.normal_(self.weight, std=0.001)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        weight = self.weight.to(x.dtype)
        if sync.spatial_size() > 1:
            if self.kernel_size[0] > 1:
                return halo_conv2d(x, weight, bias, self.stride[0],
                                   self._row_padding())
            return conv_rows(x, weight, bias, self.stride,
                             self._row_padding())
        return self._conv_forward(x, weight, bias)

    def _row_padding(self) -> Tuple[int, int]:
        """(H, W) padding; 'same' (odd kernels, stride 1) is (k - 1) // 2."""
        if isinstance(self.padding, str):
            if self.padding != "same" or self.stride != (1, 1) or not all(
                    k % 2 for k in self.kernel_size):
                raise ValueError(f"padding {self.padding!r} with kernel "
                                 f"{self.kernel_size} and stride "
                                 f"{self.stride} under a spatial layout")
            return tuple((k - 1) // 2 for k in self.kernel_size)
        return self.padding


def halo_conv2d(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor], stride: int,
                padding: Tuple[int, int]) -> torch.Tensor:
    """This rank's rows of a convolution over the whole image: the output
    rows it owns (``sync.own_rows`` of the output's H), from the input rows
    they read. Output row o reads input rows ``stride*o - p .. stride*o - p
    + k - 1``, its own and, across the seams, those of other ranks (zeros
    outside the image: the padding; ``sync.halo_rows``), then the rank
    convolves with no H padding. Shards may differ in size: a rank's input
    and output rows need not line up (a stride-2 convolution whose output
    shard starts at row o reads from input row 2o - p, whichever rank owns
    it), and a rank that owns no output row still joins the exchange."""
    k, p = weight.shape[2], padding[0]
    s = sync.spatial_size()
    height = sync.global_rows(x.shape[2], x.shape[3])
    out_h = (height + 2 * p - k) // stride + 1
    windows = []
    for r in range(s):
        a, b = sync.row_range(out_h, r, s)
        lo = stride * a - p
        windows.append((lo, stride * (b - 1) - p + k) if b > a else (lo, lo))
    xh = sync.halo_rows(x, height, windows, "zeros")
    if xh.shape[2] == 0:
        w_out = (x.shape[3] + 2 * padding[1] - weight.shape[3]) // stride + 1
        return sync.connected_empty(xh, (x.shape[0], weight.shape[0], 0,
                                         w_out))
    return F.conv2d(xh, weight, bias, stride, (0, padding[1]))


def conv_rows(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor] = None, stride=1,
              padding=0) -> torch.Tensor:
    """``F.conv2d`` of a one-row kernel over a rank's rows, which may be
    none under a spatial layout: then a zero-row output connected to x."""
    if x.shape[2] > 0:
        return F.conv2d(x, weight, bias, stride, padding)
    sw = stride if isinstance(stride, int) else stride[1]
    pw = padding if isinstance(padding, int) else padding[1]
    w_out = (x.shape[3] + 2 * pw - weight.shape[3]) // sw + 1
    return sync.connected_empty(x, (x.shape[0], weight.shape[0], 0, w_out))


class Linear(nn.Linear):
    """``nn.Linear`` that computes in its input's dtype with float32
    parameters, initialised as flax's ``Dense`` in the JAX package: kernel
    normal(std 0.001) (vae2.py:52), bias 0."""

    def reset_parameters(self) -> None:
        nn.init.normal_(self.weight, std=0.001)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


def _remat_contexts():
    # the forward runs as it is; its recompute leaves running stats alone
    return contextlib.nullcontext(), frozen_running_stats()


def remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward instead of kept. Its body
    runs in ``hrnet.remat``, so the span shows in the forward and again in
    the backward's recompute."""
    def body(*a):
        with spans.span("hrnet.remat"):
            return fn(*a)

    return checkpoint(body, *args, use_reentrant=False,
                      preserve_rng_state=False, context_fn=_remat_contexts)


def _conv(in_channels: int, features: int, kernel: int, stride: int) -> Conv2d:
    # torch-style symmetric padding ((k-1)//2 both sides), which is what the
    # JAX package's _conv spells out (hrnet.py:88-106), stride 2 included
    return Conv2d(in_channels, features, kernel, stride,
                  padding=(kernel - 1) // 2, bias=False)


def cat_channels(parts: Sequence[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """Channel-concat into one channels_last buffer of ``dtype``. Parts may
    be broadcast views (a batch of 1, or expanded code maps): each is
    materialised once, in the buffer."""
    batch = max(p.shape[0] for p in parts)
    _, _, h, w = parts[-1].shape
    out = torch.empty((batch, sum(p.shape[1] for p in parts), h, w),
                      dtype=dtype, device=parts[-1].device,
                      memory_format=torch.channels_last)
    off = 0
    for p in parts:
        out[:, off:off + p.shape[1]].copy_(p)
        off += p.shape[1]
    return out


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (enc_hrnet.py:33-62)."""

    expansion = 1

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 use_projection: bool = False):
        super().__init__()
        self.conv1 = _conv(in_channels, features, 3, stride)
        self.bn1 = BatchNormAct(features, act="relu")
        self.conv2 = _conv(features, features, 3, 1)
        self.bn2 = BatchNormAct(features, act=None)
        self.use_projection = use_projection
        if use_projection:
            self.down_conv = _conv(in_channels, features, 1, stride)
            self.down_bn = BatchNormAct(features, act=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn2(self.conv2(self.bn1(self.conv1(x))))
        residual = self.down_bn(self.down_conv(x)) if self.use_projection else x
        return torch.relu_(y + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1(x4) residual block (enc_hrnet.py:65-103)."""

    expansion = 4

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 use_projection: bool = False):
        super().__init__()
        out_features = features * self.expansion
        self.conv1 = _conv(in_channels, features, 1, 1)
        self.bn1 = BatchNormAct(features, act="relu")
        self.conv2 = _conv(features, features, 3, stride)
        self.bn2 = BatchNormAct(features, act="relu")
        self.conv3 = _conv(features, out_features, 1, 1)
        self.bn3 = BatchNormAct(out_features, act=None)
        self.use_projection = use_projection
        if use_projection:
            self.down_conv = _conv(in_channels, out_features, 1, stride)
            self.down_bn = BatchNormAct(out_features, act=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn2(self.conv2(self.bn1(self.conv1(x))))
        y = self.bn3(self.conv3(y))
        residual = self.down_bn(self.down_conv(x)) if self.use_projection else x
        return torch.relu_(y + residual)


class BlockChain(nn.Module):
    """A sequence of residual blocks forming one branch / stage-1 layer;
    the children are ``block0``, ``block1``, ..."""

    def __init__(self, block: str, features: int, num_blocks: int,
                 in_channels: int):
        super().__init__()
        cls = Bottleneck if block == "BOTTLENECK" else BasicBlock
        out_c = features * cls.expansion
        for i in range(num_blocks):
            c_in = in_channels if i == 0 else out_c
            self.add_module(f"block{i}", cls(c_in, features, 1,
                                             use_projection=c_in != out_c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.children():
            x = blk(x)
        return x


class FuseLayer(nn.Module):
    """Cross-resolution fusion: every output branch receives every input
    branch, adapted in resolution and width (enc_hrnet.py:177-250)."""

    def __init__(self, in_channels: Tuple[int, ...]):
        super().__init__()
        self.in_channels = tuple(in_channels)
        n = len(in_channels)
        for i in range(n):
            for j in range(n):
                if j > i:
                    # low-res -> high-res: 1x1 conv + BN, bilinear upsample
                    self.add_module(f"up_{i}_{j}_conv",
                                    _conv(in_channels[j], in_channels[i], 1, 1))
                    self.add_module(f"up_{i}_{j}_bn",
                                    BatchNormAct(in_channels[i], act=None))
                elif j < i:
                    # high-res -> low-res: chain of stride-2 3x3 convs
                    for k in range(i - j):
                        last = k == i - j - 1
                        c = in_channels[i] if last else in_channels[j]
                        self.add_module(f"down_{i}_{j}_{k}_conv",
                                        _conv(in_channels[j], c, 3, 2))
                        self.add_module(
                            f"down_{i}_{j}_{k}_bn",
                            BatchNormAct(c, act=None if last else "relu"))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        n = len(xs)
        outs = []
        for i in range(n):
            h, w = xs[i].shape[2], xs[i].shape[3]
            y = None
            for j in range(n):
                if j == i:
                    t = xs[j]
                elif j > i:
                    t = getattr(self, f"up_{i}_{j}_conv")(xs[j])
                    t = getattr(self, f"up_{i}_{j}_bn")(t)
                    t = resize_bilinear(t, h, w)
                else:
                    t = xs[j]
                    for k in range(i - j):
                        t = getattr(self, f"down_{i}_{j}_{k}_conv")(t)
                        t = getattr(self, f"down_{i}_{j}_{k}_bn")(t)
                y = t if y is None else y + t
            outs.append(torch.relu(y))
        return outs


class HRModule(nn.Module):
    """num_branches parallel block chains + one fusion (enc_hrnet.py:106-250)."""

    def __init__(self, spec: StageSpec, in_channels: Tuple[int, ...]):
        super().__init__()
        self.num_branches = spec.num_branches
        for b in range(spec.num_branches):
            self.add_module(f"branch{b}", BlockChain(
                spec.block, spec.num_channels[b], spec.num_blocks[b],
                in_channels[b]))
        if spec.num_branches > 1:
            self.fuse = FuseLayer(spec.out_channels)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        if len(xs) != self.num_branches:
            raise ValueError(f"HRModule expects {self.num_branches} branches, "
                             f"got {len(xs)}")
        ys = [getattr(self, f"branch{b}")(x) for b, x in enumerate(xs)]
        if self.num_branches == 1:
            return ys
        return self.fuse(ys)


class Transition(nn.Module):
    """Adapt the previous stage's branches to the next stage's widths and
    create new lower-resolution branches (enc_hrnet.py:372-406)."""

    def __init__(self, in_channels: Tuple[int, ...],
                 out_channels: Tuple[int, ...]):
        super().__init__()
        self.in_channels = tuple(in_channels)
        self.out_channels = tuple(out_channels)
        n_pre = len(in_channels)
        for i, c_out in enumerate(out_channels):
            if i < n_pre:
                if in_channels[i] != c_out:
                    self.add_module(f"adapt{i}_conv",
                                    _conv(in_channels[i], c_out, 3, 1))
                    self.add_module(f"adapt{i}_bn",
                                    BatchNormAct(c_out, act="relu"))
            else:
                # new branch: chain of stride-2 convs from the last branch
                for j in range(i + 1 - n_pre):
                    c = c_out if j == i - n_pre else in_channels[-1]
                    self.add_module(f"new{i}_{j}_conv",
                                    _conv(in_channels[-1], c, 3, 2))
                    self.add_module(f"new{i}_{j}_bn",
                                    BatchNormAct(c, act="relu"))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        n_pre = len(self.in_channels)
        outs = []
        for i, c_out in enumerate(self.out_channels):
            if i < n_pre:
                if self.in_channels[i] != c_out:
                    t = getattr(self, f"adapt{i}_conv")(xs[i])
                    outs.append(getattr(self, f"adapt{i}_bn")(t))
                else:
                    outs.append(xs[i])
            else:
                t = xs[-1]
                for j in range(i + 1 - n_pre):
                    t = getattr(self, f"new{i}_{j}_conv")(t)
                    t = getattr(self, f"new{i}_{j}_bn")(t)
                outs.append(t)
        return outs


def gen_code_maps(code: torch.Tensor, features: List[torch.Tensor]
                  ) -> List[torch.Tensor]:
    """Tile a (B, z) code spatially to each branch's (B, z, h_b, w_b), as
    broadcast views (enc_hrnet.py:454-462)."""
    b, z = code.shape
    return [code[:, :, None, None].expand(b, z, f.shape[2], f.shape[3])
            for f in features]


class ZInject(nn.Module):
    """The ``transition3_e`` latent-injection layer: per-branch concat of
    code maps with features, then 3x3 conv+BN+ReLU back to the branch width
    (enc_hrnet.py:314-316, 818-830). ``code_channels`` is the width of all
    code maps together."""

    def __init__(self, out_channels: Tuple[int, ...], code_channels: int):
        super().__init__()
        for i, c in enumerate(out_channels):
            self.add_module(f"inject{i}_conv", _conv(c + code_channels, c, 3, 1))
            self.add_module(f"inject{i}_bn", BatchNormAct(c, act="relu"))

    def forward(self, xs: List[torch.Tensor],
                code_maps: List[List[torch.Tensor]]) -> List[torch.Tensor]:
        outs = []
        for i, x in enumerate(xs):
            # [rand-code maps, z maps, x]; f32 maps cast to x's dtype
            t = cat_channels([m[i] for m in code_maps] + [x], x.dtype)
            t = getattr(self, f"inject{i}_conv")(t)
            outs.append(getattr(self, f"inject{i}_bn")(t))
        return outs


class HRNetTrunk(nn.Module):
    """Stem + stage1 + (transition, stage)x3, with optional latent injection.

    ``z_mode``: 'none' (plain trunk), 'z' (concat posterior-z maps at the
    stage-4 transition: decoders, baseline encoder) or 'z+rand' (concat
    [fresh random code map, z map]: the non-baseline encoder). ``remat``:
    'none', 'stage' or 'trunk' (see the module docstring).

    Returns the list of stage-4 branch feature maps, highest resolution
    first. Heads live outside the trunk.
    """

    def __init__(self, specs: Tuple[StageSpec, ...], in_channels: int,
                 stem_stride: int = 1, z_mode: str = "none", z_dim: int = 32,
                 dtype: torch.dtype = torch.bfloat16, remat: str = "none"):
        super().__init__()
        if z_mode not in ("none", "z", "z+rand"):
            raise ValueError(f"unknown z_mode {z_mode!r}")
        if remat not in REMAT_MODES:
            raise ValueError(f"TPU.REMAT must be none|trunk|stage, got "
                             f"{remat!r}")
        s1, s2, s3, s4 = specs
        self.specs = tuple(specs)
        self.z_mode = z_mode
        self.z_dim = z_dim
        self.dtype = dtype
        self.remat = remat
        # Stem (enc_hrnet.py:271-277 / :539-543)
        self.conv1 = _conv(in_channels, 64, 3, stem_stride)
        self.bn1 = BatchNormAct(64, act="relu")
        self.conv2 = _conv(64, 64, 3, stem_stride)
        self.bn2 = BatchNormAct(64, act="relu")
        # Stage 1 (enc_hrnet.py:280-285)
        self.layer1 = BlockChain(s1.block, s1.num_channels[0],
                                 s1.num_blocks[0], 64)
        prev = s1.out_channels
        for idx, spec in ((2, s2), (3, s3), (4, s4)):
            self.add_module(f"transition{idx - 1}",
                            Transition(prev, spec.out_channels))
            for m in range(spec.num_modules):
                self.add_module(f"stage{idx}_module{m}",
                                HRModule(spec, spec.out_channels))
            prev = spec.out_channels
        if z_mode != "none":
            n_maps = 2 if z_mode == "z+rand" else 1
            self.transition3_e = ZInject(s4.out_channels, n_maps * z_dim)

    def forward(self, x, z=None, mode: str = "full",
                rand_code: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """mode: 'full', or the two halves that multi-sample inference uses
        to share the z-independent computation across samples (see
        VAE2EncDec.sample): 'prefix' runs stem..transition3 and returns the
        branch list; 'suffix' takes that list as ``x`` and runs the
        z-injection + stage 4.

        ``rand_code`` (B, z_dim) replaces the random code that 'z+rand'
        draws, from ``generator``, when it is None (across ranks, this
        rank's rows of the global batch's draw)."""
        if mode not in ("full", "prefix", "suffix"):
            raise ValueError(f"unknown trunk mode {mode!r}")
        if self.z_mode == "z+rand" and mode != "prefix" and rand_code is None:
            first = x[0] if mode == "suffix" else x
            rand_code = sync.randn_rows((first.shape[0], self.z_dim),
                                        generator, device=first.device)
        if self.remat == "trunk" and torch.is_grad_enabled():
            return remat(self._forward, x, z, mode, rand_code)
        return self._forward(x, z, mode, rand_code)

    def _module(self, name: str, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        module = getattr(self, name)
        if self.remat == "stage" and torch.is_grad_enabled():
            return remat(module, xs)
        return module(xs)

    def _forward(self, x, z, mode: str, rand_code) -> List[torch.Tensor]:
        s4 = self.specs[3]
        if mode in ("full", "prefix"):
            if sync.spatial_size() > 1:  # x: this rank's H / S image rows
                sync.set_image(x.shape[2] * sync.spatial_size(), x.shape[3])
            x = x.to(dtype=self.dtype, memory_format=torch.channels_last)
            x = self.bn1(self.conv1(x))
            x = self.bn2(self.conv2(x))
            xs = [self.layer1(x)]
            for idx in (2, 3, 4):
                xs = getattr(self, f"transition{idx - 1}")(xs)
                if idx == 4:
                    break
                for m in range(self.specs[idx - 1].num_modules):
                    xs = self._module(f"stage{idx}_module{m}", xs)
            if mode == "prefix":
                return xs
        else:
            xs = list(x)

        if self.z_mode != "none":
            xs = self._inject_z(xs, z, rand_code)
        for m in range(s4.num_modules):
            xs = self._module(f"stage4_module{m}", xs)
        return xs

    def _inject_z(self, xs, z, rand_code) -> List[torch.Tensor]:
        # Posterior z: per-branch spatial maps (hd_z) or a (B, z_dim) vector
        # tiled spatially (enc_hrnet.py:818-830).
        if z is None:
            raise ValueError("z required when z_mode != 'none'")
        z_maps = list(z) if isinstance(z, (list, tuple)) else gen_code_maps(z, xs)
        code_maps = [z_maps]
        if self.z_mode == "z+rand":
            code_maps = [gen_code_maps(rand_code, xs), z_maps]
        return self.transition3_e(xs, code_maps)


def upsampled_branches(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Upsample all branches to branch-0 resolution, without concatenating
    (hrnet.py:425-434 of the JAX package; ``TPU.HEAD_DATAFLOW`` 'presum')."""
    h, w = xs[0].shape[2], xs[0].shape[3]
    return [xs[0]] + [resize_bilinear(x, h, w) for x in xs[1:]]


def concat_upsampled(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Upsample all branches to branch-0 resolution and channel-concat
    (enc_hrnet.py:833-839)."""
    return cat_channels(upsampled_branches(xs), xs[0].dtype)


class ConvHead(nn.Module):
    """1x1 conv (C->C) + BN + ReLU + final conv (C->out) — the shared shape
    of the prediction heads (enc_hrnet.py:323-370; hrnet.py:443-500 of the
    JAX package).

    Takes the full-resolution concat (the reference dataflow) or a branch
    list. For a list, conv1's one (C, C) kernel is sliced by fan-in and
    applied per branch, each result upsampled to branch-0 resolution and
    summed, then the bias added: the same function as conv-of-concat. The
    list is either the raw branches ('multiscale': the 1x1 conv runs before
    the upsample) or the upsampled ones ('presum': the resize is a no-op).
    The parameters are the same in every dataflow."""

    def __init__(self, in_channels: int, out_features: int,
                 final_kernel: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_channels, in_channels, 1, bias=True)
        self.bn = BatchNormAct(in_channels, act="relu")
        self.conv2 = Conv2d(in_channels, out_features, final_kernel,
                            padding="same", bias=True)

    def forward(self, x) -> torch.Tensor:
        if isinstance(x, (list, tuple)):
            x = self._conv1_branches(list(x))
        else:
            x = self.conv1(x)
        return self.conv2(self.bn(x))

    def _conv1_branches(self, parts: List[torch.Tensor]) -> torch.Tensor:
        dtype = parts[0].dtype
        weight = self.conv1.weight.to(dtype)
        h, w = parts[0].shape[2], parts[0].shape[3]
        off, y = 0, None
        for p in parts:
            cb = p.shape[1]
            yb = resize_bilinear(conv_rows(p, weight[:, off:off + cb]), h, w)
            y = yb if y is None else y + yb
            off += cb
        if off != weight.shape[1]:
            raise ValueError(f"ConvHead: branches have {off} channels, conv1 "
                             f"takes {weight.shape[1]}")
        return y + self.conv1.bias.to(dtype).view(1, -1, 1, 1)
