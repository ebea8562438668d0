"""Plain float32 HRNet networks: the VAE² encoder-dual-decoder, posterior and
discriminators, and HRNetV2 segmentation.

A frozen, independent copy of the published architecture (HRNet,
arXiv:1908.07919; VAE², the enc_hrnet family of the reference repo) in
plain ``torch`` operations: no kernels, no sharding, no cache. Submodules
and parameters carry the names that ``vae2_tpu_torch`` gives them, so one
state dict made by the benchmark loads into both.

Every stored value (a convolution's operands and output, a BN's folded
scale, shift and output, a residual sum) goes through :mod:`quant`, the
identity unless the control precision is switched on. BN in
train mode normalizes with the batch's biased statistics and keeps no
running statistics (a training step's outputs do not read them); in eval
mode it uses the buffers it was given; under :func:`calibrating` it writes
the batch statistics of its input into those buffers as it runs.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import quant

EPS = 1e-5
_CALIBRATE = [False]


@contextlib.contextmanager
def calibrating():
    """BNs run on batch statistics and store them as running statistics."""
    _CALIBRATE[0] = True
    try:
        yield
    finally:
        _CALIBRATE[0] = False


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 bias: bool = False):
        super().__init__()
        self.stride, self.pad = stride, (k - 1) // 2
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        return quant.conv_output(F.conv2d(quant.store(x), quant.store(self.weight),
                                          self.bias, self.stride, self.pad))


class BN(nn.Module):
    """BatchNorm over every axis but 1, then ReLU when ``relu``."""

    def __init__(self, c: int, relu: bool):
        super().__init__()
        self.relu = relu
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        if self.training or _CALIBRATE[0]:
            dims = [0] + list(range(2, x.dim()))
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
            if _CALIBRATE[0]:
                self.running_mean.copy_(mean)
                self.running_var.copy_(var)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = self.weight * torch.rsqrt(var + EPS)
        add = self.bias - mean * mul
        y = x * quant.store(mul).view(shape) + quant.store(add).view(shape)
        return quant.store(torch.relu(y) if self.relu else y)


def resize(x, h: int, w: int):
    if x.shape[2] == h and x.shape[3] == w:
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)


class Basic(nn.Module):
    expansion = 1

    def __init__(self, cin: int, c: int):
        super().__init__()
        self.conv1, self.bn1 = Conv(cin, c, 3), BN(c, True)
        self.conv2, self.bn2 = Conv(c, c, 3), BN(c, False)
        if cin != c:
            self.down_conv, self.down_bn = Conv(cin, c, 1), BN(c, False)

    def forward(self, x):
        y = self.bn2(self.conv2(self.bn1(self.conv1(x))))
        r = self.down_bn(self.down_conv(x)) if hasattr(self, "down_conv") else x
        return quant.store(torch.relu(y + r))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, c: int):
        super().__init__()
        self.conv1, self.bn1 = Conv(cin, c, 1), BN(c, True)
        self.conv2, self.bn2 = Conv(c, c, 3), BN(c, True)
        self.conv3, self.bn3 = Conv(c, 4 * c, 1), BN(4 * c, False)
        if cin != 4 * c:
            self.down_conv = Conv(cin, 4 * c, 1)
            self.down_bn = BN(4 * c, False)

    def forward(self, x):
        y = self.bn3(self.conv3(self.bn2(self.conv2(self.bn1(self.conv1(x))))))
        r = self.down_bn(self.down_conv(x)) if hasattr(self, "down_conv") else x
        return quant.store(torch.relu(y + r))


class Chain(nn.Module):
    def __init__(self, block: str, c: int, n: int, cin: int):
        super().__init__()
        cls = Bottleneck if block == "BOTTLENECK" else Basic
        for i in range(n):
            self.add_module(f"block{i}", cls(cin if i == 0 else c * cls.expansion, c))

    def forward(self, x):
        for b in self.children():
            x = b(x)
        return x


class Fuse(nn.Module):
    def __init__(self, chans: Sequence[int]):
        super().__init__()
        n = len(chans)
        self.n = n
        for i in range(n):
            for j in range(n):
                if j > i:
                    self.add_module(f"up_{i}_{j}_conv", Conv(chans[j], chans[i], 1))
                    self.add_module(f"up_{i}_{j}_bn", BN(chans[i], False))
                for k in range(i - j):
                    last = k == i - j - 1
                    c = chans[i] if last else chans[j]
                    self.add_module(f"down_{i}_{j}_{k}_conv", Conv(chans[j], c, 3, 2))
                    self.add_module(f"down_{i}_{j}_{k}_bn", BN(c, not last))

    def forward(self, xs):
        outs = []
        for i in range(self.n):
            y = None
            for j in range(self.n):
                t = xs[j]
                if j > i:
                    t = getattr(self, f"up_{i}_{j}_bn")(getattr(self, f"up_{i}_{j}_conv")(t))
                    t = resize(t, xs[i].shape[2], xs[i].shape[3])
                for k in range(i - j):
                    t = getattr(self, f"down_{i}_{j}_{k}_bn")(
                        getattr(self, f"down_{i}_{j}_{k}_conv")(t))
                y = t if y is None else y + t
            outs.append(quant.store(torch.relu(y)))
        return outs


class HRModule(nn.Module):
    def __init__(self, spec: dict, chans: Sequence[int]):
        super().__init__()
        self.nb = spec["NUM_BRANCHES"]
        for b in range(self.nb):
            self.add_module(f"branch{b}", Chain(spec["BLOCK"], spec["NUM_CHANNELS"][b],
                                                spec["NUM_BLOCKS"][b], chans[b]))
        if self.nb > 1:
            self.fuse = Fuse(out_channels(spec))

    def forward(self, xs):
        ys = [getattr(self, f"branch{b}")(x) for b, x in enumerate(xs)]
        return self.fuse(ys) if self.nb > 1 else ys


class Transition(nn.Module):
    def __init__(self, cin: Sequence[int], cout: Sequence[int]):
        super().__init__()
        self.cin, self.cout = tuple(cin), tuple(cout)
        for i, c in enumerate(cout):
            if i < len(cin):
                if cin[i] != c:
                    self.add_module(f"adapt{i}_conv", Conv(cin[i], c, 3))
                    self.add_module(f"adapt{i}_bn", BN(c, True))
            else:
                for j in range(i + 1 - len(cin)):
                    cj = c if j == i - len(cin) else cin[-1]
                    self.add_module(f"new{i}_{j}_conv", Conv(cin[-1], cj, 3, 2))
                    self.add_module(f"new{i}_{j}_bn", BN(cj, True))

    def forward(self, xs):
        outs = []
        for i, c in enumerate(self.cout):
            if i < len(self.cin):
                t = xs[i]
                if self.cin[i] != c:
                    t = getattr(self, f"adapt{i}_bn")(getattr(self, f"adapt{i}_conv")(t))
            else:
                t = xs[-1]
                for j in range(i + 1 - len(self.cin)):
                    t = getattr(self, f"new{i}_{j}_bn")(getattr(self, f"new{i}_{j}_conv")(t))
            outs.append(t)
        return outs


def out_channels(spec: dict) -> Tuple[int, ...]:
    e = 4 if spec["BLOCK"] == "BOTTLENECK" else 1
    return tuple(c * e for c in spec["NUM_CHANNELS"])


class ZInject(nn.Module):
    def __init__(self, chans: Sequence[int], code: int):
        super().__init__()
        for i, c in enumerate(chans):
            self.add_module(f"inject{i}_conv", Conv(c + code, c, 3))
            self.add_module(f"inject{i}_bn", BN(c, True))

    def forward(self, xs, maps):
        outs = []
        for i, x in enumerate(xs):
            parts = [m[i].expand(x.shape[0], -1, x.shape[2], x.shape[3])
                     for m in maps] + [x]
            t = torch.cat(parts, dim=1)
            outs.append(getattr(self, f"inject{i}_bn")(getattr(self, f"inject{i}_conv")(t)))
        return outs


class Trunk(nn.Module):
    """Stem, stage 1, then (transition, stage) x 3; ``z_mode`` 'none', 'z'
    (z maps injected before stage 4) or 'z+rand' (a random code's maps,
    then the z maps). ``remat``: each HRModule under checkpoint (the same
    numbers; BNs here have no side effects outside calibration)."""

    def __init__(self, stages: Sequence[dict], cin: int, stem_stride: int = 1,
                 z_mode: str = "none", z_dim: int = 32, remat: bool = False):
        super().__init__()
        self.stages, self.z_mode, self.remat = list(stages), z_mode, remat
        self.conv1, self.bn1 = Conv(cin, 64, 3, stem_stride), BN(64, True)
        self.conv2, self.bn2 = Conv(64, 64, 3, stem_stride), BN(64, True)
        s1 = stages[0]
        self.layer1 = Chain(s1["BLOCK"], s1["NUM_CHANNELS"][0], s1["NUM_BLOCKS"][0], 64)
        prev = out_channels(s1)
        for idx in (2, 3, 4):
            spec = stages[idx - 1]
            self.add_module(f"transition{idx - 1}", Transition(prev, out_channels(spec)))
            for m in range(spec["NUM_MODULES"]):
                self.add_module(f"stage{idx}_module{m}", HRModule(spec, out_channels(spec)))
            prev = out_channels(spec)
        if z_mode != "none":
            n = 2 if z_mode == "z+rand" else 1
            self.transition3_e = ZInject(prev, n * z_dim)

    def _run(self, name, xs):
        mod = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            return checkpoint(mod, xs, use_reentrant=False)
        return mod(xs)

    def prefix(self, x) -> List[torch.Tensor]:
        x = self.bn2(self.conv2(self.bn1(self.conv1(x))))
        xs = [self.layer1(x)]
        for idx in (2, 3, 4):
            xs = getattr(self, f"transition{idx - 1}")(xs)
            if idx == 4:
                return xs
            for m in range(self.stages[idx - 1]["NUM_MODULES"]):
                xs = self._run(f"stage{idx}_module{m}", xs)

    def suffix(self, xs, z=None, code=None) -> List[torch.Tensor]:
        if self.z_mode != "none":
            maps = [z] if self.z_mode == "z" else [[code[:, :, None, None]] * len(xs), z]
            xs = self.transition3_e(xs, maps)
        for m in range(self.stages[3]["NUM_MODULES"]):
            xs = self._run(f"stage4_module{m}", xs)
        return xs

    def forward(self, x, z=None, code=None):
        return self.suffix(self.prefix(x), z, code)


def concat_up(xs) -> torch.Tensor:
    h, w = xs[0].shape[2], xs[0].shape[3]
    return torch.cat([xs[0]] + [resize(x, h, w) for x in xs[1:]], dim=1)


class Head(nn.Module):
    """1x1 conv (bias) -> BN + ReLU -> 1x1 conv (bias)."""

    def __init__(self, c: int, out: int):
        super().__init__()
        self.conv1, self.bn, self.conv2 = Conv(c, c, 1, bias=True), BN(c, True), \
            Conv(c, out, 1, bias=True)

    def forward(self, x):
        return self.conv2(self.bn(self.conv1(x)))


class TrunkHeads(nn.Module):
    def __init__(self, stages, cin: int, heads: int, classes: int, z_mode: str,
                 z_dim: int, remat: bool):
        super().__init__()
        self.heads = heads
        self.trunk = Trunk(stages, cin, 1, z_mode, z_dim, remat)
        width = sum(out_channels(stages[3]))
        for i in range(heads):
            self.add_module(f"last_layer_{i + 1}", Head(width, classes))

    def head(self, feats):
        y = concat_up(feats)
        return torch.cat([getattr(self, f"last_layer_{i + 1}")(y)
                          for i in range(self.heads)], dim=1)

    def forward(self, x, z=None, code=None):
        return self.head(self.trunk(x, z, code))


class EncDec(nn.Module):
    def __init__(self, stages, clip: int = 3, classes: int = 3, z_dim: int = 32,
                 remat: bool = False):
        super().__init__()
        kw = dict(heads=clip, classes=classes, z_dim=z_dim, remat=remat)
        self.encoder = TrunkHeads(stages, 3 * clip, z_mode="z+rand", **kw)
        self.dec_future = TrunkHeads(stages, classes * clip, z_mode="z", **kw)
        self.dec_past = TrunkHeads(stages, classes * clip, z_mode="z", **kw)

    def forward(self, x, z, code):
        x2p = self.encoder(x, z, code)
        return self.dec_past(x2p, z), x2p, self.dec_future(x2p, z)

    def sample(self, x, z, code):
        """One clip's encoder prefix, shared by the samples of z and code."""
        feats = [f.expand(code.shape[0], -1, -1, -1)
                 for f in self.encoder.trunk.prefix(x)]
        x2p = self.encoder.head(self.encoder.trunk.suffix(feats, z, code))
        return self.dec_past(x2p, z), x2p, self.dec_future(x2p, z)


class Posterior(nn.Module):
    """Per-branch 1x1 convs to (mu, logvar) maps (HD_Z)."""

    def __init__(self, stages, cin: int, z_dim: int = 32, remat: bool = False):
        super().__init__()
        self.trunk = Trunk(stages, cin, 1, "none", z_dim, remat)
        for i, c in enumerate(out_channels(stages[3])):
            self.add_module(f"z_layer_{i}", Conv(c, 2 * z_dim, 1))

    def forward(self, x):
        return [getattr(self, f"z_layer_{i}")(f) for i, f in enumerate(self.trunk(x))]


class Discriminator(nn.Module):
    def __init__(self, stages, cin: int, remat: bool = False):
        super().__init__()
        self.trunk = Trunk(stages, cin, 1, "none", remat=remat)
        self.last_layer = Head(sum(out_channels(stages[3])), 1)

    def forward(self, x):
        return self.last_layer(concat_up(self.trunk(x)))


class SegNet(nn.Module):
    """HRNetV2: the stride-2 stem, logits at 1/4 of the input."""

    def __init__(self, stages, classes: int):
        super().__init__()
        self.trunk = Trunk(stages, 3, 2, "none")
        self.last_layer = Head(sum(out_channels(stages[3])), classes)

    def forward(self, x):
        return self.last_layer(concat_up(self.trunk(x)))


def stages_of(extra: dict) -> List[dict]:
    return [extra[f"STAGE{i}"] for i in (1, 2, 3, 4)]


def vae2_modules(recipe: dict, remat: bool = False) -> nn.ModuleDict:
    """{'encdec', 'd_seq', 'd_frame', 'encz'} of the VAE² recipe."""
    extra = recipe["MODEL"]["EXTRA"]
    stages, z_dim = stages_of(extra), extra["Z_DIM"]
    clip = recipe["TRAIN"]["CLIP_LENGTH"]
    classes = recipe["DATASET"]["NUM_CLASSES"]
    return nn.ModuleDict({
        "encdec": EncDec(stages, clip, classes, z_dim, remat),
        "d_seq": Discriminator(stages, 3 * clip, remat),
        "d_frame": Discriminator(stages, 3, remat),
        "encz": Posterior(stages, 6 * clip, z_dim, remat),
    })


def seg_module(recipe: dict) -> nn.Module:
    return SegNet(stages_of(recipe["MODEL"]["EXTRA"]),
                  recipe["DATASET"]["NUM_CLASSES"])


def identity_bns(module: nn.Module) -> List[BN]:
    return [m for m in module.modules() if isinstance(m, BN) and not m.relu]
