"""InceptionV3 feature extractors for FID and the Inception Score.

Counterpart of ``vae2_tpu/models/inception.py`` (reference
tools/fid_score.py:66-378, tools/inception_score.py:32-97), as an
``nn.Module`` in two variants:

- **FID** (``fid_variant=True``, the pytorch-fid "pt_inception-2015-12-05"
  skeleton): the InceptionA/C average pools and Mixed_7b's use
  ``count_include_pad=False``, Mixed_7c's pool branch is a max pool
  (fid_score.py:261-378). Output: the 2048-d pool3 features.
- **torchvision inception_v3** (``fid_variant=False``): pools that count
  the padding, and the 1000-way ``fc`` for the Inception Score.

Inference only: each BasicConv2d is a convolution without bias, BN on its
running statistics (eps 1e-3) as plain folded ops, and ReLU. Submodules
carry torch's state-dict names (``Mixed_5b.branch1x1.conv.weight``,
``.bn.running_var``, ...), so ``load_torch_inception_weights`` loads a
pytorch-fid or torchvision ``.pth`` by the names of ``_conv_specs`` (plus
``fc``). Without a weight file the net is randomly initialized (He-normal
convolutions, BN at identity, drawn from a ``torch.Generator`` of seed 0):
FID and IS are then self-consistent but not comparable to published
numbers, and do not equal the JAX package's random init.

Input: NHWC float images in [0, 1]; the model resizes them bilinearly to
299x299 (align_corners=False, no antialias) and scales to [-1, 1]. The
forward runs under ``exact_f32`` and in ``channels_last`` memory: cuDNN
would run its float32 convolutions in TF32, and the JAX package asks for
``Precision.HIGHEST``.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import exact_f32

BN_EPS = 1e-3
# stride-2 convolutions, and the stem's unpadded ones; every other
# convolution pads to keep its size (kernel // 2 on each side)
_STRIDE2 = {"Conv2d_1a_3x3", "Mixed_6a.branch3x3", "Mixed_6a.branch3x3dbl_3",
            "Mixed_7a.branch3x3_2", "Mixed_7a.branch7x7x3_4"}
_UNPADDED = _STRIDE2 | {"Conv2d_2a_3x3", "Conv2d_4a_3x3"}


def _conv_specs() -> List[Tuple[str, int, int, int, int]]:
    """(name, cin, cout, kh, kw) for every BasicConv2d, matching torchvision
    inception_v3 channel math (a copy of the JAX package's table)."""
    specs = [
        ("Conv2d_1a_3x3", 3, 32, 3, 3),
        ("Conv2d_2a_3x3", 32, 32, 3, 3),
        ("Conv2d_2b_3x3", 32, 64, 3, 3),
        ("Conv2d_3b_1x1", 64, 80, 1, 1),
        ("Conv2d_4a_3x3", 80, 192, 3, 3),
    ]

    def block_a(prefix, cin, pool_features):
        return [
            (f"{prefix}.branch1x1", cin, 64, 1, 1),
            (f"{prefix}.branch5x5_1", cin, 48, 1, 1),
            (f"{prefix}.branch5x5_2", 48, 64, 5, 5),
            (f"{prefix}.branch3x3dbl_1", cin, 64, 1, 1),
            (f"{prefix}.branch3x3dbl_2", 64, 96, 3, 3),
            (f"{prefix}.branch3x3dbl_3", 96, 96, 3, 3),
            (f"{prefix}.branch_pool", cin, pool_features, 1, 1),
        ]

    def block_c(prefix, c7):
        return [
            (f"{prefix}.branch1x1", 768, 192, 1, 1),
            (f"{prefix}.branch7x7_1", 768, c7, 1, 1),
            (f"{prefix}.branch7x7_2", c7, c7, 1, 7),
            (f"{prefix}.branch7x7_3", c7, 192, 7, 1),
            (f"{prefix}.branch7x7dbl_1", 768, c7, 1, 1),
            (f"{prefix}.branch7x7dbl_2", c7, c7, 7, 1),
            (f"{prefix}.branch7x7dbl_3", c7, c7, 1, 7),
            (f"{prefix}.branch7x7dbl_4", c7, c7, 7, 1),
            (f"{prefix}.branch7x7dbl_5", c7, 192, 1, 7),
            (f"{prefix}.branch_pool", 768, 192, 1, 1),
        ]

    def block_e(prefix, cin):
        return [
            (f"{prefix}.branch1x1", cin, 320, 1, 1),
            (f"{prefix}.branch3x3_1", cin, 384, 1, 1),
            (f"{prefix}.branch3x3_2a", 384, 384, 1, 3),
            (f"{prefix}.branch3x3_2b", 384, 384, 3, 1),
            (f"{prefix}.branch3x3dbl_1", cin, 448, 1, 1),
            (f"{prefix}.branch3x3dbl_2", 448, 384, 3, 3),
            (f"{prefix}.branch3x3dbl_3a", 384, 384, 1, 3),
            (f"{prefix}.branch3x3dbl_3b", 384, 384, 3, 1),
            (f"{prefix}.branch_pool", cin, 192, 1, 1),
        ]

    specs += block_a("Mixed_5b", 192, 32)
    specs += block_a("Mixed_5c", 256, 64)
    specs += block_a("Mixed_5d", 288, 64)
    specs += [
        ("Mixed_6a.branch3x3", 288, 384, 3, 3),
        ("Mixed_6a.branch3x3dbl_1", 288, 64, 1, 1),
        ("Mixed_6a.branch3x3dbl_2", 64, 96, 3, 3),
        ("Mixed_6a.branch3x3dbl_3", 96, 96, 3, 3),
    ]
    specs += block_c("Mixed_6b", 128)
    specs += block_c("Mixed_6c", 160)
    specs += block_c("Mixed_6d", 160)
    specs += block_c("Mixed_6e", 192)
    specs += [
        ("Mixed_7a.branch3x3_1", 768, 192, 1, 1),
        ("Mixed_7a.branch3x3_2", 192, 320, 3, 3),
        ("Mixed_7a.branch7x7x3_1", 768, 192, 1, 1),
        ("Mixed_7a.branch7x7x3_2", 192, 192, 1, 7),
        ("Mixed_7a.branch7x7x3_3", 192, 192, 7, 1),
        ("Mixed_7a.branch7x7x3_4", 192, 192, 3, 3),
    ]
    specs += block_e("Mixed_7b", 1280)
    specs += block_e("Mixed_7c", 2048)
    return specs


class _BN(nn.Module):
    """The BN parameters under torch's names (``weight``, ``bias``,
    ``running_mean``, ``running_var``); applied by ``BasicConv2d``."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))


class BasicConv2d(nn.Module):
    """conv (no bias) + BN (eps 1e-3, running statistics) + ReLU."""

    def __init__(self, name: str, cin: int, cout: int, kh: int, kw: int):
        super().__init__()
        pad = (0, 0) if name in _UNPADDED else (kh // 2, kw // 2)
        self.conv = nn.Conv2d(cin, cout, (kh, kw), stride=2 if name in
                              _STRIDE2 else 1, padding=pad, bias=False)
        self.bn = _BN(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.bn
        inv = torch.rsqrt(bn.running_var + BN_EPS)
        shape = (1, -1, 1, 1)
        y = ((self.conv(x) - bn.running_mean.view(shape)) * inv.view(shape)
             * bn.weight.view(shape) + bn.bias.view(shape))
        return F.relu(y)


def _avg_pool(x: torch.Tensor, include_pad: bool) -> torch.Tensor:
    """3x3 stride-1 pad-1 average pool; ``include_pad`` is torch's
    ``count_include_pad`` (the FID patch sets it False)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=include_pad)


class _Block(nn.Module):
    """A Mixed_* block: one BasicConv2d per entry of ``_conv_specs`` under
    ``prefix``, named by its branch."""

    def __init__(self, prefix: str):
        super().__init__()
        for name, cin, cout, kh, kw in _conv_specs():
            parent, _, leaf = name.rpartition(".")
            if parent == prefix:
                self.add_module(leaf, BasicConv2d(name, cin, cout, kh, kw))


class InceptionA(_Block):
    def __init__(self, prefix: str, include_pad: bool):
        super().__init__(prefix)
        self.include_pad = include_pad

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool(x, self.include_pad))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(_Block):
    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = F.max_pool2d(x, 3, 2)
        return torch.cat([b3, bd, bp], dim=1)


class InceptionC(_Block):
    def __init__(self, prefix: str, include_pad: bool):
        super().__init__(prefix)
        self.include_pad = include_pad

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool(x, self.include_pad))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(_Block):
    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        bp = F.max_pool2d(x, 3, 2)
        return torch.cat([b3, b7, bp], dim=1)


class InceptionE(_Block):
    """``pool``: 'avg' (count_include_pad=False, FIDInceptionE_1), 'max'
    (FIDInceptionE_2) or 'avg_incl' (torchvision)."""

    def __init__(self, prefix: str, pool: str):
        super().__init__(prefix)
        if pool not in ("avg", "max", "avg_incl"):
            raise ValueError(f"unknown InceptionE pool {pool!r}")
        self.pool = pool

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=1)
        if self.pool == "max":
            bp = F.max_pool2d(x, 3, 1, 1)
        else:
            bp = _avg_pool(x, self.pool == "avg_incl")
        bp = self.branch_pool(bp)
        return torch.cat([b1, b3, bd, bp], dim=1)


_STEM = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1",
         "Conv2d_4a_3x3")


class InceptionV3(nn.Module):
    """The FID (``fid_variant``) or torchvision network; ``with_fc`` adds
    the 1000-way classifier that ``forward(x, with_logits=True)`` applies.
    Randomly initialized from a ``torch.Generator`` of seed 0."""

    def __init__(self, fid_variant: bool = True, with_fc: bool = False):
        super().__init__()
        include_pad = not fid_variant
        specs = {s[0]: s for s in _conv_specs()}
        # the layers' own init is overwritten below; keep it off the
        # global random state
        with torch.random.fork_rng(devices=[]):
            for name in _STEM:
                self.add_module(name, BasicConv2d(*specs[name]))
            for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
                self.add_module(name, InceptionA(name, include_pad))
            self.Mixed_6a = InceptionB("Mixed_6a")
            for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
                self.add_module(name, InceptionC(name, include_pad))
            self.Mixed_7a = InceptionD("Mixed_7a")
            self.Mixed_7b = InceptionE("Mixed_7b",
                                       "avg" if fid_variant else "avg_incl")
            self.Mixed_7c = InceptionE("Mixed_7c",
                                       "max" if fid_variant else "avg_incl")
            self.fc = nn.Linear(2048, 1000) if with_fc else None
        self._random_init(torch.Generator().manual_seed(0))
        self.eval()

    @torch.no_grad()
    def _random_init(self, g: torch.Generator) -> None:
        """He-normal convolutions (std sqrt(2 / fan_in)), so that a ReLU
        stack with identity BN keeps unit activation variance and the
        weightless features stay discriminative; fc normal(0.02), bias 0
        (inception.py:220-235, 319-324)."""
        for name, cin, _, kh, kw in _conv_specs():
            w = self.get_submodule(name).conv.weight
            w.copy_(torch.randn(w.shape, generator=g)
                    * math.sqrt(2.0 / (kh * kw * cin)))
        if self.fc is not None:
            self.fc.weight.copy_(torch.randn(self.fc.weight.shape,
                                             generator=g) * 0.02)
            self.fc.bias.zero_()

    def forward(self, x: torch.Tensor, with_logits: bool = False
                ) -> torch.Tensor:
        """(B, H, W, 3) float in [0, 1] -> pool3 features (B, 2048), or the
        logits (B, 1000) with ``with_logits``."""
        if with_logits and self.fc is None:
            raise ValueError("with_logits needs a model built with_fc")
        with exact_f32():
            x = x.permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
            x = F.interpolate(x, size=(299, 299), mode="bilinear",
                              align_corners=False, antialias=False)
            x = 2.0 * x - 1.0
            for name in _STEM[:3]:
                x = getattr(self, name)(x)
            x = F.max_pool2d(x, 3, 2)
            x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
            x = F.max_pool2d(x, 3, 2)
            for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                         "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                         "Mixed_7a", "Mixed_7b", "Mixed_7c"):
                x = getattr(self, name)(x)
            feats = x.mean(dim=(2, 3))  # global average pool
            return self.fc(feats) if with_logits else feats


def load_torch_inception_weights(model: InceptionV3, path: str) -> None:
    """Load a pytorch-fid ``pt_inception-2015-12-05-*.pth`` or a torchvision
    ``inception_v3_google-*.pth`` state dict into ``model``: the
    ``_conv_specs`` entries (``.conv.weight`` and the four BN tensors) and,
    when the model has one, ``fc``; every other key (``AuxLogits.*``,
    ``num_batches_tracked``) is ignored. Raises on a missing key or a shape
    that does not fit (inception.py:328-352)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    want = model.state_dict()
    missing = sorted(k for k in want if k not in sd)
    if missing:
        raise KeyError(f"{path}: no {missing[:5]} ({len(missing)} missing)")
    model.load_state_dict({k: sd[k] for k in want}, strict=True)


def get_inception(weights_path: str = "", fid_variant: bool = True,
                  with_fc: bool = False,
                  device: Optional[torch.device] = None) -> InceptionV3:
    """The network with the weights of ``weights_path`` if that file
    exists, else randomly initialized; in eval mode, channels_last, on
    ``device``."""
    model = InceptionV3(fid_variant=fid_variant, with_fc=with_fc)
    if weights_path and os.path.isfile(weights_path):
        load_torch_inception_weights(model, weights_path)
    return model.to(device=device, memory_format=torch.channels_last)
