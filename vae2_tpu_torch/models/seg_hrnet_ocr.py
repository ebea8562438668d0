"""HRNetV2 + OCR (Object-Contextual Representations; Yuan, Chen and Wang,
ECCV 2020, arXiv:1909.11065), as lib/models/seg_hrnet_ocr.py of
HRNet-Semantic-Segmentation builds it, layer for layer and in its order.

On ``SegHRNet``'s trunk (the stride-2 stem, features at 1/4 of the input)
and its upsample-concat of the four branches (``feats``, C channels):

1. ``aux_head`` (soft object regions): 1x1 C->C (bias) + BN + ReLU, 1x1
   C->K (bias), K = NUM_CLASSES; ``ConvHead``, the shape of SegHRNet's
   ``last_layer``.
2. ``conv3x3_ocr``: 3x3 C->MID (bias) + BN + ReLU.
3. ``ocr_gather_head``: a softmax of the auxiliary logits over the pixels
   weights the MID-channel features into K region vectors.
4. ``ocr_distri_head.object_context_block``: the query ``f_pixel`` (twice
   1x1 ->KEY + BN + ReLU) on the pixels, the key ``f_object`` (the same)
   and the value ``f_down`` (1x1 MID->KEY + BN + ReLU) on the regions; each
   pixel's softmax over the regions of q.k * KEY^-0.5 weights the values;
   ``f_up``, 1x1 KEY->MID + BN + ReLU. SCALE 1: no pooling.
5. ``ocr_distri_head.conv_bn``: 1x1 2*MID->MID + BN + ReLU on
   ``cat([context, feats])``, then ``ocr_distri_head.dropout``
   (``Dropout2d``).
6. ``cls_head``: 1x1 MID->K (bias).

The forward returns ``[aux, out]``, each float32 logits (B, K, H/4, W/4),
channels_last: the training loss weights them by LOSS.BALANCE_WEIGHTS,
inference takes TEST.OUTPUT_INDEX. Every BN here is BN + ReLU, so each
takes ``BatchNormAct``'s plain path. The gather and the attention are
batched matrix products on (B, H*W, C) views of the channels_last maps.

The object side runs in float32: the gather's product and its output, the
region layers ``f_object`` and ``f_down`` (their 1x1 convs as float32
matrix products on the B*K region rows, ``RegionConvBNReLU``), and both
products of the attention; the pixel-side convs run in the compute dtype.
The region vectors share most of what they hold (each is a weighted mean
of the same maps), and the BNs over their B*K rows divide by the small
spread left, so a rounding of the regions, or of the gradient that they
hand back to the gather's softmax over the pixels (a large common part
less its mean), decides the keys and values and, through the gather's
backward, the gradient of the whole trunk: with these in bfloat16, the
head's gradient into its input features at random weights errs by ten
times a plain 1x1 head's. The cost is two float32 copies of (B, H*W, .)
rows, about 0.3 GB at 1024x512 x 3. The trunk's own rounding still moves
the keys and values: at random weights ``out`` sits several times further
from a float32 run than ``aux`` does.

Spans: ``ocr.aux`` (step 1), ``ocr.gather`` (2-3), ``ocr.attention`` (4),
``ocr.fuse`` (5-6). Counter ``ocr.forwards`` (``SegHRNetOCR.forwards``):
one a forward of the network, eager or captured; a step replayed from the
seg step's CUDA graph (``core/seg_loop.py``) adds it through the
capture's change of it, which the capture itself takes back, so that each
step, eager or replayed, counts one.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.norm import BatchNormAct
from ..parallel import sync
from ..utils import spans
from ..utils.device import compute_dtype
from .hrnet import (Conv2d, ConvHead, HRNetTrunk, StageSpec, cat_channels,
                    concat_upsampled, stage_specs_from_extra)


class ConvBNReLU(nn.Module):
    """A convolution, then BN + ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 1,
                 bias: bool = False):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel,
                           padding=(kernel - 1) // 2, bias=bias)
        self.bn = BatchNormAct(out_channels, act="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class RegionConvBNReLU(ConvBNReLU):
    """A 1x1 ``ConvBNReLU`` on (N, C) region rows, in float32: the conv as
    a float32 matrix product (cuBLAS, which takes no TF32 unless the caller
    allows it for matrix products; cuDNN's convolutions would by default),
    the BN over the N rows."""

    def forward(self, rows: torch.Tensor) -> torch.Tensor:
        weight = self.conv.weight.flatten(1)  # float32, as every parameter
        return self.bn(F.linear(rows.to(weight.dtype), weight))


def _rows(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) channels_last as its (B, H*W, C) rows (a view)."""
    b, c = x.shape[:2]
    return x.permute(0, 2, 3, 1).reshape(b, -1, c)


def _map(rows: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H*W, C) rows as a (B, C, H, W) channels_last map (a view)."""
    return rows.view(rows.shape[0], h, w, rows.shape[2]).permute(0, 3, 1, 2)


class SpatialGather(nn.Module):
    """Region vectors (B, C, K, 1), float32: the features averaged over
    the pixels with each class's softmax over the pixels of the auxiliary
    logits."""

    def forward(self, feats: torch.Tensor, probs: torch.Tensor
                ) -> torch.Tensor:
        weights = torch.softmax(_rows(probs).float(), dim=1)  # (B, HW, K)
        regions = torch.bmm(weights.transpose(1, 2),
                            _rows(feats).float())  # (B, K, C)
        return regions.transpose(1, 2).unsqueeze(3)


class ObjectAttention(nn.Module):
    """Each pixel's context: its attention over the K region vectors."""

    def __init__(self, in_channels: int, key_channels: int):
        super().__init__()
        self.key_channels = key_channels
        self.f_pixel = nn.Sequential(ConvBNReLU(in_channels, key_channels),
                                     ConvBNReLU(key_channels, key_channels))
        self.f_object = nn.Sequential(
            RegionConvBNReLU(in_channels, key_channels),
            RegionConvBNReLU(key_channels, key_channels))
        self.f_down = nn.Sequential(RegionConvBNReLU(in_channels,
                                                     key_channels))
        self.f_up = nn.Sequential(ConvBNReLU(key_channels, in_channels))

    def forward(self, x: torch.Tensor, proxy: torch.Tensor) -> torch.Tensor:
        (b, c, k), (h, w) = proxy.shape[:3], x.shape[2:]
        regions = proxy.flatten(2).transpose(1, 2).reshape(b * k, c)
        query = _rows(self.f_pixel(x)).float()               # (B, HW, KEY)
        key = self.f_object(regions).view(b, k, -1).transpose(1, 2)
        value = self.f_down(regions).view(b, k, -1)          # (B, K, KEY)
        sim = torch.bmm(query, key) * self.key_channels ** -0.5
        sim = torch.softmax(sim, dim=-1)                     # (B, HW, K)
        return self.f_up(_map(torch.bmm(sim, value).to(x.dtype), h, w))


class KeptDropout2d(nn.Module):
    """``Dropout2d(p)`` in training: each (sample, channel) kept with
    probability 1 - p, drawn from the default generator of the input's
    device (on CUDA a graph-safe draw: each replay of a captured step draws
    anew), and the kept ones scaled by 1 / (1 - p). The float32 keep mask
    (B, C, 1, 1) it applied is copied into ``mask``, a non-persistent
    buffer of the batch's shape, so that the mask of the last eager,
    captured or replayed step can be read after it. A buffer is kept for
    each batch shape (a graph holds its address); ``mask`` is the one of
    the shape of the last eager or captured forward."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.register_buffer("mask", torch.ones(0), persistent=False)
        self._masks = {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        shape = (x.shape[0], x.shape[1], 1, 1)
        keep = (torch.rand(shape, device=x.device) >= self.p).float()
        mask = self._masks.get(shape)
        if mask is None or mask.device != x.device:
            mask = self._masks[shape] = torch.empty_like(keep)
        self.mask = mask
        mask.copy_(keep)
        # scaled in float32, rounded once to the compute dtype
        return (x * (keep / (1.0 - self.p))).to(x.dtype)


class SpatialOCR(nn.Module):
    """Object attention, then the fuse of context and features."""

    def __init__(self, in_channels: int, key_channels: int,
                 out_channels: int, dropout: float):
        super().__init__()
        self.object_context_block = ObjectAttention(in_channels,
                                                    key_channels)
        self.conv_bn = ConvBNReLU(2 * in_channels, out_channels)
        self.dropout = KeptDropout2d(dropout)

    def forward(self, feats: torch.Tensor, proxy: torch.Tensor
                ) -> torch.Tensor:
        with spans.span("ocr.attention"):
            context = self.object_context_block(feats, proxy)
        with spans.span("ocr.fuse"):
            return self.dropout(self.conv_bn(
                cat_channels([context, feats], feats.dtype)))


class SegHRNetOCR(nn.Module):
    forwards = 0  # network forwards, read as the ocr.forwards counter

    def __init__(self, specs: Tuple[StageSpec, ...], num_classes: int = 19,
                 mid_channels: int = 512, key_channels: int = 256,
                 dropout: float = 0.05, scale: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if scale != 1:
            raise ValueError(f"MODEL.OCR.SCALE {scale}: only 1 (no pooling, "
                             "as the published recipe) is built")
        width = sum(specs[3].out_channels)
        self.trunk = HRNetTrunk(specs, 3, stem_stride=2, z_mode="none",
                                dtype=dtype)
        self.aux_head = ConvHead(width, num_classes)
        self.conv3x3_ocr = ConvBNReLU(width, mid_channels, 3, bias=True)
        self.ocr_gather_head = SpatialGather()
        self.ocr_distri_head = SpatialOCR(mid_channels, key_channels,
                                          mid_channels, dropout)
        self.cls_head = Conv2d(mid_channels, num_classes, 1, bias=True)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        if sync.spatial_size() > 1:
            raise ValueError("SegHRNetOCR gathers over every pixel of an "
                             "image: no spatial layout")
        SegHRNetOCR.forwards += 1
        feats = concat_upsampled(self.trunk(x))
        with spans.span("ocr.aux"):
            aux = self.aux_head(feats)
        with spans.span("ocr.gather"):
            feats = self.conv3x3_ocr(feats)
            regions = self.ocr_gather_head(feats, aux)
        feats = self.ocr_distri_head(feats, regions)
        with spans.span("ocr.fuse"):
            out = self.cls_head(feats)
        return [aux.float(), out.float()]


spans.counter("ocr.forwards", lambda: SegHRNetOCR.forwards)
spans.replayed(SegHRNetOCR, "forwards")


def get_seg_ocr_model(cfg) -> SegHRNetOCR:
    """The SegHRNetOCR of a config: MODEL.EXTRA's stages, MODEL.OCR,
    DATASET.NUM_CLASSES and the compute dtype; TPU.HEAD_DATAFLOW must be
    'concat' (the heads take the concat)."""
    ocr = cfg.MODEL.OCR
    if bool(cfg.TPU.get("MULTISCALE_HEAD", False)) or \
            cfg.TPU.get("HEAD_DATAFLOW", "concat") != "concat":
        raise ValueError("seg_hrnet_ocr takes TPU.HEAD_DATAFLOW 'concat'")
    return SegHRNetOCR(specs=stage_specs_from_extra(cfg.MODEL.EXTRA),
                       num_classes=cfg.DATASET.NUM_CLASSES,
                       mid_channels=int(ocr.MID_CHANNELS),
                       key_channels=int(ocr.KEY_CHANNELS),
                       dropout=float(ocr.DROPOUT), scale=int(ocr.SCALE),
                       dtype=compute_dtype(cfg))
