"""Plain float32 HRNetV2 + OCR and its training step, on :mod:`nets`'s
trunk: a frozen, independent copy of HRNet-Semantic-Segmentation's
lib/models/seg_hrnet_ocr.py (arXiv:1909.11065) in plain ``torch``
operations, with ``vae2_tpu_torch``'s parameter names, so that one state
dict made by ``weights.make_state`` loads into both.

The network: the trunk's upsample-concat ``feats``; ``aux_head`` (1x1 conv
with bias, BN + ReLU, 1x1 conv with bias to the classes); ``conv3x3_ocr``
(3x3 conv with bias, BN + ReLU); the gather (each class's softmax over the
pixels of the auxiliary logits weights the features into a region
vector); the object attention (``f_pixel`` and ``f_object``: two 1x1 convs
+ BN + ReLU each, ``f_down`` and ``f_up``: one; softmax over the regions
of q.k / sqrt(KEY)); ``cls_head`` of ``Dropout2d(cat([context, feats]) ->
1x1 conv + BN + ReLU)``. It returns ``[aux, out]``.

Departures from seg_hrnet_ocr.py:
- The dropout masks are given, not drawn: the (B, MID, 1, 1) keep mask of
  each step, as the program applied it; kept channels are scaled by
  1 / (1 - DROPOUT).
- BNs are :mod:`nets`'s (biased batch statistics, no running statistics in
  training), the resizes align_corners False, as the rest of the benchmark's
  reference; ``MODEL.OCR.SCALE`` 1 only (no pooling).
- Stored values go through :mod:`quant` as in :mod:`nets` (the identity
  unless the control precision is on).

The step (:func:`ocr_step`): BALANCE_WEIGHTS[i] times the class-weighted
cross entropy of output i (``steps.seg_loss``), summed, then ``steps.SGD``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from . import nets, quant, steps


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 1, bias: bool = False):
        super().__init__()
        self.conv, self.bn = nets.Conv(cin, cout, k, bias=bias), nets.BN(cout, True)

    def forward(self, x):
        return self.bn(self.conv(x))


def gather(feats, probs):
    """(B, C, K, 1): each class's softmax over the pixels of ``probs``
    (B, K, H, W) weights ``feats`` (B, C, H, W)."""
    w = quant.store(torch.softmax(probs.flatten(2), dim=2))   # (B, K, HW)
    return quant.store(torch.matmul(w, feats.flatten(2).transpose(1, 2))).transpose(1, 2)[
        ..., None]


class Attention(nn.Module):
    def __init__(self, cin: int, key: int):
        super().__init__()
        self.key = key
        self.f_pixel = nn.Sequential(ConvBNReLU(cin, key), ConvBNReLU(key, key))
        self.f_object = nn.Sequential(ConvBNReLU(cin, key), ConvBNReLU(key, key))
        self.f_down = nn.Sequential(ConvBNReLU(cin, key))
        self.f_up = nn.Sequential(ConvBNReLU(key, cin))

    def forward(self, x, proxy):
        b, _, h, w = x.shape
        q = self.f_pixel(x).flatten(2).transpose(1, 2)          # (B, HW, KEY)
        k = self.f_object(proxy).flatten(2)                      # (B, KEY, K)
        v = self.f_down(proxy).flatten(2).transpose(1, 2)        # (B, K, KEY)
        sim = quant.store(torch.softmax(torch.matmul(q, k) * self.key ** -0.5, dim=-1))
        ctx = quant.store(torch.matmul(sim, v)).transpose(1, 2).reshape(b, self.key, h, w)
        return self.f_up(ctx)


class Distri(nn.Module):
    def __init__(self, cin: int, key: int, dropout: float):
        super().__init__()
        self.dropout = dropout
        self.object_context_block = Attention(cin, key)
        self.conv_bn = ConvBNReLU(2 * cin, cin)

    def forward(self, feats, proxy, mask):
        y = self.conv_bn(torch.cat([self.object_context_block(feats, proxy), feats], 1))
        return quant.store(y * (mask / (1.0 - self.dropout))) if self.training else y


class OCRNet(nn.Module):
    def __init__(self, stages, classes: int, mid: int, key: int, dropout: float):
        super().__init__()
        self.trunk = nets.Trunk(stages, 3, 2, "none")
        width = sum(nets.out_channels(stages[3]))
        self.aux_head = nets.Head(width, classes)
        self.conv3x3_ocr = ConvBNReLU(width, mid, 3, bias=True)
        self.ocr_distri_head = Distri(mid, key, dropout)
        self.cls_head = nets.Conv(mid, classes, 1, bias=True)

    def forward(self, x, mask):
        feats = nets.concat_up(self.trunk(x))
        aux = self.aux_head(feats)
        feats = self.conv3x3_ocr(feats)
        feats = self.ocr_distri_head(feats, gather(feats, aux), mask)
        return [aux, self.cls_head(feats)]


def ocr_module(recipe: dict) -> nn.Module:
    ocr = recipe["MODEL"]["OCR"]
    if ocr.get("SCALE", 1) != 1:
        raise ValueError("the reference builds MODEL.OCR.SCALE 1 only")
    return OCRNet(nets.stages_of(recipe["MODEL"]["EXTRA"]), recipe["DATASET"]["NUM_CLASSES"],
                  ocr["MID_CHANNELS"], ocr["KEY_CHANNELS"], ocr["DROPOUT"])


def ocr_step(net, opt: steps.SGD, images, labels, mask, weights, ignore: int,
             balance: Sequence[float]) -> Dict[str, torch.Tensor]:
    outputs = net(images, mask)
    loss = sum(b * steps.seg_loss(o, labels, weights, ignore)
               for b, o in zip(balance, outputs))
    loss.backward()
    opt.step()
    return {"loss": loss.detach()}

