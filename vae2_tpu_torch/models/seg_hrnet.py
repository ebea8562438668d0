"""HRNetV2 semantic segmentation (counterpart of
``vae2_tpu/models/seg_hrnet.py:25-56``; reference
lib/models/seg_hrnet.py:259-480).

The trunk of the video nets with the original stride-2 x2 stem (features
at 1/4 of the input resolution) and one head: ``_head_input`` of the
branches (upsample-concat by default) -> 1x1 conv + BN + ReLU -> 1x1 conv
to NUM_CLASSES (seg_hrnet.py:323-343). Submodules ``trunk`` and
``last_layer`` carry the flax names, so a JAX parameter tree maps onto the
state dict through ``utils.jax_params.from_jax_params`` as it is, and a
reference seg checkpoint through ``utils.torch_import``.

Input (B, 3, H, W) normalized RGB, NCHW (channels_last or not); output
float32 logits (B, NUM_CLASSES, H/4, W/4), channels_last. No remat, as in
the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..utils.device import compute_dtype
from .hrnet import ConvHead, HRNetTrunk, StageSpec, stage_specs_from_extra
from .seg_hrnet_ocr import get_seg_ocr_model
from .vae2 import _head_dataflow, _head_input


class SegHRNet(nn.Module):
    def __init__(self, specs: Tuple[StageSpec, ...], num_classes: int = 19,
                 final_kernel: int = 1, dtype: torch.dtype = torch.bfloat16,
                 head_dataflow: str = "concat"):
        super().__init__()
        self.head_dataflow = head_dataflow
        self.trunk = HRNetTrunk(specs, 3, stem_stride=2, z_mode="none",
                                dtype=dtype)
        self.last_layer = ConvHead(sum(specs[3].out_channels), num_classes,
                                   final_kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _head_input(self.trunk(x), self.head_dataflow)
        return self.last_layer(y).float()


def get_seg_model(cfg) -> nn.Module:
    """The seg network of a config by MODEL.NAME: 'seg_hrnet_ocr' builds
    ``SegHRNetOCR`` (``models/seg_hrnet_ocr.py``); any other name the
    SegHRNet of MODEL.EXTRA's stages, DATASET.NUM_CLASSES, the compute dtype
    (GPU.DTYPE, else TPU.DTYPE) and TPU.HEAD_DATAFLOW."""
    if cfg.MODEL.NAME == "seg_hrnet_ocr":
        return get_seg_ocr_model(cfg)
    extra = cfg.MODEL.EXTRA
    return SegHRNet(specs=stage_specs_from_extra(extra),
                    num_classes=cfg.DATASET.NUM_CLASSES,
                    final_kernel=int(extra.get("FINAL_CONV_KERNEL", 1)),
                    dtype=compute_dtype(cfg),
                    head_dataflow=_head_dataflow(cfg))
