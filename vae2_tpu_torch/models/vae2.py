"""The VAE² encoder-dual-decoder in PyTorch, inference mode.

Counterpart of ``VAE2EncDec`` (vae2_tpu/models/vae2.py:107-168; reference
lib/models/enc_hrnet.py:530-981): the encoder predicts the middle clip
``x2p`` from the past clip; the future and past decoders decode ``x3p`` and
``x1p`` from that prediction. The latent z (and, in the encoder, a fresh
random code) is injected at every network's stage-4 transition.

Inputs and outputs are NCHW in ``torch.channels_last`` memory; z is a list
of per-branch (S, z_dim, h_b, w_b) maps (hd_z) or an (S, z_dim) vector. The
posterior and the discriminators come with later slices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..utils.device import compute_dtype
from .hrnet import (ConvHead, HRNetTrunk, StageSpec, cat_channels,
                    concat_upsampled, stage_specs_from_extra)


def _check_head_dataflow(dataflow: str) -> None:
    """TPU.HEAD_DATAFLOW: only the reference 'concat' dataflow
    (enc_hrnet.py:833-839) is ported."""
    if dataflow in ("presum", "multiscale"):
        raise NotImplementedError(
            f"head dataflow {dataflow!r} is not ported yet; use 'concat'")
    if dataflow != "concat":
        raise ValueError(
            f"unknown head dataflow {dataflow!r}: "
            "expected 'concat', 'presum', or 'multiscale'")


class _TrunkWithHeads(nn.Module):
    """A video trunk + ``num_heads`` frame-prediction heads, one RGB frame
    each, concatenated on channels (enc_hrnet.py:323-370, 841-845)."""

    def __init__(self, specs: Tuple[StageSpec, ...], in_channels: int,
                 num_heads: int, num_classes: int, final_kernel: int,
                 z_mode: str, z_dim: int, dtype: torch.dtype):
        super().__init__()
        self.trunk = HRNetTrunk(specs, in_channels, stem_stride=1,
                                z_mode=z_mode, z_dim=z_dim, dtype=dtype)
        width = sum(specs[3].out_channels)
        self.num_heads = num_heads
        for i in range(num_heads):
            self.add_module(f"last_layer_{i + 1}",
                            ConvHead(width, num_classes, final_kernel))

    def forward(self, x, z=None, mode: str = "full",
                rand_code: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        feats = self.trunk(x, z, mode, rand_code, generator)
        if mode == "prefix":
            return feats
        y = concat_upsampled(feats)
        frames = [getattr(self, f"last_layer_{i + 1}")(y)
                  for i in range(self.num_heads)]
        return cat_channels(frames, y.dtype)


class VAE2EncDec(nn.Module):
    """Encoder + future/past decoders (HighResolutionNetED,
    enc_hrnet.py:530-981)."""

    def __init__(self, specs: Tuple[StageSpec, ...], clip_length: int = 3,
                 num_classes: int = 3, final_kernel: int = 1,
                 is_baseline: bool = False,
                 baseline_mode: str = "VAE_NATIVE", z_dim: int = 32,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        det = baseline_mode == "DETERMINISTIC"
        enc_z = "none" if det else ("z" if is_baseline else "z+rand")
        dec_z = "none" if det else "z"
        # the baseline encoder sees [xt, x2t] (system.py:289-292)
        enc_in = 3 * clip_length * (2 if is_baseline else 1)
        head_kw = dict(specs=specs, num_heads=clip_length,
                       num_classes=num_classes, final_kernel=final_kernel,
                       z_dim=z_dim, dtype=dtype)
        self.encoder = _TrunkWithHeads(in_channels=enc_in, z_mode=enc_z,
                                       **head_kw)
        dec_in = num_classes * clip_length
        self.dec_future = _TrunkWithHeads(in_channels=dec_in, z_mode=dec_z,
                                          **head_kw)
        self.dec_past = _TrunkWithHeads(in_channels=dec_in, z_mode=dec_z,
                                        **head_kw)

    def forward(self, x, z=None, rand_code=None, generator=None):
        x2p = self.encoder(x, z, "full", rand_code, generator)
        x3p = self.dec_future(x2p, z)
        x1p = self.dec_past(x2p, z)
        return x1p, x2p, x3p

    def encode(self, x, z=None, rand_code=None, generator=None):
        return self.encoder(x, z, "full", rand_code, generator)

    def decode(self, x2p, z=None):
        return self.dec_past(x2p, z), self.dec_future(x2p, z)

    def sample(self, x, z, rand_code=None, generator=None):
        """Multi-sample rollout sharing the z-independent encoder prefix.

        ``x`` is a single conditioning clip (1, C, H, W); ``z`` carries the
        sample batch S. The encoder's stem..transition3 runs once and is
        broadcast (a view, no copy) to the S samples; the z-injection,
        which materialises the S copies, stage 4, the heads and both
        decoders run per sample.
        """
        if isinstance(z, (list, tuple)):
            s = z[0].shape[0]
        elif z is not None:
            s = z.shape[0]
        else:
            s = x.shape[0]
        feats = self.encoder(x, None, "prefix")
        feats = [f.expand(s, -1, -1, -1) for f in feats]
        x2p = self.encoder(feats, z, "suffix", rand_code, generator)
        x3p = self.dec_future(x2p, z)
        x1p = self.dec_past(x2p, z)
        return x1p, x2p, x3p


def _head_dataflow(config) -> str:
    """TPU.MULTISCALE_HEAD=True (the legacy knob) wins; otherwise
    TPU.HEAD_DATAFLOW."""
    if bool(config.TPU.get("MULTISCALE_HEAD", False)):
        return "multiscale"
    return str(config.TPU.get("HEAD_DATAFLOW", "concat"))


def get_encdec_model(config) -> VAE2EncDec:
    """The encdec network of a config (vae2.py:268-281). Per-stage remat
    (TPU.REMAT) is a training concern and is not read."""
    _check_head_dataflow(_head_dataflow(config))
    extra = config.MODEL.EXTRA
    return VAE2EncDec(
        specs=stage_specs_from_extra(extra),
        clip_length=config.TRAIN.CLIP_LENGTH,
        num_classes=config.DATASET.NUM_CLASSES,
        final_kernel=int(extra.get("FINAL_CONV_KERNEL", 1)),
        is_baseline=bool(extra.IS_BASELINE),
        baseline_mode=str(extra.BASELINE_MODE),
        z_dim=int(extra.get("Z_DIM", 32)),
        dtype=compute_dtype(config),
    )
