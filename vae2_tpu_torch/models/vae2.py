"""The VAE² model family in PyTorch: encoder-dual-decoder, posterior,
discriminators.

Counterpart of ``vae2_tpu/models/vae2.py`` (reference
lib/models/enc_hrnet.py:530-1210). ``VAE2EncDec``: the encoder predicts the
middle clip ``x2p`` from the past clip; the future and past decoders decode
``x3p`` and ``x1p`` from that prediction. The latent z (and, in the
encoder, a fresh random code) is injected at every network's stage-4
transition. ``VAE2Posterior`` gives q(z | clips); ``VAE2Discriminator`` is
the LSGAN sequence or frame discriminator.

Inputs and outputs are NCHW in ``torch.channels_last`` memory; z is a list
of per-branch (S, z_dim, h_b, w_b) maps (hd_z) or an (S, z_dim) vector.
Every network is a trunk of ``models/hrnet.py`` plus a head; each is given
its input width, which flax infers.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from ..ops.norm import BatchNormAct
from ..utils.device import compute_dtype
from .hrnet import (REMAT_MODES, ConvHead, HRNetTrunk, Linear, StageSpec,
                    _conv, cat_channels, concat_upsampled,
                    stage_specs_from_extra, upsampled_branches)


HEAD_DATAFLOWS = ("concat", "presum", "multiscale")


def _head_input(feats: List[torch.Tensor], dataflow: str):
    """What the heads take under TPU.HEAD_DATAFLOW (vae2.py:38-50 of the JAX
    package): the upsample-concat ('concat', enc_hrnet.py:833-839), the
    upsampled branch list ('presum') or the raw branches ('multiscale');
    ``ConvHead`` computes the same function from each."""
    if dataflow == "multiscale":
        return feats
    if dataflow == "presum":
        return upsampled_branches(feats)
    if dataflow != "concat":
        raise ValueError(f"unknown head dataflow {dataflow!r}: expected "
                         "'concat', 'presum', or 'multiscale'")
    return concat_upsampled(feats)


class _TrunkWithHeads(nn.Module):
    """A video trunk + ``num_heads`` frame-prediction heads, one RGB frame
    each, concatenated on channels (enc_hrnet.py:323-370, 841-845)."""

    def __init__(self, specs: Tuple[StageSpec, ...], in_channels: int,
                 num_heads: int, num_classes: int, final_kernel: int,
                 z_mode: str, z_dim: int, dtype: torch.dtype,
                 remat: str = "none", head_dataflow: str = "concat"):
        super().__init__()
        self.head_dataflow = head_dataflow
        self.trunk = HRNetTrunk(specs, in_channels, stem_stride=1,
                                z_mode=z_mode, z_dim=z_dim, dtype=dtype,
                                remat=remat)
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
        y = _head_input(feats, self.head_dataflow)
        frames = [getattr(self, f"last_layer_{i + 1}")(y)
                  for i in range(self.num_heads)]
        return cat_channels(frames, frames[0].dtype)


class VAE2EncDec(nn.Module):
    """Encoder + future/past decoders (HighResolutionNetED,
    enc_hrnet.py:530-981)."""

    def __init__(self, specs: Tuple[StageSpec, ...], clip_length: int = 3,
                 num_classes: int = 3, final_kernel: int = 1,
                 is_baseline: bool = False,
                 baseline_mode: str = "VAE_NATIVE", z_dim: int = 32,
                 dtype: torch.dtype = torch.bfloat16, remat: str = "none",
                 head_dataflow: str = "concat"):
        super().__init__()
        det = baseline_mode == "DETERMINISTIC"
        enc_z = "none" if det else ("z" if is_baseline else "z+rand")
        dec_z = "none" if det else "z"
        # the baseline encoder sees [xt, x2t] (system.py:289-292)
        enc_in = 3 * clip_length * (2 if is_baseline else 1)
        head_kw = dict(specs=specs, num_heads=clip_length,
                       num_classes=num_classes, final_kernel=final_kernel,
                       z_dim=z_dim, dtype=dtype, remat=remat,
                       head_dataflow=head_dataflow)
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


class VAE2Posterior(nn.Module):
    """q(z | clips): trunk + latent head (HighResolutionNetEDz,
    enc_hrnet.py:984-1122; vae2.py:171-210 of the JAX package).

    ``hd_z``: per-branch 1x1 convs ``z_layer_i`` emit a (B, 2*z_dim, h_b,
    w_b) map per resolution. Otherwise: upsample-concat, global average
    pool, ``z_fc1`` (512) -> ``z_bn`` (BN + ReLU) -> ``z_fc2`` ->
    (B, 2*z_dim). Outputs are float32.
    """

    def __init__(self, specs: Tuple[StageSpec, ...], in_channels: int,
                 hd_z: bool = True, z_dim: int = 32,
                 dtype: torch.dtype = torch.bfloat16, remat: str = "none"):
        super().__init__()
        self.hd_z = hd_z
        self.trunk = HRNetTrunk(specs, in_channels, stem_stride=1,
                                z_mode="none", z_dim=z_dim, dtype=dtype,
                                remat=remat)
        widths = specs[3].out_channels
        if hd_z:
            for i, c in enumerate(widths):
                self.add_module(f"z_layer_{i}", _conv(c, 2 * z_dim, 1, 1))
        else:
            self.z_fc1 = Linear(sum(widths), 512)
            self.z_bn = BatchNormAct(512, act="relu")
            self.z_fc2 = Linear(512, 2 * z_dim)

    def forward(self, x) -> Union[List[torch.Tensor], torch.Tensor]:
        feats = self.trunk(x)
        if self.hd_z:
            return [getattr(self, f"z_layer_{i}")(f).float()
                    for i, f in enumerate(feats)]
        y = concat_upsampled(feats).mean(dim=(2, 3))  # global average pool
        return self.z_fc2(self.z_bn(self.z_fc1(y))).float()


class VAE2Discriminator(nn.Module):
    """LSGAN discriminator emitting a (B, 1, H, W) float32 score map
    (HighResolutionNetDsc, enc_hrnet.py:1125-1183): the sequence D sees a
    clip (9 channels), the frame D one frame (3)."""

    def __init__(self, specs: Tuple[StageSpec, ...], in_channels: int,
                 final_kernel: int = 1, dtype: torch.dtype = torch.bfloat16,
                 remat: str = "none", head_dataflow: str = "concat"):
        super().__init__()
        self.head_dataflow = head_dataflow
        self.trunk = HRNetTrunk(specs, in_channels, stem_stride=1,
                                z_mode="none", dtype=dtype, remat=remat)
        self.last_layer = ConvHead(sum(specs[3].out_channels), 1,
                                   final_kernel)

    def forward(self, x) -> torch.Tensor:
        return self.last_layer(_head_input(self.trunk(x),
                                           self.head_dataflow)).float()


def _remat(config) -> str:
    """TPU.REMAT as a policy string; the legacy booleans map True -> 'trunk'
    and False -> 'none' (vae2.py:245-253)."""
    v = config.TPU.get("REMAT", True)
    if isinstance(v, str):
        if v not in REMAT_MODES:
            raise ValueError(f"TPU.REMAT must be none|trunk|stage, got {v!r}")
        return v
    return "trunk" if v else "none"


def _head_dataflow(config) -> str:
    """TPU.MULTISCALE_HEAD=True (the legacy knob) wins; otherwise
    TPU.HEAD_DATAFLOW."""
    if bool(config.TPU.get("MULTISCALE_HEAD", False)):
        return "multiscale"
    v = str(config.TPU.get("HEAD_DATAFLOW", "concat"))
    if v not in HEAD_DATAFLOWS:
        raise ValueError(
            f"TPU.HEAD_DATAFLOW must be concat|presum|multiscale, got {v!r}")
    return v


def _common(config):
    extra = config.MODEL.EXTRA
    return extra, stage_specs_from_extra(extra), dict(
        dtype=compute_dtype(config), remat=_remat(config))


def get_encdec_model(config) -> VAE2EncDec:
    """The encdec network of a config (vae2.py:268-281)."""
    extra, specs, kw = _common(config)
    return VAE2EncDec(
        specs=specs,
        clip_length=config.TRAIN.CLIP_LENGTH,
        num_classes=config.DATASET.NUM_CLASSES,
        final_kernel=int(extra.get("FINAL_CONV_KERNEL", 1)),
        is_baseline=bool(extra.IS_BASELINE),
        baseline_mode=str(extra.BASELINE_MODE),
        z_dim=int(extra.get("Z_DIM", 32)),
        head_dataflow=_head_dataflow(config),
        **kw,
    )


def get_encz_model(config) -> VAE2Posterior:
    """The posterior (vae2.py:284-292). It sees [xt, x3t], and the baseline
    [xt, x2t, x3t] (system.py:294-300)."""
    extra, specs, kw = _common(config)
    clips = 3 if bool(extra.IS_BASELINE) else 2
    return VAE2Posterior(
        specs=specs, in_channels=3 * config.TRAIN.CLIP_LENGTH * clips,
        hd_z=bool(extra.get("HD_Z", True)), z_dim=int(extra.get("Z_DIM", 32)),
        **kw)


def get_D_sequence_model(config) -> VAE2Discriminator:
    """The sequence discriminator (vae2.py:295-300): one clip in."""
    extra, specs, kw = _common(config)
    return VAE2Discriminator(
        specs=specs, in_channels=3 * config.TRAIN.CLIP_LENGTH,
        final_kernel=int(extra.get("FINAL_CONV_KERNEL", 1)),
        head_dataflow=_head_dataflow(config), **kw)


def get_D_frame_model(config) -> VAE2Discriminator:
    """The frame discriminator (vae2.py:303-304): one RGB frame in."""
    extra, specs, kw = _common(config)
    return VAE2Discriminator(
        specs=specs, in_channels=3,
        final_kernel=int(extra.get("FINAL_CONV_KERNEL", 1)),
        head_dataflow=_head_dataflow(config), **kw)
