"""The VAE² training system (counterpart of ``vae2_tpu/core/system.py``;
reference lib/utils/utils.py:39-155, 244-276, lib/core/function.py:443-516).

- ``generator_loss``: posterior -> reparameterized z -> encoder + dual
  decoder -> L1 / KL / LSGAN generator loss (system.py:351-441).
- ``discriminator_loss``: LSGAN real/fake loss of the sequence and frame
  discriminators on the detached prediction, not scaled by GAN_LAMBDA
  (system.py:443-478).
- ``train_step``: a G update of {encdec, encz}, then a D update of {d_seq,
  d_frame} (the split step, system.py:550-613; the unsplit step computes
  the same numbers, so ``TPU.SPLIT_STEP`` selects nothing here).
- ``eval_step``: one stochastic rollout of ``generator_loss`` in eval mode
  (system.py:615-630), in any of its sampling modes: 'default' (z from the
  posterior of the batch), 'prior_sampling' (z ~ N(0, I) shaped like the
  posterior's mus) or 'momentum_sampling' (the posterior of the previous
  window's clips ``xt_last``, ``x3t_last``; a 5-clip batch).

In ``train_step`` the networks run in train mode throughout, the
discriminators in the G step too: their running statistics update there,
as in the JAX package.
The G step differentiates only the G parameters: the discriminators'
parameters stop recording while it runs. Clips are NHWC float tensors
(B, H, W, 3F), as ``normalize_clips`` gives them; the networks see NCHW
``channels_last`` views of them. The noise — eps per posterior output and
the encoder's random code — is drawn from an explicit ``torch.Generator``,
or passed in.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Iterator, Optional, Tuple

import torch
from torch import nn

from ..data.loader import normalize_clips
from ..parallel import sync
from . import losses, optim

BASELINE_MODES = ("VAE_NATIVE", "VAE_ANNEAL", "VAE_GAN", "DETERMINISTIC")
SAMPLING_MODES = ("default", "prior_sampling", "momentum_sampling")
D_METRICS = ("loss_D", "loss_D_sequence", "loss_D_frame")


@dataclasses.dataclass(frozen=True)
class Hyper:
    """Static loss/model hyper-parameters (from TRAIN.* / MODEL.EXTRA.*)."""

    x1recon_lambda: float = 1.0
    x2recon_lambda: float = 0.1
    x3recon_lambda: float = 1.0
    gan_lambda: float = 1.0
    is_baseline: bool = False
    baseline_mode: str = "VAE_NATIVE"
    hd_z: bool = True
    z_dim: int = 32
    clip_length: int = 3
    family: str = "image"

    def __post_init__(self):
        if self.baseline_mode not in BASELINE_MODES:
            raise ValueError(f"unknown baseline mode {self.baseline_mode!r}")

    @property
    def deterministic(self) -> bool:
        return self.baseline_mode == "DETERMINISTIC"

    @property
    def runs_d_step(self) -> bool:
        return (not self.is_baseline) or self.baseline_mode == "VAE_GAN"


def make_optimizer(params: Iterable[nn.Parameter], cfg_train,
                   moment_dtype: str = "float32",
                   max_iters: int = 0) -> torch.optim.Optimizer:
    """The optimizer of TRAIN.OPTIMIZER (system.py:116-167; reference
    tools/train.py:232-263). ``torch.optim.SGD`` applies the weight decay as
    an L2 gradient term before the momentum buffer, as optax's
    ``add_decayed_weights`` + ``sgd`` do, and its first step sets the buffer
    to the gradient, as optax's trace does from zero. ``moment_dtype``
    (TPU.ADAM_MOMENT_DTYPE) 'bfloat16' stores Adam's moments in bf16
    (``optim.AdamLowp``). TRAIN.LR_SCHEDULE 'poly' decays the lr per update
    over ``max_iters`` updates (``optim.attach_poly_lr``)."""
    name = cfg_train.OPTIMIZER.lower()
    schedule = str(cfg_train.get("LR_SCHEDULE", "")).lower()
    if schedule not in ("", "constant", "none", "poly"):
        raise ValueError(f"bad TRAIN.LR_SCHEDULE {schedule!r}")
    if name == "sgd":
        opt = torch.optim.SGD(params, lr=cfg_train.LR,
                              momentum=cfg_train.MOMENTUM,
                              weight_decay=cfg_train.WD,
                              nesterov=cfg_train.NESTEROV)
    elif name == "adam":
        if moment_dtype == "bfloat16":
            opt = optim.AdamLowp(params, lr=cfg_train.LR, eps=1e-8)
        elif moment_dtype == "float32":
            opt = torch.optim.Adam(params, lr=cfg_train.LR, eps=1e-8)
        else:
            raise ValueError(f"bad ADAM_MOMENT_DTYPE {moment_dtype!r}")
    else:
        raise ValueError("Only Support SGD and ADAM optimizer")
    if schedule == "poly":
        optim.attach_poly_lr(opt, max_iters,
                             float(cfg_train.get("LR_POWER", 0.9)))
    return opt


def normal_like(mus, generator: Optional[torch.Generator]):
    """Standard normal draws shaped like ``mus`` (a tensor or a list), in
    list order (utils.py:89, 97-98). Across ranks each draw is that of the
    global batch, of which this rank keeps its rows (``sync.randn_rows``)."""
    if isinstance(mus, (list, tuple)):
        return [normal_like(m, generator) for m in mus]
    return sync.randn_rows(mus.shape, generator, dtype=mus.dtype,
                           device=mus.device)


def reparameterize(mus, logvars, eps):
    """z = mu + exp(logvar / 2) * eps (reference utils.py:92-100)."""
    if isinstance(mus, (list, tuple)):
        return [m + torch.exp(0.5 * v) * e for m, v, e in zip(mus, logvars, eps)]
    return mus + torch.exp(0.5 * logvars) * eps


def split_muvar(muvars, z_dim: int):
    """Split posterior output into (mus, logvars) along the channel axis
    (axis 1 in the port's NCHW; the JAX package's last axis)."""
    if isinstance(muvars, (list, tuple)):
        return ([m[:, :z_dim] for m in muvars],
                [m[:, z_dim:] for m in muvars])
    return muvars[:, :z_dim], muvars[:, z_dim:]


def fold_frames(x: torch.Tensor, frame_channels: int = 3) -> torch.Tensor:
    """(B, F*c, H, W) -> (F*B, c, H, W), frames folded frame-major into the
    batch axis (system.py:199-205), channels_last."""
    b, fc, h, w = x.shape
    f = fc // frame_channels
    x = x.reshape(b, f, frame_channels, h, w).transpose(0, 1)
    return x.reshape(f * b, frame_channels, h, w).contiguous(
        memory_format=torch.channels_last)


def _nchw(clip: torch.Tensor) -> torch.Tensor:
    """An NHWC clip as the NCHW channels_last view the networks take; the
    toy family's (B, 10) vectors as they are."""
    return clip.permute(0, 3, 1, 2) if clip.dim() == 4 else clip


class VAE2System:
    """The networks by role and the two optimizers.

    ``modules`` has 'encdec', 'encz' (absent when DETERMINISTIC), 'd_seq'
    and 'd_frame' ('d_seq' alone in the toy family, where one
    discriminator plays both roles: reference tools/toy_example.py:84).
    ``optimizer_g`` updates encdec + encz, ``optimizer_d`` d_seq + d_frame;
    both are None in a system built for inference.
    """

    def __init__(self, modules: Dict[str, nn.Module], hyper: Hyper,
                 optimizer_g: Optional[torch.optim.Optimizer] = None,
                 optimizer_d: Optional[torch.optim.Optimizer] = None):
        self.modules = nn.ModuleDict(modules)
        self.hyper = hyper
        self.optimizer_g = optimizer_g
        self.optimizer_d = optimizer_d

    # -- parameter partitions ------------------------------------------------

    def _parameters(self, names) -> Iterator[nn.Parameter]:
        for name in names:
            if name in self.modules:
                yield from self.modules[name].parameters()

    def g_parameters(self) -> Iterator[nn.Parameter]:
        return self._parameters(("encdec", "encz"))

    def d_parameters(self) -> Iterator[nn.Parameter]:
        return self._parameters(("d_seq", "d_frame"))

    # -- input assembly (reference utils.py:77, 105) -------------------------

    def _encoder_input(self, xt: torch.Tensor, x2t: torch.Tensor) -> torch.Tensor:
        """The encoder sees the past clip, and the baseline also the middle
        one; clips are (B, H, W, 3F), concatenated on the last axis."""
        if self.hyper.is_baseline:
            return torch.cat([xt, x2t], dim=-1)
        return xt

    def _posterior_input(self, xt, x2t, x3t) -> torch.Tensor:
        if self.hyper.is_baseline:
            return torch.cat([xt, x2t, x3t], dim=-1)
        return torch.cat([xt, x3t], dim=-1)

    # -- forward passes ------------------------------------------------------

    def posterior(self, xt, x2t, x3t):
        """(mus, logvars) of q(z | clips)."""
        muvars = self.modules["encz"](_nchw(self._posterior_input(xt, x2t, x3t)))
        return split_muvar(muvars, self.hyper.z_dim)

    def momentum_posterior(self, xt_last, x3t_last):
        """(mus, logvars) of q(z | the previous window's clips): the posterior
        on concat(xt_last, x3t_last) (reference utils.py:195)."""
        muvars = self.modules["encz"](
            _nchw(torch.cat([xt_last, x3t_last], dim=-1)))
        return split_muvar(muvars, self.hyper.z_dim)

    def encdec_forward(self, xt, x2t, z, rand_code=None, generator=None):
        """(x1p, x2p, x3p), NCHW channels_last in the compute dtype."""
        x1p, x2p, x3p = self.modules["encdec"](
            _nchw(self._encoder_input(xt, x2t)), z, rand_code=rand_code,
            generator=generator)
        if self.hyper.is_baseline:
            # baseline decoders run without gradient (enc_hrnet.py:969-974)
            x1p, x3p = x1p.detach(), x3p.detach()
        return x1p, x2p, x3p

    def _frame_gan(self, x: torch.Tensor, real: bool) -> torch.Tensor:
        """Sum over frames of 0.5 * lsgan(D_frame(frame)), frames folded
        into the batch: 0.5 * F * lsgan(all) (system.py:338-347)."""
        num_frames = x.shape[1] // 3
        d_out = self.modules["d_frame"](fold_frames(x, 3))
        return 0.5 * num_frames * losses.lsgan_loss(d_out, real)

    # -- losses --------------------------------------------------------------

    def generator_loss(self, batch: Dict[str, torch.Tensor],
                       generator: Optional[torch.Generator] = None,
                       multiplier: float = 1.0, eps=None,
                       rand_code: Optional[torch.Tensor] = None,
                       sampling_mode: str = "default"):
        """Reference FullModel_encdec.forward (utils.py:67-155;
        system.py:351-441). The networks run in whatever mode they are in:
        ``train_step`` calls it in train mode, ``eval_step`` in eval mode.

        ``sampling_mode`` says where z comes from: 'default', reparameterized
        from the posterior of the batch; 'prior_sampling', N(0, I) draws
        shaped like the posterior's mus (the posterior still runs, for the
        KL term); 'momentum_sampling', reparameterized from the posterior
        of the previous window's clips ``batch['xt_last']``,
        ``batch['x3t_last']``.

        ``batch`` holds normalized NHWC clips 'xt', 'x2t', 'x3t'. ``eps``
        (shaped like the posterior's mus; in prior mode it is z itself) and
        ``rand_code`` (B, z_dim) are drawn from ``generator`` when they are
        None, eps first. Returns (total, metrics, (x1p, x2p, x3p)); metrics
        are 0-d tensors.
        """
        h = self.hyper
        if sampling_mode not in SAMPLING_MODES:
            raise ValueError(f"unknown sampling_mode: {sampling_mode}")
        xt, x2t, x3t = batch["xt"], batch["x2t"], batch["x3t"]
        x2recon_lambda = h.x2recon_lambda
        if h.family == "toy":  # the anneal scales x2-recon (utils.py:193)
            x2recon_lambda = h.x2recon_lambda * multiplier
            kl_lambda = h.x3recon_lambda
        else:  # and the KL in VAE_ANNEAL (utils.py:74)
            kl_lambda = (h.x3recon_lambda * multiplier
                         if h.baseline_mode == "VAE_ANNEAL"
                         else h.x3recon_lambda)

        if not h.deterministic:
            if sampling_mode == "momentum_sampling":
                mus, logvars = self.momentum_posterior(batch["xt_last"],
                                                       batch["x3t_last"])
            else:
                mus, logvars = self.posterior(xt, x2t, x3t)
            if eps is None:
                eps = normal_like(mus, generator)
            z = (eps if sampling_mode == "prior_sampling"
                 else reparameterize(mus, logvars, eps))
        else:
            mus = logvars = z = None

        x1p, x2p, x3p = self.encdec_forward(xt, x2t, z, rand_code, generator)

        zero = torch.zeros((), dtype=torch.float32, device=xt.device)
        gan_seq = gan_frame = z_kl = zero
        if not h.is_baseline:
            x1_recon = losses.l1_loss(x1p, _nchw(xt))
            x2_recon = losses.l1_loss(x2p, _nchw(x2t))
            x3_recon = losses.l1_loss(x3p, _nchw(x3t))
        else:
            x1_recon = x3_recon = zero
            # the baseline predicts the future (system.py:410)
            x2_recon = losses.l1_loss(x2p, _nchw(x3t))
        if not h.deterministic:
            z_kl = losses.kl_loss(mus, logvars)
        if h.runs_d_step:
            gan_seq = 0.5 * losses.lsgan_loss(self.modules["d_seq"](x2p),
                                              real=True)
            if "d_frame" in self.modules:
                gan_frame = self._frame_gan(x2p, True)
            else:  # toy: one discriminator, no 0.5 (utils.py:232)
                gan_seq = 2.0 * gan_seq

        total = (h.x1recon_lambda * x1_recon + x2recon_lambda * x2_recon
                 + h.x3recon_lambda * x3_recon + kl_lambda * z_kl
                 + h.gan_lambda * (gan_seq + gan_frame))
        metrics = {
            "loss_encdec": total,
            "loss_xt_recon": x1_recon,
            "loss_x2t_recon": x2_recon,
            "loss_x3t_recon": x3_recon,
            "loss_z_KL": z_kl,
            "loss_x2t_gan_sequence": gan_seq,
            "loss_x2t_gan_frame": gan_frame,
        }
        return total, {k: v.detach() for k, v in metrics.items()}, \
            (x1p, x2p, x3p)

    def discriminator_loss(self, x2t_real: torch.Tensor, x2p: torch.Tensor):
        """Reference FullModel_D.forward (utils.py:259-276), on the NHWC real
        clip and the NCHW prediction, both detached. The reference builds
        FullModel_D with its default gan_lambda 1.0 (tools/train.py:211), so
        the D loss is not scaled by TRAIN.GAN_LAMBDA. Returns (total,
        metrics)."""
        real = _nchw(x2t_real.detach())
        fake = x2p.detach()
        d_seq = self.modules["d_seq"]
        loss_seq = (0.5 * losses.lsgan_loss(d_seq(real), real=True)
                    + 0.5 * losses.lsgan_loss(d_seq(fake), real=False))
        if "d_frame" in self.modules:
            loss_frame = (self._frame_gan(real, True)
                          + self._frame_gan(fake, False))
            total = loss_seq + loss_frame
        else:  # toy: the D loss alone, reported twice (utils.py:299)
            loss_frame = total = loss_seq
        metrics = {"loss_D": total, "loss_D_sequence": loss_seq,
                   "loss_D_frame": loss_frame}
        return total, {k: v.detach() for k, v in metrics.items()}

    # -- the adversarial step ------------------------------------------------

    def train_step(self, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   multiplier: float = 1.0, eps=None,
                   rand_code: Optional[torch.Tensor] = None
                   ) -> Tuple[Dict[str, torch.Tensor], Tuple[torch.Tensor, ...]]:
        """One G update then one D update (reference function.py:482-516).
        ``batch`` clips may be uint8 (normalized here, on their device) or
        already normalized. Returns (metrics, detached predictions)."""
        h = self.hyper
        if self.optimizer_g is None or self.optimizer_d is None:
            raise RuntimeError("train_step needs a system built with "
                               "optimizers (build_system(..., train=True))")
        batch = {k: normalize_clips(v) if v.dtype == torch.uint8 else v
                 for k, v in batch.items()}

        d_params = list(self.d_parameters())
        for p in d_params:
            p.requires_grad_(False)
        try:
            total, metrics, preds = self.generator_loss(
                batch, generator, multiplier, eps=eps, rand_code=rand_code)
            self.optimizer_g.zero_grad(set_to_none=True)
            total.backward()
        finally:
            for p in d_params:
                p.requires_grad_(True)
        _step(self.optimizer_g)
        preds = tuple(p.detach() for p in preds)

        if h.runs_d_step:
            x2_real = batch["x3t"] if h.is_baseline else batch["x2t"]
            d_total, d_metrics = self.discriminator_loss(x2_real, preds[1])
            self.optimizer_d.zero_grad(set_to_none=True)
            d_total.backward()
            _step(self.optimizer_d)
        else:
            zero = torch.zeros((), dtype=torch.float32, device=total.device)
            d_metrics = {k: zero for k in D_METRICS}
        return {**metrics, **d_metrics}, preds

    def eval_step(self, batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None,
                  sampling_mode: str = "prior_sampling", eps=None,
                  rand_code: Optional[torch.Tensor] = None
                  ) -> Tuple[Tuple[torch.Tensor, ...], Dict[str, torch.Tensor]]:
        """One stochastic rollout in eval mode (system.py:615-630; reference
        function.py:45-53): every network in ``eval()`` on its running BN
        statistics, no gradient; each network's train/eval flag is restored
        after. ``batch`` clips may be uint8 (normalized here) or already
        normalized. Returns (predictions, metrics)."""
        batch = {k: normalize_clips(v) if v.dtype == torch.uint8 else v
                 for k, v in batch.items()}
        was_training = {k: m.training for k, m in self.modules.items()}
        self.modules.eval()
        try:
            with torch.inference_mode():
                _, metrics, preds = self.generator_loss(
                    batch, generator, eps=eps, rand_code=rand_code,
                    sampling_mode=sampling_mode)
        finally:
            for k, m in self.modules.items():
                m.train(was_training[k])
        return preds, metrics


def _step(optimizer: torch.optim.Optimizer) -> None:
    """optimizer.step() where a parameter without a gradient counts as a
    zero gradient, as optax sees it (its weight decay and momentum still
    apply: the baseline decoders, system.py:332-335). Across ranks the
    gradients are first averaged over the ranks, in one flat f32 bucket
    (one all-reduce per optimizer, what DDP's reducer would do; the step
    freezes D during the G update, runs D twice per backward and recomputes
    under checkpoint, each of which trips DDP's bookkeeping)."""
    grads = []
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
    sync.average_(grads)
    optimizer.step()
