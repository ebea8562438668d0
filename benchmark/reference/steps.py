"""Plain training steps and prior sampling over :mod:`nets`.

- :func:`vae2_step`: the VAE² adversarial step. The G loss is L1 on the
  three clips (x2 weighted by X2RECON_LAMBDA), the KL of the per-branch
  posterior maps and the LSGAN terms of the sequence and frame
  discriminators (0.5 each, the frame term over the clip's frames folded
  into the batch); Adam on the encoder-decoders and the posterior. Then
  the D loss on the real and the (pre-update) predicted clip, Adam on the
  discriminators. Every loss is a sum over elements divided by the batch.
- :func:`seg_step`: HRNetV2's class-weighted cross entropy on logits
  resized bilinearly to the labels, pixels labelled IGNORE_LABEL left out;
  SGD with momentum and L2 weight decay.
- :func:`prior_samples`: the paper's prior sampling, z ~ N(0, I) per
  branch map and a random code, drawn in that order, per call of
  ``chunk`` samples.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from . import nets, scores


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def l1(p, t):
    return (p - t).abs().sum() / p.shape[0]


def lsgan(s, real: bool):
    return ((s - (1.0 if real else 0.0)) ** 2).sum() / s.shape[0]


def kl(mus, logvars):
    return sum((0.5 * (m * m + torch.exp(v) - v - 1.0)).sum() / m.shape[0]
               for m, v in zip(mus, logvars))


def fold_frames(x):
    b, fc, h, w = x.shape
    return x.reshape(b, fc // 3, 3, h, w).transpose(0, 1).reshape(-1, 3, h, w)


def frame_gan(d_frame, x, real: bool):
    return 0.5 * (x.shape[1] // 3) * lsgan(d_frame(fold_frames(x)), real)


class Adam:
    """Adam, no weight decay: mu, nu in float32, bias-corrected."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = list(params), lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, m, v in zip(self.params, self.mu, self.nu):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (m / bc1) / ((v / bc2).sqrt() + self.eps))
            p.grad = None

    def first_grads(self) -> List[torch.Tensor]:
        """The gradient of the first step, from the first moment."""
        return [m / (1 - self.b1) for m in self.mu]


class SGD:
    """SGD with momentum (no dampening, not Nesterov) and L2 weight decay."""

    def __init__(self, params, lr, momentum, wd):
        self.params, self.lr, self.momentum, self.wd = list(params), lr, momentum, wd
        self.buf = [None] * len(self.params)

    @torch.no_grad()
    def step(self):
        for i, p in enumerate(self.params):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            d = g + self.wd * p
            self.buf[i] = d.clone() if self.buf[i] is None else self.buf[i].mul_(self.momentum).add_(d)
            p.sub_(self.lr * self.buf[i])
            p.grad = None


def g_params(mods):
    return [p for k in ("encdec", "encz") for p in mods[k].parameters()]


def d_params(mods):
    return [p for k in ("d_seq", "d_frame") for p in mods[k].parameters()]


def vae2_step(mods, opt_g: Adam, opt_d: Adam, batch: Dict[str, torch.Tensor],
              eps: Sequence[torch.Tensor], code: torch.Tensor,
              lambdas: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """One G update then one D update on uint8 NHWC clips 'xt', 'x2t',
    'x3t'; returns the two losses, detached."""
    xt, x2t, x3t = (scores.normalize(batch[k]) for k in ("xt", "x2t", "x3t"))
    dps = d_params(mods)
    for p in dps:
        p.requires_grad_(False)
    muvars = mods["encz"](_nchw(torch.cat([xt, x3t], dim=-1)))
    z_dim = muvars[0].shape[1] // 2
    mus = [m[:, :z_dim] for m in muvars]
    logvars = [m[:, z_dim:] for m in muvars]
    z = [m + torch.exp(0.5 * v) * e for m, v, e in zip(mus, logvars, eps)]
    x1p, x2p, x3p = mods["encdec"](_nchw(xt), z, code)
    gan_seq = 0.5 * lsgan(mods["d_seq"](x2p), True)
    gan_frame = frame_gan(mods["d_frame"], x2p, True)
    total = (lambdas["x1"] * l1(x1p, _nchw(xt)) + lambdas["x2"] * l1(x2p, _nchw(x2t))
             + lambdas["x3"] * l1(x3p, _nchw(x3t)) + lambdas["x3"] * kl(mus, logvars)
             + lambdas["gan"] * (gan_seq + gan_frame))
    total.backward()
    for p in dps:
        p.requires_grad_(True)
    opt_g.step()
    real, fake = _nchw(x2t), x2p.detach()
    d_total = (0.5 * lsgan(mods["d_seq"](real), True)
               + 0.5 * lsgan(mods["d_seq"](fake), False)
               + frame_gan(mods["d_frame"], real, True)
               + frame_gan(mods["d_frame"], fake, False))
    d_total.backward()
    opt_d.step()
    return {"loss_encdec": total.detach(), "loss_D": d_total.detach()}


def seg_loss(logits, labels, weights, ignore: int):
    h, w = labels.shape[1:]
    logp = torch.log_softmax(nets.resize(logits, h, w), dim=1)
    valid = labels != ignore
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    pw = torch.where(valid, weights[safe], torch.zeros_like(logp[:, 0]))
    nll = -logp.gather(1, safe[:, None])[:, 0]
    return (nll * pw).sum() / pw.sum().clamp(min=1e-8)


def seg_step(net, opt: SGD, images, labels, weights, ignore: int
             ) -> Dict[str, torch.Tensor]:
    loss = seg_loss(net(images), labels, weights, ignore)
    loss.backward()
    opt.step()
    return {"loss": loss.detach()}


def prior_draws(generator, chunk: int, z_dim: int, h: int, w: int, device):
    """One sampling call's noise, in the order the sampler draws it: the
    four branch maps, then the code."""
    z = [torch.randn((chunk, z_dim, h >> b, w >> b), generator=generator, device=device)
         for b in range(4)]
    code = torch.randn((chunk, z_dim), generator=generator, device=device)
    return z, code


@torch.no_grad()
def prior_samples(encdec, xt_u8, z, code):
    """(x1p, x2p, x3p) of one clip for the samples of (z, code)."""
    x = _nchw(scores.normalize(xt_u8))
    return encdec.sample(x, z, code)
