"""Toy 1-D sequence-VAE models (counterpart of ``vae2_tpu/models/toy.py``;
reference lib/models/toy_fc.py): the synthetic sigmoid-family task that
drives the whole VAE² objective (posterior, reparameterized z, encoder and
dual decoders with a random-code injection, an LSGAN discriminator) with
no images and no BatchNorm, so no kernel of the port runs.

Inputs are (B, 10) function-value vectors; hidden width 128; z dim 8
(toy_fc.py:16-18). The encoder takes [x, z, r], r a fresh random code per
forward (toy_fc.py:53-56, 108-117), drawn from the caller's
``torch.Generator`` unless it is given as ``rand_code``; each decoder
takes [x2_pred, z]. Submodules carry the flax names (``mlp``, ``enc``,
``decf``, ``decp``; ``h1``, ``h2``, ``out``), so that
``utils/jax_params.from_jax_params`` maps a JAX tree onto them; weights
are normal(0.001) and biases zero, as flax initialises them.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel import sync

HID_DIM = 128
Z_DIM = 8
INPUT_DIM = 10


def _dense(in_dim: int, out_dim: int) -> nn.Linear:
    layer = nn.Linear(in_dim, out_dim)
    nn.init.normal_(layer.weight, std=0.001)
    nn.init.zeros_(layer.bias)
    return layer


class _MLP(nn.Module):
    """Two ReLU hidden layers and a linear output (toy_fc.py:32-42)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.h1 = _dense(in_dim, HID_DIM)
        self.h2 = _dense(HID_DIM, HID_DIM)
        self.out = _dense(HID_DIM, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.h1(x))
        return self.out(torch.relu(self.h2(x)))


class ToyPosterior(nn.Module):
    """q(z | clips) -> (B, 2 * Z_DIM) [mu ; logvar] from the concatenated
    conditioning and future vectors (toy_fc_EDz, toy_fc.py:64-72)."""

    z_dim, hd_z = Z_DIM, False

    def __init__(self, is_baseline: bool = False):
        super().__init__()
        self.mlp = _MLP(INPUT_DIM * (3 if is_baseline else 2), 2 * Z_DIM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x)


class ToyEncDec(nn.Module):
    """Encoder and dual decoders (toy_fc_ED, toy_fc.py:75-144): the encoder
    predicts the middle vector from the past one (and z and r); both
    decoders rebuild past and future from that prediction, so both
    reconstructions' gradients flow through x2_pred. The baseline encoder
    sees [xt, x2t] (and z unless DETERMINISTIC), no random code, and its
    past decoder rebuilds both."""

    z_dim, hd_z = Z_DIM, False

    def __init__(self, is_baseline: bool = False,
                 baseline_mode: str = "VAE_NATIVE"):
        super().__init__()
        self.is_baseline = is_baseline
        self.deterministic = baseline_mode == "DETERMINISTIC"
        z = 0 if self.deterministic else Z_DIM
        enc_in = 2 * INPUT_DIM + z if is_baseline else INPUT_DIM + 2 * Z_DIM
        self.enc = _MLP(enc_in, INPUT_DIM)
        self.decf = _MLP(INPUT_DIM + z, INPUT_DIM)
        self.decp = _MLP(INPUT_DIM + z, INPUT_DIM * (2 if is_baseline else 1))

    def encode(self, x, z, rand_code=None, generator=None):
        if self.is_baseline:
            inp = x if self.deterministic else torch.cat([x, z], dim=-1)
        else:
            if rand_code is None:
                rand_code = sync.randn_rows((x.shape[0], Z_DIM), generator,
                                            dtype=x.dtype, device=x.device)
            inp = torch.cat([x, z, rand_code], dim=-1)
        return self.enc(inp)

    def _decode(self, net: nn.Module, x2p, z):
        return net(x2p if self.deterministic else torch.cat([x2p, z], dim=-1))

    def forward(self, x, z=None, rand_code=None, generator=None):
        x2p = self.encode(x, z, rand_code, generator)
        return (self._decode(self.decp, x2p, z), x2p,
                self._decode(self.decf, x2p, z))


class ToyDiscriminator(nn.Module):
    """LSGAN scalar discriminator over a predicted vector
    (toy_fc.py:147-155)."""

    def __init__(self):
        super().__init__()
        self.mlp = _MLP(INPUT_DIM, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x)


# -- factories (reference lib/models/toy_fc.py:158-176) ----------------------


def get_encdec_model(config) -> ToyEncDec:
    extra = config.MODEL.EXTRA
    return ToyEncDec(is_baseline=extra.IS_BASELINE,
                     baseline_mode=extra.BASELINE_MODE)


def get_encz_model(config) -> ToyPosterior:
    return ToyPosterior(is_baseline=config.MODEL.EXTRA.IS_BASELINE)


def get_D_model(config) -> ToyDiscriminator:
    del config
    return ToyDiscriminator()
