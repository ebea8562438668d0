"""vae2_tpu_torch's training pieces against the JAX package, in float32, on
the same numpy inputs and weights: the plain versions of the ABN backward
kernels (2 and 3) against ``_abn_bwd_rows`` in interpret mode, the
``fused_abn`` autograd op against ``jax.vjp`` of the JAX ``fused_abn`` and
against autograd of the plain BN formula, ``BatchNormAct`` in train mode,
the posterior and the discriminators in train mode, the losses and the
small helpers; then, on the port alone, one train step under each
``TPU.REMAT`` policy and the train CLI with resume.

Tolerances (stated per test): modules and kernels |port - jax| <= 1e-4 *
(1 + max|jax|) — both sides compute in f32 with their own summation orders
and convolution algorithms, nothing else differs. The same bound holds
where gamma is near 0 (|gamma| ~ 1e-3), where the InPlace-ABN backward
rebuilds y_norm = (y - beta) / gamma from the output and so amplifies a
rounding of y by 1/|gamma|.
"""

import glob
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from test_torch_port_model import SPECS, T_SPECS, fill_variables
from vae2_tpu.core import losses as jax_losses
from vae2_tpu.core import system as jax_system
from vae2_tpu.models.vae2 import VAE2Discriminator as JaxDisc
from vae2_tpu.models.vae2 import VAE2Posterior as JaxPosterior
from vae2_tpu.ops.norm import BatchNormAct as JaxBN
from vae2_tpu.ops.pallas.abn import _abn_bwd_rows
from vae2_tpu.ops.pallas.abn import _fused_abn_fwd as jax_fused_abn_fwd
from vae2_tpu.ops.pallas.abn import fused_abn as jax_fused_abn
from vae2_tpu.utils.logging import AverageMeter as JaxMeter
from vae2_tpu.utils.schedule import dynamic_coeff as jax_dynamic_coeff
from vae2_tpu_torch.config import get_default_config
from vae2_tpu_torch.core import losses
from vae2_tpu_torch.core import system as port_system
from vae2_tpu_torch.core.builder import build_system
from vae2_tpu_torch.data.loader import ClipLoader, DevicePrefetcher
from vae2_tpu_torch.data.video import make_dataset
from vae2_tpu_torch.models.vae2 import VAE2Discriminator, VAE2Posterior
from vae2_tpu_torch.ops import abn
from vae2_tpu_torch.ops.norm import BatchNormAct
from vae2_tpu_torch.tools import train as train_cli
from vae2_tpu_torch.utils.jax_params import from_jax_params
from vae2_tpu_torch.utils.logging import AverageMeter
from vae2_tpu_torch.utils.schedule import dynamic_coeff

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "experiments", "cityscapes",
                        "debug_tiny_32x64.yaml")
DATA = os.path.join(REPO, "data", "synthetic64")
ACTS = ["none", "leaky_relu", "elu"]
Z_DIM = 4


def _cl(a):
    """NHWC numpy -> NCHW channels_last torch (the same bytes)."""
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def assert_close(got, want, rel=1e-4, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel,
                               atol=rel * (1.0 + np.abs(want).max()),
                               err_msg=err_msg)


def _act_np(z, act):
    if act == "leaky_relu":
        return np.where(z >= 0, z, z * 0.01)
    if act == "elu":
        return np.where(z >= 0, z, np.expm1(np.minimum(z, 0)))
    return z


def _gammas(rng, c, near_zero):
    g = rng.uniform(0.5, 1.5, c) * np.where(rng.rand(c) < 0.5, -1, 1)
    return (g * (1e-3 if near_zero else 1.0)).astype(np.float32)


# ---- kernels 2 and 3 ---------------------------------------------------------


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("c", [4, 18, 36])
def test_bwd_kernels_plain_match_pallas(c, act):
    """Plain kernels 2-3 against the Pallas ``_sums_kernel``/``_dx_kernel``
    (interpret mode) on the same y, dz, gamma, beta, inv_std. 1e-4 bound."""
    rng = np.random.RandomState(c)
    gamma = _gammas(rng, c, False)
    beta = rng.randn(c).astype(np.float32) * 0.3
    z = rng.randn(2, 6, 10, c).astype(np.float32) * 1.5
    y = _act_np(z, act).astype(np.float32)
    dz = rng.randn(2, 6, 10, c).astype(np.float32)
    inv_std = rng.uniform(0.5, 2.0, c).astype(np.float32)
    dx_j, edz_j, eydz_j = _abn_bwd_rows(
        jnp.asarray(y.reshape(-1, c)), jnp.asarray(dz.reshape(-1, c)),
        jnp.asarray(gamma), jnp.asarray(beta), jnp.asarray(inv_std), 0.01,
        act)
    yt, dzt = _cl(y), _cl(dz)
    g, b = torch.from_numpy(gamma), torch.from_numpy(beta)
    before = (abn.abn_bwd_sums.launches, abn.abn_bwd_dx.launches)
    sums = abn.abn_bwd_sums(yt, dzt, g, b, 0.01, act)
    dx = abn.abn_bwd_dx(yt, dzt, g, b, g * torch.from_numpy(inv_std), sums,
                        0.01, act, 2 * 6 * 10)
    assert (abn.abn_bwd_sums.launches, abn.abn_bwd_dx.launches) == before
    assert dx.is_contiguous(memory_format=torch.channels_last)
    assert_close(sums[0].numpy(), edz_j)
    assert_close(sums[1].numpy(), eydz_j)
    assert_close(_nhwc(dx).reshape(-1, c), dx_j)


@pytest.mark.parametrize("near_zero", [False, True], ids=["gamma", "gamma~0"])
@pytest.mark.parametrize("act", ACTS)
def test_fused_abn_matches_jax_vjp(act, near_zero):
    """Forward and (dx, dgamma, dbeta) of the autograd op against jax.vjp of
    the JAX ``fused_abn`` (Pallas kernels in interpret mode)."""
    rng = np.random.RandomState(11)
    c = 18
    x = (rng.randn(2, 6, 10, c) * 2 + 0.5).astype(np.float32)
    gamma = _gammas(rng, c, near_zero)
    beta = (rng.randn(c) * 0.3).astype(np.float32)
    dz = rng.randn(2, 6, 10, c).astype(np.float32)
    y_j, vjp = jax.vjp(
        lambda a, g, b: jax_fused_abn(a, g, b, 1e-5, 0.01, act),
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    dx_j, dg_j, db_j = vjp(jnp.asarray(dz))

    xt = _cl(x).requires_grad_(True)
    g = torch.from_numpy(gamma).requires_grad_(True)
    b = torch.from_numpy(beta).requires_grad_(True)
    y = abn.fused_abn(xt, g, b, 1e-5, 0.01, act)
    y.backward(_cl(dz))
    assert_close(_nhwc(y), y_j)
    assert_close(_nhwc(xt.grad), dx_j)
    assert_close(g.grad.numpy(), dg_j)
    assert_close(b.grad.numpy(), db_j)


@pytest.mark.parametrize("c", [4, 18, 36])
def test_fused_abn_saves_y_and_gamma_inv_like_jax(c):
    """The forward saves (y, gamma, beta, gamma * inv_std) — the JAX
    residuals (abn.py:253), with the product that the backward hands the dx
    kernel (abn.py:208) formed once in the forward; no x. Then the VJP
    against jax.vjp, 1e-4 bound as above."""
    rng = np.random.RandomState(20 + c)
    x = (rng.randn(2, 4, 6, c) * 2 - 0.5).astype(np.float32)
    gamma = _gammas(rng, c, False)
    beta = (rng.randn(c) * 0.3).astype(np.float32)
    dz = rng.randn(2, 4, 6, c).astype(np.float32)
    y_j, res = jax_fused_abn_fwd(jnp.asarray(x), jnp.asarray(gamma),
                                 jnp.asarray(beta), 1e-5, 0.01, "leaky_relu")
    dx_j, dg_j, db_j = jax.vjp(
        lambda a, g, b: jax_fused_abn(a, g, b, 1e-5, 0.01, "leaky_relu"),
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))[1](
            jnp.asarray(dz))

    xt = _cl(x).requires_grad_(True)
    g = torch.from_numpy(gamma).requires_grad_(True)
    b = torch.from_numpy(beta).requires_grad_(True)
    y = abn.fused_abn(xt, g, b, 1e-5, 0.01, "leaky_relu")
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 4
    torch.testing.assert_close(saved[0], y.detach(), rtol=0, atol=0)
    assert saved[1] is g and saved[2] is b
    np.testing.assert_allclose(saved[3].numpy(), np.asarray(res[1] * res[3]),
                               rtol=1e-5, atol=0)
    y.backward(_cl(dz))
    assert_close(_nhwc(y), y_j)
    assert_close(_nhwc(xt.grad), dx_j)
    assert_close(g.grad.numpy(), dg_j)
    assert_close(b.grad.numpy(), db_j)


@pytest.mark.parametrize("near_zero", [False, True], ids=["gamma", "gamma~0"])
@pytest.mark.parametrize("act", ACTS)
def test_fused_abn_matches_autograd_of_plain_bn(act, near_zero):
    """The InPlace-ABN backward (from y) against autograd of the plain BN
    formula (from x): the same gradient, rounded elsewhere."""
    rng = np.random.RandomState(12)
    c = 36
    x = torch.from_numpy((rng.randn(2, 5, 7, c) * 2).astype(np.float32))
    x = x.permute(0, 3, 1, 2)
    gamma = torch.from_numpy(_gammas(rng, c, near_zero))
    beta = torch.from_numpy((rng.randn(c) * 0.3).astype(np.float32))
    dz = torch.from_numpy(rng.randn(2, 5, 7, c).astype(np.float32))
    dz = dz.permute(0, 3, 1, 2)

    def run(fn):
        xx = x.clone().requires_grad_(True)
        g = gamma.clone().requires_grad_(True)
        b = beta.clone().requires_grad_(True)
        fn(xx, g, b).backward(dz)
        return xx.grad, g.grad, b.grad

    def plain(xx, g, b):
        mean, var = abn.batch_stats(xx)
        inv = torch.rsqrt(var + 1e-5)
        z = xx * (inv * g).view(1, -1, 1, 1) + (b - mean * inv * g).view(
            1, -1, 1, 1)
        if act == "leaky_relu":
            return F.leaky_relu(z, 0.01)
        return F.elu(z) if act == "elu" else z

    got = run(lambda xx, g, b: abn.fused_abn(xx, g, b, 1e-5, 0.01, act))
    want = run(plain)
    for gt, wt in zip(got, want):
        assert_close(gt.numpy(), wt.numpy())


def test_fused_abn_gradient_layouts():
    """An incoming gradient in another layout (NCHW-contiguous here; a
    channel slice of a concat on the main path) is made channels_last-dense
    with one copy, counted, and gives the same dx."""
    rng = np.random.RandomState(13)
    x_np = rng.randn(2, 4, 6, 8)
    dz = torch.from_numpy(rng.randn(2, 8, 4, 6).astype(np.float32))
    grads = []
    for layout in (torch.channels_last, torch.contiguous_format):
        x = _cl(x_np).requires_grad_(True)
        g = torch.ones(8, requires_grad=True)
        b = torch.zeros(8, requires_grad=True)
        before = abn.FusedABN.dz_copies
        abn.fused_abn(x, g, b, act="leaky_relu").backward(
            dz.contiguous(memory_format=layout))
        copies = abn.FusedABN.dz_copies - before
        assert copies == (0 if layout == torch.channels_last else 1)
        grads.append(x.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


# ---- BatchNormAct train mode -------------------------------------------------


@pytest.mark.parametrize("act,ndim", [(None, 4), ("relu", 4),
                                      ("leaky_relu", 4), ("elu", 4),
                                      ("relu", 2)])
def test_batchnorm_act_train_matches_jax(act, ndim):
    """Outputs, running statistics (momentum 0.01, Bessel-corrected var) and
    the gradients of x, scale and bias, against the JAX module with
    ``mutable=['batch_stats']`` (Pallas backend: act None/leaky/elu take the
    custom VJP). 1e-4 bound."""
    rng = np.random.RandomState(14)
    c = 18
    shape = (4, 6, 10, c) if ndim == 4 else (6, c)
    x = (rng.randn(*shape) * 2 + 0.3).astype(np.float32)
    w = rng.randn(*shape).astype(np.float32)
    variables = {
        "params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                   "bias": (rng.randn(c) * 0.2).astype(np.float32)},
        "batch_stats": {"mean": (rng.randn(c) * 0.2).astype(np.float32),
                        "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}}
    jbn = JaxBN(act=act, dtype=jnp.float32, backend="pallas")

    def loss(params, xx):
        y, upd = jbn.apply({"params": params,
                            "batch_stats": variables["batch_stats"]},
                           xx, True, mutable=["batch_stats"])
        return jnp.sum(y * w), (y, upd["batch_stats"])

    (_, (y_j, stats_j)), (gp_j, gx_j) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(x))

    bn = BatchNormAct(c, act=act).train()
    bn.load_state_dict(from_jax_params(variables["params"],
                                       variables["batch_stats"]))
    to = _cl if ndim == 4 else torch.from_numpy
    back = _nhwc if ndim == 4 else (lambda t: t.detach().numpy())
    xt = to(x).requires_grad_(True)
    y = bn(xt)
    (y * to(w)).sum().backward()
    assert_close(back(y), y_j)
    assert_close(bn.running_mean.numpy(), stats_j["mean"])
    assert_close(bn.running_var.numpy(), stats_j["var"])
    assert_close(back(xt.grad), gx_j)
    assert_close(bn.weight.grad.numpy(), gp_j["scale"])
    assert_close(bn.bias.grad.numpy(), gp_j["bias"])


# ---- posterior and discriminators ------------------------------------------


def _train_apply(jmod, v, x):
    out, upd = jmod.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    return out, upd["batch_stats"]


def _check_stats(module, stats_j, prefix=""):
    """Every running statistic of ``module`` against the JAX tree."""
    sd = module.state_dict()

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{path}{k}.")
            else:
                name = {"mean": "running_mean", "var": "running_var"}[k]
                assert_close(sd[path + name].numpy(), np.asarray(v),
                             err_msg=path + name)

    walk(stats_j, prefix)


@pytest.mark.parametrize("hd_z", [True, False], ids=["hd_z", "mlp"])
def test_posterior_train_matches_jax(hd_z):
    """VAE2Posterior in train mode on [xt, x3t] (18 channels): per-branch
    mu/logvar maps (hd_z) or the pooled MLP's vector, and every running
    statistic after the forward. 1e-4 bound."""
    rng = np.random.RandomState(15)
    # per-clip scales, so that the pooled features differ between clips:
    # the MLP's batch-of-2 BN divides by their spread
    x = (rng.randn(2, 16, 32, 18) * np.array([0.5, 2.0])[:, None, None, None]
         + np.array([-1.0, 1.0])[:, None, None, None]).astype(np.float32)
    jmod = JaxPosterior(specs=SPECS, hd_z=hd_z, z_dim=Z_DIM,
                        dtype=jnp.float32)
    v = fill_variables(jmod, jnp.asarray(x), True, seed=16)
    want, stats_j = _train_apply(jmod, v, x)
    tmod = VAE2Posterior(T_SPECS, 18, hd_z=hd_z, z_dim=Z_DIM,
                         dtype=torch.float32)
    tmod.load_state_dict(from_jax_params(v["params"], v["batch_stats"]),
                         strict=True)
    got = tmod.train()(_cl(x))
    if hd_z:
        assert len(got) == 4
        for g_, w_ in zip(got, want):
            assert g_.dtype == torch.float32
            assert_close(_nhwc(g_), w_)
    else:
        assert got.shape == (2, 2 * Z_DIM)
        assert_close(got.detach().numpy(), want)
    _check_stats(tmod, stats_j)


@pytest.mark.parametrize("frames", [3, 1], ids=["sequence", "frame"])
def test_discriminator_train_matches_jax(frames):
    """The sequence (9 channels) and frame (3) discriminators in train mode:
    the score map and every running statistic. 1e-4 bound."""
    rng = np.random.RandomState(17 + frames)
    x = rng.randn(2, 16, 32, 3 * frames).astype(np.float32)
    jmod = JaxDisc(specs=SPECS, dtype=jnp.float32)
    v = fill_variables(jmod, jnp.asarray(x), True, seed=18)
    want, stats_j = _train_apply(jmod, v, x)
    tmod = VAE2Discriminator(T_SPECS, 3 * frames, dtype=torch.float32)
    tmod.load_state_dict(from_jax_params(v["params"], v["batch_stats"]),
                         strict=True)
    got = tmod.train()(_cl(x))
    assert got.shape == (2, 1, 16, 32) and got.dtype == torch.float32
    assert_close(_nhwc(got), want)
    _check_stats(tmod, stats_j)


# ---- losses and helpers ------------------------------------------------------


def test_losses_match_jax():
    """l1 / kl (array and hd_z list) / lsgan real and fake: rtol 1e-5 (f32
    sums of a few thousand terms)."""
    rng = np.random.RandomState(19)
    p, t = rng.randn(2, 8, 16, 9), rng.randn(2, 8, 16, 9)
    mus = [rng.randn(2, 8 // 2**b, 16 // 2**b, 4) for b in range(3)]
    lvs = [rng.randn(*m.shape) * 0.3 for m in mus]
    d = rng.randn(6, 8, 16, 1)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    cases = [
        (losses.l1_loss(_cl(p), _cl(t)),
         jax_losses.l1_loss(f32(p), f32(t))),
        (losses.kl_loss([_cl(m) for m in mus], [_cl(v) for v in lvs]),
         jax_losses.kl_loss([f32(m) for m in mus], [f32(v) for v in lvs])),
        (losses.kl_loss(_cl(mus[0]), _cl(lvs[0])),
         jax_losses.kl_loss(f32(mus[0]), f32(lvs[0]))),
        (losses.lsgan_loss(_cl(d), True), jax_losses.lsgan_loss(f32(d), True)),
        (losses.lsgan_loss(_cl(d), False),
         jax_losses.lsgan_loss(f32(d), False)),
    ]
    for got, want in cases:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_fold_frames_and_reparameterize_match_jax():
    """fold_frames (frame-major) exactly; reparameterize with the same eps
    to 1e-6 (one exp and one multiply-add)."""
    rng = np.random.RandomState(20)
    x = rng.randn(2, 4, 6, 9).astype(np.float32)
    got = port_system.fold_frames(_cl(x), 3)
    assert got.shape == (6, 3, 4, 6)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_nhwc(got),
                                  np.asarray(jax_system.fold_frames(x, 3)))

    mus = [rng.randn(2, 4, 6, 4).astype(np.float32) for _ in range(2)]
    lvs = [rng.randn(2, 4, 6, 4).astype(np.float32) for _ in range(2)]
    eps = [rng.randn(2, 4, 6, 4).astype(np.float32) for _ in range(2)]
    want = [m + np.exp(0.5 * v) * e for m, v, e in zip(mus, lvs, eps)]
    got = port_system.reparameterize([_cl(m) for m in mus],
                                     [_cl(v) for v in lvs],
                                     [_cl(e) for e in eps])
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(_nhwc(g_), w_, rtol=1e-6, atol=1e-6)
    vec = port_system.reparameterize(torch.from_numpy(mus[0][:, 0, 0]),
                                     torch.from_numpy(lvs[0][:, 0, 0]),
                                     torch.from_numpy(eps[0][:, 0, 0]))
    np.testing.assert_allclose(vec.numpy(), want[0][:, 0, 0], rtol=1e-6,
                               atol=1e-6)


def test_schedule_and_meter_match_jax():
    for i in range(0, 11, 5):
        assert dynamic_coeff(10, i) == jax_dynamic_coeff(10, i)
    a, b = AverageMeter(), JaxMeter()
    for v, w in ((1.0, 1.0), (3.0, 2.0)):
        a.update(v, w)
        b.update(v, w)
    assert (a.value(), a.average()) == (b.value(), b.average())


def _opt_cfg(name, **over):
    cfg = get_default_config()
    cfg.TRAIN.OPTIMIZER = name
    for k, v in over.items():
        cfg.TRAIN[k] = v
    return cfg.TRAIN


@pytest.mark.parametrize("name,nesterov", [("sgd", False), ("sgd", True),
                                           ("adam", False)])
def test_make_optimizer_matches_optax(name, nesterov):
    """Three updates of the port's optimizer against the JAX package's
    ``make_optimizer`` on the same params and grads: rtol 1e-6, atol 1e-6
    (1e-4 of one update at lr 0.01: Adam's bias corrections and epsilon
    are applied in another order)."""
    rng = np.random.RandomState(21)
    p0 = rng.randn(5, 3).astype(np.float32)
    grads = [rng.randn(5, 3).astype(np.float32) for _ in range(3)]
    cfg = _opt_cfg(name, LR=0.01, NESTEROV=nesterov)
    tx = jax_system.make_optimizer(cfg)
    params = {"w": jnp.asarray(p0)}
    state = tx.init(params)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = port_system.make_optimizer([p], cfg)
    for g in grads:
        upd, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, upd)
        p.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(params["w"]), rtol=1e-6,
                                   atol=1e-6)


def test_make_optimizer_refuses_unported_knobs():
    """Poly decay and bf16 moments are ported (tests/test_torch_port_ddp.py
    holds them against optax); what the JAX package refuses, the port
    refuses: poly without max_iters, an unknown schedule or moment dtype."""
    p = [torch.nn.Parameter(torch.zeros(1))]
    with pytest.raises(ValueError, match="max_iters"):
        port_system.make_optimizer(p, _opt_cfg("sgd", LR_SCHEDULE="poly"))
    with pytest.raises(ValueError, match="LR_SCHEDULE"):
        port_system.make_optimizer(p, _opt_cfg("sgd", LR_SCHEDULE="step"))
    with pytest.raises(ValueError, match="ADAM_MOMENT_DTYPE"):
        port_system.make_optimizer(p, _opt_cfg("adam"), moment_dtype="fp16")


def test_device_prefetcher_yields_the_loader_batches():
    cfg = _tiny_config(**{"DATASET.ROOT": DATA})
    ds = make_dataset(cfg, os.path.join(DATA, "train_list.txt"),
                      random_pos=False, num_samples=4)
    loader = ClipLoader(ds, batch_size=2, shuffle=True, num_threads=1, seed=3)
    loader.set_epoch(1)
    want = list(loader)
    pre = DevicePrefetcher(loader, torch.device("cpu"), depth=2)
    got = list(pre)
    assert len(pre) == len(loader) == len(got) == 2
    for (gb, gn), (wb, wn) in zip(got, want):
        assert gn == wn and set(gb) == {"xt", "x2t", "x3t"}
        for k in gb:
            assert gb[k].dtype == torch.uint8
            np.testing.assert_array_equal(gb[k].numpy(), wb[k])


# ---- the port's own train step and CLI ---------------------------------------


def _tiny_config(**over):
    cfg = get_default_config()
    cfg.merge_from_file(TINY_CFG)
    cfg.GPU.DTYPE = "float32"
    cfg.TRAIN.OPTIMIZER = "sgd"
    cfg.TRAIN.LR = 0.01
    for k, v in over.items():
        node, key = k.split(".")
        cfg[node][key] = v
    return cfg


def _step_under(remat):
    system = build_system(_tiny_config(**{"TPU.REMAT": remat}), seed=0,
                          train=True)
    rng = np.random.RandomState(22)
    batch = {k: torch.from_numpy(rng.randint(0, 256, (2, 16, 32, 9),
                                             dtype=np.uint8))
             for k in ("xt", "x2t", "x3t")}
    metrics, _ = system.train_step(batch, torch.Generator().manual_seed(5))
    return system, metrics


@pytest.fixture(scope="module")
def step_without_remat():
    return _step_under("none")


@pytest.mark.parametrize("remat", ["stage", "trunk"])
def test_train_step_under_remat_equals_no_remat(step_without_remat, remat):
    """Losses, updated parameters and running statistics after one step
    under TPU.REMAT 'stage' / 'trunk' equal those without remat (to 1e-6:
    the recompute repeats the same f32 ops), so the checkpointed BNs update
    their running statistics once, and the random code is drawn once."""
    ref, ref_metrics = step_without_remat
    system, metrics = _step_under(remat)
    assert set(metrics) == set(ref_metrics) and len(metrics) == 10
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(ref_metrics[k]),
                                   rtol=1e-6, err_msg=k)
    want, got = ref.modules.state_dict(), system.modules.state_dict()
    init = build_system(_tiny_config(), seed=0).modules.state_dict()
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        moved += not torch.equal(init[k], want[k])
    assert moved > 0.9 * len(want)  # parameters and running stats moved


def test_train_cli_on_cpu_then_resume(tmp_path):
    """One epoch of a 4-video list at the tiny spec (2 steps of batch 2),
    then TRAIN.RESUME for a second epoch."""
    lst = tmp_path / "train4.txt"
    lst.write_text("".join(os.path.join(DATA, line)
                           for line in open(os.path.join(DATA,
                                                         "train_list.txt"))
                           .readlines()[:4]))
    opts = ["--cfg", TINY_CFG, "--device", "cpu", "--seed", "1",
            "OUTPUT_DIR", str(tmp_path / "out"), "LOG_DIR",
            str(tmp_path / "log"), "DATASET.ROOT", "/",
            "DATASET.TRAIN_SET", str(lst), "TRAIN.BATCH_SIZE_PER_GPU", "2",
            "TRAIN.END_EPOCH", "1", "PRINT_FREQ", "1", "WORKERS", "1",
            "GPU.DTYPE", "float32", "TRAIN.IMAGE_SIZE", "[32, 16]"]
    out = train_cli.main(opts)
    ckpt = torch.load(os.path.join(out, "checkpoint.pt"), weights_only=True)
    assert ckpt["epoch"] == 1
    assert set(ckpt) == {"epoch", "state_dict", "optimizer_g", "optimizer_d"}
    assert ckpt["optimizer_g"]["state"]  # momentum buffers were written
    pngs = glob.glob(os.path.join(out, "vis", "epoch0", "*", "*.png"))
    assert len(pngs) == 6 * 3  # x1t/x2t/x3t and their predictions, 3 frames
    logs = glob.glob(os.path.join(out, "*_train.log"))
    lines = [ln for ln in open(logs[0]) if "Loss_D_ave" in ln]
    assert len(lines) == 2
    vals = [float(t.split(": ")[1]) for t in lines[-1].split(", ")[3:]]
    assert len(vals) == 10 and all(map(math.isfinite, vals))

    out2 = train_cli.main(opts[:-8] + ["TRAIN.END_EPOCH", "2",
                                       "TRAIN.RESUME", "True", *opts[-6:]])
    assert out2 == out
    text = "".join(open(p).read() for p in glob.glob(
        os.path.join(out, "*_train.log")))
    assert "=> loaded checkpoint (epoch 1)" in text
    assert torch.load(os.path.join(out, "checkpoint.pt"),
                      weights_only=True)["epoch"] == 2
    assert glob.glob(os.path.join(out, "vis", "epoch1", "*", "*.png"))


def test_train_cli_runs_on_cuda_unless_asked():
    """Without --device the CLI takes GPU.DEVICE 'cuda', and raises where
    there is no card rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would train on it")
    with pytest.raises(RuntimeError, match="cuda"):
        train_cli.main(["--cfg", TINY_CFG])
