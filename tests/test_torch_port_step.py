"""One adversarial train step of vae2_tpu_torch against the JAX package, piece
by piece, at the tiny debug spec in float32 (batch 2 at 16x32).

The JAX side never runs ``system.init`` or ``make_train_step`` (their CPU
compiles take minutes): its parameters are shaped by ``jax.eval_shape`` and
filled with numpy, and its G loss and D loss are each one jitted
``value_and_grad`` on the 'xla' BN backend (the same math as the Pallas
path; tests/test_torch_port_train.py holds the kernels to Pallas). Both
sides get the same weights (``from_jax_params``), the same clips and the
same noise: eps through a monkeypatch of the JAX ``reparameterize``, the
encoder's random code through ``nn.intercept_methods``. optax's update
(``make_optimizer``: SGD, lr 1e-2, momentum 0.9, wd 5e-4) is applied to the
JAX grads, the D loss to the JAX G step's prediction and statistics, and
the port runs its own ``train_step`` once.

Tolerances: losses rtol 1e-4; predictions and running statistics 1e-4 *
(1 + max|jax|). Gradients of the whole step: per network, |port - jax|_2 <=
3e-2 * |jax|_2 (measured 2e-4 to 1.2e-2). This random tiny network's
gradient is that sensitive to rounding: on the port alone, noise of 1e-7
relative (about one f32 ulp) on the input clips moves the encdec gradient
by 0.66% (L2). On the same input the discriminators' gradients agree
to 5e-3 (L2); single elements of ReLU-BN biases differ by up to 0.7% of
their tensor's largest element. The optimizer: the port's updated
parameters equal optax's update of the port's own gradients to 1e-6 of
the tensor's scale, and optax's update of the JAX gradients within lr
times the gradient bound.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn
from flax import traverse_util

from vae2_tpu.config import get_default_config as jax_default_config
from vae2_tpu.core import system as jax_system
from vae2_tpu.core.builder import build_system as jax_build_system
from vae2_tpu.models import hrnet as jh
from vae2_tpu_torch.config import get_default_config
from vae2_tpu_torch.core.builder import build_system
from vae2_tpu_torch.utils.jax_params import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "experiments", "cityscapes",
                        "debug_tiny_32x64.yaml")
B, H, W, Z_DIM = 2, 16, 32, 4
NETS_G, NETS_D = ("encdec", "encz"), ("d_seq", "d_frame")


def _configure(cfg):
    cfg.merge_from_file(TINY_CFG)
    cfg.TPU.DTYPE = "float32"
    cfg.TPU.REMAT = "none"
    cfg.TRAIN.OPTIMIZER = "sgd"
    cfg.TRAIN.LR = 0.01
    return cfg


def _fill(shapes, stats_shapes, seed):
    """numpy-filled params and batch_stats: kernels normal(1/sqrt(fan_in)),
    conv/dense biases normal(0.1), BN scale U(0.5, 1.5), bias N(0, 0.2),
    mean N(0, 0.2), var U(0.5, 1.5)."""
    rng = np.random.RandomState(seed)
    out = []
    for tree in (shapes, stats_shapes):
        flat = traverse_util.flatten_dict(tree)
        filled = {}
        for path, sd in flat.items():
            siblings = {p[-1] for p in flat if p[:-1] == path[:-1]}
            name = path[-1]
            if name == "kernel":
                v = rng.randn(*sd.shape) / np.sqrt(np.prod(sd.shape[:-1]))
            elif name in ("scale", "var"):
                v = rng.uniform(0.5, 1.5, sd.shape)
            elif name == "bias" and "scale" not in siblings:
                v = rng.randn(*sd.shape) * 0.1
            else:
                v = rng.randn(*sd.shape) * 0.2
            filled[path] = jnp.asarray(v, jnp.float32)
        out.append(traverse_util.unflatten_dict(filled))
    return out


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def step():
    rng = np.random.RandomState(0)
    batch = {k: rng.randn(B, H, W, 9).astype(np.float32)
             for k in ("xt", "x2t", "x3t")}
    eps = [rng.randn(B, H // 2**b, W // 2**b, Z_DIM).astype(np.float32)
           for b in range(4)]
    rand = rng.randn(B, Z_DIM).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    # ---- the JAX package ----
    cfg = _configure(jax_default_config())
    system = jax_build_system(cfg)
    shapes = jax.eval_shape(
        lambda: system.init(jax.random.PRNGKey(0), jbatch))
    params, stats0 = _fill(shapes.params, shapes.batch_stats, seed=1)
    g0 = system._g_params(params)
    d0 = system._d_params(params)

    def reparameterize(mus, logvars, key):
        del key
        return [m + jnp.exp(0.5 * v) * jnp.asarray(e)
                for m, v, e in zip(mus, logvars, eps)]

    def inject_rand(next_fun, args, kwargs, context):
        # the encoder's [random-code maps, z maps] get this random code
        if (isinstance(context.module, jh.ZInject)
                and context.method_name == "__call__" and len(args[1]) == 2):
            xs, maps = args[0], args[1]
            args = (xs, [jh.gen_code_maps(jnp.asarray(rand), xs), maps[1]]) \
                + tuple(args[2:])
        return next_fun(*args, **kwargs)

    @jax.jit
    def g_loss(g, d, stats, b):
        with nn.intercept_methods(inject_rand):
            return jax.value_and_grad(system.generator_loss, has_aux=True)(
                g, d, stats, b, jax.random.PRNGKey(7), jnp.float32(1.0))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_system, "reparameterize", reparameterize)
        (_, (g_metrics, preds, stats1)), g_grads = g_loss(g0, d0, stats0,
                                                          jbatch)
    tx = jax_system.make_optimizer(cfg.TRAIN)
    upd, _ = tx.update(g_grads, tx.init(g0), g0)
    g1 = optax.apply_updates(g0, upd)

    d_loss = jax.jit(jax.value_and_grad(system.discriminator_loss,
                                        has_aux=True))
    (_, (d_metrics, stats2)), d_grads = d_loss(d0, g1, stats1,
                                               jbatch["x2t"], preds[1])
    upd, _ = tx.update(d_grads, tx.init(d0), d0)
    d1 = optax.apply_updates(d0, upd)
    stats2 = _np_tree(stats2)
    jax_out = {
        "metrics": {**_np_tree(g_metrics), **_np_tree(d_metrics)},
        "preds": [np.asarray(p) for p in preds],
        "grads": from_jax_params(_np_tree({**g_grads, **d_grads}), stats2),
        "params": from_jax_params(_np_tree({**g1, **d1}), stats2),
        "init": from_jax_params(_np_tree(params), _np_tree(stats0)),
        "x2t": batch["x2t"], "tx": tx,
    }

    # ---- the port ----
    port = _port(jax_out["init"])
    cl = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    metrics, port_preds = port.train_step(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        eps=[cl(e) for e in eps], rand_code=torch.from_numpy(rand))
    return jax_out, port, metrics, port_preds


def _port(state_dict):
    cfg = _configure(get_default_config())
    cfg.GPU.DTYPE = "float32"
    port = build_system(cfg, train=True)
    port.modules.load_state_dict(state_dict, strict=True)
    return port


def _close(got, want, rel=1e-4, scale=None, err_msg=""):
    want = np.asarray(want)
    scale = 1.0 + np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel,
                               atol=rel * scale, err_msg=err_msg)


def _named(port, net, what):
    return [(f"{net}.{n}", t) for n, t in
            getattr(port.modules[net], f"named_{what}")()]


def _l2_rel(pairs) -> float:
    d2 = sum(float(((a - b) ** 2).sum()) for a, b in pairs)
    w2 = sum(float((b**2).sum()) for _, b in pairs)
    return (d2 / w2) ** 0.5


def test_generator_and_discriminator_losses_match_jax(step):
    jax_out, _, metrics, _ = step
    assert set(metrics) == set(jax_out["metrics"]) and len(metrics) == 10
    for k, want in jax_out["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), float(want), rtol=1e-4,
                                   err_msg=k)


def test_predictions_match_jax(step):
    jax_out, _, _, preds = step
    for got, want in zip(preds, jax_out["preds"]):
        assert got.shape == (B, 9, H, W)
        _close(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("net", NETS_G + NETS_D)
def test_gradients_match_jax(step, net):
    """The G step's grads of encdec/encz and the D step's of d_seq/d_frame
    (the port's .grad after its train_step), L2 over the network."""
    jax_out, port, _, _ = step
    pairs = [(p.grad.numpy(), jax_out["grads"][k].numpy())
             for k, p in _named(port, net, "parameters")]
    assert len(pairs) > 100
    assert _l2_rel(pairs) <= 3e-2, _l2_rel(pairs)


@pytest.mark.parametrize("net", NETS_D)
def test_discriminator_gradients_on_the_same_prediction(step, net):
    """The port's D loss on the JAX G step's prediction, from the initial
    weights: the same inputs on both sides, L2 over the network 5e-3."""
    jax_out, _, _, _ = step
    port = _port(jax_out["init"])
    pred = torch.from_numpy(jax_out["preds"][1]).permute(0, 3, 1, 2)
    total, _ = port.discriminator_loss(torch.from_numpy(jax_out["x2t"]), pred)
    total.backward()
    pairs = [(p.grad.numpy(), jax_out["grads"][k].numpy())
             for k, p in _named(port, net, "parameters")]
    assert _l2_rel(pairs) <= 5e-3, _l2_rel(pairs)


@pytest.mark.parametrize("net", NETS_G + NETS_D)
def test_sgd_step_matches_optax(step, net):
    """The port's parameter update against optax's ``make_optimizer`` update
    of the port's own gradients (1e-6 relative: the same arithmetic, rounded in
    another order) and of the JAX gradients (lr times the gradient bound, L2
    over the network)."""
    jax_out, port, _, _ = step
    tx = jax_out["tx"]
    named = _named(port, net, "parameters")
    p0 = {k: jax_out["init"][k].numpy() for k, _ in named}
    grads = {k: p.grad.numpy() for k, p in named}
    upd, _ = tx.update(grads, tx.init(p0), p0)
    want = optax.apply_updates(p0, upd)
    for k, p in named:
        _close(p.detach().numpy(), want[k], rel=1e-6,
               scale=np.abs(np.asarray(want[k])).max(), err_msg=k)
    pairs = [(p.detach().numpy() - p0[k], jax_out["params"][k].numpy() - p0[k])
             for k, p in named]
    assert _l2_rel(pairs) <= 3e-2, _l2_rel(pairs)


@pytest.mark.parametrize("net", NETS_G + NETS_D)
def test_running_stats_match_jax(step, net):
    """BN running statistics after the G step (every network, the
    discriminators in train mode too) and the D step (real, then fake)."""
    jax_out, port, _, _ = step
    named = _named(port, net, "buffers")
    assert named
    for k, buf in named:
        _close(buf.numpy(), jax_out["params"][k].numpy(), err_msg=k)
