"""The toy family of vae2_tpu_torch (models/toy.py, data/toy.py, its
builder and system branches, the toy CLIs) against the JAX package.

One G/D step per mode, non-baseline and the four baseline modes, on the
same weights (drawn with numpy at fan-in scale into the JAX tree, carried
by ``from_jax_params``), the same batch and the same noise: eps through a
monkeypatch of the JAX ``reparameterize``, the encoder's random code r
through one of ``ToyEncDec._random_code``; the sin-anneal multiplier 0.5
scales the x2-recon weight. SGD (lr 1e-2, momentum 0.9, wd 5e-4), whose update is
linear in the gradient, on both sides.

Tolerances (f32 on the CPU): losses rtol 1e-5 (atol 1e-7); gradients and
updates per network within 1e-4 of the JAX ones in L2. Not at the flax
init (weights normal(0.001)): there the posterior's logvar is ~1e-6, the
KL's gradient exp(v) - 1 keeps about one significant digit in f32 in
either framework, and a baseline step's encz gradient (norm ~5e-7) is
rounding, 3e-3 apart in L2.
"""

import glob
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from vae2_tpu.config import get_default_config as jax_default_config
from vae2_tpu.core import system as jax_system
from vae2_tpu.core.builder import build_system as jax_build_system
from vae2_tpu.data import toy as jax_toy_data
from vae2_tpu.models import toy as jax_toy
from vae2_tpu_torch.config import get_default_config
from vae2_tpu_torch.core.builder import build_system
from vae2_tpu_torch.data import toy as toy_data
from vae2_tpu_torch.tools import toy_example, toy_example_inference
from vae2_tpu_torch.utils.jax_params import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY_CFG = os.path.join(REPO, "experiments", "toyexample", "toyexample.yaml")
MODES = [(False, "VAE_NATIVE"), (True, "VAE_NATIVE"), (True, "VAE_ANNEAL"),
         (True, "VAE_GAN"), (True, "DETERMINISTIC")]
B = 64


def test_toy_batches_equal_jax():
    port = toy_data.ToyLoader(batch_size=100, shuffle_seed=3, num_batches=3)
    ref = jax_toy_data.ToyLoader(batch_size=100, shuffle_seed=3,
                                 num_batches=3)
    assert len(port) == len(ref) == 3
    for (pb, pn), (jb, jn) in zip(port, ref):
        assert pn == jn
        for k in ("xt", "x2t", "x3t"):
            assert pb[k].dtype == np.float32
            np.testing.assert_array_equal(pb[k], jb[k])
    assert len(toy_data.ToyLoader(batch_size=500)) == 20


def _cfg(get, is_baseline, mode):
    cfg = get()
    cfg.merge_from_file(TOY_CFG)
    cfg.MODEL.EXTRA.IS_BASELINE = is_baseline
    cfg.MODEL.EXTRA.BASELINE_MODE = mode
    cfg.TRAIN.OPTIMIZER = "sgd"
    cfg.TRAIN.LR = 0.01
    return cfg


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _fan_in(params, rng):
    """Dense kernels normal(1 / sqrt(fan_in)), biases normal(0.1)."""
    flat = traverse_util.flatten_dict(_np(params))
    return traverse_util.unflatten_dict({
        path: jnp.asarray((rng.randn(*v.shape) / np.sqrt(v.shape[0])
                           if path[-1] == "kernel" else rng.randn(*v.shape)
                           * 0.1).astype(np.float32))
        for path, v in flat.items()})


def _l2(pairs):
    d2 = sum(float(((a - b) ** 2).sum()) for a, b in pairs)
    w2 = sum(float((b ** 2).sum()) for _, b in pairs)
    return (d2 / max(w2, 1e-30)) ** 0.5


@pytest.mark.parametrize("is_baseline,mode", MODES,
                         ids=[("baseline_" if b else "") + m.lower()
                              for b, m in MODES])
def test_toy_step_matches_jax(monkeypatch, is_baseline, mode):
    rng = np.random.RandomState(5)
    batch, _ = next(iter(toy_data.ToyLoader(batch_size=B, shuffle_seed=1)))
    eps = rng.randn(B, 8).astype(np.float32)
    rand = rng.randn(B, 8).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    # ---- the JAX package ----
    cfg = _cfg(jax_default_config, is_baseline, mode)
    system = jax_build_system(cfg)
    state = system.init(jax.random.PRNGKey(0), jbatch)
    state = state.replace(params=_fan_in(state.params, rng))
    monkeypatch.setattr(jax_system, "reparameterize",
                        lambda mus, logvars, key: mus + jnp.exp(
                            0.5 * logvars) * jnp.asarray(eps))
    monkeypatch.setattr(jax_toy.ToyEncDec, "_random_code",
                        lambda self, b: jnp.asarray(rand))
    g0 = system._g_params(state.params)
    d0 = system._d_params(state.params)
    (_, (g_metrics, preds, stats)), g_grads = jax.value_and_grad(
        system.generator_loss, has_aux=True)(
        g0, d0, state.batch_stats, jbatch, jax.random.PRNGKey(1),
        jnp.float32(0.5))
    tx = jax_system.make_optimizer(cfg.TRAIN)
    upd, _ = tx.update(g_grads, tx.init(g0), g0)
    g1 = optax.apply_updates(g0, upd)
    metrics, grads, params = dict(_np(g_metrics)), dict(g_grads), dict(g1)
    if (not is_baseline) or mode == "VAE_GAN":
        real = jbatch["x3t"] if is_baseline else jbatch["x2t"]
        (_, (d_metrics, _)), d_grads = jax.value_and_grad(
            system.discriminator_loss, has_aux=True)(
            d0, g1, stats, real, preds[1])
        upd, _ = tx.update(d_grads, tx.init(d0), d0)
        metrics.update(_np(d_metrics))
        grads.update(d_grads)
        params.update(optax.apply_updates(d0, upd))
    else:
        params.update(d0)
        metrics.update({k: 0.0 for k in ("loss_D", "loss_D_sequence",
                                         "loss_D_frame")})

    # ---- the port ----
    port = build_system(_cfg(get_default_config, is_baseline, mode),
                        train=True)
    assert port.hyper.family == "toy" and "d_frame" not in port.modules
    assert ("encz" in port.modules) == (mode != "DETERMINISTIC")
    port.modules.load_state_dict(from_jax_params(_np(state.params)),
                                 strict=True)
    got, _ = port.train_step(
        {k: torch.from_numpy(v) for k, v in batch.items()}, multiplier=0.5,
        eps=None if mode == "DETERMINISTIC" else torch.from_numpy(eps),
        rand_code=torch.from_numpy(rand))

    assert set(got) == set(metrics) and len(got) == 10
    for k, want in metrics.items():
        np.testing.assert_allclose(float(got[k]), float(want), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    want_grads = from_jax_params(_np(grads))
    want_params = from_jax_params(_np(params))
    init = from_jax_params(_np(state.params))
    for net, module in port.modules.items():
        named = [(f"{net}.{n}", p) for n, p in module.named_parameters()]
        if net == "d_seq" and not port.hyper.runs_d_step:
            assert all(p.grad is None for _, p in named)
        else:
            assert _l2([(p.grad, want_grads[k]) for k, p in named]) <= 1e-4
        assert _l2([(p.detach() - init[k], want_params[k] - init[k])
                    for k, p in named]) <= 1e-4, net


def test_toy_clis_on_cpu(tmp_path, monkeypatch):
    """Two epochs of the toy train CLI, a resumed third, then the toy
    inference CLI with matplotlib absent (the card's machine has none: the
    txt dumps, no PDF) and present (the PDFs too)."""
    out = ["OUTPUT_DIR", str(tmp_path / "o"), "LOG_DIR", str(tmp_path / "l")]
    common = ["--cfg", TOY_CFG, "--device", "cpu"]
    run_dir = toy_example.main([*common, *out, "TRAIN.END_EPOCH", "2",
                                "TRAIN.BATCH_SIZE_PER_GPU", "1000",
                                "PRINT_FREQ", "5"])
    for e in (0, 1):
        npys = glob.glob(os.path.join(run_dir, "vis", f"epoch{e}", "*",
                                      "*.npy"))
        assert len(npys) == 6
    toy_example.main([*common, *out, "TRAIN.END_EPOCH", "3",
                      "TRAIN.BATCH_SIZE_PER_GPU", "1000", "TRAIN.RESUME",
                      "True"])
    log = "".join(open(p).read() for p in glob.glob(
        os.path.join(run_dir, "*_train.log")))
    assert "=> loaded checkpoint (epoch 2)" in log
    assert glob.glob(os.path.join(run_dir, "vis", "epoch2", "*", "*.npy"))

    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: (
        None if name == "matplotlib" else find_spec(name, *a)))
    args = [*common, "--num-samples", "3", "--batch-size", "50",
            "--num-batches", "2", *out]
    toy_example_inference.main(args)
    dirs = glob.glob(os.path.join(run_dir, "vis", "epoch3", "*"))
    assert len(dirs) == 2
    for d in dirs:
        assert not glob.glob(os.path.join(d, "*.pdf"))
        lines = open(os.path.join(d, "x2t_axis.txt")).read().splitlines()
        assert len(lines) == 3 and all(len(line.split()) == 10
                                       for line in lines)
        assert len(open(os.path.join(d, "gt_axis.txt")).readlines()) == 1
    monkeypatch.setattr(importlib.util, "find_spec", find_spec)
    if find_spec("matplotlib") is not None:
        toy_example_inference.main(args)
        for d in dirs:
            assert sorted(os.path.basename(p) for p in glob.glob(
                os.path.join(d, "*.pdf"))) == ["gt.pdf", "prd.pdf"]
