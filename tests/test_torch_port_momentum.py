"""vae2_tpu_torch's momentum sampling and eval step against the JAX package
on the CPU, at the tiny debug spec in float32: ``make_momentum_sampler``
(the JAX side on the Pallas kernel in interpret mode) under the JAX
package's own eps and random-code draws, ``generator_loss`` in its eval form
(``eval_step``) in all three sampling modes, the 5-clip eval layout and the
inference CLI's momentum mode.

Weights are numpy-filled flax trees (``test_torch_port_step._fill``) carried
by ``from_jax_params``. The JAX networks run jitted: one jit of the sampler
and one of the three losses, because eager dispatch of the same networks
measured slower on one CPU core (70 s for the sampler, against 15 s to
compile it).

Tolerances: predictions 1e-4 * (1 + max|jax|) elementwise; losses rtol
1e-4. Both sides compute in f32 with their own convolution algorithms and
summation orders; nothing else differs.
"""

import glob
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from test_torch_port_step import _fill, _np_tree
from vae2_tpu.config import get_default_config as jax_default_config
from vae2_tpu.core import system as jax_system
from vae2_tpu.core.builder import build_system as jax_build_system
from vae2_tpu.core.infer_loop import make_momentum_sampler as jax_momentum
from vae2_tpu.data import loader as jax_loader
from vae2_tpu.data.video import make_dataset as jax_make_dataset
from vae2_tpu.models import hrnet as jh
from vae2_tpu.ops.norm import set_default_bn_backend
from vae2_tpu_torch.config import get_default_config
from vae2_tpu_torch.core import infer_loop
from vae2_tpu_torch.core.builder import build_system
from vae2_tpu_torch.data.loader import ClipLoader
from vae2_tpu_torch.data.video import make_dataset
from vae2_tpu_torch.tools import inference
from vae2_tpu_torch.utils.checkpoint import save_checkpoint
from vae2_tpu_torch.utils.jax_params import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "experiments", "cityscapes",
                        "debug_tiny_32x64.yaml")
DATA = os.path.join(REPO, "data", "synthetic64")
H, W, Z_DIM, CHUNK = 32, 64, 4, 3
MODES = ("default", "prior_sampling", "momentum_sampling")
CLIPS = ("xt", "x2t", "x3t", "xt_last", "x3t_last")


def _configure(cfg):
    cfg.merge_from_file(TINY_CFG)
    cfg.TPU.DTYPE = "float32"
    cfg.TPU.REMAT = "none"
    return cfg


def _port_config():
    cfg = _configure(get_default_config())
    cfg.GPU.DTYPE = "float32"
    return cfg


def assert_close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-4 * (1.0 + np.abs(want).max()),
                               err_msg=err_msg)


def _nchw(a):
    return torch.from_numpy(np.asarray(a)).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def systems():
    """The JAX system with numpy-filled weights, and the port's system on
    the same weights."""
    system = jax_build_system(_configure(jax_default_config()))
    batch = {k: jnp.zeros((1, H, W, 9), jnp.float32)
             for k in ("xt", "x2t", "x3t")}
    shapes = jax.eval_shape(lambda: system.init(jax.random.PRNGKey(0), batch))
    params, stats = _fill(shapes.params, shapes.batch_stats, seed=3)
    port = build_system(_port_config())
    port.modules.load_state_dict(
        from_jax_params(_np_tree(params), _np_tree(stats)), strict=True)
    port.modules.eval()
    return system, params, stats, port


@pytest.fixture
def pallas_backend():
    """The JAX side's eval BNs reach the Pallas kernel (interpret mode on
    the CPU); the backend is module-global, so restore it."""
    set_default_bn_backend("pallas")
    yield
    set_default_bn_backend("xla")


def test_momentum_sampler_matches_jax_pallas(systems, pallas_backend):
    """The JAX ``make_momentum_sampler`` (key 7) and the port's, given the
    JAX draws: eps reproduced from the key as the JAX sampler splits it
    (one key per latent, in the posterior's dtype), the encoder's random
    code read out of the JAX run by a host callback."""
    system, params, stats, port = systems
    rng = np.random.RandomState(8)
    clips = [rng.randint(0, 256, (1, H, W, 9)).astype(np.uint8)
             for _ in range(4)]
    state = jax_system.VAE2State(step=0, params=params, batch_stats=stats,
                                 opt_state_g=None, opt_state_d=None)
    codes = []

    def read_code(next_fun, args, kwargs, context):
        # the encoder's ZInject gets [random-code maps, z maps]
        if (isinstance(context.module, jh.ZInject)
                and context.method_name == "__call__" and len(args[1]) == 2):
            jax.debug.callback(lambda c: codes.append(np.asarray(c)),
                               args[1][0][0][:, 0, 0, :])
        return next_fun(*args, **kwargs)

    key = jax.random.PRNGKey(7)
    with nn.intercept_methods(read_code):
        want = jax_momentum(system, CHUNK)(
            state, *(jnp.asarray(c) for c in clips), key)
        want = [np.asarray(w) for w in want]
    assert len(codes) == 1 and codes[0].shape == (CHUNK, Z_DIM)

    rng_eps, _ = jax.random.split(key)
    eps = [np.asarray(jax.random.normal(k, (CHUNK, H >> b, W >> b, Z_DIM),
                                        jnp.float32))
           for b, k in enumerate(jax.random.split(rng_eps, 4))]
    sampler = infer_loop.make_momentum_sampler(port, CHUNK)
    got = sampler(*(torch.from_numpy(c) for c in clips), None,
                  eps=[_nchw(e) for e in eps],
                  rand_code=torch.from_numpy(codes[0]))
    for g, w_ in zip(got, want):
        assert g.shape == (CHUNK, 9, H, W)
        assert_close(g.permute(0, 2, 3, 1).numpy(), w_)
    # the same call drawing its own noise: eps per latent in list order,
    # then the random code, from one generator; z differs per sample
    drawn = sampler(*(torch.from_numpy(c) for c in clips),
                    torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(0)
    eps = [torch.randn(CHUNK, Z_DIM, H >> b, W >> b, generator=gen)
           for b in range(4)]
    given = sampler(*(torch.from_numpy(c) for c in clips), gen, eps=eps)
    assert all(torch.equal(a, b) for a, b in zip(drawn, given))
    assert not torch.allclose(drawn[1][0], drawn[1][1])


@pytest.fixture(scope="module")
def eval_losses(systems):
    """The JAX ``generator_loss`` in eval form (train=False) in each
    sampling mode, one jit for the three, with eps injected through
    ``reparameterize`` / ``prior_sample_like`` and the random code through
    ``nn.intercept_methods``; then the port's ``eval_step`` on the same."""
    system, params, stats, port = systems
    rng = np.random.RandomState(9)
    b, h, w = 2, H // 2, W // 2
    batch = {k: rng.randn(b, h, w, 9).astype(np.float32) for k in CLIPS}
    eps = [rng.randn(b, h >> i, w >> i, Z_DIM).astype(np.float32)
           for i in range(4)]
    rand = rng.randn(b, Z_DIM).astype(np.float32)

    def reparameterize(mus, logvars, key):
        del key
        return [m + jnp.exp(0.5 * v) * jnp.asarray(e)
                for m, v, e in zip(mus, logvars, eps)]

    def prior_sample_like(mus, key):
        del mus, key
        return [jnp.asarray(e) for e in eps]

    def inject_rand(next_fun, args, kwargs, context):
        if (isinstance(context.module, jh.ZInject)
                and context.method_name == "__call__" and len(args[1]) == 2):
            xs, maps = args[0], args[1]
            args = (xs, [jh.gen_code_maps(jnp.asarray(rand), xs), maps[1]]) \
                + tuple(args[2:])
        return next_fun(*args, **kwargs)

    @jax.jit
    def losses(p, s, bt):
        g, d = system._g_params(p), system._d_params(p)
        with nn.intercept_methods(inject_rand):
            return {mode: system.generator_loss(
                g, d, s, bt, jax.random.PRNGKey(0), jnp.float32(1.0),
                sampling_mode=mode, train=False)[1][:2] for mode in MODES}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_system, "reparameterize", reparameterize)
        mp.setattr(jax_system, "prior_sample_like", prior_sample_like)
        want = _np_tree(losses(params, stats, {k: jnp.asarray(v)
                                               for k, v in batch.items()}))
    port.modules.train()  # eval_step puts every network in eval mode
    got = {mode: port.eval_step({k: torch.from_numpy(v)
                                 for k, v in batch.items()},
                                sampling_mode=mode,
                                eps=[_nchw(e) for e in eps],
                                rand_code=torch.from_numpy(rand))
           for mode in MODES}
    assert all(m.training for m in port.modules.values())  # restored
    port.modules.eval()
    return want, got


@pytest.mark.parametrize("mode", MODES)
def test_eval_step_losses_match_jax(eval_losses, mode):
    (metrics_j, preds_j), (preds, metrics) = (eval_losses[0][mode],
                                              eval_losses[1][mode])
    assert set(metrics) == set(metrics_j) and len(metrics) == 7
    for k, want in metrics_j.items():
        np.testing.assert_allclose(float(metrics[k]), float(want), rtol=1e-4,
                                   err_msg=k)
    for g, w_ in zip(preds, preds_j):
        assert_close(g.permute(0, 2, 3, 1).numpy(), w_, err_msg=mode)


def test_sampling_modes_differ_as_they_should(eval_losses):
    """The three modes agree on nothing z touches (same eps, different
    posteriors or none), while the reconstruction targets stay the same."""
    _, got = eval_losses
    x2 = {m: got[m][0][1] for m in MODES}
    assert not torch.allclose(x2["default"], x2["momentum_sampling"])
    assert not torch.allclose(x2["default"], x2["prior_sampling"])
    kl = {m: float(got[m][1]["loss_z_KL"]) for m in MODES}
    assert kl["default"] == kl["prior_sampling"] != kl["momentum_sampling"]
    with pytest.raises(ValueError, match="sampling_mode"):
        build_system(_port_config()).generator_loss(
            {}, sampling_mode="posterior")


def test_five_clip_loader_and_remap_match_jax():
    """clip_num 5 on data/synthetic64: 15 of the 30 frames of each video
    (eval position 30 - 15 - 1 = 14), byte-equal to the JAX loader; then the
    momentum-eval remap (function.py:109-115)."""
    test_list = os.path.join(DATA, "test_list.txt")

    def cfg(get):
        c = get()
        c.DATASET.ROOT = DATA
        c.TRAIN.IMAGE_SIZE = [256, 128]
        return c

    kw = dict(random_pos=False, num_samples=2, clip_num=5)
    ds = make_dataset(cfg(get_default_config), test_list, **kw)
    assert ds.sample_position(30) == 14 and ds[0][0].shape == (128, 256, 45)
    port = ClipLoader(ds, batch_size=2, shuffle=False, drop_last=False,
                      num_threads=1)
    ref = jax_loader.ClipLoader(
        jax_make_dataset(cfg(jax_default_config), test_list, **kw),
        batch_size=2, shuffle=False, drop_last=False, num_threads=1)
    (pb, pn), (rb, rn) = next(iter(port)), next(iter(ref))
    assert pn == rn and sorted(pb) == sorted(rb) == sorted(
        ["xt", "x2t", "x3t", "x4t", "x5t"])
    for k in pb:
        np.testing.assert_array_equal(pb[k], rb[k])
    window = infer_loop.eval_window(pb)
    assert sorted(window) == sorted(CLIPS)
    for new, old in (("xt_last", "xt"), ("x3t_last", "x3t"), ("xt", "x3t"),
                     ("x2t", "x4t"), ("x3t", "x5t")):
        assert window[new] is pb[old]
    three = {k: pb[k] for k in ("xt", "x2t", "x3t")}
    assert infer_loop.eval_window(three) is three


def test_momentum_refusals(tmp_path):
    cfg = _port_config()
    cfg.MODEL.EXTRA.IS_BASELINE = True
    cfg.MODEL.EXTRA.BASELINE_MODE = "DETERMINISTIC"
    with pytest.raises(ValueError, match="stochastic"):
        infer_loop.make_momentum_sampler(build_system(cfg), 2)
    cfg = _port_config()
    cfg.TRAIN.IMAGE_SIZE = [64, 32]
    cfg.DATASET.ROOT = DATA
    loader = ClipLoader(
        make_dataset(cfg, os.path.join(DATA, "test_list.txt"),
                     random_pos=False, num_samples=1),
        batch_size=1, shuffle=False, drop_last=False, num_threads=1)
    with pytest.raises(ValueError, match="--clip-num 5"):
        infer_loop.run_inference(cfg, build_system(cfg), loader,
                                 str(tmp_path), 0, torch.Generator(),
                                 num_samples=1,
                                 sampling_mode="momentum_sampling")


def test_momentum_inference_cli_on_cpu(tmp_path):
    """``--clip-num 5 --sampling-mode momentum_sampling`` writes the metric
    tree of the prior mode: per video x1t/x2t/x3t frames, and x2tpredict /
    x3tpredict with 3 frames x 4 metric txts of one line per sample and one
    PNG per sample and frame."""
    system = build_system(_port_config(), seed=0)
    ckpt = str(tmp_path / "init.pt")
    save_checkpoint(ckpt, system.modules.state_dict(), epoch=0)
    out_dir = inference.main([
        "--cfg", TINY_CFG, "--checkpoint", ckpt, "--num-samples", "3",
        "--clip-num", "5", "--sampling-mode", "momentum_sampling",
        "--device", "cpu", "--seed", "1",
        "OUTPUT_DIR", str(tmp_path / "out"), "LOG_DIR", str(tmp_path / "log"),
        "DATASET.ROOT", DATA,
        "DATASET.TEST_SET", os.path.join(DATA, "test_list.txt"),
        "TEST.NUM_SAMPLES", "2", "TEST.BATCH_SIZE_PER_GPU", "1",
        "TPU.INFER_SAMPLE_BATCH", "2", "WORKERS", "1", "GPU.DTYPE", "float32",
        "TRAIN.IMAGE_SIZE", "[64, 32]"])
    root = os.path.join(out_dir, "vis", "epoch0")
    assert len(os.listdir(root)) == 2
    for video in os.listdir(root):
        frames = glob.glob(os.path.join(root, video, "x?t_*.png"))
        assert len(frames) == 9
    for tag in ("x2t", "x3t"):
        txts = glob.glob(os.path.join(root, "*", f"{tag}predict", "*.txt"))
        assert len(txts) == 2 * 3 * 4
        for t in txts:
            vals = [float(v) for v in open(t)]
            assert len(vals) == 3 and all(map(math.isfinite, vals)), t
        pngs = glob.glob(os.path.join(root, "*", f"{tag}predict", "*.png"))
        assert len(pngs) == 2 * 3 * 3
