"""vae2_tpu_torch's HRNet blocks and VAE2EncDec.sample against the JAX
package, in eval mode, on the same weights and inputs.

Weights are drawn with numpy into a flax parameter tree (shaped by
``jax.eval_shape`` of the flax ``init``, so no init graph runs) and carried
to the port by ``from_jax_params``. BN statistics and affine parameters are
non-trivial, so a BN that maps wrongly shows. Everything runs in float32.

Tolerance: |port - jax| <= 1e-4 * (1 + max|jax|) elementwise. Both sides
compute in f32 with their own convolution algorithms and summation orders;
nothing else differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax import traverse_util

from vae2_tpu.models import hrnet as jh
from vae2_tpu.core.system import split_muvar as jax_split_muvar
from vae2_tpu.models.vae2 import VAE2EncDec as JaxEncDec
from vae2_tpu.ops.norm import set_default_bn_backend
from vae2_tpu_torch.core.system import split_muvar
from vae2_tpu_torch.models import hrnet as th
from vae2_tpu_torch.models.vae2 import VAE2EncDec as TorchEncDec
from vae2_tpu_torch.utils.jax_params import from_jax_params

SPECS = (
    jh.StageSpec(1, 1, (1,), (8,), "BOTTLENECK"),
    jh.StageSpec(1, 2, (1, 1), (4, 8), "BASIC"),
    jh.StageSpec(1, 3, (1, 1, 1), (4, 8, 16), "BASIC"),
    jh.StageSpec(1, 4, (1, 1, 1, 1), (4, 8, 16, 32), "BASIC"),
)
T_SPECS = tuple(th.StageSpec(s.num_modules, s.num_branches, s.num_blocks,
                             s.num_channels, s.block) for s in SPECS)
Z_DIM = 4
H, W = 32, 64
RTOL = 1e-4


def fill_variables(module, *init_args, seed=0, method=None):
    """numpy-filled {'params', 'batch_stats'} for a flax module: kernels
    normal(1/sqrt(fan_in)) so that signal propagates, conv biases
    normal(0.1), BN scale U(0.5, 1.5), bias N(0, 0.2), mean N(0, 0.2),
    var U(0.5, 1.5)."""
    rngs = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(
        lambda: module.init(rngs, *init_args, method=method))
    rng = np.random.RandomState(seed)
    out = {}
    for col in ("params", "batch_stats"):
        flat = traverse_util.flatten_dict(shapes.get(col, {}))
        filled = {}
        for path, sd in flat.items():
            siblings = {p[-1] for p in flat if p[:-1] == path[:-1]}
            name = path[-1]
            if name == "kernel":
                fan_in = int(np.prod(sd.shape[:-1]))
                v = rng.randn(*sd.shape) / np.sqrt(fan_in)
            elif name == "scale" or name == "var":
                v = rng.uniform(0.5, 1.5, sd.shape)
            elif name == "bias" and "scale" not in siblings:
                v = rng.randn(*sd.shape) * 0.1
            else:  # BN bias, BN mean
                v = rng.randn(*sd.shape) * 0.2
            filled[path] = np.asarray(v, np.float32)
        out[col] = traverse_util.unflatten_dict(filled)
    return out


def to_torch(module, variables):
    module.load_state_dict(
        from_jax_params(variables["params"], variables.get("batch_stats")),
        strict=True)
    return module.eval()


def nchw(a):
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def assert_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=RTOL, atol=RTOL * (1.0 + np.abs(want).max()))


def _apply(jmod, variables, *args, **kw):
    return jmod.apply(variables, *args, **kw)


def _randn(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("block", ["basic", "basic_proj", "bottleneck",
                                   "bottleneck_proj"])
def test_residual_blocks(block):
    rng = np.random.RandomState(1)
    c_in = 8 if block.endswith("proj") else (4 if block == "basic" else 16)
    proj = block.endswith("proj")
    if block.startswith("basic"):
        jmod = jh.BasicBlock(features=4, use_projection=proj, dtype=jnp.float32)
        tmod = th.BasicBlock(c_in, 4, use_projection=proj)
    else:
        jmod = jh.Bottleneck(features=4, use_projection=proj, dtype=jnp.float32)
        tmod = th.Bottleneck(c_in, 4, use_projection=proj)
    x = _randn(rng, 2, 8, 16, c_in)
    v = fill_variables(jmod, jnp.asarray(x), False)
    want = _apply(jmod, v, jnp.asarray(x), False)
    got = to_torch(tmod, v)(nchw(x).contiguous(memory_format=torch.channels_last))
    assert_close(nhwc(got), want)


def _branches(rng, widths, h=16, w=32, batch=2):
    return [_randn(rng, batch, h // 2**b, w // 2**b, c)
            for b, c in enumerate(widths)]


def _cl(xs):
    return [nchw(x).contiguous(memory_format=torch.channels_last) for x in xs]


def test_fuse_layer():
    rng = np.random.RandomState(2)
    widths = (4, 8, 16, 32)
    xs = _branches(rng, widths)
    jmod = jh.FuseLayer(in_channels=widths, dtype=jnp.float32)
    v = fill_variables(jmod, [jnp.asarray(x) for x in xs], False)
    want = _apply(jmod, v, [jnp.asarray(x) for x in xs], False)
    got = to_torch(th.FuseLayer(widths), v)(_cl(xs))
    for g, w_ in zip(got, want):
        assert_close(nhwc(g), w_)


def test_transition():
    rng = np.random.RandomState(3)
    xs = _branches(rng, (32,), batch=2)  # stage-1 output -> two branches
    jmod = jh.Transition(in_channels=(32,), out_channels=(4, 8, 16),
                         dtype=jnp.float32)
    v = fill_variables(jmod, [jnp.asarray(x) for x in xs], False)
    want = _apply(jmod, v, [jnp.asarray(x) for x in xs], False)
    got = to_torch(th.Transition((32,), (4, 8, 16)), v)(_cl(xs))
    assert len(got) == 3
    for g, w_ in zip(got, want):
        assert_close(nhwc(g), w_)


def test_zinject():
    rng = np.random.RandomState(4)
    widths = (4, 8)
    xs = _branches(rng, widths)
    code = _randn(rng, 2, Z_DIM)
    zmaps = _branches(rng, (Z_DIM, Z_DIM))
    jxs = [jnp.asarray(x) for x in xs]
    jcode = [jh.gen_code_maps(jnp.asarray(code), jxs),
             [jnp.asarray(z) for z in zmaps]]
    jmod = jh.ZInject(out_channels=widths, dtype=jnp.float32)
    v = fill_variables(jmod, jxs, jcode, False)
    want = _apply(jmod, v, jxs, jcode, False)
    txs = _cl(xs)
    tcode = [th.gen_code_maps(torch.from_numpy(code), txs), _cl(zmaps)]
    got = to_torch(th.ZInject(widths, 2 * Z_DIM), v)(txs, tcode)
    for g, w_ in zip(got, want):
        assert_close(nhwc(g), w_)


@pytest.fixture(scope="module")
def trunk_case():
    rng = np.random.RandomState(5)
    x = _randn(rng, 2, H, W, 9)
    z = _branches(rng, (Z_DIM,) * 4, h=H, w=W)
    jmod = jh.HRNetTrunk(specs=SPECS, z_mode="z", z_dim=Z_DIM,
                         dtype=jnp.float32)
    jz = [jnp.asarray(a) for a in z]
    v = fill_variables(jmod, jnp.asarray(x), jz, False)
    tmod = to_torch(th.HRNetTrunk(T_SPECS, 9, z_mode="z", z_dim=Z_DIM,
                                  dtype=torch.float32), v)
    return jmod, v, tmod, x, z, jz


@pytest.mark.parametrize("mode", ["full", "prefix", "suffix"])
def test_trunk_modes(trunk_case, mode):
    jmod, v, tmod, x, z, jz = trunk_case
    tz = _cl(z)
    if mode == "suffix":
        feats = _apply(jmod, v, jnp.asarray(x), None, False, "prefix")
        want = _apply(jmod, v, feats, jz, False, "suffix")
        got = tmod(_cl([np.asarray(f) for f in feats]), tz, "suffix")
    else:
        want = _apply(jmod, v, jnp.asarray(x), jz, False, mode)
        got = tmod(nchw(x), tz, mode)
    assert len(got) == 4  # prefix ends after the stage-4 transition
    for g, w_ in zip(got, want):
        assert g.is_contiguous(memory_format=torch.channels_last)
        assert_close(nhwc(g), w_)


@pytest.fixture
def pallas_backend():
    """The JAX side's eval BNs reach the Pallas kernel (interpret mode on
    the CPU); the backend is module-global, so restore it."""
    set_default_bn_backend("pallas")
    yield
    set_default_bn_backend("xla")


@pytest.mark.parametrize("method", ["sample", "__call__"])
def test_encdec_matches_jax_pallas(pallas_backend, method):
    """The whole slice: VAE2EncDec.sample (the shared-prefix rollout of one
    clip) and __call__ (S clips) with the same weights, z maps and random
    code on both sides."""
    s = 2
    rng = np.random.RandomState(6)
    x = _randn(rng, 1 if method == "sample" else s, H, W, 9)
    z = _branches(rng, (Z_DIM,) * 4, h=H, w=W, batch=s)
    rand = _randn(rng, s, Z_DIM)
    jmod = JaxEncDec(specs=SPECS, z_dim=Z_DIM, dtype=jnp.float32)
    jz = [jnp.asarray(a) for a in z]
    v = fill_variables(jmod, jnp.asarray(x), jz, False, method="sample")

    def inject_rand(next_fun, args, kwargs, context):
        # substitute the encoder's random-code maps: [rand maps, z maps]
        if (isinstance(context.module, jh.ZInject)
                and context.method_name == "__call__" and len(args[1]) == 2):
            xs, maps = args[0], args[1]
            args = (xs, [jh.gen_code_maps(jnp.asarray(rand), xs), maps[1]]) \
                + tuple(args[2:])
        return next_fun(*args, **kwargs)

    @jax.jit
    def jax_sample(variables, x_, z_):
        with nn.intercept_methods(inject_rand):
            return jmod.apply(variables, x_, z_, False, method=method,
                              rngs={"sample": jax.random.PRNGKey(9)})

    want = jax_sample(v, jnp.asarray(x), jz)
    tmod = to_torch(TorchEncDec(T_SPECS, z_dim=Z_DIM, dtype=torch.float32), v)
    run = tmod.sample if method == "sample" else tmod
    with torch.inference_mode():
        got = run(nchw(x), _cl(z), rand_code=torch.from_numpy(rand))
    for g, w_ in zip(got, want):
        assert g.shape == (s, 9, H, W)
        assert_close(nhwc(g), w_)


def test_split_muvar_matches_jax():
    rng = np.random.RandomState(7)
    maps = _branches(rng, (2 * Z_DIM,) * 2)
    vec = _randn(rng, 2, 2 * Z_DIM)
    want_maps = jax_split_muvar([jnp.asarray(m) for m in maps], Z_DIM)
    got_maps = split_muvar(_cl(maps), Z_DIM)
    for got, want in zip(got_maps, want_maps):
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(nhwc(g), np.asarray(w_))
    for g, w_ in zip(split_muvar(torch.from_numpy(vec), Z_DIM),
                     jax_split_muvar(jnp.asarray(vec), Z_DIM)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
