"""vae2_tpu_torch's ops against the JAX package on the same numpy inputs:
the fused-ABN wrapper (its plain path, which the CPU takes) against the
Pallas kernel in interpret mode, the eval BatchNormAct, bilinear resize,
SSIM / MS-SSIM / PSNR and the per-sample metric function.

Tolerances (float32 on both sides):
- fused ABN: atol 1e-5 (abn.py's own test uses the same); in bf16 one
  bf16 ulp of the output scale (each side folds in f32 with its own rsqrt
  and casts the fold to bf16); ``gamma * inv_std`` rtol 1e-5;
- resize: atol 1e-5 (the JAX side interpolates W by a matmul);
- ssim, ms_ssim, psnr and the metric function: rtol 1e-4 (sums of
  ~1e4 terms in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae2_tpu.core.losses import psnr as jax_psnr
from vae2_tpu.data.loader import denormalize_clips as jax_denormalize
from vae2_tpu.ops import image as jax_image
from vae2_tpu.ops import ssim as jax_ssim
from vae2_tpu.ops.norm import BatchNormAct as JaxBN
from vae2_tpu.ops.pallas.abn import _abn_rows as _jax_abn_rows
from vae2_tpu.ops.pallas.abn import _fused_abn_fwd as _jax_fused_abn_fwd
from vae2_tpu.ops.pallas.abn import fused_abn_infer as jax_abn
from vae2_tpu_torch.core import infer_loop as port_infer
from vae2_tpu_torch.core.losses import psnr as port_psnr
from vae2_tpu_torch.ops import abn as port_abn
from vae2_tpu_torch.ops import image as port_image
from vae2_tpu_torch.ops import ssim as port_ssim
from vae2_tpu_torch.ops.norm import BatchNormAct as PortBN


def _cl(a):
    """NHWC numpy -> NCHW channels_last torch (the same bytes)."""
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _abn_inputs(c, seed, tiny_gamma=False):
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, 6, 10, c) * 2).astype(np.float32)
    mean = rng.randn(c).astype(np.float32)
    var = (rng.rand(c) + 0.1).astype(np.float32)
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    if tiny_gamma:
        scale = (rng.randn(c) * 1e-6).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    return x, mean, var, scale, bias


@pytest.mark.parametrize("act", ["none", "leaky_relu", "elu"])
@pytest.mark.parametrize("c", [18, 36])
def test_fused_abn_infer_matches_pallas(act, c):
    x, *stats = _abn_inputs(c, seed=c)
    want = np.asarray(jax_abn(jnp.asarray(x), *map(jnp.asarray, stats),
                              1e-5, 0.01, act))
    before = port_abn.abn_rows.launches
    got = port_abn.fused_abn_infer(_cl(x), *map(torch.from_numpy, stats),
                                   1e-5, 0.01, act)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert port_abn.abn_rows.launches == before  # CPU: no kernel
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5, rtol=0)


def test_fused_abn_infer_gamma_near_zero():
    x, *stats = _abn_inputs(18, seed=3, tiny_gamma=True)
    want = np.asarray(jax_abn(jnp.asarray(x), *map(jnp.asarray, stats),
                              1e-5, 0.01, "leaky_relu"))
    got = port_abn.fused_abn_infer(_cl(x), *map(torch.from_numpy, stats),
                                   1e-5, 0.01, "leaky_relu")
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5, rtol=0)


def test_fused_abn_plain_equals_wrapper_and_rejects_bad_input():
    x, *stats = _abn_inputs(36, seed=4)
    xt, st = _cl(x), [torch.from_numpy(s) for s in stats]
    torch.testing.assert_close(port_abn.fused_abn_infer_plain(xt, *st),
                               port_abn.fused_abn_infer(xt, *st),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="channels_last"):
        port_abn.fused_abn_infer(xt.contiguous(), *st)
    with pytest.raises(ValueError, match="float32 or"):
        port_abn.fused_abn_infer(xt.double(), *st)
    with pytest.raises(ValueError, match="length C"):
        port_abn.fused_abn_infer(xt, st[0][:5], *st[1:])
    with pytest.raises(ValueError, match="act"):
        port_abn.fused_abn_infer(xt, *st, act="relu")


def _abn_close(got, want, dtype):
    """f32: atol 1e-5. bf16: one bf16 ulp of the output scale, 2**-7 * (1 +
    max|want|): each side folds in f32 (its own rsqrt, and for the training
    entry its own summation order of the batch statistics) and casts mul
    and add to bf16, where one f32 ulp apart can round one bf16 ulp apart."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol = 1e-5 if dtype == "f32" else 2.0**-7 * (1.0 + np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("tiny_gamma", [False, True], ids=["gamma", "gamma~1e-6"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c", [4, 18, 36])
@pytest.mark.parametrize("entry", ["infer", "train"])
def test_abn_fold_entries_match_jax(entry, c, dtype, tiny_gamma):
    """Kernel 1's fold entries (the plain versions, which the CPU takes)
    against the JAX package: ``fused_abn_infer`` against its
    ``fused_abn_infer`` on the same statistics; ``abn_fwd_train`` on the
    batch statistics against ``_fused_abn_fwd``'s y and ``scale * inv_std``
    (the ``mul`` its backward hands the dx kernel, abn.py:208; rtol 1e-5:
    both sides' rsqrt and batch statistics round in their own order)."""
    x, *stats = _abn_inputs(c, seed=c + 100 * tiny_gamma,
                            tiny_gamma=tiny_gamma)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    xj = jnp.asarray(x).astype(jdt)
    xt = _cl(x).to(tdt)
    mean, var, scale, bias = map(torch.from_numpy, stats)
    for act in ("none", "leaky_relu", "elu"):
        if entry == "infer":
            want = jax_abn(xj, *map(jnp.asarray, stats), 1e-5, 0.01, act)
            got = port_abn.fused_abn_infer(xt, mean, var, scale, bias, 1e-5,
                                           0.01, act)
        else:
            want, res = _jax_fused_abn_fwd(xj, jnp.asarray(stats[2]),
                                           jnp.asarray(stats[3]), 1e-5, 0.01,
                                           act)
            got, gamma_inv = port_abn.abn_fwd_train(
                xt, *port_abn.batch_stats(xt), scale, bias, 1e-5, 0.01, act)
            assert gamma_inv.dtype == torch.float32
            np.testing.assert_allclose(gamma_inv.numpy(),
                                       np.asarray(res[1] * res[3]), rtol=1e-5,
                                       atol=0)
        assert got.dtype == tdt
        assert got.is_contiguous(memory_format=torch.channels_last)
        _abn_close(_nhwc(got.float()), jnp.asarray(want, jnp.float32), dtype)


@pytest.mark.parametrize("c", [4, 18, 36])
def test_abn_rows_matches_pallas(c):
    """Kernel 1's (x, mul, add) entry (its plain version) against the
    Pallas ``_abn_rows`` (interpret mode) on the same folded vectors, f32
    and bf16, with the tolerances of ``_abn_close`` (XLA on the CPU may
    contract the multiply and the add into one rounding)."""
    rng = np.random.RandomState(c)
    x = (rng.randn(2, 5, 6, c) * 2).astype(np.float32)
    mul = (rng.rand(c) + 0.5).astype(np.float32)
    add = rng.randn(c).astype(np.float32)
    for dtype, jdt, tdt in (("f32", jnp.float32, torch.float32),
                            ("bf16", jnp.bfloat16, torch.bfloat16)):
        for act in ("none", "leaky_relu", "elu"):
            want = _jax_abn_rows(jnp.asarray(x).reshape(-1, c).astype(jdt),
                                 jnp.asarray(mul).astype(jdt),
                                 jnp.asarray(add).astype(jdt), 0.01, act)
            got = port_abn.abn_rows(_cl(x).to(tdt),
                                    torch.from_numpy(mul).to(tdt),
                                    torch.from_numpy(add).to(tdt), 0.01, act)
            _abn_close(_nhwc(got.float()).reshape(-1, c),
                       want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("act", [None, "relu", "leaky_relu", "elu"])
def test_batchnorm_act_eval_matches_jax(act):
    x, mean, var, scale, bias = _abn_inputs(18, seed=5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    want = JaxBN(act=act, dtype=jnp.float32, backend="pallas").apply(
        variables, jnp.asarray(x), False)
    bn = PortBN(18, act=act).eval()
    bn.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean),
                        "running_var": torch.from_numpy(var)})
    got = bn(_cl(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5, rtol=0)


def test_batchnorm_act_train_mode_raises():
    """Train mode is ported (tests/test_torch_port_train.py holds it to the
    JAX package); it raises on what it does not take: NCHW-contiguous input
    to the fused ABN, 2-d input but for act 'relu', 3-d input."""
    bn = PortBN(4)
    assert bn.training
    with pytest.raises(ValueError, match="channels_last"):
        bn(torch.zeros(1, 4, 2, 2))
    with pytest.raises(ValueError, match="takes"):
        bn(torch.zeros(2, 4))
    with pytest.raises(ValueError, match="takes"):
        PortBN(4, act="relu")(torch.zeros(2, 4, 3))
    y = PortBN(4, act="relu")(torch.randn(3, 4))
    assert y.shape == (3, 4)


@pytest.mark.parametrize("size", [(16, 32), (32, 64), (12, 20)])
def test_resize_bilinear_matches_jax(size):
    x = np.random.RandomState(6).randn(2, 4, 8, 5).astype(np.float32)
    want = jax_image.resize_bilinear(jnp.asarray(x), *size)
    got = port_image.resize_bilinear(_cl(x), *size)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5, rtol=0)


def _images(h, w, seed):
    rng = np.random.RandomState(seed)
    a = rng.uniform(0, 255, (2, h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.randn(2, h, w, 3) * 20, 0, 255).astype(np.float32)
    return a, b


@pytest.mark.parametrize("size_average", [True, False])
def test_ssim_and_psnr_match_jax(size_average):
    a, b = _images(64, 128, seed=7)
    want = jax_ssim.ssim(jnp.asarray(a), jnp.asarray(b), 255.0, size_average)
    got = port_ssim.ssim(torch.from_numpy(a), torch.from_numpy(b), 255.0,
                         size_average)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    np.testing.assert_allclose(
        port_psnr(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax_psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-4)


@pytest.mark.parametrize("h,w,strict", [(64, 128, True), (64, 128, False),
                                        (32, 64, False)])
def test_ms_ssim_matches_jax(h, w, strict):
    """Strict (all 3 levels) and level-drop (32x64 keeps 2 levels)."""
    a, b = _images(h, w, seed=8)
    want = jax_ssim.ms_ssim(jnp.asarray(a), jnp.asarray(b), 255.0,
                            size_average=False, strict=strict)
    got = port_ssim.ms_ssim(torch.from_numpy(a), torch.from_numpy(b), 255.0,
                            size_average=False, strict=strict)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)


def test_ms_ssim_strict_refuses_small_images():
    a, b = _images(32, 64, seed=9)
    with pytest.raises(ValueError, match="strict"):
        port_ssim.ms_ssim(torch.from_numpy(a), torch.from_numpy(b),
                          strict=True)


def test_metric_fn_matches_jax_per_frame():
    """Per-sample, per-frame [ssim, msssim, recon, psnr] of normalized
    predictions against a uint8 clip, at 64x128 (strict MS-SSIM).

    The expected values apply the JAX package's metric ops to each RGB
    frame, as the reference does (function.py:238-316). The JAX package's
    own make_metric_fn maps its inner vmap over the colour axis
    (infer_loop.py:180-181), so its 'frame' k is colour k of all frames;
    the port does not copy that."""
    rng = np.random.RandomState(10)
    pred = (rng.randn(2, 64, 128, 9) * 0.8).astype(np.float32)
    gt = rng.randint(0, 256, (1, 64, 128, 9)).astype(np.uint8)
    pred255 = np.asarray(jax_denormalize(jnp.asarray(pred)))
    want = {k: np.zeros((2, 3), np.float32)
            for k in ("ssim", "msssim", "recon", "psnr")}
    for s in range(2):
        for f in range(3):
            p = jnp.asarray(pred255[s:s + 1, ..., 3 * f:3 * f + 3])
            g = jnp.asarray(gt[:, ..., 3 * f:3 * f + 3].astype(np.float32))
            want["ssim"][s, f] = jax_ssim.ssim(p, g, 255.0)
            want["msssim"][s, f] = jax_ssim.ms_ssim(p, g, 255.0, strict=True)
            want["recon"][s, f] = jnp.mean(jnp.abs(p - g))
            want["psnr"][s, f] = jax_psnr(p, g)
    got = port_infer.make_metric_fn()(torch.from_numpy(pred),
                                      torch.from_numpy(gt))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4,
                                   err_msg=k)
