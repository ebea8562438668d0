"""vae2_tpu_torch's FID / Inception Score path against the JAX package on the
CPU: every Inception block and the whole network of both variants on
carried weights, the Frechet distance and the Inception Score's split math
on the same arrays, ``from_jax_inception_params``, and the port's FID and
IS CLIs on a few seeded PNGs.

Weights are drawn with numpy into the JAX package's flat parameter dict
(He-normal kernels, non-trivial BN statistics and affine parameters, so a
BN that maps wrongly shows) and carried to the port by
``from_jax_inception_params``. The JAX side runs eagerly (no jit of the
network: its CPU compile is the slow part of the JAX package's own
Inception tests).

Tolerances: features, logits and FID statistics |port - jax| <= 1e-4 *
(1 + max|jax|) elementwise (both sides in f32, with their own convolution
algorithms and summation orders); the Frechet distance and the IS split
math on the same float64/float32 arrays to 1e-10 relative (the same scipy
calls in the same order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vae2_tpu.eval import fid as jax_fid
from vae2_tpu.eval import is_score as jax_is
from vae2_tpu.models import inception as ji
from vae2_tpu_torch.eval import fid, is_score
from vae2_tpu_torch.models import inception as ti
from vae2_tpu_torch.tools import fid_score as fid_cli
from vae2_tpu_torch.tools import inception_score as is_cli
from vae2_tpu_torch.utils.jax_params import from_jax_inception_params

RTOL = 1e-4
H, W = 128, 256  # the eval frames' size: imread's resize is the identity


def assert_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=RTOL, atol=RTOL * (1.0 + np.abs(want).max()))


def fill_inception(seed=0):
    """numpy-filled JAX parameter dict: kernels He-normal, BN scale and var
    U(0.5, 1.5), bias and mean N(0, 0.2); fc normal(0.02), bias N(0, 0.1)."""
    rng = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    params = {}
    for name, cin, cout, kh, kw in ji._conv_specs():
        params[name] = {
            "w": f32(rng.randn(kh, kw, cin, cout)
                     * np.sqrt(2.0 / (kh * kw * cin))),
            "bn_scale": f32(rng.uniform(0.5, 1.5, cout)),
            "bn_bias": f32(rng.randn(cout) * 0.2),
            "bn_mean": f32(rng.randn(cout) * 0.2),
            "bn_var": f32(rng.uniform(0.5, 1.5, cout)),
        }
    params["fc"] = {"w": f32(rng.randn(2048, 1000) * 0.02),
                    "b": f32(rng.randn(1000) * 0.1)}
    return params


@pytest.fixture(scope="module")
def params():
    return fill_inception()


@pytest.fixture(scope="module")
def weights_pth(params, tmp_path_factory):
    """The same weights as a torch state dict under torchvision's names,
    with an ``AuxLogits`` entry that the loader must ignore."""
    sd = from_jax_inception_params(params)
    sd["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    path = str(tmp_path_factory.mktemp("w") / "inception.pth")
    torch.save(sd, path)
    return path


def _port(module, params, prefix=""):
    sd = from_jax_inception_params(params)
    if prefix:
        sd = {k[len(prefix) + 1:]: v for k, v in sd.items()
              if k.startswith(prefix + ".")}
    else:
        sd = {k: v for k, v in sd.items() if k in module.state_dict()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


BLOCKS = {  # case: (prefix, port block, JAX block, (h, w) of the input)
    "A_excl": ("Mixed_5b", lambda: ti.InceptionA("Mixed_5b", False),
               lambda p, x: ji._inception_a(p, "Mixed_5b", x, False), (7, 9)),
    "A_incl": ("Mixed_5c", lambda: ti.InceptionA("Mixed_5c", True),
               lambda p, x: ji._inception_a(p, "Mixed_5c", x, True), (7, 9)),
    "B": ("Mixed_6a", lambda: ti.InceptionB("Mixed_6a"),
          lambda p, x: ji._inception_b(p, "Mixed_6a", x), (9, 11)),
    "C_excl": ("Mixed_6b", lambda: ti.InceptionC("Mixed_6b", False),
               lambda p, x: ji._inception_c(p, "Mixed_6b", x, False), (7, 9)),
    "C_incl": ("Mixed_6e", lambda: ti.InceptionC("Mixed_6e", True),
               lambda p, x: ji._inception_c(p, "Mixed_6e", x, True), (7, 9)),
    "D": ("Mixed_7a", lambda: ti.InceptionD("Mixed_7a"),
          lambda p, x: ji._inception_d(p, "Mixed_7a", x), (9, 11)),
    "E_avg": ("Mixed_7b", lambda: ti.InceptionE("Mixed_7b", "avg"),
              lambda p, x: ji._inception_e(p, "Mixed_7b", x, "avg"), (5, 7)),
    "E_max": ("Mixed_7c", lambda: ti.InceptionE("Mixed_7c", "max"),
              lambda p, x: ji._inception_e(p, "Mixed_7c", x, "max"), (5, 7)),
    "E_avg_incl": ("Mixed_7c", lambda: ti.InceptionE("Mixed_7c", "avg_incl"),
                   lambda p, x: ji._inception_e(p, "Mixed_7c", x, "avg_incl"),
                   (5, 7)),
}


@pytest.mark.parametrize("case", list(BLOCKS))
def test_inception_block_matches_jax(params, case):
    prefix, port_block, jax_block, (h, w) = BLOCKS[case]
    cin = next(s[1] for s in ji._conv_specs()
               if s[0].startswith(prefix + "."))
    x = np.random.RandomState(len(case)).randn(2, h, w, cin).astype(np.float32)
    want = np.asarray(jax_block(params, jnp.asarray(x)))
    block = _port(port_block(), params, prefix)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    with torch.inference_mode():
        got = block(xt).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert_close(got, want)


@pytest.mark.parametrize("variant", ["fid", "torchvision"])
def test_inception_forward_matches_jax(params, variant):
    """The whole network at batch 1 on a 128x256 frame: the FID variant's
    pool3 features, the torchvision variant's logits."""
    fid_variant = variant == "fid"
    x = np.random.RandomState(1).rand(1, H, W, 3).astype(np.float32)
    want = np.asarray(ji.inception_forward(
        params, jnp.asarray(x), fid_variant=fid_variant,
        with_logits=not fid_variant))
    model = _port(ti.InceptionV3(fid_variant, with_fc=not fid_variant),
                  params)
    with torch.inference_mode():
        got = model(torch.from_numpy(x), with_logits=not fid_variant).numpy()
    assert got.shape == ((1, 2048) if fid_variant else (1, 1000))
    assert_close(got, want)


def test_random_init_is_seeded_he_normal():
    a, b = ti.InceptionV3(), ti.InceptionV3()
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    w = sa["Mixed_7c.branch3x3dbl_1.conv.weight"]  # cin 2048, 1x1
    assert abs(float(w.std()) - (2.0 / 2048) ** 0.5) < 1e-3
    assert torch.equal(sa["Mixed_7c.branch1x1.bn.running_var"],
                       torch.ones(320))
    assert "fc.weight" not in sa
    c = ti.InceptionV3(fid_variant=False, with_fc=True)
    assert c.state_dict()["fc.weight"].shape == (1000, 2048)


def test_from_jax_inception_params_maps_and_refuses(params, weights_pth):
    sd = from_jax_inception_params(params)
    model = ti.InceptionV3(fid_variant=False, with_fc=True)
    assert set(sd) == set(model.state_dict())
    w = params["Mixed_6b.branch7x7_2"]["w"]  # (1, 7, 128, 128) HWIO
    assert torch.equal(sd["Mixed_6b.branch7x7_2.conv.weight"],
                       torch.from_numpy(w.transpose(3, 2, 0, 1)))
    assert torch.equal(sd["fc.weight"], torch.from_numpy(params["fc"]["w"].T))
    assert torch.equal(sd["Conv2d_1a_3x3.bn.running_var"],
                       torch.from_numpy(params["Conv2d_1a_3x3"]["bn_var"]))
    with pytest.raises(KeyError, match="cannot map"):
        from_jax_inception_params(
            {"Conv2d_1a_3x3": {**params["Conv2d_1a_3x3"], "gamma": 1.0}})
    with pytest.raises(KeyError, match="cannot map"):
        from_jax_inception_params({"fc": {"w": params["fc"]["w"]}})
    # a .pth of torch names loads (AuxLogits ignored); a missing key raises
    loaded = ti.get_inception(weights_pth, fid_variant=False, with_fc=True,
                              device="cpu")
    assert all(torch.equal(v, sd[k]) for k, v in loaded.state_dict().items())
    partial = str(os.path.dirname(weights_pth)) + "/partial.pth"
    torch.save({k: v for k, v in sd.items() if not k.startswith("fc.")},
               partial)
    ti.get_inception(partial, fid_variant=True, device="cpu")  # no fc needed
    with pytest.raises(KeyError, match="fc.weight"):
        ti.get_inception(partial, fid_variant=False, with_fc=True,
                         device="cpu")


@pytest.mark.parametrize("rank", ["full", "deficient"])
def test_frechet_distance_matches_jax(rank):
    """Full-rank covariances, and the rank-deficient ones of fewer samples
    than dimensions (as a handful of images gives)."""
    rng = np.random.RandomState(3)
    d, n = 32, (200 if rank == "full" else 6)
    a, b = rng.randn(n, d), rng.randn(n, d) * 1.3 + 0.2
    stats = (a.mean(0), np.cov(a, rowvar=False), b.mean(0),
             np.cov(b, rowvar=False))
    want = jax_fid.calculate_frechet_distance(*stats)
    got = fid.calculate_frechet_distance(*stats)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    assert abs(fid.calculate_frechet_distance(*stats[:2], *stats[:2])) < 1e-4


def _write_pngs(root, n, seed, tag=""):
    """n seeded (H, W) RGB PNGs; the red value of pixel (0, 0) is the
    image's index."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        im = rng.randint(0, 256, (H, W, 3), np.uint8)
        im[0, 0, 0] = i
        Image.fromarray(im).save(os.path.join(root, f"{tag}{i:02d}.png"))


def test_inception_score_split_math_matches_jax(tmp_path, monkeypatch):
    """The JAX ``inception_score`` with its classifier replaced by a table
    lookup (row = the image's index) and its softmax by the identity, so
    that its split math sees exactly ``preds``; the port's ``split_scores``
    on the same array."""
    n, splits = 23, 4
    rng = np.random.RandomState(5)
    logits = rng.randn(n, 1000) * 3
    preds = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    preds = preds.astype(np.float32)
    _write_pngs(str(tmp_path), n, seed=6)
    files = jax_is.collect_files(str(tmp_path), "*.png")

    def lookup(table, x, **_):
        idx = jnp.round(x[:, 0, 0, 0] * 255.0).astype(jnp.int32)
        return jnp.take(table, idx, axis=0)

    monkeypatch.setattr(jax_is, "get_inception",
                        lambda *a, **k: jnp.asarray(preds))
    monkeypatch.setattr(jax_is, "inception_forward", lookup)
    monkeypatch.setattr(jax.nn, "softmax", lambda x, axis=-1: x)
    want = jax_is.inception_score(files, batch_size=5, splits=splits)
    got = is_score.split_scores(preds, splits)
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_fid_cli_matches_jax_statistics(params, weights_pth, tmp_path):
    """The port's FID CLI on the CPU with a .pth of the carried weights
    between two dirs of seeded PNGs (batch 3 over 4 images: a ragged last
    batch). The statistics it computes (``save_statistics``, the same
    path) against the JAX network's features of the same images (eager, one
    image at a time). One FID only: scipy's sqrtm of a 2048-d product takes
    15-20 s on one core."""
    dirs = [str(tmp_path / d) for d in ("a", "b")]
    for seed, d in enumerate(dirs):
        _write_pngs(d, 4, seed=10 + seed)
    got = fid_cli.main(["--path", *dirs, "--batch-size", "3",
                        "--weights", weights_pth, "--device", "cpu"])
    assert np.isfinite(got) and got > 0
    for d in dirs:
        files = fid.list_images(d)
        assert files == jax_fid.list_images(d) and len(files) == 4
        npz = d + ".npz"
        fid.save_statistics(d, None, npz, batch_size=3, weights=weights_pth,
                            device="cpu")
        feats = np.concatenate([np.asarray(ji.inception_forward(
            params, jnp.asarray(jax_fid.imread(f)[None] / np.float32(255.0))))
            for f in files]).astype(np.float64)
        with np.load(npz) as stats:
            assert_close(stats["mu"], feats.mean(0))
            assert_close(stats["sigma"], np.cov(feats, rowvar=False))


def test_inception_score_cli_matches_jax_logits(params, weights_pth, tmp_path):
    """The port's IS CLI on the CPU (recursive pattern, batch 4, 3 splits)
    against the split math on the JAX network's softmax of the same images
    (eager, one image at a time)."""
    _write_pngs(str(tmp_path / "v0" / "x3tpredict"), 6, seed=20, tag="x3t_")
    _write_pngs(str(tmp_path / "v1" / "x3tpredict"), 6, seed=21, tag="x3t_")
    _write_pngs(str(tmp_path / "v1"), 3, seed=22, tag="x2t_")  # not matched
    mean, std = is_cli.main(["--path", str(tmp_path), "--pattern", "x3t_*",
                             "--batch-size", "4", "--splits", "3",
                             "--weights", weights_pth, "--device", "cpu"])
    files = jax_is.collect_files(str(tmp_path), "x3t_*")
    assert files == is_score.collect_files(str(tmp_path), "x3t_*")
    assert len(files) == 12
    preds = np.concatenate([np.asarray(jax.nn.softmax(ji.inception_forward(
        params, jnp.asarray(np.asarray(Image.open(f).convert("RGB"),
                                       np.float32)[None] / 255.0),
        fid_variant=False, with_logits=True), axis=-1)) for f in files])
    want = is_score.split_scores(preds, 3)
    np.testing.assert_allclose((mean, std), want, rtol=1e-4, atol=1e-6)
    assert 1.0 <= mean <= 1000.0
    with pytest.raises(ValueError, match="batch_size"):
        is_score.inception_score(files, batch_size=12, device="cpu")
