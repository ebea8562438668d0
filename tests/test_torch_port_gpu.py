"""Card tests of vae2_tpu_torch: the fused-ABN CUDA kernels (forward, and
the backward's sums and dx) against their plain PyTorch versions, the
``fused_abn`` autograd op and the tiny VAE2EncDec.sample and train step on
the card against the CPU. They need an NVIDIA Hopper GPU and nvcc, carry the
``gpu`` marker, and skip elsewhere. This file imports nothing of JAX, so it
runs where JAX is absent:

    python -m pytest tests/test_torch_port_gpu.py -m gpu

Tolerances: kernel 1, f32 1e-6 (rtol and atol; elu's expf may differ from
torch.exp in the last bit); bf16 one bf16 ulp (rtol 2**-7) for the same
reason, after the multiply and the add, which both round alike. Kernel 2
(per-channel f32 sums in another order): 1e-5 of the sum of the terms'
magnitudes. Kernel 3, given the same sums: rtol 1e-5 (f32) or one bf16 ulp,
atol 1e-5 * max|dx| (the plain leaky_relu divides by the slope through a
reciprocal on the card, elu's logf may differ in the last bit, and dx
cancels).
"""

import os
import unittest.mock

import pytest
import torch

from vae2_tpu_torch.config import get_default_config
from vae2_tpu_torch.core.builder import build_system
from vae2_tpu_torch.ops import abn
from vae2_tpu_torch.utils.device import exact_f32

ACTS = ("none", "leaky_relu", "elu")

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {torch.float32: dict(rtol=1e-6, atol=1e-6),
       torch.bfloat16: dict(rtol=2.0**-7, atol=1e-6)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100)")
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed, offset=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    n, c, h, w = shape
    flat = torch.randn(n * c * h * w + offset, generator=g) * 2
    # channels_last bytes, starting `offset` elements into the buffer
    x = flat[offset:].view(n, h, w, c).permute(0, 3, 1, 2)
    stats = [torch.randn(c, generator=g), torch.rand(c, generator=g) + 0.1,
             torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g)]
    return x.to(device, dtype), [s.to(device) for s in stats]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("act", ["none", "leaky_relu", "elu"])
@pytest.mark.parametrize("shape,offset", [
    ((2, 18, 16, 32), 0), ((1, 256, 8, 8), 0), ((3, 7, 5, 9), 0),
    ((2, 36, 6, 10), 1),            # not 16-byte aligned: element path
    ((1, 7000, 2, 3), 0),           # wide C: a grid step of 875 blocks
    ((1, 30000, 1, 2), 0),          # grid step (1875) above the block cap
])
def test_kernel_matches_plain(cuda, dtype, act, shape, offset):
    x, stats = _inputs(shape, dtype, cuda, seed=shape[1], offset=offset)
    assert x.is_contiguous(memory_format=torch.channels_last)
    before = abn.abn_rows.launches
    got = abn.fused_abn_infer(x, *stats, 1e-5, 0.01, act)
    torch.cuda.synchronize()
    assert abn.abn_rows.launches == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = abn.fused_abn_infer_plain(x, *stats, 1e-5, 0.01, act)
    torch.testing.assert_close(got, want, **TOL[dtype])


def test_kernel_rejects_what_it_does_not_take(cuda):
    x, stats = _inputs((1, 18, 4, 4), torch.bfloat16, cuda, seed=0)
    with pytest.raises(ValueError, match="channels_last"):
        abn.fused_abn_infer(x.contiguous(), *stats)
    with pytest.raises(ValueError, match="float32 vectors"):
        abn.fused_abn_infer(x, stats[0].cpu(), *stats[1:])


def _tiny(dtype):
    cfg = get_default_config()
    cfg.merge_from_file(os.path.join(
        REPO, "experiments", "cityscapes", "debug_tiny_32x64.yaml"))
    cfg.GPU.DTYPE = dtype
    system = build_system(cfg, seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in system.modules.modules():
            if isinstance(m, torch.nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               / fan_in**0.5)
            elif hasattr(m, "running_var"):
                c = m.weight.shape[0]
                m.weight.copy_(torch.rand(c, generator=g) + 0.5)
                m.bias.copy_(torch.randn(c, generator=g) * 0.2)
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.2)
                m.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    return system.modules["encdec"].eval()


def _sample_inputs(device, s=2, z_dim=4, h=32, w=64):
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 9, h, w, generator=g)
    z = [torch.randn(s, z_dim, h // 2**b, w // 2**b, generator=g)
         for b in range(4)]
    rand = torch.randn(s, z_dim, generator=g)
    return x.to(device), [t.to(device) for t in z], rand.to(device)


def test_tiny_sample_on_card_matches_cpu(cuda):
    """Float32, TF32 off: the card's kernels and convolutions against the
    CPU path that the JAX parity tests hold. Tolerance 1e-4 * (1 + max)."""
    net = _tiny("float32")
    with torch.inference_mode(), exact_f32():
        x, z, rand = _sample_inputs("cpu")
        want = net.sample(x, z, rand_code=rand)
        net.to(cuda)
        x, z, rand = _sample_inputs(cuda)
        before = abn.abn_rows.launches
        got = net.sample(x, z, rand_code=rand)
        torch.cuda.synchronize()
    assert abn.abn_rows.launches > before
    for g_, w_ in zip(got, want):
        tol = 1e-4 * (1.0 + float(w_.abs().max()))
        torch.testing.assert_close(g_.cpu(), w_, rtol=1e-4, atol=tol)


def test_tiny_sample_bf16_kernel_matches_plain_path(cuda):
    """bfloat16 on the card, BNs through the kernel and through the plain
    version; tolerance one bf16 ulp of the output scale."""
    net = _tiny("bfloat16").to(cuda)
    x, z, rand = _sample_inputs(cuda)
    with torch.inference_mode():
        got = net.sample(x, z, rand_code=rand)
        with unittest.mock.patch.object(abn, "fused_abn_infer",
                                        abn.fused_abn_infer_plain):
            want = net.sample(x, z, rand_code=rand)
    for g_, w_ in zip(got, want):
        tol = 2.0**-7 * (1.0 + float(w_.abs().max()))
        torch.testing.assert_close(g_.float(), w_.float(), rtol=0, atol=tol)


def _bwd_inputs(shape, dtype, device, seed, act, offset=0):
    """y (a plausible output of act), dz, gamma, beta, gamma * inv_std."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    n, c, h, w = shape
    z = torch.randn(n * c * h * w + offset, generator=g) * 1.5
    y = {"none": z, "leaky_relu": torch.where(z >= 0, z, z * 0.01),
         "elu": torch.where(z >= 0, z, torch.expm1(z))}[act]
    dz = torch.randn(n * c * h * w + offset, generator=g)
    lay = lambda t: t[offset:].view(n, h, w, c).permute(0, 3, 1, 2)  # noqa
    gamma = (torch.rand(c, generator=g) + 0.5) * torch.sign(
        torch.randn(c, generator=g))
    beta = torch.randn(c, generator=g) * 0.3
    mul = gamma * (torch.rand(c, generator=g) + 0.5)
    return (lay(y).to(device, dtype), lay(dz).to(device, dtype),
            gamma.to(device), beta.to(device), mul.to(device))


def check_bwd(y, dz, gamma, beta, mul, act):
    """Kernels 2 and 3 against their plain versions on the same inputs;
    returns (max sums error, max dx error)."""
    before = (abn.abn_bwd_sums.launches, abn.abn_bwd_dx.launches)
    sums = abn.abn_bwd_sums(y, dz, gamma, beta, 0.01, act)
    dx = abn.abn_bwd_dx(y, dz, gamma, beta, mul, sums, 0.01, act)
    torch.cuda.synchronize()
    assert (abn.abn_bwd_sums.launches, abn.abn_bwd_dx.launches) == (
        before[0] + 1, before[1] + 1)
    want_sums = abn.abn_bwd_sums_plain(y, dz, gamma, beta, 0.01, act)
    y_norm, dz_eff = abn._y_norm(y, dz, gamma, beta, 0.01, act)
    mags = torch.stack([dz_eff.abs().sum((0, 2, 3)),
                        (y_norm * dz_eff).abs().sum((0, 2, 3))])
    sums_err = (sums - want_sums).abs()
    assert bool((sums_err <= 1e-5 * mags + 1e-30).all()), float(
        (sums_err / (mags + 1e-30)).max())
    want_dx = abn.abn_bwd_dx_plain(y, dz, gamma, beta, mul, sums, 0.01, act)
    assert dx.is_contiguous(memory_format=torch.channels_last)
    rtol = 1e-5 if y.dtype == torch.float32 else 2.0**-7
    scale = float(want_dx.float().abs().max())
    torch.testing.assert_close(dx.float(), want_dx.float(), rtol=rtol,
                               atol=1e-5 * scale)
    return float(sums_err.max()), float((dx.float() - want_dx.float())
                                        .abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape,offset", [
    ((2, 18, 16, 32), 0), ((1, 256, 8, 8), 0), ((3, 7, 5, 9), 0),
    ((2, 36, 6, 10), 1),            # not 16-byte aligned: V = 1 path
    ((3, 18, 5, 3), 0),             # n not a multiple of 8: V = 1 path
    ((1, 7000, 2, 3), 0),           # wide C: a grid step of 875 blocks
    ((1, 30000, 1, 2), 0),          # grid step (1875) above the block cap
])
def test_bwd_kernels_match_plain(cuda, dtype, act, shape, offset):
    check_bwd(*_bwd_inputs(shape, dtype, cuda, shape[1], act, offset), act)


def test_bwd_sums_are_deterministic(cuda):
    y, dz, gamma, beta, _ = _bwd_inputs((8, 18, 64, 128), torch.bfloat16,
                                        cuda, 3, "none")
    first = abn.abn_bwd_sums(y, dz, gamma, beta, 0.01, "none")
    for _ in range(3):
        again = abn.abn_bwd_sums(y, dz, gamma, beta, 0.01, "none")
        assert torch.equal(first, again)


@pytest.mark.parametrize("act", ACTS)
def test_fused_abn_on_card_matches_cpu(cuda, act):
    """The autograd op in f32 on the card (kernels 1-3) against the CPU
    (plain versions): y to 1e-6, dx/dgamma/dbeta to 1e-5 * (1 + max)."""
    g = torch.Generator().manual_seed(4)
    x = (torch.randn(4, 12, 20, 36, generator=g) * 2).permute(0, 3, 1, 2)
    gamma = torch.rand(36, generator=g) + 0.5
    beta = torch.randn(36, generator=g) * 0.3
    dz = torch.randn(4, 12, 20, 36, generator=g).permute(0, 3, 1, 2)
    out = []
    for dev in ("cpu", cuda):
        xx = x.to(dev).detach().clone().requires_grad_(True)
        gg = gamma.to(dev).detach().clone().requires_grad_(True)
        bb = beta.to(dev).detach().clone().requires_grad_(True)
        y = abn.fused_abn(xx, gg, bb, 1e-5, 0.01, act)
        y.backward(dz.to(dev))
        out.append([t.detach().cpu() for t in (y, xx.grad, gg.grad, bb.grad)])
    for i, (want, got) in enumerate(zip(*out)):
        tol = (1e-6 if i == 0 else 1e-5) * (1.0 + float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=tol)


def _tiny_train_system(device):
    cfg = get_default_config()
    cfg.merge_from_file(os.path.join(
        REPO, "experiments", "cityscapes", "debug_tiny_32x64.yaml"))
    cfg.GPU.DTYPE = "float32"
    cfg.TRAIN.OPTIMIZER = "sgd"
    cfg.TRAIN.LR = 0.01
    cfg.TPU.REMAT = "stage"
    return build_system(cfg, seed=0, device=device, train=True)


def tiny_train_step(device):
    """One G/D step of the tiny spec in f32 with fixed clips and noise;
    returns (metrics, initial state dict, state dict after the step)."""
    system = _tiny_train_system(device)
    init = {k: v.detach().cpu().clone()
            for k, v in system.modules.state_dict().items()}
    g = torch.Generator().manual_seed(6)
    batch = {k: torch.randint(0, 256, (2, 32, 64, 9), generator=g,
                              dtype=torch.uint8).to(device)
             for k in ("xt", "x2t", "x3t")}
    eps = [torch.randn(2, 4, 32 >> b, 64 >> b, generator=g).to(device)
           for b in range(4)]
    rand = torch.randn(2, 4, generator=g).to(device)
    with exact_f32():
        metrics, _ = system.train_step(batch, eps=eps, rand_code=rand)
    after = {k: v.detach().cpu() for k, v in system.modules.state_dict().items()}
    return {k: float(v) for k, v in metrics.items()}, init, after


# KL sums exp(lv) - lv - 1 over the 2 x 10,880 latent elements of the tiny
# step, which cancels near lv = 0: each term keeps ~one ulp of 1 (6e-8), so
# the sum / B carries up to ~7e-4 whatever the order.
KL_ATOL = 1e-3


def compare_train_steps(got, want):
    """Losses rtol 1e-4 (KL also atol KL_ATOL); running statistics 1e-4 * (1 + max); parameter
    updates within 3e-2 (L2, per network) — the bound of the CPU step test
    against the JAX package (tests/test_torch_port_step.py), whose random
    tiny network's gradient moves by ~1% under one-ulp input noise.
    Returns the largest update difference seen."""
    (m_got, init, after_got), (m_want, _, after_want) = got, want
    for k in m_want:
        tol = 1e-4 * abs(m_want[k]) + KL_ATOL * (k == "loss_z_KL")
        assert abs(m_got[k] - m_want[k]) <= tol + 1e-6, k
    worst = 0.0
    for net in ("encdec", "encz", "d_seq", "d_frame"):
        d2 = w2 = 0.0
        for k, want in after_want.items():
            if not k.startswith(net + "."):
                continue
            if "running_" in k:
                tol = 1e-4 * (1.0 + float(want.abs().max()))
                torch.testing.assert_close(after_got[k], want, rtol=1e-4,
                                           atol=tol)
            elif k.endswith(("weight", "bias")):
                du = (after_got[k] - init[k]) - (want - init[k])
                d2 += float((du**2).sum())
                w2 += float(((want - init[k]) ** 2).sum())
        rel = (d2 / w2) ** 0.5
        assert rel <= 3e-2, (net, rel)
        worst = max(worst, rel)
    return worst


def test_tiny_train_step_on_card_matches_cpu(cuda):
    """Float32, TF32 off, REMAT 'stage': one step on the card (kernels 1-3,
    cuDNN) against the CPU path that the CPU tests hold to JAX."""
    want = tiny_train_step("cpu")
    counts = [f.launches for f in (abn.abn_rows, abn.abn_bwd_sums,
                                   abn.abn_bwd_dx)]
    got = tiny_train_step(cuda)
    after = [f.launches for f in (abn.abn_rows, abn.abn_bwd_sums,
                                  abn.abn_bwd_dx)]
    assert all(a > b for a, b in zip(after, counts))
    compare_train_steps(got, want)
