"""Card tests of vae2_tpu_torch: the fused-ABN CUDA kernels (forward, and
the backward's sums and dx) against their plain PyTorch versions, at the
W18 paths' shapes and at HRNetV2-W48 segmentation's, the ``fused_abn``
autograd op, the tiny VAE2EncDec.sample, momentum sampler, train step and
seg train step, and InceptionV3 (under ``exact_f32``) on the card against
the CPU. They need an NVIDIA Hopper GPU and nvcc, carry the
``gpu`` marker, and skip elsewhere. This file imports nothing of JAX, so it
runs where JAX is absent:

    python -m pytest tests/test_torch_port_gpu.py -m gpu

Tolerances: kernel 1, f32 1e-6 (rtol and atol; elu's expf may differ from
torch.exp in the last bit); bf16 one bf16 ulp (rtol 2**-7) for the same
reason, after the multiply and the add, which both round alike. At the
paths' shapes kernel 1 (the fold inside) matches its plain version bit for
bit for none/leaky_relu, and its ``gamma * inv`` equals ``weight *
torch.rsqrt(var + eps)``. Kernel 2's sums are bit-identical over repeats
and across streams; each kernel call is one device launch. Kernel 2
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
from vae2_tpu_torch.core.infer_loop import make_momentum_sampler
from vae2_tpu_torch.models.inception import InceptionV3
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("c,offset", [(256, 0), (36, 2), (36, 1), (6, 0),
                                      (18, 1), (7, 0)])
def test_fold_reads_statistics_at_any_alignment(cuda, dtype, c, offset):
    """The fold reads the four statistics 4 floats at a time (C a multiple
    of 4, vectors 16-byte aligned), 2 (C even, 8-byte aligned) or one by
    one; the vectors here start ``offset`` floats into their buffers. Each
    way gives the plain version's bits for none/leaky_relu, and the
    training entry's ``gamma * inv`` those of ``weight * rsqrt(var + eps)``."""
    x, _ = _inputs((2, c, 4, 6), dtype, cuda, seed=c)
    g = torch.Generator().manual_seed(c + offset)
    mean, var, gamma, beta = (
        t.to(cuda)[offset:] for t in (
            torch.randn(c + offset, generator=g),
            torch.rand(c + offset, generator=g) + 0.1,
            torch.rand(c + offset, generator=g) + 0.5,
            torch.randn(c + offset, generator=g)))
    assert mean.data_ptr() % 8 == (4 * offset) % 8
    for act in ("none", "leaky_relu"):
        got = abn.fused_abn_infer(x, mean, var, gamma, beta, 1e-5, 0.01, act)
        want = abn.fused_abn_infer_plain(x, mean, var, gamma, beta, 1e-5,
                                         0.01, act)
        assert torch.equal(got, want), act
        y, gamma_inv = abn.abn_fwd_train(x, mean, var, gamma, beta, 1e-5,
                                         0.01, act)
        assert torch.equal(y, want), act
        assert torch.equal(gamma_inv, gamma * torch.rsqrt(var + 1e-5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_folded_entry_matches_plain(cuda, dtype):
    """Kernel 1's (x, mul, add) entry, with (mul, add) folded already in
    x's dtype: the plain version's bits for none/leaky_relu, elu within
    TOL, one launch each."""
    for shape, offset in (((2, 18, 16, 32), 0), ((3, 7, 5, 9), 0),
                          ((2, 36, 6, 10), 1)):
        x, (_, _, mul, add) = _inputs(shape, dtype, cuda, seed=3,
                                      offset=offset)
        mul, add = mul.to(dtype), add.to(dtype)
        for act in ACTS:
            before = abn.abn_rows.launches
            got = abn.abn_rows(x, mul, add, 0.01, act)
            assert abn.abn_rows.launches == before + 1
            want = abn.abn_rows_plain(x, mul, add, 0.01, act)
            if act == "elu":
                torch.testing.assert_close(got, want, **TOL[dtype])
            else:
                assert torch.equal(got, want), (shape, act)


def test_kernel_rejects_what_it_does_not_take(cuda):
    x, stats = _inputs((1, 18, 4, 4), torch.bfloat16, cuda, seed=0)
    with pytest.raises(ValueError, match="channels_last"):
        abn.fused_abn_infer(x.contiguous(), *stats)
    with pytest.raises(ValueError, match="float32 vectors"):
        abn.fused_abn_infer(x, stats[0].cpu(), *stats[1:])


def _randomize(modules, seed):
    """Conv kernels normal(1/sqrt(fan_in)), so that signal propagates, and
    seeded non-trivial BN statistics and affine parameters."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in modules.modules():
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


def _tiny_system(dtype):
    cfg = get_default_config()
    cfg.merge_from_file(os.path.join(
        REPO, "experiments", "cityscapes", "debug_tiny_32x64.yaml"))
    cfg.GPU.DTYPE = dtype
    system = build_system(cfg, seed=0)
    _randomize(system.modules, seed=1)
    system.modules.eval()
    return system


def _tiny(dtype):
    return _tiny_system(dtype).modules["encdec"]


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
    count = y.numel() // y.shape[1]
    dx = abn.abn_bwd_dx(y, dz, gamma, beta, mul, sums, 0.01, act, count)
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
    want_dx = abn.abn_bwd_dx_plain(y, dz, gamma, beta, mul, sums, 0.01, act,
                                   count)
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


@pytest.fixture(scope="module")
def path_shapes():
    """(infer, train) shapes of the W18-small-v2 paths on the card:
    (N, C, H, W) -> launches per sampling call, and -> [forward launches,
    of which recomputes] per train step (bench_abn.path_shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100)")
    from vae2_tpu_torch.tools.bench_abn import path_shapes as collect

    return collect(torch, torch.device("cuda"))


def _rows_on(shape, dtype, device, seed):
    """Random channels_last rows made on the card (the path's large
    shapes would take seconds each on the host)."""
    n, c, h, w = shape
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn((n, h, w, c), generator=g, device=device) * 2
            ).to(dtype).permute(0, 3, 1, 2)


def _stats_for(c, device, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [t.to(device) for t in (
        torch.randn(c, generator=g) * 0.3, torch.rand(c, generator=g) + 0.05,
        (torch.rand(c, generator=g) + 0.5) * torch.sign(torch.randn(c, generator=g)),
        torch.randn(c, generator=g) * 0.3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("act", ACTS)
def test_fold_entries_match_plain_at_path_shapes(cuda, path_shapes, dtype,
                                                 act):
    """Kernel 1 with the fold inside, at every shape of both paths: the
    inference entry against ``fused_abn_infer_plain``, the training entry's
    y against ``abn_fwd_train_plain`` and its ``gamma * inv`` against
    ``weight * torch.rsqrt(var + eps)``. The kernel folds with rsqrtf, the
    function ATen's CUDA rsqrt calls, and rounds the multiply and the add as
    PyTorch does: bit for bit for none/leaky_relu; elu within TOL (expf)."""
    infer, train = path_shapes
    for i, (n, c, h, w) in enumerate(sorted(set(infer) | set(train))):
        x = _rows_on((n, c, h, w), dtype, cuda, seed=i)
        mean, var, gamma, beta = _stats_for(c, cuda, seed=i)
        got = abn.fused_abn_infer(x, mean, var, gamma, beta, 1e-5, 0.01, act)
        want = abn.fused_abn_infer_plain(x, mean, var, gamma, beta, 1e-5,
                                         0.01, act)
        y, gamma_inv = abn.abn_fwd_train(x, mean, var, gamma, beta, 1e-5,
                                         0.01, act)
        want_y, _ = abn.abn_fwd_train_plain(x, mean, var, gamma, beta, 1e-5,
                                            0.01, act)
        assert torch.equal(gamma_inv, gamma * torch.rsqrt(var + 1e-5))
        for g_, w_ in ((got, want), (y, want_y)):
            assert g_.is_contiguous(memory_format=torch.channels_last)
            if act == "elu":
                torch.testing.assert_close(g_, w_, **TOL[dtype])
            else:
                assert torch.equal(g_, w_), (n, c, h, w)
        del x, got, want, y, want_y


def test_bwd_sums_are_deterministic(cuda, path_shapes):
    """Kernel 2's sums bit for bit over 3 repeats, at a 64x128 shape of C 18
    and at every shape a train step hands it, bf16 and f32."""
    _, train = path_shapes
    shapes = [(8, 18, 64, 128)] + sorted(s for s, (fwd, rec) in train.items()
                                         if fwd > rec)
    for i, shape in enumerate(shapes):
        for dtype in (torch.bfloat16, torch.float32):
            y = torch.nn.functional.leaky_relu(
                _rows_on(shape, dtype, cuda, seed=i), 0.01)
            dz = _rows_on(shape, dtype, cuda, seed=i + 1000)
            _, _, gamma, beta = _stats_for(shape[1], cuda, seed=i)
            first = abn.abn_bwd_sums(y, dz, gamma, beta, 0.01, "leaky_relu")
            for _ in range(3):
                again = abn.abn_bwd_sums(y, dz, gamma, beta, 0.01,
                                         "leaky_relu")
                assert torch.equal(first, again), (shape, dtype)
            del y, dz


def test_one_launch_and_only_outputs_allocated_per_call(cuda):
    """Kernel 1 (both fold entries) and kernel 2 each start one device
    kernel per call (counted exactly from a CUDA graph of the call, and by
    torch.profiler, whose device time is all the kernel's) and allocate
    only their outputs: y; y and gamma * inv; the (2, C) sums
    (torch.cuda.memory_stats)."""
    from vae2_tpu_torch.tools.bench_abn import (KERNEL_NAMES, device_profile,
                                                graph_launches)

    x, _ = _inputs((4, 36, 16, 32), torch.bfloat16, cuda, seed=5)
    mean, var, gamma, beta = _stats_for(36, cuda, seed=5)
    y, dz, g, b, _ = _bwd_inputs((4, 36, 16, 32), torch.bfloat16, cuda, 5,
                                 "none")
    calls = {
        "abn_rows": (lambda _: abn.fused_abn_infer(
            x, mean, var, gamma, beta, 1e-5, 0.01, "none"), 1),
        "abn_fwd_train": (lambda _: abn.abn_fwd_train(
            x, mean, var, gamma, beta, 1e-5, 0.01, "none"), 2),
        "abn_bwd_sums": (lambda _: abn.abn_bwd_sums(
            y, dz, g, b, 0.01, "none"), 1),
    }
    for name, (fn, outputs) in calls.items():
        kernel = KERNEL_NAMES.get(name, KERNEL_NAMES["abn_rows"])
        assert graph_launches(torch, fn, None) == 1, name
        prof = device_profile(torch, fn, [None], kernel)
        assert prof["profiled_launches_per_call"] == 1, (name, prof)
        assert prof["device_ms"] == prof["device_call_ms"], (name, prof)
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        keep = [fn(None) for _ in range(5)]
        torch.cuda.synchronize()
        after = torch.cuda.memory_stats()["allocation.all.allocated"]
        assert after - before == 5 * outputs, name
        del keep


def test_bwd_sums_streams_keep_their_own_scratch(cuda):
    """Two side streams in turn, and the current stream between them, give
    the sums of one stream, bit for bit; each stream has its scratch."""
    cases = [_bwd_inputs(s, torch.bfloat16, cuda, i, "none")
             for i, s in enumerate([(8, 18, 64, 128), (2, 144, 8, 16),
                                    (4, 36, 32, 64)])]
    want = [abn.abn_bwd_sums(*case[:4], 0.01, "none") for case in cases]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = []
    for rep in range(3):
        for i, case in enumerate(cases):
            s = streams[(rep + i) % 2]
            with torch.cuda.stream(s):
                got.append((i, abn.abn_bwd_sums(*case[:4], 0.01, "none")))
            got.append((i, abn.abn_bwd_sums(*case[:4], 0.01, "none")))
    torch.cuda.synchronize()
    for i, sums in got:
        assert torch.equal(sums, want[i]), i
    keys = {(cuda.index or 0, s.cuda_stream) for s in streams}
    assert keys <= set(abn._sums_scratch)


def test_refused_sums_launch_raises(cuda, monkeypatch):
    """A launch the library refuses (here: no blocks per SM) raises; the
    wrapper counts no launch and nothing falls back."""
    y, dz, gamma, beta, _ = _bwd_inputs((2, 18, 4, 8), torch.float32, cuda,
                                        0, "none")
    monkeypatch.setattr(abn, "SUMS_BLOCKS_PER_SM", 0)
    before = abn.abn_bwd_sums.launches
    with pytest.raises(RuntimeError, match="sums kernel launch failed"):
        abn.abn_bwd_sums(y, dz, gamma, beta, 0.01, "none")
    assert abn.abn_bwd_sums.launches == before


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_elu_forward_on_card_equals_cpu_bit_for_bit(cuda, dtype):
    """Kernel 1's elu takes exp(z) - 1 in f64 and rounds once, as the
    plain version does, so from the same (mul, add) y on the card has the
    CPU's bits. (From the BN statistics they differ: the card's rsqrt is
    not the CPU's.) The backward inverts elu from y, where one ulp of y
    near -1 moves dx by ~1e-4."""
    x, (mean, var, gamma, beta) = _inputs((4, 36, 20, 36), dtype, "cpu", 9)
    inv = torch.rsqrt(var + 1e-5)
    mul = (gamma * inv).to(dtype)
    add = (beta - mean * inv * gamma).to(dtype)
    for act in ACTS:
        want = abn.abn_rows(x, mul, add, 0.01, act)
        got = abn.abn_rows(x.to(cuda), mul.to(cuda), add.to(cuda), 0.01, act)
        assert torch.equal(got.cpu(), want), act


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


def test_tiny_momentum_sampler_on_card_matches_cpu(cuda):
    """Float32, TF32 off: the momentum sampler (the posterior at batch 1,
    its BNs through kernel 1, then the shared-prefix decode) with the same
    eps and random code on the card and on the CPU path that the CPU tests
    hold to JAX. Tolerance 1e-4 * (1 + max)."""
    system = _tiny_system("float32")
    g = torch.Generator().manual_seed(3)
    clips = [torch.randint(0, 256, (1, 32, 64, 9), generator=g,
                           dtype=torch.uint8) for _ in range(4)]
    eps = [torch.randn(3, 4, 32 >> b, 64 >> b, generator=g) for b in range(4)]
    rand = torch.randn(3, 4, generator=g)
    want = make_momentum_sampler(system, 3)(*clips, None, eps=eps,
                                            rand_code=rand)
    system.modules.to(cuda)
    per_call = sum(1 for net in ("encz", "encdec")
                   for m in system.modules[net].modules()
                   if getattr(m, "act", "relu") != "relu")
    before = abn.abn_rows.launches
    got = make_momentum_sampler(system, 3)(
        *(c.to(cuda) for c in clips), None, eps=[e.to(cuda) for e in eps],
        rand_code=rand.to(cuda))
    torch.cuda.synchronize()
    assert abn.abn_rows.launches - before == per_call > 0
    for g_, w_ in zip(got, want):
        tol = 1e-4 * (1.0 + float(w_.abs().max()))
        torch.testing.assert_close(g_.cpu(), w_, rtol=1e-4, atol=tol)


@pytest.mark.parametrize("variant", ["fid", "torchvision"])
def test_inception_on_card_matches_cpu(cuda, variant):
    """InceptionV3 (pool3 features, or the torchvision logits) on the card
    under exact_f32 against the CPU, seeded weights and BN statistics, 4
    frames of 128x256. Tolerance 1e-4 * (1 + max): float32 on both sides,
    other convolution algorithms and summation orders; TF32 (about three
    decimal digits per convolution) would not hold it."""
    fid_variant = variant == "fid"
    model = InceptionV3(fid_variant, with_fc=not fid_variant)
    _randomize(model, seed=4)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):  # He-normal, as the init
                m.weight.mul_(2.0**0.5)
    x = torch.rand(4, 128, 256, 3, generator=torch.Generator().manual_seed(5))
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    with torch.inference_mode():
        want = model(x, with_logits=not fid_variant)
        model.to(cuda, memory_format=torch.channels_last)
        got = model(x.to(cuda), with_logits=not fid_variant)
        torch.cuda.synchronize()
    assert tf32 == (torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_tf32)
    assert got.shape == ((4, 2048) if fid_variant else (4, 1000))
    tol = 1e-4 * (1.0 + float(want.abs().max()))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=tol)


# ---- HRNetV2-W48 segmentation ------------------------------------------------

# The (N, C, H, W) that one W48 seg train step (batch 3, 1024x512 crops)
# and one 2048x1024 test forward hand the fused-ABN kernels: stage 1 at
# C 256, the four branches at C 48/96/192/384 (grid steps of 3 where W18's
# were 9); the largest 25.2 M and 33.6 M elements.
W48_TRAIN_SHAPES = [(3, 256, 128, 256), (3, 48, 128, 256), (3, 96, 64, 128),
                    (3, 192, 32, 64), (3, 384, 16, 32)]
W48_TEST_SHAPES = [(1, 256, 256, 512), (1, 48, 256, 512), (1, 96, 128, 256),
                   (1, 192, 64, 128), (1, 384, 32, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("act", ACTS)
def test_fold_entries_match_plain_at_w48_shapes(cuda, dtype, act):
    """Kernel 1 (inference and training entries) at every W48 shape: bit for
    bit for none/leaky_relu, elu within TOL; one launch per call."""
    for i, shape in enumerate(W48_TRAIN_SHAPES + W48_TEST_SHAPES):
        x = _rows_on(shape, dtype, cuda, seed=100 + i)
        stats = _stats_for(shape[1], cuda, seed=100 + i)
        before = abn.abn_rows.launches
        got = abn.fused_abn_infer(x, *stats, 1e-5, 0.01, act)
        y, gamma_inv = abn.abn_fwd_train(x, *stats, 1e-5, 0.01, act)
        assert abn.abn_rows.launches == before + 2
        want = abn.fused_abn_infer_plain(x, *stats, 1e-5, 0.01, act)
        want_y, want_gi = abn.abn_fwd_train_plain(x, *stats, 1e-5, 0.01, act)
        assert torch.equal(gamma_inv, want_gi)
        for g_, w_ in ((got, want), (y, want_y)):
            if act == "elu":
                torch.testing.assert_close(g_, w_, **TOL[dtype])
            else:
                assert torch.equal(g_, w_), shape
        del x, got, want, y, want_y


def _bwd_on(shape, dtype, device, seed, act):
    """``_bwd_inputs`` made on the card (the W48 shapes are large)."""
    n, c, h, w = shape
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn((n, h, w, c), generator=g, device=device) * 1.5
    y = {"none": z, "leaky_relu": torch.where(z >= 0, z, z * 0.01),
         "elu": torch.where(z >= 0, z, torch.expm1(z))}[act]
    dz = torch.randn((n, h, w, c), generator=g, device=device)
    gamma = (torch.rand(c, generator=g, device=device) + 0.5) * torch.sign(
        torch.randn(c, generator=g, device=device))
    beta = torch.randn(c, generator=g, device=device) * 0.3
    mul = gamma * (torch.rand(c, generator=g, device=device) + 0.5)
    return (y.to(dtype).permute(0, 3, 1, 2), dz.to(dtype).permute(0, 3, 1, 2),
            gamma, beta, mul)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", W48_TRAIN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_bwd_kernels_match_plain_at_w48_shapes(cuda, dtype, act, shape):
    """Kernels 2 and 3 at the W48 train step's shapes; kernel 2's scratch
    grows to what C 384 asks for."""
    check_bwd(*_bwd_on(shape, dtype, cuda, shape[1], act), act)


def tiny_seg_step(device):
    """One seg train step of the tiny seg spec in f32 (TF32 off), SGD lr
    1e-2 with momentum and WD, class weights, a fixed batch with ignored
    pixels: (loss, train-mode logits, state dict after)."""
    from vae2_tpu_torch.core.seg_loop import make_seg_train_step
    from vae2_tpu_torch.core.system import make_optimizer
    from vae2_tpu_torch.data.segmentation import CITYSCAPES_CLASS_WEIGHTS
    from vae2_tpu_torch.models.seg_hrnet import get_seg_model

    cfg = get_default_config()
    cfg.merge_from_file(os.path.join(
        REPO, "experiments", "cityscapes", "debug_seg_tiny_32x64.yaml"))
    cfg.GPU.DTYPE = "float32"
    cfg.TRAIN.OPTIMIZER = "sgd"
    cfg.TRAIN.LR = 0.01
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = get_seg_model(cfg)
    _randomize(model, seed=5)
    model.to(device)
    step = make_seg_train_step(model, make_optimizer(model.parameters(),
                                                     cfg.TRAIN),
                               class_weights=CITYSCAPES_CLASS_WEIGHTS)
    g = torch.Generator().manual_seed(6)
    images = torch.randn(2, 32, 64, 3, generator=g).permute(0, 3, 1, 2)
    labels = torch.randint(-1, 19, (2, 32, 64), generator=g)
    logits = []
    hook = model.register_forward_hook(
        lambda m, a, out: logits.append(out.detach().cpu()))
    with exact_f32():
        loss = float(step(images, labels))
    hook.remove()
    return loss, logits[0], {k: v.detach().cpu()
                             for k, v in model.state_dict().items()}


def test_tiny_seg_step_on_card_matches_cpu(cuda):
    """The seg step on the card (kernels 1-3, cuDNN) against the CPU path
    that the CPU tests hold to JAX: loss rtol 1e-4; logits, parameters and
    running statistics 1e-4 * (1 + max)."""
    want = tiny_seg_step("cpu")
    before = abn.abn_bwd_dx.launches
    got = tiny_seg_step(cuda)
    assert abn.abn_bwd_dx.launches > before
    assert abs(got[0] - want[0]) <= 1e-4 * abs(want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-4,
                               atol=1e-4 * (1.0 + float(want[1].abs().max())))
    for k, w_ in want[2].items():
        torch.testing.assert_close(got[2][k], w_, rtol=1e-4,
                                   atol=1e-4 * (1.0 + float(w_.abs().max())))
