"""Card tests of vae2_tpu_torch: the fused-ABN CUDA kernel against its plain
PyTorch version, and the tiny VAE2EncDec.sample on the card against the CPU.
They need an NVIDIA Hopper GPU and nvcc, carry the ``gpu`` marker, and skip
elsewhere. This file imports nothing of JAX, so it runs where JAX is absent:

    python -m pytest tests/test_torch_port_gpu.py -m gpu

Tolerances: f32 1e-6 (rtol and atol; elu's expf may differ from
torch.exp in the last bit); bf16 one bf16 ulp (rtol 2**-7) for the same
reason, after the multiply and the add, which both round alike.
"""

import os
import unittest.mock

import pytest
import torch

from vae2_tpu_torch.config import get_default_config
from vae2_tpu_torch.core.builder import build_system
from vae2_tpu_torch.ops import abn
from vae2_tpu_torch.utils.device import exact_f32

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
    before = abn.fused_abn_infer.launches
    got = abn.fused_abn_infer(x, *stats, 1e-5, 0.01, act)
    torch.cuda.synchronize()
    assert abn.fused_abn_infer.launches == before + 1
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
        before = abn.fused_abn_infer.launches
        got = net.sample(x, z, rand_code=rand)
        torch.cuda.synchronize()
    assert abn.fused_abn_infer.launches > before
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
