"""The benchmark's plain reference against vae2_tpu_torch at a tiny size in
float32 on the CPU, on the same weights and inputs: every network's
forward, the first training step's losses and gradients, prior sampling,
the frame scores and the segmentation step. (The test imports both; the
reference imports neither the program nor JAX.)"""

import pytest
import torch

from benchmark import compare, inputs, run as runner, weights
from benchmark.drivers import seg_train, vae2_prior, vae2_train
from benchmark.reference import nets, scores, steps

from . import tiny

CPU = torch.device("cpu")


def close(a, b, tol=1e-4):
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) <= tol * max(1.0, float(b.abs().max()))


def _vae2(seed=3):
    from vae2_tpu_torch.core.builder import build_system

    p = tiny.parts("vae2_train_b8")
    recipe = p["config"]["recipe"]
    system = build_system(vae2_train._config(recipe), train=True, device=CPU)
    state = weights.make_state(weights.skeleton(lambda: nets.vae2_modules(recipe)), seed, CPU)
    system.modules.load_state_dict(state, strict=True)
    ref = weights.reference_on(CPU, lambda: nets.vae2_modules(recipe), state)
    return p, recipe, system, ref, state


def test_every_vae2_network_forward():
    torch.manual_seed(0)
    p, recipe, system, ref, _ = _vae2()
    w, h = recipe["TRAIN"]["IMAGE_SIZE"]
    z_dim = recipe["MODEL"]["EXTRA"]["Z_DIM"]
    x = torch.randn(2, 9, h, w).contiguous(memory_format=torch.channels_last)
    xx = torch.randn(2, 18, h, w).contiguous(memory_format=torch.channels_last)
    z = [torch.randn(2, z_dim, h >> b, w >> b) for b in range(4)]
    code = torch.randn(2, z_dim)
    with torch.no_grad():
        for got, want in zip(system.modules["encz"](xx), ref["encz"](xx)):
            assert close(got, want)
        for got, want in zip(system.modules["encdec"](x, z, rand_code=code),
                             ref["encdec"](x, z, code)):
            assert close(got, want)
        assert close(system.modules["d_seq"](x), ref["d_seq"](x))
        f = x[:, :3].contiguous(memory_format=torch.channels_last)
        assert close(system.modules["d_frame"](f), ref["d_frame"](f))


def test_first_vae2_step():
    p, recipe, system, ref, state = _vae2(5)
    run = runner.Run(p, 5, CPU)
    pool = vae2_train._pool(run, recipe)
    item = pool[0]
    m, _ = system.train_step(item["batch"], eps=item["eps"], rand_code=item["code"])
    prog = {"losses": [{k: float(m[k]) for k in ("loss_encdec", "loss_D")}],
            "grad": vae2_train.first_grads(system)}
    want = vae2_train.reference_readings(run, recipe, state, pool, 1)
    assert compare.loss_gap(prog["losses"], want["losses"]) < 1e-5
    # BN scales whose gradient is a small difference of large terms (a BN
    # follows them) differ by up to ~1% between two float32 orders
    assert compare.norm_gap(prog["grad"], want["grad"]) < 0.05
    assert sorted(prog["grad"]) == sorted(want["grad"])


def test_prior_sampling_and_scores():
    from vae2_tpu_torch.core import infer_loop
    from vae2_tpu_torch.core.builder import build_system

    p = tiny.parts("vae2_eval_prior_k100")
    recipe = p["config"]["recipe"]
    run = runner.Run(p, 9, CPU)
    g = torch.Generator().manual_seed(1)
    state = vae2_prior.calibrated_state(run, recipe, g)
    system = build_system(vae2_train._config(recipe), device=CPU)
    system.modules.load_state_dict(state, strict=True)
    system.modules.eval()
    w, h = recipe["TRAIN"]["IMAGE_SIZE"]
    clip = inputs.clips(g, 1, h, w, 3, 8, CPU)
    sampler = infer_loop.make_prior_sampler(system, 4, h, w)
    _, x2p, x3p = sampler(clip["xt"], clip["x2t"], torch.Generator().manual_seed(7))
    z, code = steps.prior_draws(torch.Generator().manual_seed(7), 4,
                                recipe["MODEL"]["EXTRA"]["Z_DIM"], h, w, CPU)
    encdec = weights.reference_on(CPU, lambda: nets.vae2_modules(recipe), state)["encdec"].eval()
    _, r2, r3 = steps.prior_samples(encdec, clip["xt"], z, code)
    assert close(x2p, r2) and close(x3p, r3)
    metric = infer_loop.make_metric_fn()
    got = metric(x2p.permute(0, 2, 3, 1), clip["x2t"])
    want = scores.frame_scores(r2.permute(0, 2, 3, 1), clip["x2t"])
    for k in ("recon", "psnr", "ssim", "msssim"):
        assert close(got[k], want[k], 1e-4), k


@pytest.mark.parametrize("seed", [1, 2])
def test_seg_forward_and_step(seed):
    from vae2_tpu_torch.models.seg_hrnet import get_seg_model

    p = tiny.parts("seg_w48_train_b3")
    recipe = p["config"]["recipe"]
    model = get_seg_model(vae2_train._config(recipe))
    state = weights.make_state(weights.skeleton(lambda: nets.seg_module(recipe)), seed, CPU)
    model.load_state_dict(state, strict=True)
    ref = weights.reference_on(CPU, lambda: nets.seg_module(recipe), state)
    x = torch.randn(2, 3, 32, 64).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        assert close(model(x), ref(x))
    run = runner.Run(p, seed, CPU)
    st = seg_train.setup(run)
    for k in ("model", "optimizer", "step"):
        st.pop(k)
    want = seg_train.reference_readings(run, recipe, st["state0"], st["pool"], 3,
                                        p["config"]["class_weights"])
    numbers = compare.train_numbers(st["prog"], want)
    assert numbers["loss_gap"] < 1e-5 and numbers["grad_gap"] < 1e-3
    assert numbers["update_gap"] < 1e-2
