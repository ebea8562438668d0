"""The port's per-term gradient attribution
(``vae2_tpu_torch/tools/grad_diagnosis.py`` ``attribute``) against the JAX
package at the tiny debug spec in float32 (batch 2 at 16x32).

Both sides take the weights of ``tests/fixtures/jax_tiny_checkpoint.msgpack``
(the JAX package's bf16 parameters and f32 batch statistics), the same
seeded clips and the same noise: part 1's reparameterization eps and the
encoder's random code, and the draws of part 2's ``generator_loss`` call,
injected as ``tests/test_torch_port_step.py`` injects them (a monkeypatch of
the JAX ``reparameterize``, ``nn.intercept_methods`` on ``ZInject``). The
JAX side computes parts 1 and 2 as tools/grad_diagnosis.py:121-190 does,
through ``vae2_tpu``'s own modules and ``system.generator_loss``, in two
jitted functions, each compiled once and called once per term with a
one-hot cotangent: part 1, the posterior and encoder pass and the vjp of
the five weighted terms on x2p; part 2, the vjp of the six weighted terms
of ``generator_loss`` on the generator's parameters, whose rows are the JAX
tool's six ``jax.grad`` calls. (One vmapped Jacobian took 86 s to compile
here, the vjp 52 s; jit per term, as the tool does, takes minutes.)

Tolerances: the weighted losses rtol 1e-4; every ``grad_x2p_mean_abs``,
``grad_x2p_norm``, ``grad_encdec_norm`` and ``grad_encz_norm`` rtol 3e-2,
the repo's gradient bound (tests/test_torch_port_step.py: one f32 ulp of
input noise moves this net's gradient by 0.66%). The port runs REMAT
'stage', so that each of part 2's backwards recomputes its checkpointed
regions from the retained graph.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax import serialization

from test_torch_port_msgpack import _jax_tiny
from vae2_tpu.core import losses as jlosses
from vae2_tpu.core import system as jax_system
from vae2_tpu.data.loader import normalize_clips as jax_normalize
from vae2_tpu.models import hrnet as jh
from vae2_tpu_torch.config import get_default_config
from vae2_tpu_torch.core.builder import build_system
from vae2_tpu_torch.ops import abn
from vae2_tpu_torch.tools import grad_diagnosis as gd
from vae2_tpu_torch.utils.checkpoint import load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "experiments", "cityscapes",
                        "debug_tiny_32x64.yaml")
CKPT = os.path.join(REPO, "tests", "fixtures", "jax_tiny_checkpoint.msgpack")
B, H, W, Z_DIM = 2, 16, 32, 4
LOSS_RTOL, GRAD_RTOL = 1e-4, 3e-2


def _inputs():
    rng = np.random.RandomState(3)
    clips = {k: rng.randint(0, 256, (B, H, W, 9)).astype(np.uint8)
             for k in ("xt", "x2t", "x3t")}

    def noise():
        return ([rng.randn(B, H >> b, W >> b, Z_DIM).astype(np.float32)
                 for b in range(4)], rng.randn(B, Z_DIM).astype(np.float32))

    return clips, noise(), noise()


def _inject(rand):
    """The encoder's [random-code maps, z maps] get this random code."""
    def inject(next_fun, args, kwargs, context):
        if (isinstance(context.module, jh.ZInject)
                and context.method_name == "__call__" and len(args[1]) == 2):
            xs, maps = args[0], args[1]
            args = (xs, [jh.gen_code_maps(jnp.asarray(rand), xs), maps[1]]) \
                + tuple(args[2:])
        return next_fun(*args, **kwargs)
    return inject


def _tree_norm(t):
    return jnp.sqrt(sum(jnp.sum(jnp.square(x.astype(jnp.float32)))
                        for x in jax.tree.leaves(t)))


def jax_attribution(clips, noise1, noise2):
    """The table of tools/grad_diagnosis.py, computed by the JAX package."""
    system, _ = _jax_tiny()
    with open(CKPT, "rb") as f:
        state = serialization.msgpack_restore(f.read())["state"]
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                          state["params"])
    stats = jax.tree.map(jnp.asarray, state["batch_stats"])
    batch = {k: jax_normalize(jnp.asarray(v)) for k, v in clips.items()}
    hyp = system.hyper
    lam = {"x1_recon": hyp.x1recon_lambda, "x2_recon": hyp.x2recon_lambda,
           "x3_recon": hyp.x3recon_lambda, "z_kl": hyp.x3recon_lambda,
           "gan_seq": hyp.gan_lambda, "gan_frame": hyp.gan_lambda}

    def mod_apply(name, *args, **kw):
        variables = {"params": params[name], "batch_stats": stats[name]}
        out, _ = system.modules[name].apply(
            variables, *args, train=True, mutable=["batch_stats"], **kw)
        return out

    def x2p_terms(x2p, z):
        """The five weighted terms of part 1 as functions of x2p."""
        x1p, x3p = mod_apply("encdec", x2p, z, method="decode")
        d_frame = mod_apply("d_frame", jax_system.fold_frames(x2p, 3))
        vals = {
            "x2_recon": jlosses.l1_loss(x2p, batch["x2t"]),
            "x1_recon": jlosses.l1_loss(x1p, batch["xt"]),
            "x3_recon": jlosses.l1_loss(x3p, batch["x3t"]),
            "gan_seq": 0.5 * jlosses.lsgan_loss(mod_apply("d_seq", x2p),
                                                real=True),
            "gan_frame": 0.5 * (x2p.shape[-1] // 3)
            * jlosses.lsgan_loss(d_frame, real=True)}
        return jnp.stack([jnp.float32(lam[n]) * vals[n]
                          for n in gd.X2P_TERMS])

    @jax.jit
    def part1(eps, rand, cotangent):
        # the posterior and encoder pass (forward_x2p), then one term's
        # value and gradient on x2p: a one-hot cotangent picks the term
        with nn.intercept_methods(_inject(rand)):
            q_in = system._posterior_input(batch["xt"], batch["x2t"],
                                           batch["x3t"])
            mus, logvars = jax_system.split_muvar(mod_apply("encz", q_in),
                                                  hyp.z_dim)
            z = [m + jnp.exp(0.5 * v) * e
                 for m, v, e in zip(mus, logvars, eps)]
            x2p0 = mod_apply("encdec", batch["xt"], z, method="encode",
                             rngs={"sample": jax.random.PRNGKey(1)})
        vals, vjp = jax.vjp(lambda x: x2p_terms(x, z), x2p0)
        g, = vjp(cotangent)
        g = g.astype(jnp.float32)
        return (vals @ cotangent, jnp.mean(jnp.abs(g)),
                jnp.linalg.norm(g.ravel()), jlosses.kl_loss(mus, logvars))

    def reparameterize(mus, logvars, key):
        del key
        return [m + jnp.exp(0.5 * v) * e
                for m, v, e in zip(mus, logvars, noise2[0])]

    def terms(gp):
        with nn.intercept_methods(_inject(noise2[1])):
            _, (metrics, _, _) = system.generator_loss(
                gp, system._d_params(params), stats, batch,
                jax.random.PRNGKey(7), jnp.float32(1.0))
        return jnp.stack([jnp.float32(lam[n]) * metrics[gd.METRICS[n]]
                          for n in gd.TERMS])

    @jax.jit
    def part2(g_params, cotangent):
        # one row of the Jacobian: the gradient of term i (a one-hot
        # cotangent), one backward compiled once for the six
        g, = jax.vjp(terms, g_params)[1](cotangent)
        return _tree_norm(g["encdec"]), _tree_norm(g["encz"])

    eps1 = [jnp.asarray(e) for e in noise1[0]]
    x2p_rows = {n: part1(eps1, noise1[1], jnp.eye(len(gd.X2P_TERMS))[i])
                for i, n in enumerate(gd.X2P_TERMS)}
    kl = x2p_rows["x2_recon"][3]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_system, "reparameterize", reparameterize)
        gp = system._g_params(params)
        param_rows = {n: part2(gp, jnp.eye(len(gd.TERMS))[i])
                      for i, n in enumerate(gd.TERMS)}
    table = {}
    for name in gd.TERMS:
        enc, encz = param_rows[name]
        row = {"grad_encdec_norm": float(enc), "grad_encz_norm": float(encz)}
        if name in x2p_rows:
            val, mean_abs, norm, _ = x2p_rows[name]
            row.update(loss=float(val), grad_x2p_mean_abs=float(mean_abs),
                       grad_x2p_norm=float(norm))
        else:
            row.update(loss=lam[name] * float(kl), grad_x2p_mean_abs=0.0,
                       grad_x2p_norm=0.0)
        table[name] = row
    return table, lam


def port_system():
    cfg = get_default_config()
    cfg.merge_from_file(TINY_CFG)
    cfg.GPU.DTYPE = "float32"
    cfg.TPU.REMAT = "stage"
    system = build_system(cfg)
    state_dict, _ = load_checkpoint(CKPT)
    system.modules.load_state_dict(state_dict, strict=True)
    return system


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def port_noise(noise):
    eps, rand = noise
    return [_nchw(e) for e in eps], torch.from_numpy(rand)


@pytest.fixture(scope="module")
def tables():
    clips, noise1, noise2 = _inputs()
    want, jax_lam = jax_attribution(clips, noise1, noise2)
    system = port_system()
    eps, rand = port_noise(noise1)
    g_eps, g_rand = port_noise(noise2)
    lam = gd.lambdas(system.hyper)
    got = gd.attribute(system, {k: torch.from_numpy(v)
                                for k, v in clips.items()}, lam, eps, rand,
                       g_eps, g_rand)
    return got, want, lam, jax_lam


def test_table_schema_and_lambdas(tables):
    got, want, lam, jax_lam = tables
    assert lam == jax_lam
    assert list(got) == list(want) == list(gd.TERMS)
    for name in gd.TERMS:
        assert list(got[name]) == list(want[name])
    assert got["z_kl"]["grad_x2p_norm"] == 0.0
    assert got["z_kl"]["grad_encdec_norm"] == 0.0
    assert set(gd.relative_pulls(got)) == {"x1_recon", "x3_recon", "gan_seq",
                                           "gan_frame"}


@pytest.mark.parametrize("term", gd.TERMS)
def test_attribution_matches_jax(tables, term):
    got, want, _, _ = tables
    g, w = got[term], want[term]
    gaps = {k: abs(g[k] - w[k]) / max(abs(w[k]), 1e-30) for k in w}
    print(f"{term}: relative gaps {gaps}")
    np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
    for k in ("grad_x2p_mean_abs", "grad_x2p_norm", "grad_encdec_norm",
              "grad_encz_norm"):
        if w[k] == 0.0:
            assert g[k] == 0.0, k
        else:
            np.testing.assert_allclose(g[k], w[k], rtol=GRAD_RTOL, err_msg=k)


def test_attribute_leaves_the_system_as_it_was():
    """Parameters, running statistics, train flags, the discriminators'
    requires_grad and every .grad are as they were."""
    clips, noise1, noise2 = _inputs()
    system = port_system()
    system.modules["d_frame"].eval()
    before = {k: v.clone() for k, v in system.modules.state_dict().items()}
    flags = {k: m.training for k, m in system.modules.items()}
    batch = {k: torch.from_numpy(v) for k, v in clips.items()}
    lam = gd.lambdas(system.hyper)
    first = gd.attribute(system, batch, lam, *port_noise(noise1),
                         *port_noise(noise2))
    after = system.modules.state_dict()
    assert after.keys() == before.keys()
    changed = [k for k in before if not torch.equal(after[k], before[k])]
    assert not changed, changed
    assert {k: m.training for k, m in system.modules.items()} == flags
    assert all(p.requires_grad and p.grad is None
               for p in system.modules.parameters())
    assert all(np.isfinite(v) for row in first.values() for v in row.values())


def test_launches_per_stage_match_the_model(monkeypatch):
    """Each stage's fused-ABN launches, counted by routing every kernel
    call to its plain version with a count (the CUDA branch's bookkeeping),
    equal ``expected_launches`` of the model, under REMAT 'stage' and
    'trunk' (each of part 2's backwards recomputes) and 'none'."""
    counters = {"abn_rows": abn.abn_rows, "fused_abn_infer": abn.abn_rows,
                "abn_fwd_train": abn.abn_rows,
                "abn_bwd_sums": abn.abn_bwd_sums,
                "abn_bwd_dx": abn.abn_bwd_dx}

    def dispatch(name, x, cuda_fn, plain_fn, *args):
        counters[name].launches += 1
        return plain_fn(*args)

    monkeypatch.setattr(abn, "_dispatch", dispatch)
    clips, _, _ = _inputs()
    batch = {k: torch.from_numpy(v) for k, v in clips.items()}
    for remat in ("stage", "trunk", "none"):
        system = port_system()
        for m in system.modules.modules():
            if hasattr(m, "remat"):
                m.remat = remat
        seen = {}
        gd.attribute(system, batch, gd.lambdas(system.hyper),
                     generator=torch.Generator().manual_seed(0),
                     launches=seen)
        want = gd.expected_launches(system)
        assert seen == want, (remat, seen, want)
        assert want["params:x1_recon"]["abn_bwd_sums"] > 0
        if remat != "none":
            assert want["params:x2_recon"]["abn_rows"] > 0
