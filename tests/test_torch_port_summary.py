"""vae2_tpu_torch's model summary (utils/summary.py, tools/model_summary.py)
against the JAX package's: parameter counts per network and per submodule
equal ``vae2_tpu.utils.summary.count_params`` exactly (the JAX trees are
shaped by ``jax.eval_shape``, so no init graph runs), for the tiny spec,
the flagship W18-small-v2 recipe and the toy family; FLOPs as
FlopCounterMode counts them, 2 per multiply-add of a convolution."""

import os

import jax
import jax.numpy as jnp
import pytest
import torch

from vae2_tpu.config import get_default_config as jax_default_config
from vae2_tpu.core.builder import build_system as jax_build_system
from vae2_tpu.utils.summary import count_params as jax_count_params
from vae2_tpu_torch.config import get_default_config
from vae2_tpu_torch.core.builder import build_system
from vae2_tpu_torch.tools import model_summary
from vae2_tpu_torch.utils.summary import (count_params, layer_rows,
                                          network_summaries)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = {
    "tiny": "experiments/cityscapes/debug_tiny_32x64.yaml",
    "flagship": "experiments/cityscapes/vae2_hrnet_w18_small_v2_128x256.yaml",
    "toy": "experiments/toyexample/toyexample.yaml",
}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_param_counts_equal_jax(recipe):
    path = os.path.join(REPO, RECIPES[recipe])
    jcfg = jax_default_config()
    jcfg.merge_from_file(path)
    jsys = jax_build_system(jcfg)
    shape = (1, 10) if recipe == "toy" else (1, 16, 32, 9)
    batch = {k: jnp.zeros(shape, jnp.float32) for k in ("xt", "x2t", "x3t")}
    params = jax.eval_shape(
        lambda: jsys.init(jax.random.PRNGKey(0), batch)).params
    cfg = get_default_config()
    cfg.merge_from_file(path)
    port = build_system(cfg)
    assert set(port.modules) == set(params)
    for name, tree in params.items():
        net = port.modules[name]
        assert count_params(net) == jax_count_params(tree), name
        children = dict(net.named_children())
        assert set(children) == set(tree), name
        for sub, subtree in tree.items():
            assert count_params(children[sub]) == jax_count_params(subtree), \
                (name, sub)


@pytest.mark.parametrize("k,stride", [(3, 1), (1, 1), (3, 2)])
def test_conv_flops(k, stride):
    c_in, c_out, h, w = 6, 10, 12, 20
    conv = torch.nn.Conv2d(c_in, c_out, k, stride=stride, padding=k // 2)
    rows, total = layer_rows(conv, torch.zeros(1, c_in, h, w))
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    assert total == rows[0]["flops"] == 2 * k * k * c_in * c_out * ho * wo
    assert rows[0]["params"] == c_out * (c_in * k * k + 1)
    assert rows[0]["in"] == [1, c_in, h, w]
    assert rows[0]["out"] == [1, c_out, ho, wo]


def test_model_summary_cli_on_cpu(capsys):
    """The tool on the tiny spec: every network, its table, one JSON line;
    a network's FLOPs are its children's sum (the convolutions live in the
    children)."""
    nets = model_summary.main(["--cfg", os.path.join(REPO, RECIPES["tiny"]),
                               "--device", "cpu", "--depth", "1"])
    out = capsys.readouterr().out
    assert set(nets) == {"encz", "encdec", "d_seq", "d_frame"}
    assert '"networks"' in out.splitlines()[-1]
    for name in nets:
        assert f"== {name} ==" in out
    cfg = get_default_config()
    cfg.merge_from_file(os.path.join(REPO, RECIPES["tiny"]))
    system = build_system(cfg, seed=0)
    rows = network_summaries(system, 32, 64, depth=1)["encdec"]["rows"]
    assert rows[0]["flops"] == sum(r["flops"] for r in rows[1:]) \
        == nets["encdec"]["flops"]
    assert rows[0]["params"] == nets["encdec"]["params"] == count_params(
        system.modules["encdec"])
