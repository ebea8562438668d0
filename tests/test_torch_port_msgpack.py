"""The port's reader of the JAX package's msgpack checkpoints
(``vae2_tpu_torch/utils/msgpack.py``, no msgpack and no flax) against
``flax.serialization.msgpack_restore``, the JAX state it loads against the
JAX forward, the CLIs that take a ``.msgpack``, and the committed fixture.

The fixture ``tests/fixtures/jax_tiny_checkpoint.msgpack`` is a tiny-spec
VAE² state (experiments/cityscapes/debug_tiny_32x64.yaml) written by
``vae2_tpu.utils.checkpoint.save_checkpoint``: parameters drawn with numpy
from seed 0 and stored in bf16 (which keeps the file under 2 MB and has
the reader take flax's 'bfloat16' arrays), f32 batch statistics, the
(empty) state of optax.sgd, epoch 3. ``jax_tiny_outputs.npz`` holds fixed
inputs (clips, z maps, the encoder's random code) and the JAX package's
VAE2EncDec outputs on them, in eval mode, in f32. The card phase of
chip_smoke.py (``jax_checkpoint``) reads both where no JAX is installed.
Rebuild them with ``PYTHONPATH=. python tests/test_torch_port_msgpack.py``.

Tolerance of the forward: |port - jax| <= 1e-4 * (1 + max|jax|), f32, as
tests/test_torch_port_model.py. The rebuilt outputs are held to the
committed ones at 1e-6 * (1 + max): XLA's CPU code may round apart by an
ulp on another CPU; the checkpoint's bytes are held exactly.
"""

import functools
import glob
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn
from flax import serialization

from test_torch_port_model import fill_variables
from test_torch_port_step import _fill
from vae2_tpu.config import get_default_config as jax_default_config
from vae2_tpu.core import system as jax_system
from vae2_tpu.core.builder import build_system as jax_build_system
from vae2_tpu.models import hrnet as jh
from vae2_tpu.models.seg_hrnet import get_seg_model as jax_get_seg_model
from vae2_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from vae2_tpu_torch.config import get_default_config
from vae2_tpu_torch.core.builder import build_system
from vae2_tpu_torch.models.seg_hrnet import get_seg_model
from vae2_tpu_torch.tools import ckpt_checker, inference, train
from vae2_tpu_torch.tools import test as test_cli
from vae2_tpu_torch.utils import msgpack
from vae2_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from vae2_tpu_torch.utils.device import exact_f32
from vae2_tpu_torch.utils.jax_params import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_CFG = os.path.join(REPO, "experiments", "cityscapes",
                        "debug_tiny_32x64.yaml")
SEG_CFG = os.path.join(REPO, "experiments", "cityscapes",
                       "debug_seg_tiny_32x64.yaml")
FIXTURES = os.path.join(REPO, "tests", "fixtures")
CKPT = os.path.join(FIXTURES, "jax_tiny_checkpoint.msgpack")
OUTPUTS = os.path.join(FIXTURES, "jax_tiny_outputs.npz")
DATA = os.path.join(REPO, "data", "synthetic64")
B, H, W, Z_DIM = 2, 32, 64, 4


@functools.lru_cache(maxsize=None)
def _jax_tiny():
    """The JAX tiny-spec system and its state's shapes (traced once)."""
    cfg = jax_default_config()
    cfg.merge_from_file(TINY_CFG)
    cfg.TPU.DTYPE = "float32"
    cfg.TPU.REMAT = "none"
    system = jax_build_system(cfg)
    batch = {k: jnp.zeros((1, H, W, 9), jnp.float32)
             for k in ("xt", "x2t", "x3t")}
    shapes = jax.eval_shape(lambda: system.init(jax.random.PRNGKey(0), batch))
    return system, shapes


def fixture_inputs():
    rng = np.random.RandomState(0)
    xt = rng.randn(B, H, W, 9).astype(np.float32)
    z = [rng.randn(B, H >> b, W >> b, Z_DIM).astype(np.float32)
         for b in range(4)]
    rand = rng.randn(B, Z_DIM).astype(np.float32)
    return xt, z, rand


def jax_encdec(system, params, stats, xt, z, rand):
    """The JAX VAE2EncDec forward in eval mode with this random code."""
    def inject_rand(next_fun, args, kwargs, context):
        if (isinstance(context.module, jh.ZInject)
                and context.method_name == "__call__" and len(args[1]) == 2):
            xs, maps = args[0], args[1]
            args = (xs, [jh.gen_code_maps(jnp.asarray(rand), xs), maps[1]]) \
                + tuple(args[2:])
        return next_fun(*args, **kwargs)

    @jax.jit
    def run(p, s, x_, z_):
        with nn.intercept_methods(inject_rand):
            return system.modules["encdec"].apply(
                {"params": p, "batch_stats": s}, x_, z_, train=False,
                rngs={"sample": jax.random.PRNGKey(1)})

    return [np.asarray(o) for o in run(params["encdec"], stats["encdec"],
                                       jnp.asarray(xt),
                                       [jnp.asarray(a) for a in z])]


def build_fixture(path):
    """Write the checkpoint to ``path``; returns the outputs' arrays."""
    system, shapes = _jax_tiny()
    params, stats = _fill(shapes.params, shapes.batch_stats, seed=0)
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    sgd = optax.sgd(0.01)
    state = jax_system.VAE2State(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state_g=sgd.init(system._g_params(params)),
        opt_state_d=sgd.init(system._d_params(params)))
    jax_save_checkpoint(path, state, epoch=3)
    xt, z, rand = fixture_inputs()
    f32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    x1p, x2p, x3p = jax_encdec(system, f32, stats, xt, z, rand)
    return {"xt": xt, **{f"z{b}": a for b, a in enumerate(z)}, "rand": rand,
            "x1p": x1p, "x2p": x2p, "x3p": x3p}


def _close(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * (1.0 + np.abs(want).max()))


def test_fixture_is_what_the_jax_package_writes(tmp_path):
    path = str(tmp_path / "c.msgpack")
    outputs = build_fixture(path)
    with open(path, "rb") as a, open(CKPT, "rb") as b:
        assert a.read() == b.read()
    assert os.path.getsize(CKPT) < 2 * 2**20
    committed = np.load(OUTPUTS)
    assert sorted(committed.files) == sorted(outputs)
    for k, v in outputs.items():
        _close(committed[k], v, 1e-6)


def _leaves_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _leaves_equal(got[k], want[k], f"{path}/{k}")
        return
    if isinstance(got, torch.Tensor):  # a bf16 leaf
        assert str(np.asarray(want).dtype) == "bfloat16", path
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want, np.float32), err_msg=path)
        return
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, np.ndarray) or np.isscalar(want):
        np.testing.assert_array_equal(got, want, err_msg=path)
        assert np.asarray(got).dtype == np.asarray(want).dtype, path
    else:
        assert got == want, path


def test_reader_equals_flax_on_a_training_checkpoint(tmp_path):
    """A tiny VAE² state with f32 parameters, Adam's state in bf16 moments
    (TPU.ADAM_MOMENT_DTYPE bfloat16: bf16 leaves, an int32 count) and
    f32 (optax.adam), numpy scalars (epoch, step), as the JAX train CLI
    writes it: leaf for leaf what flax restores."""
    system, shapes = _jax_tiny()
    params, stats = _fill(shapes.params, shapes.batch_stats, seed=1)
    cfg = jax_default_config()
    cfg.TRAIN.OPTIMIZER = "adam"
    low = jax_system.make_optimizer(cfg.TRAIN, moment_dtype="bfloat16")
    state = jax_system.VAE2State(
        step=jnp.asarray(5, jnp.int32), params=params, batch_stats=stats,
        opt_state_g=low.init(system._g_params(params)),
        opt_state_d=optax.adam(1e-3).init(system._d_params(params)))
    path = str(tmp_path / "checkpoint.msgpack")
    jax_save_checkpoint(path, state, epoch=2)
    with open(path, "rb") as f:
        blob = f.read()
    want = serialization.msgpack_restore(blob)
    got = msgpack.loads(blob)
    _leaves_equal(got, want)
    assert isinstance(got["epoch"], np.int64) and got["epoch"] == 2
    sd, epoch = load_checkpoint(path)
    assert epoch == 2
    port = build_system(_port_cfg())
    port.modules.load_state_dict(sd, strict=True)


def test_reader_types_and_chunked_arrays():
    """Every msgpack type the reader takes, flax's ext types (ndarrays of
    several dtypes, a complex, numpy scalars, bf16), and arrays in flax's
    chunked layout (written by hand: flax chunks only arrays over 2**30
    bytes), f32 and bf16: what msgpack_restore returns."""
    arr = np.arange(15, dtype=np.float32).reshape(3, 5)
    half = jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3)
    flat, hflat = arr.reshape(-1), np.asarray(half).reshape(-1)
    tree = {
        "ints": {"a": 0, "b": 127, "c": -32, "d": 255, "e": -129,
                 "f": 70000, "g": -70000, "h": 2**40, "i": -2**40,
                 "j": 2**64 - 1},
        "floats": {"a": 1.5, "b": -0.0, "c": 1e300},
        "misc": {"t": True, "f": False, "n": None, "s": "x" * 40,
                 "b": b"\x00\x01" * 200, "l": [1, "two", [3.0]]},
        "np": {"i8": np.arange(4, dtype=np.int8),
               "u16": np.arange(4, dtype=np.uint16).reshape(2, 2),
               "f64": np.linspace(0, 1, 5), "b": np.array([True, False]),
               "empty": np.zeros((0, 3), np.float32),
               "s32": np.int32(-7), "f32": np.float32(0.25),
               "c": complex(1.0, -2.0), "bf": half},
        "chunked": {"__msgpack_chunked_array__": True,
                    "shape": {"0": 3, "1": 5},
                    "chunks": {"0": flat[:8], "1": flat[8:]}},
        "nested": {"h": {"__msgpack_chunked_array__": True,
                         "shape": {"0": 2, "1": 3},
                         "chunks": {"0": hflat[:4], "1": hflat[4:]}}},
        "big": {str(i): i for i in range(20)},
    }
    blob = serialization.msgpack_serialize(tree)
    want = serialization.msgpack_restore(blob)
    got = msgpack.loads(blob)
    np.testing.assert_array_equal(got["chunked"], arr)
    assert got["nested"]["h"].dtype == torch.bfloat16
    _leaves_equal(got, want)
    with pytest.raises(ValueError, match="truncated"):
        msgpack.loads(blob[:-3])


def _port_cfg():
    cfg = get_default_config()
    cfg.merge_from_file(TINY_CFG)
    cfg.GPU.DTYPE = "float32"
    return cfg


def port_forward(system, data, device="cpu"):
    """The port's VAE2EncDec on the fixture's inputs, eval mode, f32."""
    def cl(a):
        return torch.from_numpy(a).to(device).permute(0, 3, 1, 2)

    enc = system.modules["encdec"].eval()
    with torch.inference_mode(), exact_f32():
        out = enc(cl(data["xt"]), [cl(data[f"z{b}"]) for b in range(4)],
                  rand_code=torch.from_numpy(data["rand"]).to(device))
    return [o.permute(0, 2, 3, 1).float().cpu().numpy() for o in out]


def test_loaded_checkpoint_gives_the_jax_forward():
    sd, epoch = load_checkpoint(CKPT)
    assert epoch == 3
    system = build_system(_port_cfg())
    system.modules.load_state_dict(sd, strict=True)
    data = np.load(OUTPUTS)
    for got, k in zip(port_forward(system, data), ("x1p", "x2p", "x3p")):
        _close(got, data[k], 1e-4)


def test_inference_cli_and_train_resume_read_msgpack(tmp_path):
    """The inference CLI with ``--checkpoint <.msgpack>``; the train CLI
    with TRAIN.RESUME over an output directory that holds only the JAX
    package's checkpoint.msgpack: its weights, fresh optimizers, said so."""
    flags = ["--cfg", TINY_CFG, "--device", "cpu"]
    common = ["OUTPUT_DIR", str(tmp_path / "o"), "LOG_DIR",
              str(tmp_path / "l"), "GPU.DTYPE", "float32", "WORKERS", "1"]
    out = inference.main([
        *flags, "--checkpoint", CKPT, "--num-samples", "2", "--no-images",
        *common, "DATASET.ROOT", DATA,
        "DATASET.TEST_SET", os.path.join(DATA, "test_list.txt"),
        "TEST.NUM_SAMPLES", "1", "TEST.BATCH_SIZE_PER_GPU", "1",
        "TPU.INFER_SAMPLE_BATCH", "2"])
    assert glob.glob(os.path.join(out, "vis", "epoch3", "*", "x2tpredict",
                                  "*.txt"))
    lst = tmp_path / "train.txt"
    lst.write_text("".join(os.path.join(DATA, f"synthetic_{i:04d}.zip") + "\n"
                           for i in range(2)))
    run_dir = os.path.join(str(tmp_path / "o"), "cityscapessequence",
                           "debug_tiny_32x64")
    os.makedirs(run_dir, exist_ok=True)
    shutil.copy(CKPT, os.path.join(run_dir, "checkpoint.msgpack"))
    train.main([*flags, *common, "DATASET.ROOT", "/",
                "DATASET.TRAIN_SET", str(lst),
                "TRAIN.END_EPOCH", "4", "TRAIN.RESUME", "True",
                "TRAIN.BATCH_SIZE_PER_GPU", "2", "TRAIN.IMAGE_SIZE",
                "[32, 16]", "PRINT_FREQ", "1"])
    log = "".join(open(p).read() for p in glob.glob(
        os.path.join(run_dir, "*_train.log")))
    assert ("loaded the JAX package's checkpoint" in log
            and "(epoch 3): weights and BN statistics only" in log)
    assert torch.load(os.path.join(run_dir, "checkpoint.pt"),
                      weights_only=True)["epoch"] == 4


def test_seg_test_cli_reads_a_jax_seg_state(tmp_path):
    """The JAX seg CLI's ``seg_final_state.msgpack`` ({params,
    batch_stats}) loads strictly onto the port's SegHRNet, entry for entry
    what ``from_jax_params`` makes of the same tree, and the seg test CLI
    evaluates it as TEST.MODEL_FILE."""
    cfg = jax_default_config()
    cfg.merge_from_file(SEG_CFG)
    cfg.TPU.DTYPE = "float32"
    v = fill_variables(jax_get_seg_model(cfg), jnp.zeros((1, 32, 64, 3)),
                       False)
    path = str(tmp_path / "seg_final_state.msgpack")
    jax_save_checkpoint(path, {"params": v["params"],
                               "batch_stats": v["batch_stats"]}, 2)
    sd, epoch = load_checkpoint(path)
    want = from_jax_params(v["params"], v["batch_stats"])
    assert epoch == 2 and sd.keys() == want.keys()
    assert all(torch.equal(sd[k], want[k]) for k in want)
    tcfg = get_default_config()
    tcfg.merge_from_file(SEG_CFG)
    get_seg_model(tcfg).load_state_dict(sd, strict=True)
    root = os.path.join(REPO, "data", "synthetic_seg")
    result = test_cli.main([
        "--cfg", SEG_CFG, "--device", "cpu", "DATASET.ROOT", root,
        "DATASET.TEST_SET", os.path.join(root, "val.lst"),
        "OUTPUT_DIR", str(tmp_path / "o"), "LOG_DIR", str(tmp_path / "l"),
        "GPU.DTYPE", "float32", "TEST.MODEL_FILE", path])
    assert len(result) == 3 and all(np.isfinite(result))


def test_ckpt_checker(tmp_path, capsys):
    """compare: the JAX fixture against the port .pt of the same state
    (name for name, no difference) and against one with a changed entry;
    rename: the historical typo; import: a reference checkpoint into a port
    .pt of the configured system, on the CPU."""
    sd, _ = load_checkpoint(CKPT)
    pt = str(tmp_path / "same.pt")
    save_checkpoint(pt, sd, epoch=3)
    assert ckpt_checker.main(["compare", "--src", CKPT, "--dst", pt]) == 0
    assert "0 differing common params" in capsys.readouterr().out
    changed = dict(sd)
    key = "encdec.encoder.trunk.conv1.weight"
    changed[key] = changed[key] + 1.0
    save_checkpoint(str(tmp_path / "changed.pt"), changed, epoch=3)
    assert ckpt_checker.compare(ckpt_checker.load_any(CKPT),
                                ckpt_checker.load_any(
                                    str(tmp_path / "changed.pt"))) == 1

    ref = {"encdec_mode.a": torch.ones(2), "d.b": torch.zeros(1)}
    torch.save({"epoch": 1, "state_dict": ref}, str(tmp_path / "r.pth.tar"))
    ckpt_checker.main(["rename", "--src", str(tmp_path / "r.pth.tar"),
                       "--dst", str(tmp_path / "f.pth.tar")])
    fixed = torch.load(str(tmp_path / "f.pth.tar"), weights_only=True)
    assert sorted(fixed["state_dict"]) == ["d.b", "encdec_model.a"]

    from vae2_tpu_torch.utils import torch_import as ti
    system = build_system(_port_cfg(), seed=5)
    ref = {ti.system_key(k): v for k, v in system.modules.state_dict().items()}
    torch.save({"state_dict": ref}, str(tmp_path / "ref.pth"))
    ckpt_checker.main(["import", "--cfg", TINY_CFG, "--src",
                       str(tmp_path / "ref.pth"), "--dst",
                       str(tmp_path / "imp.pt"), "--device", "cpu"])
    assert "imported with 0 unmatched leaves" in capsys.readouterr().out
    got = ckpt_checker.load_any(str(tmp_path / "imp.pt"))
    want = {k: v.numpy() for k, v in system.modules.state_dict().items()}
    assert ckpt_checker.compare(got, want) == 0


if __name__ == "__main__":
    os.makedirs(FIXTURES, exist_ok=True)
    np.savez(OUTPUTS, **build_fixture(CKPT))
    print(f"wrote {CKPT} ({os.path.getsize(CKPT)} bytes) and {OUTPUTS}")
