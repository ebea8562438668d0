"""The LIP and PASCAL-Context segmentation recipes in vae2_tpu_torch against
the JAX package, on the CPU: each recipe (experiments/lip/
seg_hrnet_w48_473x473.yaml, experiments/pascal_ctx/seg_hrnet_w48_480x480.yaml)
with the tiny seg spec's stages (experiments/cityscapes/
debug_seg_tiny_32x64.yaml) in f32, at an odd crop of 57x57: the stem's two
stride-2 convolutions give 29 and 15 rows, so branches of 15/8/4/2, odd or
uneven at every step.

- ``gen_seg_data --dataset`` writes each recipe's label ids (LIP 0-19;
  PASCAL-Context raw ids 0-59, of which 0 becomes the ignore label), which
  the recipe's dataset class reads through its own augmentation
  (multi-scale, flip; LIP's left/right label swap);
- one ``make_seg_train_step`` step (the recipe's SGD, WD and momentum; no
  class weights) on two such samples against the JAX package's step from
  the same numpy-filled weights: loss to rtol 1e-4, updated parameters and
  running statistics to 1e-4 * (1 + max|jax|), the tolerance of
  tests/test_torch_port_seg_model.py;
- LIP's flip TTA (``flip_tta`` with the dataset's flip pairs: the left and
  right parts' logits swapped) against ``vae2_tpu.core.seg_loop.flip_tta``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_port_model import assert_close, fill_variables, nhwc
from vae2_tpu.config import get_default_config as jax_default_config
from vae2_tpu.core import seg_loop as jsl
from vae2_tpu.core.system import make_optimizer as jax_make_optimizer
from vae2_tpu.models.seg_hrnet import get_seg_model as jax_get_seg_model
from vae2_tpu_torch.config import get_default_config
from vae2_tpu_torch.core import seg_loop as tsl
from vae2_tpu_torch.core.system import make_optimizer
from vae2_tpu_torch.data.segmentation import make_seg_dataset
from vae2_tpu_torch.models.seg_hrnet import get_seg_model
from vae2_tpu_torch.tools.gen_seg_data import write_synthetic_seg
from vae2_tpu_torch.utils.jax_params import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = {"lip": os.path.join(REPO, "experiments", "lip",
                               "seg_hrnet_w48_473x473.yaml"),
           "pascal_ctx": os.path.join(REPO, "experiments", "pascal_ctx",
                                      "seg_hrnet_w48_480x480.yaml")}
TINY = os.path.join(REPO, "experiments", "cityscapes",
                    "debug_seg_tiny_32x64.yaml")
CROP, SIZE, B = 57, 72, 2  # the crop; the generated images are SIZE^2


def _tiny_stages():
    """The tiny seg spec's stages, as config overrides."""
    with open(TINY) as f:
        extra = yaml.safe_load(f)["MODEL"]["EXTRA"]
    return [item for i in range(1, 5) for key in (
        "NUM_MODULES", "NUM_BRANCHES", "NUM_BLOCKS", "NUM_CHANNELS")
        for item in (f"MODEL.EXTRA.STAGE{i}.{key}",
                     str(extra[f"STAGE{i}"][key]))]


def _configure(cfg, recipe, root=""):
    cfg.merge_from_file(RECIPES[recipe])
    cfg.merge_from_list(_tiny_stages() + [
        "TPU.DTYPE", "float32", "TRAIN.IMAGE_SIZE", f"[{CROP}, {CROP}]",
        "TRAIN.BASE_SIZE", str(SIZE), "DATASET.ROOT", root])
    return cfg


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


@pytest.fixture(scope="module", params=sorted(RECIPES))
def recipe(request, tmp_path_factory):
    """(name, port config, a batch of B train samples (NHWC images,
    labels), the JAX model and its numpy-filled weights)."""
    name = request.param
    root = str(tmp_path_factory.mktemp(name))
    train, _ = write_synthetic_seg(root, SIZE, SIZE, train=B, val=0,
                                   dataset=name)
    cfg = _configure(get_default_config(), name, root)
    data = make_seg_dataset(cfg, train, train=True, seed=0)
    samples = [data[i] for i in range(B)]
    x = np.stack([s[0] for s in samples]).astype(np.float32)
    labels = np.stack([s[1] for s in samples]).astype(np.int32)
    jmodel = jax_get_seg_model(_configure(jax_default_config(), name))
    variables = fill_variables(jmodel, jnp.asarray(x), False, seed=1)
    return name, cfg, data, x, labels, jmodel, variables


def _port_model(cfg, variables):
    model = get_seg_model(cfg)
    model.load_state_dict(from_jax_params(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"])), strict=True)
    return model


def test_generated_labels_are_the_recipes_classes(recipe):
    """The samples' labels lie in the recipe's classes (or ignore): LIP
    0-19; PASCAL-Context 0-58 after the 59-class shift, raw 0 as -1."""
    name, cfg, data, x, labels, _, _ = recipe
    assert x.shape == (B, CROP, CROP, 3) and labels.shape == (B, CROP, CROP)
    classes = int(cfg.DATASET.NUM_CLASSES)
    assert classes == {"lip": 20, "pascal_ctx": 59}[name]
    valid = labels[labels != cfg.TRAIN.IGNORE_LABEL]
    assert valid.size and valid.min() >= 0 and valid.max() < classes
    if name == "lip":
        assert data.flip_pairs
    else:  # raw 0 (background) is ignored under the 59-class mode
        raw = np.array([[0, 1, 59]], np.uint8)
        np.testing.assert_array_equal(data.convert_label(raw),
                                      [[cfg.TRAIN.IGNORE_LABEL, 0, 58]])


def test_recipe_train_step_matches_jax(recipe):
    name, cfg, data, x, labels, jmodel, variables = recipe
    jcfg = _configure(jax_default_config(), name)
    tx = jax_make_optimizer(jcfg.TRAIN)
    jstep = jsl.make_seg_train_step(jmodel, tx,
                                    ignore_label=jcfg.TRAIN.IGNORE_LABEL)
    params = variables["params"]
    new_p, new_s, _, jloss = jstep(params, variables["batch_stats"],
                                   tx.init(params), jnp.asarray(x),
                                   jnp.asarray(labels))
    want = from_jax_params(jax.tree.map(np.asarray, new_p),
                           jax.tree.map(np.asarray, new_s))
    model = _port_model(cfg, variables)
    step = tsl.make_seg_train_step(
        model, make_optimizer(model.parameters(), cfg.TRAIN),
        ignore_label=cfg.TRAIN.IGNORE_LABEL, class_weights=data.class_weights)
    loss = step(_nchw(x), torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert_close(got[k].numpy(), v.numpy())


def test_lip_flip_tta_swaps_the_pairs_as_jax(recipe):
    """LIP's flip TTA on the odd crop (PASCAL-Context's recipe tests
    without flip)."""
    name, cfg, data, x, _, jmodel, variables = recipe
    if name != "lip":
        assert not cfg.TEST.FLIP_TEST and data.flip_pairs is None
        return
    assert cfg.TEST.FLIP_TEST
    want = np.asarray(jsl.flip_tta(jsl.make_infer_fn(jmodel, variables),
                                   jnp.asarray(x[:1]), data.flip_pairs))
    got = tsl.flip_tta(tsl.make_infer_fn(_port_model(cfg, variables)),
                       _nchw(x[:1]), data.flip_pairs)
    assert got.shape == (1, 20, CROP, CROP)
    assert_close(nhwc(got), want)
