"""Segmentation evaluation CLI (counterpart of tools/test.py; reference
tools/test.py).

Builds the seg HRNet, loads TEST.MODEL_FILE (a port ``.pt``, the JAX
package's ``seg_final_state.msgpack``, or a reference ``.pth``/``.tar``
through ``utils.torch_import``; without one it warns and
evaluates the random init) and runs ``seg_testval`` (mIoU, pixel and mean
accuracy, with the optional multi-scale/flip TTA) or, when the list file's
name holds "test", ``seg_test`` (predictions saved as PNGs).

    python -m vae2_tpu_torch.tools.test \
        --cfg experiments/cityscapes/seg_hrnet_w48_train_512x1024.yaml \
        TEST.MODEL_FILE output/cityscapes/seg_hrnet_w48_train_512x1024/seg_final_state.pt

Runs on CUDA (GPU.DEVICE) unless ``--device cpu``. Returns (mIoU, pixel
accuracy, mean accuracy), or None for a test split.
"""

from __future__ import annotations

import argparse
import os
import pprint
from typing import Optional, Sequence

import torch

from ..config import get_default_config, update_config
from ..core.seg_loop import seg_test, seg_testval
from ..data.segmentation import make_seg_dataset
from ..models.seg_hrnet import get_seg_model
from ..utils.checkpoint import load_checkpoint
from ..utils.device import resolve_device
from ..utils.logging import create_logger
from ..utils.torch_import import import_seg_checkpoint


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Test segmentation network (PyTorch)")
    parser.add_argument("--cfg", required=True, type=str)
    parser.add_argument("--device", default="",
                        help="'cuda' (default: GPU.DEVICE) or 'cpu'")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    config = update_config(get_default_config(), args)
    device = resolve_device(args.device or config.GPU.DEVICE)
    logger, final_output_dir, _ = create_logger(config, args.cfg, "test")
    logger.info(pprint.pformat(vars(args)))

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = get_seg_model(config)
    model_file = config.TEST.MODEL_FILE or os.path.join(
        final_output_dir, "seg_final_state.pt")
    if model_file.endswith((".pth", ".pth.tar", ".tar")):
        missing = import_seg_checkpoint(model, model_file)
        logger.info("imported torch seg checkpoint (%d unmatched)",
                    len(missing))
    elif os.path.isfile(model_file):
        state_dict, _ = load_checkpoint(model_file)
        model.load_state_dict(state_dict, strict=True)
        logger.info("loaded %s", model_file)
    else:
        logger.warning("no checkpoint found at %s — evaluating random init",
                       model_file)
    model.to(device)

    test_dataset = make_seg_dataset(config, config.DATASET.TEST_SET,
                                    train=False,
                                    num_samples=config.TEST.NUM_SAMPLES or None)
    if "test" in os.path.basename(config.DATASET.TEST_SET).lower():
        seg_test(config, test_dataset, model, final_output_dir)
        return None
    mean_iou, iou_array, pixel_acc, mean_acc = seg_testval(
        config, test_dataset, model, final_output_dir, sv_pred=False)
    logger.info("MeanIU: %.4f, Pixel_Acc: %.4f, Mean_Acc: %.4f",
                mean_iou, pixel_acc, mean_acc)
    logger.info("%s", iou_array)
    return float(mean_iou), float(pixel_acc), float(mean_acc)


if __name__ == "__main__":
    main()
