"""Train the segmentation HRNet (counterpart of tools/train_seg.py; the
reference keeps the seg ``train``/``validate`` engine functions,
lib/core/function.py:607-705, but ships no seg train CLI).

    python -m vae2_tpu_torch.tools.train_seg \
        --cfg experiments/cityscapes/seg_hrnet_w48_train_512x1024.yaml

Runs on CUDA (GPU.DEVICE) unless ``--device cpu``. One device, no resume
(the JAX CLI has none). Writes ``seg_checkpoint.pt`` (model and optimizer)
after every epoch and ``seg_final_state.pt`` at the end under OUTPUT_DIR.
"""

from __future__ import annotations

import argparse
import os
import pprint
from typing import Optional, Sequence

import torch

from ..config import get_default_config, update_config
from ..core.seg_loop import make_seg_train_step, seg_train
from ..core.system import make_optimizer
from ..data.seg_batcher import SegBatcher
from ..data.segmentation import make_seg_dataset
from ..models.seg_hrnet import get_seg_model
from ..utils.checkpoint import save_checkpoint
from ..utils.device import resolve_device
from ..utils.logging import create_logger


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Train segmentation network (PyTorch)")
    parser.add_argument("--cfg", required=True, type=str)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--device", default="",
                        help="'cuda' (default: GPU.DEVICE) or 'cpu'")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Train; returns the output directory."""
    args = parse_args(argv)
    config = update_config(get_default_config(), args)
    device = resolve_device(args.device or config.GPU.DEVICE)
    logger, final_output_dir, tb_log_dir = create_logger(config, args.cfg,
                                                         "train")
    logger.info(pprint.pformat(vars(args)))

    try:
        from tensorboardX import SummaryWriter
        writer_dict = {"writer": SummaryWriter(tb_log_dir),
                       "train_global_steps": 0}
    except ImportError:
        writer_dict = None

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = get_seg_model(config)
    model.to(device)
    optimizer = make_optimizer(model.parameters(), config.TRAIN)

    train_dataset = make_seg_dataset(config, config.DATASET.TRAIN_SET,
                                     train=True,
                                     num_samples=config.TRAIN.NUM_SAMPLES
                                     or None)
    loader = SegBatcher(train_dataset, config.TRAIN.BATCH_SIZE_PER_GPU,
                        shuffle=config.TRAIN.SHUFFLE, seed=args.seed,
                        device=device)
    step = make_seg_train_step(
        model, optimizer,
        ignore_label=config.TRAIN.IGNORE_LABEL,
        use_ohem=config.LOSS.USE_OHEM,
        ohem_thres=config.LOSS.OHEMTHRES,
        ohem_kept=config.LOSS.OHEMKEEP,
        class_weights=(train_dataset.class_weights
                       if config.LOSS.CLASS_BALANCE else None),
        balance_weights=config.LOSS.BALANCE_WEIGHTS)

    epoch_iters = len(loader)
    num_iters = config.TRAIN.END_EPOCH * epoch_iters
    for epoch in range(config.TRAIN.BEGIN_EPOCH, config.TRAIN.END_EPOCH):
        loader.set_epoch(epoch)
        seg_train(config, epoch, config.TRAIN.END_EPOCH, epoch_iters,
                  config.TRAIN.LR, num_iters, loader, step, writer_dict)
        save_checkpoint(os.path.join(final_output_dir, "seg_checkpoint.pt"),
                        model.state_dict(), epoch + 1, optimizer=optimizer)

    save_checkpoint(os.path.join(final_output_dir, "seg_final_state.pt"),
                    model.state_dict(), config.TRAIN.END_EPOCH)
    if writer_dict is not None:
        writer_dict["writer"].close()
    logger.info("Done")
    return final_output_dir


if __name__ == "__main__":
    main()
