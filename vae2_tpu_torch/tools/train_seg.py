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

import numpy as np
import torch

from ..config import get_default_config, update_config
from ..core.seg_loop import make_seg_train_step, seg_train
from ..core.system import make_optimizer
from ..data.segmentation import make_seg_dataset
from ..models.seg_hrnet import get_seg_model
from ..utils.checkpoint import save_checkpoint
from ..utils.device import resolve_device
from ..utils.logging import create_logger


class _SegBatcher:
    """Batches of a SegDataset: shuffled by ``RandomState(seed + epoch)``,
    the last partial batch dropped (tools/train_seg.py:27-53); images as
    (B, 3, H, W) channels_last float32 and labels as (B, H, W) int32, on
    ``device``."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, device: torch.device = torch.device("cpu")):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.device = device
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def __iter__(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        pin = self.device.type == "cuda"
        for i in range(len(self)):
            chunk = idx[i * self.batch_size: (i + 1) * self.batch_size]
            samples = [self.dataset[j] for j in chunk]
            images = torch.from_numpy(np.stack([s[0] for s in samples]))
            labels = torch.from_numpy(np.stack([s[1] for s in samples]))
            if pin:
                images, labels = images.pin_memory(), labels.pin_memory()
            images = images.to(self.device, non_blocking=True)
            yield (images.permute(0, 3, 1, 2),
                   labels.to(self.device, non_blocking=True), None,
                   [s[3] for s in samples])


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
    loader = _SegBatcher(train_dataset, config.TRAIN.BATCH_SIZE_PER_GPU,
                         shuffle=config.TRAIN.SHUFFLE, seed=args.seed,
                         device=device)
    step = make_seg_train_step(
        model, optimizer,
        ignore_label=config.TRAIN.IGNORE_LABEL,
        use_ohem=config.LOSS.USE_OHEM,
        ohem_thres=config.LOSS.OHEMTHRES,
        ohem_kept=config.LOSS.OHEMKEEP,
        class_weights=(train_dataset.class_weights
                       if config.LOSS.CLASS_BALANCE else None))

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
