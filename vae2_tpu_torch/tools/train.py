"""Train the VAE² video-prediction model (counterpart of tools/train.py).

Builds the four networks (encoder-dual-decoder, posterior, sequence and
frame discriminators) and their two optimizers, and runs the adversarial
G/D loop with a checkpoint (``checkpoint.pt``) after every epoch.

    python -m vae2_tpu_torch.tools.train \
        --cfg experiments/cityscapes/vae2_hrnet_w18_small_v2_128x256.yaml \
        DATASET.ROOT data/synthetic64 \
        DATASET.TRAIN_SET data/synthetic64/train_list.txt TRAIN.END_EPOCH 1

Runs on CUDA (GPU.DEVICE) unless ``--device cpu``. ``TRAIN.RESUME True``
(or ``AUTO_RESUME True``) continues from OUTPUT_DIR's ``checkpoint.pt``.
One device; no mesh.
"""

from __future__ import annotations

import argparse
import os
import pprint
import shutil
import timeit
from typing import Optional, Sequence

import torch

from ..config import get_default_config, update_config
from ..core.builder import build_system
from ..core.train_loop import adversarial_train
from ..data.loader import ClipLoader, DevicePrefetcher
from ..data.video import make_dataset
from ..utils.checkpoint import maybe_resume, save_checkpoint
from ..utils.device import resolve_device
from ..utils.logging import create_logger


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Train VAE^2 video prediction (PyTorch)")
    parser.add_argument(
        "--cfg",
        default="experiments/cityscapes/vae2_hrnet_w18_small_v2_128x256.yaml",
        type=str)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--device", default="",
                        help="'cuda' (default: GPU.DEVICE) or 'cpu'")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def _loader(config, list_path: str, seed: int) -> ClipLoader:
    dataset = make_dataset(config, list_path, random_pos=True, seed=seed)
    return ClipLoader(dataset, batch_size=config.TRAIN.BATCH_SIZE_PER_GPU,
                      shuffle=config.TRAIN.SHUFFLE,
                      num_threads=config.WORKERS, seed=seed,
                      prefetch=config.TPU.PREFETCH)


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Train; returns the output directory (checkpoints, ``vis/``)."""
    args = parse_args(argv)
    config = update_config(get_default_config(), args)
    device = resolve_device(args.device or config.GPU.DEVICE)
    logger, final_output_dir, tb_log_dir = create_logger(config, args.cfg,
                                                         "train")
    logger.info(pprint.pformat(vars(args)))
    logger.info(config)

    try:
        from tensorboardX import SummaryWriter
        writer_dict = {"writer": SummaryWriter(tb_log_dir),
                       "train_global_steps": 0, "valid_global_steps": 0}
    except ImportError:
        writer_dict = None

    loader = _loader(config, config.DATASET.TRAIN_SET, args.seed)
    extra_loader = (_loader(config, config.DATASET.EXTRA_TRAIN_SET,
                            args.seed + 1)
                    if config.DATASET.EXTRA_TRAIN_SET else None)

    system = build_system(config, seed=args.seed, device=device, train=True)
    logger.info("parameters: %s", {
        k: sum(p.numel() for p in m.parameters())
        for k, m in system.modules.items()})

    ckpt = os.path.join(final_output_dir, "checkpoint.pt")
    last_epoch = 0
    if config.TRAIN.RESUME or config.AUTO_RESUME:
        resumed = maybe_resume(ckpt, system, map_location=device)
        if resumed is not None:
            last_epoch = resumed
            logger.info("=> loaded checkpoint (epoch %d)", last_epoch)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    start = timeit.default_timer()
    end_epoch = config.TRAIN.END_EPOCH + config.TRAIN.EXTRA_EPOCH
    for epoch in range(last_epoch, end_epoch):
        extra_phase = epoch >= config.TRAIN.END_EPOCH and extra_loader is not None
        cur_loader = extra_loader if extra_phase else loader
        cur_loader.set_epoch(epoch)
        adversarial_train(
            config,
            epoch - config.TRAIN.END_EPOCH if extra_phase else epoch,
            config.TRAIN.EXTRA_EPOCH if extra_phase else config.TRAIN.END_EPOCH,
            system, DevicePrefetcher(cur_loader, device, config.TPU.PREFETCH),
            generator, writer_dict=writer_dict,
            final_output_dir=final_output_dir,
            use_multiplier=config.TRAIN.USE_X2RECON_MULTIPLIER)
        logger.info("=> saving checkpoint to %s", ckpt)
        save_checkpoint(ckpt, system.modules.state_dict(), epoch + 1,
                        system.optimizer_g, system.optimizer_d)
        snap = int(config.TRAIN.SNAPSHOT_EVERY)
        if snap and (epoch + 1) % snap == 0:
            shutil.copy(ckpt, os.path.join(
                final_output_dir, f"checkpoint_epoch{epoch + 1:04d}.pt"))

    save_checkpoint(os.path.join(final_output_dir, "model_final_state.pt"),
                    system.modules.state_dict(), end_epoch)
    if writer_dict is not None:
        writer_dict["writer"].close()
    logger.info("Hours: %d", int((timeit.default_timer() - start) / 3600))
    logger.info("Done")
    return final_output_dir


if __name__ == "__main__":
    main()
