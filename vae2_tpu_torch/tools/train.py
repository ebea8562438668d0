"""Train the VAE² video-prediction model (counterpart of tools/train.py).

Builds the four networks (encoder-dual-decoder, posterior, sequence and
frame discriminators) and their two optimizers, and runs the adversarial
G/D loop with a checkpoint (``checkpoint.pt``) after every epoch.

    python -m vae2_tpu_torch.tools.train \
        --cfg experiments/cityscapes/vae2_hrnet_w18_small_v2_128x256.yaml \
        DATASET.ROOT data/synthetic64 \
        DATASET.TRAIN_SET data/synthetic64/train_list.txt TRAIN.END_EPOCH 1

Runs on CUDA (GPU.DEVICE) unless ``--device cpu``. ``MODEL.PRETRAINED``,
when the file exists, seeds every trunk from a reference HRNet checkpoint
(``utils.torch_import.import_pretrained_trunk``). ``TRAIN.RESUME True``
(or ``AUTO_RESUME True``) continues from OUTPUT_DIR's ``checkpoint.pt``,
or, where there is none, from the JAX package's ``checkpoint.msgpack`` of
the same OUTPUT_DIR: its weights and BN statistics, with fresh optimizers.

Data parallel across processes under ``torchrun``, one rank per device:

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m vae2_tpu_torch.tools.train --cfg ... [--device cpu] [KEY VALUE ...]

Each rank runs on ``cuda:LOCAL_RANK`` (or the ``--device`` given; with
GPU.DIST_BACKEND gloo several ranks may share one card) and loads its own
shard of TRAIN.BATCH_SIZE_PER_GPU clips per step, so that the global batch
is that times the number of ranks; every BN has SyncBN semantics and the
gradients are averaged over the ranks (``parallel/``). Rank 0 alone logs and
writes checkpoints and ``vis/``. Without the torchrun environment it runs as
one process.
"""

from __future__ import annotations

import argparse
import os
import pprint
import shutil
import timeit
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..config import get_default_config, update_config
from ..core.builder import build_system
from ..core.train_loop import adversarial_train
from ..data.loader import ClipLoader, DevicePrefetcher
from ..data.video import make_dataset
from ..parallel.dist import initialize_distributed, shutdown_distributed
from ..parallel.mesh import broadcast_state, check_mesh
from ..utils.checkpoint import resume_training, save_checkpoint
from ..utils.device import resolve_device
from ..utils.logging import create_logger
from ..utils.summary import (format_rows, log_model_summary,
                             network_summaries)
from ..utils.torch_import import import_pretrained_trunk


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


def _loader(config, list_path: str, seed: int, rank: int,
            world: int) -> ClipLoader:
    dataset = make_dataset(config, list_path, random_pos=True, seed=seed)
    return ClipLoader(dataset, batch_size=config.TRAIN.BATCH_SIZE_PER_GPU,
                      shuffle=config.TRAIN.SHUFFLE,
                      num_threads=config.WORKERS, seed=seed,
                      process_index=rank, process_count=world,
                      prefetch=config.TPU.PREFETCH)


def _rank_device(name: str, local_rank: int, world: int) -> torch.device:
    """The device of this rank: ``name``, or cuda:LOCAL_RANK when ``name``
    is 'cuda' with no index in a multi-process run."""
    device = resolve_device(name)
    if device.type != "cuda":
        return device
    if device.index is None and world > 1:
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"local rank {local_rank} has no CUDA device of its own "
                f"({torch.cuda.device_count()} visible); to share one, pass "
                "--device cuda:0 with GPU.DIST_BACKEND gloo")
        device = torch.device("cuda", local_rank)
    if device.index is not None:
        torch.cuda.set_device(device)  # the kernels launch on the current one
    return device


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Train; returns the output directory (checkpoints, ``vis/``)."""
    args = parse_args(argv)
    config = update_config(get_default_config(), args)
    name = args.device or config.GPU.DEVICE
    owns_group = not dist.is_initialized()
    rank, world, local_rank = initialize_distributed(
        config.GPU.DIST_BACKEND, torch.device(name).type)
    try:
        return _train(args, config, name, rank, world, local_rank)
    finally:
        if owns_group:
            shutdown_distributed()


def _train(args, config, name: str, rank: int, world: int,
           local_rank: int) -> str:
    check_mesh(config, world)
    device = _rank_device(name, local_rank, world)
    logger, final_output_dir, tb_log_dir = create_logger(
        config, args.cfg, "train", rank=rank)
    logger.info(pprint.pformat(vars(args)))
    logger.info(config)
    logger.info("rank %d of %d on %s", rank, world, device)

    writer_dict = None
    if rank == 0:
        try:
            from tensorboardX import SummaryWriter
            writer_dict = {"writer": SummaryWriter(tb_log_dir),
                           "train_global_steps": 0, "valid_global_steps": 0}
        except ImportError:
            pass

    loader = _loader(config, config.DATASET.TRAIN_SET, args.seed, rank, world)
    extra_loader = (_loader(config, config.DATASET.EXTRA_TRAIN_SET,
                            args.seed + 1, rank, world)
                    if config.DATASET.EXTRA_TRAIN_SET else None)

    # updates per optimizer of the whole run, for TRAIN.LR_SCHEDULE 'poly':
    # this rank's steps per epoch, which every rank shares
    end_epoch = config.TRAIN.END_EPOCH + config.TRAIN.EXTRA_EPOCH
    system = build_system(config, seed=args.seed, device=device, train=True,
                          max_iters=len(loader) * end_epoch)
    if config.MODEL.PRETRAINED and os.path.isfile(config.MODEL.PRETRAINED):
        # seed the trunks from an ImageNet/seg HRNet torch checkpoint with
        # the reference's conv1 replication (enc_hrnet.py:753-785)
        missing = import_pretrained_trunk(
            system, config.MODEL.PRETRAINED,
            clip_length=config.TRAIN.CLIP_LENGTH,
            is_baseline=config.MODEL.EXTRA.IS_BASELINE)
        logger.info("=> loaded pretrained %s (%d fresh-init entries)",
                    config.MODEL.PRETRAINED, len(missing))
    log_model_summary(logger, system.modules)
    if config.TPU.LAYER_SUMMARY and rank == 0:
        # the per-layer table (reference modelsummary.py, train.py:92-98)
        width, height = config.TRAIN.IMAGE_SIZE
        for net, info in network_summaries(system, int(height), int(width),
                                           device).items():
            logger.info("per-layer summary of %s (%d FLOPs per forward at "
                        "batch 1):\n%s", net, info["flops"],
                        format_rows(info["rows"]))

    ckpt = os.path.join(final_output_dir, "checkpoint.pt")
    last_epoch = 0
    if config.TRAIN.RESUME or config.AUTO_RESUME:
        last_epoch = resume_training(final_output_dir, system, device, logger)
    broadcast_state(system.modules)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    start = timeit.default_timer()
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
                        optimizer_g=system.optimizer_g,
                        optimizer_d=system.optimizer_d)
        snap = int(config.TRAIN.SNAPSHOT_EVERY)
        if rank == 0 and snap and (epoch + 1) % snap == 0:
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
