"""Train the toy 1-D sequence VAE² (counterpart of tools/toy_example.py;
reference tools/toy_example.py): the synthetic sigmoid family, the toy MLP
networks, the whole adversarial G/D loop, a ``checkpoint.pt`` after every
epoch and ``.npy`` dumps of the last batch under ``vis/``.

    python -m vae2_tpu_torch.tools.toy_example \
        --cfg experiments/toyexample/toyexample.yaml [TRAIN.END_EPOCH 5 ...]

Runs on CUDA (GPU.DEVICE) unless ``--device cpu``. TRAIN.USE_X2RECON_MULTIPLIER
anneals the x2-recon weight with the epoch (``utils/schedule.dynamic_coeff``);
``TRAIN.RESUME True`` continues from OUTPUT_DIR's ``checkpoint.pt`` (or the
JAX package's ``checkpoint.msgpack``, weights only).
"""

from __future__ import annotations

import argparse
import os
import pprint
import timeit
from typing import Optional, Sequence

import torch

from ..config import get_default_config, update_config
from ..core.builder import build_system
from ..core.train_loop import adversarial_train
from ..data.toy import ToyLoader
from ..utils.checkpoint import resume_training, save_checkpoint
from ..utils.device import resolve_device
from ..utils.logging import create_logger
from ..utils.summary import log_model_summary


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Train toy VAE^2 (PyTorch)")
    parser.add_argument(
        "--cfg", default="experiments/toyexample/toyexample.yaml", type=str)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--device", default="",
                        help="'cuda' (default: GPU.DEVICE) or 'cpu'")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


class DeviceBatches:
    """A ToyLoader's (numpy batch, names) as (tensors on ``device``,
    names), with its length."""

    def __init__(self, loader: ToyLoader, device: torch.device):
        self.loader, self.device = loader, device

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        for batch, names in self.loader:
            yield ({k: torch.from_numpy(v).to(self.device)
                    for k, v in batch.items()}, names)


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Train; returns the output directory."""
    args = parse_args(argv)
    config = update_config(get_default_config(), args)
    device = resolve_device(args.device or config.GPU.DEVICE)
    logger, final_output_dir, tb_log_dir = create_logger(config, args.cfg,
                                                         "train")
    logger.info(pprint.pformat(vars(args)))
    logger.info(config)

    writer_dict = None
    try:
        from tensorboardX import SummaryWriter
        writer_dict = {"writer": SummaryWriter(tb_log_dir),
                       "train_global_steps": 0, "valid_global_steps": 0}
    except ImportError:
        pass

    loader = ToyLoader(batch_size=config.TRAIN.BATCH_SIZE_PER_GPU,
                       shuffle_seed=args.seed)
    end_epoch = config.TRAIN.END_EPOCH + config.TRAIN.EXTRA_EPOCH
    system = build_system(config, seed=args.seed, device=device, train=True,
                          max_iters=len(loader) * end_epoch)
    log_model_summary(logger, system.modules)

    last_epoch = 0
    if config.TRAIN.RESUME:
        last_epoch = resume_training(final_output_dir, system, device, logger)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    batches = DeviceBatches(loader, device)
    ckpt = os.path.join(final_output_dir, "checkpoint.pt")
    start = timeit.default_timer()
    for epoch in range(last_epoch, end_epoch):
        adversarial_train(
            config, epoch, config.TRAIN.END_EPOCH, system, batches, generator,
            writer_dict=writer_dict, final_output_dir=final_output_dir,
            use_multiplier=config.TRAIN.USE_X2RECON_MULTIPLIER)
        logger.info("=> saving checkpoint to %s", ckpt)
        save_checkpoint(ckpt, system.modules.state_dict(), epoch + 1,
                        optimizer_g=system.optimizer_g,
                        optimizer_d=system.optimizer_d)

    save_checkpoint(os.path.join(final_output_dir, "model_final_state.pt"),
                    system.modules.state_dict(), end_epoch)
    if writer_dict is not None:
        writer_dict["writer"].close()
    logger.info("Hours: %d", int((timeit.default_timer() - start) / 3600))
    logger.info("Done")
    return final_output_dir


if __name__ == "__main__":
    main()
