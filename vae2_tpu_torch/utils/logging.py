"""Logging setup and a running average (counterpart of
``vae2_tpu/utils/logging.py``; reference lib/utils/utils.py:365-432)."""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path


class AverageMeter:
    """Running average of a scalar (reference utils.py:365-398)."""

    def __init__(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, weight: float = 1.0) -> None:
        self.val = float(val)
        self.sum += float(val) * weight
        self.count += weight

    def value(self) -> float:
        return self.val

    def average(self) -> float:
        return self.sum / self.count if self.count else 0.0


def create_logger(cfg, cfg_name: str, phase: str = "train", rank: int = 0):
    """Create output dirs, a timestamped file+console logger, and a
    tensorboard dir.

    Returns (logger, final_output_dir, tensorboard_log_dir). A rank other
    than 0 of a multi-process run creates nothing and writes no file; its
    logger shows warnings and errors on the console only.
    """
    root_output_dir = Path(cfg.OUTPUT_DIR or "output")
    dataset = cfg.DATASET.DATASET
    model = cfg.MODEL.NAME
    cfg_name = os.path.basename(cfg_name).split(".")[0]
    final_output_dir = root_output_dir / dataset / cfg_name
    time_str = time.strftime("%Y-%m-%d-%H-%M")
    tensorboard_log_dir = (
        Path(cfg.LOG_DIR or "log") / dataset / model / f"{cfg_name}_{time_str}"
    )
    head = "%(asctime)-15s %(message)s"

    logger = logging.getLogger("vae2_tpu_torch")
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    logger.propagate = False
    console = logging.StreamHandler()
    console.setFormatter(logging.Formatter(head))
    logger.addHandler(console)
    if rank != 0:
        logger.setLevel(logging.WARNING)
        return logger, str(final_output_dir), str(tensorboard_log_dir)

    logger.setLevel(logging.INFO)
    final_output_dir.mkdir(parents=True, exist_ok=True)
    log_file = f"{cfg_name}_{time_str}_{phase}.log"
    fh = logging.FileHandler(str(final_output_dir / log_file))
    fh.setFormatter(logging.Formatter(head))
    logger.addHandler(fh)
    tensorboard_log_dir.mkdir(parents=True, exist_ok=True)

    return logger, str(final_output_dir), str(tensorboard_log_dir)
