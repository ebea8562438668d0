"""Logging setup (counterpart of ``vae2_tpu/utils/logging.py``; reference
lib/utils/utils.py:400-432)."""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path


def create_logger(cfg, cfg_name: str, phase: str = "train"):
    """Create output dirs, a timestamped file+console logger, and a
    tensorboard dir.

    Returns (logger, final_output_dir, tensorboard_log_dir).
    """
    root_output_dir = Path(cfg.OUTPUT_DIR or "output")
    root_output_dir.mkdir(parents=True, exist_ok=True)

    dataset = cfg.DATASET.DATASET
    model = cfg.MODEL.NAME
    cfg_name = os.path.basename(cfg_name).split(".")[0]

    final_output_dir = root_output_dir / dataset / cfg_name
    final_output_dir.mkdir(parents=True, exist_ok=True)

    time_str = time.strftime("%Y-%m-%d-%H-%M")
    log_file = f"{cfg_name}_{time_str}_{phase}.log"
    head = "%(asctime)-15s %(message)s"

    logger = logging.getLogger("vae2_tpu_torch")
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fh = logging.FileHandler(str(final_output_dir / log_file))
    fh.setFormatter(logging.Formatter(head))
    logger.addHandler(fh)
    console = logging.StreamHandler()
    console.setFormatter(logging.Formatter(head))
    logger.addHandler(console)
    logger.propagate = False

    tensorboard_log_dir = (
        Path(cfg.LOG_DIR or "log") / dataset / model / f"{cfg_name}_{time_str}"
    )
    tensorboard_log_dir.mkdir(parents=True, exist_ok=True)

    return logger, str(final_output_dir), str(tensorboard_log_dir)
