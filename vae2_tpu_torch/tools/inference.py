"""Stochastic multi-sample inference/eval (counterpart of
tools/inference.py).

Loads a port checkpoint (``.pt``) or the JAX package's (``.msgpack``) and,
for every test clip, draws NUM_SAMPLES prior
or momentum rollouts, dumping per-sample SSIM/MS-SSIM/L1/PSNR txt trees
(read by tools/statistic.py) and, unless --no-images, the predicted frames
as PNGs (read by the port's tools/fid_score.py and tools/inception_score.py).

    python -m vae2_tpu_torch.tools.inference \
        --cfg experiments/cityscapes/inference_vae2_128x256.yaml \
        --checkpoint ckpt.pt --num-samples 64 \
        [--clip-num 5 --sampling-mode momentum_sampling] \
        DATASET.ROOT data/synthetic64 \
        DATASET.TEST_SET data/synthetic64/test_list.txt TEST.NUM_SAMPLES 2

Runs on CUDA (GPU.DEVICE) unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import pprint
from typing import Optional, Sequence

import torch

from ..config import get_default_config, update_config
from ..core.builder import build_system
from ..core.infer_loop import run_inference
from ..data.loader import ClipLoader
from ..data.video import make_dataset
from ..utils.checkpoint import load_checkpoint
from ..utils.device import resolve_device
from ..utils.logging import create_logger


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="VAE^2 inference (PyTorch)")
    parser.add_argument(
        "--cfg",
        default="experiments/cityscapes/vae2_hrnet_w18_small_v2_128x256.yaml",
        type=str)
    parser.add_argument("--checkpoint", default="", type=str,
                        help="comma-separated port checkpoints (.pt) or "
                             "the JAX package's (.msgpack) (default: "
                             "OUTPUT_DIR's checkpoint.pt)")
    parser.add_argument("--num-samples", default=100, type=int)
    parser.add_argument(
        "--clip-num", default=3, type=int, choices=(3, 5),
        help="clips per eval sample; 5 enables the momentum-eval window "
             "layout (reference function.py:109-115)")
    parser.add_argument(
        "--sampling-mode", default="prior_sampling",
        choices=("prior_sampling", "momentum_sampling"),
        help="momentum_sampling draws z from the previous window's "
             "posterior (reference utils.py:186-207; needs --clip-num 5)")
    parser.add_argument("--no-images", action="store_true",
                        help="skip PNG dumps, write metric txts only")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--device", default="",
                        help="'cuda' (default: GPU.DEVICE) or 'cpu'")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Run the sweep; returns the output directory (its ``vis/`` holds the
    metric tree)."""
    args = parse_args(argv)
    if args.sampling_mode == "momentum_sampling" and args.clip_num != 5:
        raise SystemExit("--sampling-mode momentum_sampling needs --clip-num 5")
    config = update_config(get_default_config(), args)
    device = resolve_device(args.device or config.GPU.DEVICE)
    logger, final_output_dir, _ = create_logger(config, args.cfg, "inference")
    logger.info(pprint.pformat(vars(args)))

    system = build_system(config)
    system.modules.to(device).eval()

    # Eval data: fixed clip position, no shuffle (reference
    # tools/inference.py:116-133).
    dataset = make_dataset(config, config.DATASET.TEST_SET, random_pos=False,
                           num_samples=config.TEST.NUM_SAMPLES or None,
                           clip_num=args.clip_num)
    loader = ClipLoader(
        dataset, batch_size=config.TEST.BATCH_SIZE_PER_GPU, shuffle=False,
        drop_last=False, num_threads=config.WORKERS,
        prefetch=config.TPU.PREFETCH)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    ckpts = ([c for c in args.checkpoint.split(",") if c]
             if args.checkpoint
             else [os.path.join(final_output_dir, "checkpoint.pt")])
    for ckpt in ckpts:
        state_dict, epoch = load_checkpoint(ckpt, map_location=device)
        system.modules.load_state_dict(state_dict, strict=True)
        logger.info("=> loaded checkpoint %s (epoch %d)", ckpt, epoch)
        run_inference(config, system, loader, final_output_dir, epoch,
                      generator, num_samples=args.num_samples,
                      save_images=not args.no_images,
                      sampling_mode=args.sampling_mode)
    logger.info("Done")
    return final_output_dir


if __name__ == "__main__":
    main()
