"""Toy inference: prior-sampled rollouts and the posterior-collapse
diagnostics (counterpart of tools/toy_example_inference.py; reference
tools/toy_example_inference.py, lib/core/function.py:155-219).

For each batch of alphas it draws ``--num-samples`` prior-sampled
predictions and, for the batch's last curve, maps the values back to the h
axis (inverse sigmoid) into ``gt_axis.txt``, ``x2t_axis.txt`` and
``x3t_axis.txt`` under ``vis/epoch<N>/<name>/``; where matplotlib is
installed it also draws the scatter plots ``prd.pdf`` and ``gt.pdf``.

    python -m vae2_tpu_torch.tools.toy_example_inference \
        --cfg experiments/toyexample/toyexample.yaml [--checkpoint ckpt.pt]

Runs on CUDA (GPU.DEVICE) unless ``--device cpu``; reads a port ``.pt`` or
the JAX package's ``.msgpack`` (default: OUTPUT_DIR's checkpoint.pt).
"""

from __future__ import annotations

import argparse
import importlib.util
import math
import os
import pprint
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import get_default_config, update_config
from ..core.builder import build_system
from ..data.toy import ToyLoader
from ..utils.checkpoint import load_checkpoint
from ..utils.device import resolve_device
from ..utils.logging import create_logger

MARKERS = ["o", "v", "1", "s", "p", "*", "h", "D", "|", "^",
           "2", "P", "d", "<", "3", "H", "+", "X", ">", "4"]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Toy VAE^2 inference "
                                                 "(PyTorch)")
    parser.add_argument(
        "--cfg", default="experiments/toyexample/toyexample.yaml", type=str)
    parser.add_argument("--checkpoint", default="", type=str)
    parser.add_argument("--num-samples", default=100, type=int)
    parser.add_argument("--batch-size", default=100, type=int)
    parser.add_argument("--num-batches", default=5, type=int)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--device", default="",
                        help="'cuda' (default: GPU.DEVICE) or 'cpu'")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def inv_sigmoid(vals, alpha):
    """Map function values back to the h axis (function.py:166-171)."""
    return [-math.log(1.0 / min(max(float(v), 1e-5), 0.99999) - 1.0) / alpha
            for v in vals]


def write_axis_dumps(save_path, alpha, batch, preds_list) -> None:
    """gt_axis.txt (the future's h axis) and one line per sample of
    x2t_axis.txt / x3t_axis.txt (function.py:155-219), appended."""
    os.makedirs(save_path, exist_ok=True)
    with open(os.path.join(save_path, "gt_axis.txt"), "a") as f:
        f.write(" ".join(map(str, inv_sigmoid(batch["x3t"][-1], alpha)))
                + "\n")
    with open(os.path.join(save_path, "x2t_axis.txt"), "a") as f2, \
            open(os.path.join(save_path, "x3t_axis.txt"), "a") as f3:
        for _, x2p, x3p in preds_list:
            f2.write(" ".join(map(str, inv_sigmoid(x2p[-1], alpha))) + "\n")
            f3.write(" ".join(map(str, inv_sigmoid(x3p[-1], alpha))) + "\n")


def scatter_plots(save_path, alpha, batch, preds_list, is_baseline) -> None:
    """prd.pdf and gt.pdf (function.py:155-219); needs matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xt, x2t, x3t = (batch[k][-1] for k in ("xt", "x2t", "x3t"))
    colors = ["g"] * 10 if is_baseline else ["y"] * 10 + ["g"] * 10
    x1_axis = inv_sigmoid(xt, alpha)
    x2_axis = inv_sigmoid(x2t, alpha)
    x3_axis = inv_sigmoid(x3t, alpha)

    plt.figure()
    plt.xlim(-1.6, 1.6)
    plt.ylim(-0.1, 1.1)
    plt.xlabel("h")
    plt.ylabel("value")
    plt.grid(ls="--")
    cond_axis = x1_axis + x2_axis if is_baseline else x1_axis
    cond_vals = list(xt) + list(x2t) if is_baseline else list(xt)
    plt.scatter(cond_axis, cond_vals, c="r", alpha=0.3, marker="x")
    tgt_axis = x3_axis if is_baseline else x2_axis + x3_axis
    tgt_vals = list(x3t) if is_baseline else list(x2t) + list(x3t)
    for i, (a, v) in enumerate(zip(tgt_axis, tgt_vals)):
        plt.scatter(a, v, c="r", marker=MARKERS[10 + i if is_baseline else i],
                    alpha=0.3)
    for _, x2p, x3p in preds_list:
        p2_axis = inv_sigmoid(x2p[-1], alpha)
        p3_axis = inv_sigmoid(x3p[-1], alpha)
        axis = p2_axis if is_baseline else p2_axis + p3_axis
        vals = list(x2p[-1]) if is_baseline else list(x2p[-1]) + list(x3p[-1])
        for i, (a, v) in enumerate(zip(axis, vals)):
            plt.scatter(a, v, c=colors[i],
                        marker=MARKERS[10 + i if is_baseline else i], alpha=0.1)
    plt.savefig(os.path.join(save_path, "prd.pdf"), bbox_inches="tight")
    plt.close()

    plt.figure()
    plt.xlim(-1.5, 1.5)
    plt.ylim(-0.1, 1.1)
    plt.xlabel("h")
    plt.ylabel("value")
    plt.grid(ls="--")
    plt.scatter(x1_axis, list(xt), c="b", alpha=0.9, marker="x")
    for i, (a, v) in enumerate(zip(x2_axis + x3_axis, list(x2t) + list(x3t))):
        plt.scatter(a, v, c="b", marker=MARKERS[i], alpha=0.9)
    for axis_vals, vals in ((x1_axis, xt), (x2_axis, x2t), (x3_axis, x3t)):
        for idx, (a, v) in enumerate(zip(axis_vals, vals)):
            if idx % 3 == 0:
                plt.annotate(f"t={a:.2f}", (a, v))
    plt.savefig(os.path.join(save_path, "gt.pdf"), bbox_inches="tight")
    plt.close()


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Sample and dump; returns the output directory."""
    args = parse_args(argv)
    config = update_config(get_default_config(), args)
    device = resolve_device(args.device or config.GPU.DEVICE)
    logger, final_output_dir, _ = create_logger(config, args.cfg, "inference")
    logger.info(pprint.pformat(vars(args)))

    system = build_system(config)
    system.modules.to(device).eval()
    ckpt = args.checkpoint or os.path.join(final_output_dir, "checkpoint.pt")
    state_dict, epoch = load_checkpoint(ckpt, map_location=device)
    system.modules.load_state_dict(state_dict, strict=True)
    logger.info("=> loaded checkpoint %s (epoch %d)", ckpt, epoch)
    plots = importlib.util.find_spec("matplotlib") is not None
    if not plots:
        logger.info("matplotlib is not installed: prd.pdf and gt.pdf are "
                    "not drawn, the txt dumps are written")

    loader = ToyLoader(batch_size=args.batch_size, shuffle_seed=args.seed,
                       num_batches=args.num_batches)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    is_baseline = config.MODEL.EXTRA.IS_BASELINE
    for batch_np, names in loader:
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch_np.items()}
        preds_list = []
        for _ in range(args.num_samples):
            preds, _ = system.eval_step(batch, generator, "prior_sampling")
            preds_list.append(tuple(p.float().cpu().numpy() for p in preds))
        name = names[-1]
        alpha = float(name.split("alpha")[-1])
        save_path = os.path.join(final_output_dir, "vis", f"epoch{epoch}",
                                 name)
        write_axis_dumps(save_path, alpha, batch_np, preds_list)
        if plots:
            scatter_plots(save_path, alpha, batch_np, preds_list, is_baseline)
        logger.info("sampled %s (%d samples)", name, args.num_samples)
    logger.info("Done")
    return final_output_dir


if __name__ == "__main__":
    main()
