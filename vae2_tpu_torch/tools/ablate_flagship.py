"""Controlled ablations of the flagship model's x2 learning, on the port
(counterpart of tools/ablate_flagship.py).

At 128x256 the dual decoders learn while the middle-clip prediction loss
``loss_x2t_recon`` may barely move (docs/northstar_flagship.json): the
reference's x2 lambda 0.1 can be drowned by the decoder and GAN pulls in a
short from-scratch run. This runs the same full W18 flagship model at half
resolution (64x128) over a small grid of recipes through the port's train
CLI (``python -m vae2_tpu_torch.tools.train``), then reports the train
log's x2/x1/x3 recon trajectories.

    python -m vae2_tpu_torch.tools.ablate_flagship --epochs 40 \
        [--only control_lam0.1,x2lam1] [--device cpu] [--out ablation.json]

As the JAX tool, with one deliberate difference: the control arm sets
``TRAIN.X2RECON_LAMBDA 0.1`` explicitly. The default recipe
(northstar_flagship_128x256.yaml) carries lambda 1.0 since the fix the JAX
tool's grid found, so the JAX tool's override-free control now runs lambda
1.0, the same as ``x2lam1``; the control that docs/ablation_x2.json
measured, and that the arm's name says, is lambda 0.1. An arm that fails
is reported and the grid goes on.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
from typing import Optional, Sequence

from .northstar_loop import REPO, port_cli

ABLATIONS = {
    # control: the reference's lambda (the r3 flagship recipe) at half res
    "control_lam0.1": ["TRAIN.X2RECON_LAMBDA", "0.1"],
    # hypothesis 1: x2 supervision underweighted for from-scratch short runs
    "x2lam1": ["TRAIN.X2RECON_LAMBDA", "1.0"],
    # hypothesis 2: GAN pull dominates the prediction
    "x2lam1_gan0": ["TRAIN.X2RECON_LAMBDA", "1.0", "TRAIN.GAN_LAMBDA", "0.0"],
    # hypothesis 3: LR too conservative for the step budget
    "x2lam1_lr3e-4": ["TRAIN.X2RECON_LAMBDA", "1.0", "TRAIN.LR", "0.0003"],
    # hypothesis 4 (grad_diagnosis at init: the decoder-recon terms pull on
    # x2p 1135-1603x harder than the 0.1-weighted direct L1): the direct
    # supervision within an order of magnitude of the competing pulls
    "x2lam10": ["TRAIN.X2RECON_LAMBDA", "10.0"],
}

LOG_RE = re.compile(
    r"Epoch: \[(\d+)/\d+\] Iter:\[(\d+)/(\d+)\].*"
    r"loss_xt_recon: ([\d.eE+-]+), loss_x2t_recon: ([\d.eE+-]+), "
    r"loss_x3t_recon: ([\d.eE+-]+), loss_z_KL: ([\d.eE+-]+)")


def parse_log(log_path):
    rows = []
    with open(log_path) as f:
        for line in f:
            m = LOG_RE.search(line)
            if m:
                e, it, per = int(m.group(1)), int(m.group(2)), int(m.group(3))
                rows.append({
                    "step": e * per + it,
                    "x1": float(m.group(4)),
                    "x2": float(m.group(5)),
                    "x3": float(m.group(6)),
                    "kl": float(m.group(7)),
                })
    return rows


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg",
                    default="experiments/cityscapes/"
                            "northstar_flagship_128x256.yaml")
    ap.add_argument("--data", default="data/synthetic_flagship")
    ap.add_argument("--epochs", default=40, type=int)
    ap.add_argument("--width", default=128, type=int)
    ap.add_argument("--height", default=64, type=int)
    ap.add_argument("--only", default="",
                    help="comma-separated subset of ablation names")
    ap.add_argument("--out", default="docs/h100/ablation_x2.json")
    ap.add_argument("--out-root", default="",
                    help="directory of the arms' OUTPUT_DIRs "
                         "(output_ablate_<arm>); default the repo root")
    ap.add_argument("--device", default="cuda",
                    help="the train CLI's device: 'cuda' or 'cpu'")
    ap.add_argument("opts", nargs=argparse.REMAINDER,
                    help="extra KEY VALUE config overrides for every arm, "
                         "before the arm's own")
    return ap.parse_args(argv)


def train_cmd(args, name: str) -> list:
    out_dir = os.path.join(args.out_root, f"output_ablate_{name}")
    return port_cli("train") + [
        "--cfg", args.cfg, "--device", args.device,
        "OUTPUT_DIR", out_dir,
        "DATASET.ROOT", args.data,
        "DATASET.TRAIN_SET", f"{args.data}/train_list.txt",
        "DATASET.TEST_SET", f"{args.data}/test_list.txt",
        "TRAIN.IMAGE_SIZE", f"({args.width},{args.height})",
        "TEST.IMAGE_SIZE", f"({args.width},{args.height})",
        "TRAIN.BASE_SIZE", str(args.width),
        "TEST.BASE_SIZE", str(args.width),
        "TRAIN.END_EPOCH", str(args.epochs),
        "TPU.LAYER_SUMMARY", "False",
        "PRINT_FREQ", "5",
        "AUTO_RESUME", "True",
    ] + list(args.opts) + ABLATIONS[name]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the arms; returns {arm: {opts, rows}} of those that finished."""
    args = parse_args(argv)
    names = [n for n in ABLATIONS
             if not args.only or n in args.only.split(",")]
    cfg_name = os.path.basename(args.cfg).split(".")[0]
    results = {}
    for name in names:
        cmd = train_cmd(args, name)
        print(f"\n=== ablation {name}: {' '.join(ABLATIONS[name])}",
              flush=True)
        proc = subprocess.run(cmd, cwd=REPO)
        if proc.returncode != 0:
            print(f"!! ablation {name} failed rc={proc.returncode}", flush=True)
            continue
        log_dir = os.path.join(REPO, args.out_root, f"output_ablate_{name}",
                               "cityscapessequence", cfg_name)
        logs = sorted(
            f for f in os.listdir(log_dir) if f.endswith("_train.log"))
        rows = []
        for lg in logs:
            rows.extend(parse_log(os.path.join(log_dir, lg)))
        rows.sort(key=lambda r: r["step"])
        results[name] = {"opts": ABLATIONS[name], "rows": rows}
        if rows:
            first, last = rows[0], rows[-1]
            print(f"--- {name}: x2 {first['x2']:.0f}->{last['x2']:.0f} "
                  f"({last['x2'] / max(first['x2'], 1e-9):.3f}x)  "
                  f"x1 {first['x1']:.0f}->{last['x1']:.0f}  "
                  f"x3 {first['x3']:.0f}->{last['x3']:.0f}  "
                  f"kl {first['kl']:.0f}->{last['kl']:.0f}", flush=True)
        if args.out:
            with open(os.path.join(REPO, args.out), "w") as f:
                json.dump(results, f, indent=2)

    print("\n=== summary (train-log recon losses, first->last print) ===")
    for name, res in results.items():
        rows = res["rows"]
        if not rows:
            continue
        first, last = rows[0], rows[-1]
        print(f"{name:<18} x2: {first['x2']:9.0f} -> {last['x2']:9.0f} "
              f"({last['x2'] / max(first['x2'], 1e-9):.3f}x)   "
              f"x1: {last['x1']:8.0f}  x3: {last['x3']:8.0f}  "
              f"kl: {last['kl']:7.0f}")
    return results


if __name__ == "__main__":
    main()
