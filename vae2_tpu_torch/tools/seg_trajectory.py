"""Segmentation north-star mini-loop of the port: train -> test -> MeanIU
trajectory (counterpart of tools/seg_trajectory.py).

Drives the seg family end to end through the port's CLIs (``python -m
vae2_tpu_torch.tools.train_seg`` then ``python -m
vae2_tpu_torch.tools.test``, each with ``--device``; reference
lib/core/function.py:16-121 + tools/test.py:86-135): evaluates the
untrained init (the epoch-0 row), trains N epochs, evaluates again, and
records the MeanIU / pixel-accuracy trajectory.

    python -m vae2_tpu_torch.tools.seg_trajectory --epochs 8 [--device cpu] \
        [--trajectory-out seg_traj.json]

Exits non-zero unless the trained row beats the init row (MeanIU and pixel
accuracy both up).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
from typing import Optional, Sequence

from .northstar_loop import REPO, port_cli

MEANIU_RE = re.compile(r"MeanIU:\s*([\d.]+),\s*Pixel_Acc:\s*([\d.]+),"
                       r"\s*Mean_Acc:\s*([\d.]+)")


def run(cmd):
    print("+", " ".join(cmd), flush=True)
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(
            f"stage failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stderr[-3000:]}")
    return proc.stdout + proc.stderr


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg",
                    default="experiments/cityscapes/debug_seg_tiny_32x64.yaml")
    ap.add_argument("--epochs", default=8, type=int)
    ap.add_argument("--data", default="data/synthetic_seg")
    ap.add_argument("--out", default="output_northstar_seg")
    ap.add_argument("--trajectory-out", default="")
    ap.add_argument("--device", default="cuda",
                    help="every stage's device: 'cuda' or 'cpu'")
    ap.add_argument("opts", nargs=argparse.REMAINDER,
                    help="extra KEY VALUE config overrides forwarded to "
                         "both stages")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Run the loop; returns the two rows (exits non-zero unless the
    trained one improves)."""
    args = parse_args(argv)
    cfg_name = os.path.basename(args.cfg).split(".")[0]
    final_dir = os.path.join(REPO, args.out, "cityscapes", cfg_name)
    common = ["OUTPUT_DIR", args.out, "DATASET.ROOT", args.data,
              "DATASET.TRAIN_SET", f"{args.data}/train.lst",
              "DATASET.TEST_SET", f"{args.data}/val.lst"] + list(args.opts)
    device = ["--device", args.device]

    def train(end_epoch):
        run(port_cli("train_seg") + ["--cfg", args.cfg] + device + common
            + ["TRAIN.END_EPOCH", str(end_epoch)])

    def evaluate(epochs_trained):
        out = run(port_cli("test") + ["--cfg", args.cfg] + device + common
                  + ["TEST.MODEL_FILE",
                     os.path.join(final_dir, "seg_final_state.pt")])
        m = MEANIU_RE.search(out)
        if not m:
            raise SystemExit(f"no MeanIU line in test output:\n{out[-3000:]}")
        row = {"epochs": epochs_trained, "mean_iu": float(m.group(1)),
               "pixel_acc": float(m.group(2)), "mean_acc": float(m.group(3))}
        print(json.dumps(row), flush=True)
        return row

    # the untrained init: END_EPOCH 0 saves the seeded init and trains
    # nothing (train_seg starts from the seeded init, with no resume, so the
    # trained row trains from scratch)
    train(0)
    rows = [evaluate(0)]
    train(args.epochs)
    rows.append(evaluate(args.epochs))

    if args.trajectory_out:
        with open(os.path.join(REPO, args.trajectory_out), "w") as f:
            json.dump(rows, f, indent=2)

    first, last = rows[0], rows[-1]
    improved = (last["mean_iu"] > first["mean_iu"]
                and last["pixel_acc"] > first["pixel_acc"])
    print(f"improved init->trained: {improved} "
          f"(MeanIU {first['mean_iu']:.4f}->{last['mean_iu']:.4f}, "
          f"Pixel_Acc {first['pixel_acc']:.4f}->{last['pixel_acc']:.4f})")
    if not improved:
        raise SystemExit("seg trajectory: metrics did not improve")
    return rows


if __name__ == "__main__":
    main()
