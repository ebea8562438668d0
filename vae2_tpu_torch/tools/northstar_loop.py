"""North-star verification loop of the port: train -> inference ->
statistic -> FID/IS (counterpart of tools/northstar_loop.py).

Drives the reference workflow (reference tools/train.py ->
tools/inference.py -> tools/statistic.py -> tools/fid_score.py) end to end
through the port's CLIs, each stage a subprocess as a user would run it
(``python -m vae2_tpu_torch.tools.{train,inference,fid_score,
inception_score}``, each with ``--device``; the JAX-free
``tools/statistic.py`` and ``tools/gen_synthetic_data.py`` as they are),
and records a per-epoch metric trajectory: checkpoints round-trip between
train and inference, the metric dumps parse through the aggregator, and
the metrics improve as training goes on.

By default the tiny 32x64 synthetic recipe, so that the loop runs in
minutes. FID and IS use InceptionV3 from a seeded random init (no weights
file in the repo): self-consistent within a trajectory, and the keys say so
(``*_random_inception``).

    python -m vae2_tpu_torch.tools.northstar_loop --epochs 4 --num-samples 8 \
        [--device cpu] [--trajectory-out traj.json] [KEY VALUE ...]

Exits non-zero unless the last row improves on the first (x2 prediction
L1 down and MS-SSIM up). As the JAX tool, with the port's file names
(``checkpoint.pt``, ``model_final_state.pt``, ``checkpoint_epoch%04d.pt``);
one difference of mechanism: in the per-epoch mode the epoch-0 row
evaluates ``model_final_state.pt`` by name instead of a copy of it as
``checkpoint.pt``, which the next epoch's resume would read as a training
checkpoint without optimizer state (the next epoch starts from the same
seeded init either way).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from typing import List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TOOLS = os.path.join(REPO, "tools")  # the JAX-free statistic.py, gen_*_data.py


def port_cli(name: str) -> List[str]:
    """The command that starts the port's CLI ``name``."""
    return [sys.executable, "-m", f"vae2_tpu_torch.tools.{name}"]


def run(cmd, **kw):
    print("+", " ".join(cmd), flush=True)
    proc = subprocess.run(cmd, cwd=REPO, **kw)
    if proc.returncode != 0:
        raise SystemExit(f"stage failed ({proc.returncode}): {' '.join(cmd)}")
    return proc


def run_is(root, pattern, device):
    """Inception Score of the generated frames (random-init Inception; the
    key carries the tag, like FID's). An auxiliary metric: any failure
    records None rather than ending the trajectory."""
    try:
        proc = subprocess.run(
            port_cli("inception_score") + [
                "--path", root, "--pattern", pattern, "--batch-size", "16",
                "--splits", "2", "--device", device],
            cwd=REPO, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"rc={proc.returncode}: {proc.stderr[-2000:]}")
        for line in proc.stdout.splitlines():
            if line.startswith("IS:"):
                return float(line.split()[1])
        raise RuntimeError(f"no IS line in output:\n{proc.stdout[-2000:]}")
    except Exception as e:  # noqa: BLE001 — as the JAX tool
        print(f"# inception_score skipped for this row: {e}", flush=True)
        return None


def run_fid(gen_root, real_root, gen_pattern, real_pattern, device):
    proc = subprocess.run(
        port_cli("fid_score") + [
            "--path", gen_root, real_root,
            "--path_patterns", gen_pattern, real_pattern,
            "--batch-size", "16", "--device", device],
        cwd=REPO, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"fid_score failed: {proc.stderr[-2000:]}")
    for line in proc.stdout.splitlines():
        if line.startswith("FID:"):
            return float(line.split()[-1])
    raise SystemExit(f"no FID line in output:\n{proc.stdout[-2000:]}")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg",
                    default="experiments/cityscapes/debug_tiny_32x64.yaml")
    ap.add_argument("--epochs", default=4, type=int)
    ap.add_argument("--num-samples", default=8, type=int,
                    help="prior samples per eval clip at inference")
    ap.add_argument("--eval-clips", default=4, type=int,
                    help="TEST.NUM_SAMPLES: eval clips per epoch")
    ap.add_argument("--data", default="data/synthetic")
    ap.add_argument("--out", default="output_northstar",
                    help="OUTPUT_DIR override (isolated from other runs)")
    ap.add_argument("--trajectory-out", default="")
    ap.add_argument("--eval-epoch0", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="evaluate the untrained init as the epoch-0 row")
    ap.add_argument("--one-shot", action="store_true",
                    help="train all epochs in ONE process (snapshots every "
                         "epochs/eval-points), then evaluate every snapshot "
                         "in ONE inference process")
    ap.add_argument("--eval-points", default=4, type=int,
                    help="number of trajectory points in --one-shot mode")
    ap.add_argument("--resume", action="store_true",
                    help="continue an interrupted --one-shot run: keep the "
                         "existing checkpoint dir, skip the epoch-0 "
                         "(re)train, and let AUTO_RESUME pick training up "
                         "from checkpoint.pt")
    ap.add_argument("--device", default="cuda",
                    help="every stage's device: 'cuda' or 'cpu'")
    ap.add_argument("opts", nargs=argparse.REMAINDER,
                    help="extra KEY VALUE config overrides forwarded to "
                         "every train/inference stage")
    args = ap.parse_args(argv)
    if args.opts and args.opts[0] == "--":
        args.opts = args.opts[1:]
    if len(args.opts) % 2:
        raise SystemExit(f"opts must be KEY VALUE pairs, got {args.opts}")
    return args


def dataset_name(cfg: str, opts) -> str:
    """DATASET.DATASET of the recipe with its overrides: the logger nests
    the output under it (UCF recipes drive the same loop)."""
    from ..config import get_default_config, update_config

    config = update_config(get_default_config(), argparse.Namespace(
        cfg=os.path.join(REPO, cfg), opts=list(opts)))
    return config.DATASET.DATASET


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Run the loop; returns the trajectory (exits non-zero unless it
    improves)."""
    args = parse_args(argv)
    cfg_name = os.path.basename(args.cfg).split(".")[0]
    if not os.path.isfile(os.path.join(REPO, args.data, "train_list.txt")):
        run([sys.executable, os.path.join(TOOLS, "gen_synthetic_data.py"),
             "--out", args.data, "--num-videos", "16",
             "--width", "64", "--height", "32"])

    common_opts = ["OUTPUT_DIR", args.out, "DATASET.ROOT", args.data,
                   "DATASET.TRAIN_SET", f"{args.data}/train_list.txt",
                   "DATASET.TEST_SET", f"{args.data}/test_list.txt",
                   "TPU.LAYER_SUMMARY", "False"] + list(args.opts)
    # create_logger: OUTPUT_DIR / dataset / cfg_name
    final_dir = os.path.join(REPO, args.out,
                             dataset_name(args.cfg, common_opts), cfg_name)
    device = ["--device", args.device]

    def run_train(end_epoch, extra=()):
        cmd = port_cli("train") + ["--cfg", args.cfg] + device + common_opts \
            + ["TRAIN.END_EPOCH", str(end_epoch), "AUTO_RESUME", "True"]
        if end_epoch == 0:
            # the untrained-init run must train NOTHING (END_EPOCH +
            # EXTRA_EPOCH epochs would run otherwise)
            cmd += ["TRAIN.EXTRA_EPOCH", "0"]
        run(cmd + list(extra))

    def run_inference_cli(ckpt=""):
        cmd = port_cli("inference") + ["--cfg", args.cfg, "--num-samples",
                                       str(args.num_samples)] + device
        if ckpt:
            cmd += ["--checkpoint", ckpt]
        run(cmd + common_opts + ["TEST.NUM_SAMPLES", str(args.eval_clips)])

    if args.eval_epoch0 and not args.resume and os.path.isfile(
            os.path.join(final_dir, "checkpoint.pt")):
        raise SystemExit(
            f"{final_dir} already holds a checkpoint — the epoch-0 baseline "
            "would silently evaluate trained weights. Use a fresh --out "
            "(or --resume to continue an interrupted one-shot run).")
    if args.resume:
        if not args.one_shot:
            raise SystemExit("--resume only applies to --one-shot runs")
        if args.eval_epoch0 and not os.path.isfile(
                os.path.join(final_dir, "checkpoint_epoch0000.pt")):
            raise SystemExit(
                f"--resume with epoch-0 row needs "
                f"{final_dir}/checkpoint_epoch0000.pt from the "
                "interrupted run")

    trajectory = []

    def write_trajectory():
        if args.trajectory_out:
            with open(os.path.join(REPO, args.trajectory_out), "w") as f:
                json.dump(trajectory, f, indent=2)

    def eval_epoch(epoch):
        """stats + FID over the inference dump of one epoch -> one row."""
        vis = os.path.join(final_dir, "vis", f"epoch{epoch}")
        if not os.path.isdir(vis):
            raise SystemExit(f"inference produced no dump at {vis}")
        meanvar = {}
        for cand in ("x2t", "x3t"):
            stats_json = os.path.join(vis, f"meanvar_{cand}.json")
            run([sys.executable, os.path.join(TOOLS, "statistic.py"),
                 "--root", vis, "--mode", "meanvar", "--candidate", cand,
                 "--out", stats_json], stdout=subprocess.DEVNULL)
            with open(stats_json) as f:
                meanvar[cand] = json.load(f)
        best_json = os.path.join(vis, "bestsample.json")
        run([sys.executable, os.path.join(TOOLS, "statistic.py"),
             "--root", vis, "--mode", "bestsample", "--candidate", "x2t",
             "--points", f"1,{args.num_samples}", "--out", best_json],
            stdout=subprocess.DEVNULL)
        fid = run_fid(vis, vis, "*/x2tpredict/*.png", "*/x2t_*.png",
                      args.device)
        is_mean = run_is(vis, "x2tpredict/*.png", args.device)
        row = {
            "epoch": epoch,
            "x2_l1": meanvar["x2t"]["1_reconloss"][0],
            "x2_msssim": meanvar["x2t"]["1_msssimloss"][0],
            "x2_psnr": meanvar["x2t"]["1_psnrloss"][0],
            "x3_l1": meanvar["x3t"]["1_reconloss"][0],
            "fid_x2_random_inception": fid,
            "is_x2_random_inception": is_mean,
        }
        trajectory.append(row)
        print(json.dumps(row), flush=True)
        write_trajectory()  # incrementally: a cut-off run keeps its rows

    if args.one_shot:
        stride = max(1, args.epochs // args.eval_points)
        points = sorted(set(range(stride, args.epochs + 1, stride))
                        | {args.epochs})
        if args.eval_epoch0:
            if not args.resume:
                run_train(0)  # the untrained init's snapshot (epoch 0)
                shutil.copy(
                    os.path.join(final_dir, "model_final_state.pt"),
                    os.path.join(final_dir, "checkpoint_epoch0000.pt"))
            points = [0] + points
        # the whole training run, snapshotting every ``stride`` epochs
        run_train(args.epochs, ["TRAIN.SNAPSHOT_EVERY", str(stride)])
        ckpts = []
        for e in points:
            p = os.path.join(final_dir, f"checkpoint_epoch{e:04d}.pt")
            if not os.path.isfile(p):
                if e != args.epochs:
                    # fail before the inference pass: a substitute
                    # checkpoint would dump under its own stored epoch
                    raise SystemExit(f"missing snapshot {p}")
                p = os.path.join(final_dir, "checkpoint.pt")
            ckpts.append(p)
        run_inference_cli(",".join(ckpts))
        for e in points:
            eval_epoch(e)
    else:
        epochs = ([0] if args.eval_epoch0 else []) + \
            list(range(1, args.epochs + 1))
        for epoch in epochs:
            # one more epoch, resuming from the previous checkpoint; epoch 0
            # trains nothing and saves the untrained init
            run_train(epoch)
            run_inference_cli(os.path.join(final_dir, "model_final_state.pt")
                              if epoch == 0 else "")
            eval_epoch(epoch)

    print("\nepoch |   x2 L1  | x2 MS-SSIM | x2 PSNR |   FID")
    for r in trajectory:
        print(f"{r['epoch']:5d} | {r['x2_l1']:8.3f} | {r['x2_msssim']:10.4f} "
              f"| {r['x2_psnr']:7.3f} | {r['fid_x2_random_inception']:8.3f}")
    write_trajectory()

    first, last = trajectory[0], trajectory[-1]
    improved = (last["x2_l1"] < first["x2_l1"]
                and last["x2_msssim"] > first["x2_msssim"])
    print(f"\nimproved first->last: {improved} "
          f"(L1 {first['x2_l1']:.3f}->{last['x2_l1']:.3f}, "
          f"MS-SSIM {first['x2_msssim']:.4f}->{last['x2_msssim']:.4f}, "
          f"FID {first['fid_x2_random_inception']:.3f}->"
          f"{last['fid_x2_random_inception']:.3f})")
    if not improved:
        raise SystemExit("north-star loop: metrics did not improve")
    return trajectory


if __name__ == "__main__":
    main()
