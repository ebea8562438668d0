"""Inception Score CLI (counterpart of tools/inception_score.py). Core in
``vae2_tpu_torch/eval/is_score.py``. Runs on CUDA unless ``--device cpu``.

    python -m vae2_tpu_torch.tools.inception_score --path <dir> \\
        --pattern '*x3t*' --splits 10
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence, Tuple

from ..eval.is_score import collect_files, inception_score
from ..utils.device import resolve_device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--path", type=str, required=True)
    parser.add_argument("--pattern", type=str, default="*.png",
                        help="filename glob to select generated frames")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--splits", type=int, default=10)
    parser.add_argument("--weights", type=str, default="")
    parser.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Tuple[float, float]:
    args = parse_args(argv)
    device = resolve_device(args.device)
    files = collect_files(args.path, args.pattern)
    print(f"Computing Inception Score over {len(files)} images...")
    mean, std = inception_score(files, args.weights, args.batch_size,
                                args.splits, device=device)
    print(f"IS: {mean} +/- {std}")
    return mean, std


if __name__ == "__main__":
    main()
