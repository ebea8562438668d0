"""Frechet Inception Distance CLI (counterpart of tools/fid_score.py).

Core in ``vae2_tpu_torch/eval/fid.py``; see it for the weights file that
comparable numbers need. Runs on CUDA unless ``--device cpu``.

    python -m vae2_tpu_torch.tools.fid_score --path gen_dir real_dir \\
        [--path_patterns 'a/*' 'b/*'] [--weights pt_inception-....pth]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..eval.fid import calculate_fid_given_paths
from ..utils.device import resolve_device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--path", type=str, nargs=2, required=True,
                        help="Two image dirs (or .npz stats files)")
    parser.add_argument("--path_patterns", type=str, nargs=2, default=None,
                        help="Optional glob patterns inside each path")
    parser.add_argument("--batch-size", type=int, default=50)
    parser.add_argument("--dims", type=int, default=2048,
                        help="kept for reference-CLI compat; pool3 only")
    parser.add_argument("--weights", type=str, default="",
                        help="pt_inception .pth for bit-comparable FID")
    parser.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> float:
    args = parse_args(argv)
    patterns = tuple(args.path_patterns) if args.path_patterns else (None, None)
    fid = calculate_fid_given_paths(args.path, args.batch_size, patterns,
                                    args.weights, resolve_device(args.device))
    print("FID: ", fid)
    return fid


if __name__ == "__main__":
    main()
