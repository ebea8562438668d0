"""Rasterize PASCAL-Context 59-class label PNGs from trainval_merged.json
(counterpart of tools/gen_pascal_ctx_masks.py; reference
lib/datasets/pascal_ctx.py:52-96): decodes the COCO-style segmentations,
paints their category ids, maps them to the 59-class indices and writes
8-bit PNGs for the PASCALContext dataset's list files
(``data/pascal_detail.py``). Host work only (numpy and PIL): no device
is used.

    python -m vae2_tpu_torch.tools.gen_pascal_ctx_masks --root data --phase train
    python -m vae2_tpu_torch.tools.gen_pascal_ctx_masks --root data --phase val
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..data.pascal_detail import preprocess_masks


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default="data",
                    help="dataset root containing pascal_ctx/VOCdevkit/...")
    ap.add_argument("--phase", default="train", choices=("train", "val"))
    ap.add_argument("--out", default="", help="output dir override")
    args = ap.parse_args(argv)
    out = preprocess_masks(args.root, args.phase, args.out or None)
    print(f"masks -> {out}")
    return out


if __name__ == "__main__":
    main()
