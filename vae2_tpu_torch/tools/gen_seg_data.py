"""Write a synthetic segmentation set from a seed: RGB PNGs, 8-bit label
PNGs of a recipe's raw label ids, and ``train.lst`` / ``val.lst`` in the
layout ``data/segmentation.py`` reads (``SegDataset.read_files``).

    python -m vae2_tpu_torch.tools.gen_seg_data --out DIR \
        [--dataset cityscapes|lip|pascal_ctx] [--width W] [--height H] \
        [--train 8] [--val 4] [--seed 0]

The label ids of each ``--dataset`` (DATASET.DATASET of its recipe):
cityscapes, the raw Cityscapes ids of the 19 training classes plus two
ignored ones (0, 4), 2048x1024 by default; lip, LIP's 20 classes 0-19,
473x473 (experiments/lip); pascal_ctx, PASCAL-Context's 60 raw ids 0-59,
of which 0 (background) becomes the ignore label under the 59-class mode,
480x480 (experiments/pascal_ctx). Labels are blocks of 32x32 pixels; each
class has its own colour, plus noise, so that a network can learn the map.
Made with numpy and saved with PIL.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from ..data.segmentation import CITYSCAPES_LABEL_MAP

# dataset -> (its raw label ids, its default (width, height)); Cityscapes:
# the ids of the 19 training classes, then two ignored ones (0, 4)
DATASETS = {
    "cityscapes": (np.array(sorted(k for k, v in CITYSCAPES_LABEL_MAP.items()
                                   if v >= 0) + [0, 4], np.uint8),
                   (2048, 1024)),
    "lip": (np.arange(20, dtype=np.uint8), (473, 473)),
    "pascal_ctx": (np.arange(60, dtype=np.uint8), (480, 480)),
}
_BLOCK = 32


def _sample(rng: np.random.RandomState, width: int, height: int,
            ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    colors = rng.randint(0, 256, (len(ids), 3))
    gh, gw = -(-height // _BLOCK), -(-width // _BLOCK)
    cls = rng.randint(0, len(ids), (gh, gw))
    cls = np.repeat(np.repeat(cls, _BLOCK, 0), _BLOCK, 1)[:height, :width]
    noise = rng.randint(-20, 21, (height, width, 3))
    image = np.clip(colors[cls] + noise, 0, 255).astype(np.uint8)
    return image, ids[cls]


def write_synthetic_seg(out: str, width: Optional[int] = None,
                        height: Optional[int] = None, train: int = 8,
                        val: int = 4, seed: int = 0,
                        dataset: str = "cityscapes") -> Tuple[str, str]:
    """Write the set of ``dataset``'s label ids under ``out`` (at its
    default size unless given); returns the (train, val) list paths."""
    from PIL import Image

    ids, (w0, h0) = DATASETS[dataset]
    width, height = width or w0, height or h0
    rng = np.random.RandomState(seed)
    for sub in ("img", "lbl"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
    lists = []
    index = 0
    for split, count in (("train", train), ("val", val)):
        lines = []
        for _ in range(count):
            image, label = _sample(rng, width, height, ids)
            name = f"{index:03d}.png"
            Image.fromarray(image, "RGB").save(os.path.join(out, "img", name))
            Image.fromarray(label, "L").save(os.path.join(out, "lbl", name))
            lines.append(f"img/{name} lbl/{name}\n")
            index += 1
        path = os.path.join(out, f"{split}.lst")
        with open(path, "w") as f:
            f.writelines(lines)
        lists.append(path)
    return lists[0], lists[1]


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--dataset", default="cityscapes", choices=DATASETS)
    ap.add_argument("--width", type=int, default=None,
                    help="default: the dataset's (2048, 473 or 480)")
    ap.add_argument("--height", type=int, default=None,
                    help="default: the dataset's (1024, 473 or 480)")
    ap.add_argument("--train", type=int, default=8)
    ap.add_argument("--val", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    print(write_synthetic_seg(a.out, a.width, a.height, a.train, a.val,
                              a.seed, a.dataset))


if __name__ == "__main__":
    main()
