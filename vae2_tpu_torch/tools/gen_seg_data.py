"""Write a synthetic Cityscapes-style segmentation set from a seed: RGB
PNGs, 8-bit label PNGs of raw Cityscapes label ids (those of the 19
training classes, plus some of the ignored ones), and ``train.lst`` /
``val.lst`` in the layout ``data/segmentation.py`` reads.

    python -m vae2_tpu_torch.tools.gen_seg_data --out DIR \
        [--width 2048] [--height 1024] [--train 8] [--val 4] [--seed 0]

Labels are blocks of 32x32 pixels; each class has its own colour, plus
noise, so that a network can learn the map. Made with numpy and saved with
PIL.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from ..data.segmentation import CITYSCAPES_LABEL_MAP

# raw ids of the 19 training classes, then two ignored ones (0, 4)
_RAW_IDS = np.array(sorted(k for k, v in CITYSCAPES_LABEL_MAP.items()
                           if v >= 0) + [0, 4], np.uint8)
_BLOCK = 32


def _sample(rng: np.random.RandomState, width: int, height: int
            ) -> Tuple[np.ndarray, np.ndarray]:
    colors = rng.randint(0, 256, (len(_RAW_IDS), 3))
    gh, gw = -(-height // _BLOCK), -(-width // _BLOCK)
    cls = rng.randint(0, len(_RAW_IDS), (gh, gw))
    cls = np.repeat(np.repeat(cls, _BLOCK, 0), _BLOCK, 1)[:height, :width]
    noise = rng.randint(-20, 21, (height, width, 3))
    image = np.clip(colors[cls] + noise, 0, 255).astype(np.uint8)
    return image, _RAW_IDS[cls]


def write_synthetic_seg(out: str, width: int = 2048, height: int = 1024,
                        train: int = 8, val: int = 4, seed: int = 0
                        ) -> Tuple[str, str]:
    """Write the set under ``out``; returns the (train, val) list paths."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    for sub in ("img", "lbl"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
    lists = []
    index = 0
    for split, count in (("train", train), ("val", val)):
        lines = []
        for _ in range(count):
            image, label = _sample(rng, width, height)
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
    ap.add_argument("--width", type=int, default=2048)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--train", type=int, default=8)
    ap.add_argument("--val", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    print(write_synthetic_seg(a.out, a.width, a.height, a.train, a.val,
                              a.seed))


if __name__ == "__main__":
    main()
