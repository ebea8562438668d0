"""Per-layer FLOPs/params model summary (counterpart of
tools/model_summary.py; reference lib/utils/modelsummary.py:19-135, logged
at train startup by reference tools/train.py:92-98).

For every network of the configured model (encz, encdec, d_seq, d_frame;
the toy family's too) it prints the parameters per submodule and a
per-layer table (path, module, input/output shapes, parameters, FLOPs) of
one forward at batch 1 at the recipe's TRAIN.IMAGE_SIZE (a clip; one frame
for d_frame), FLOPs from ``torch.utils.flop_counter.FlopCounterMode``
(``utils/summary.py``), then one JSON line: each network's parameters and
FLOPs per forward.

    python -m vae2_tpu_torch.tools.model_summary \
        --cfg experiments/.../recipe.yaml [--depth 3] [KEY VALUE ...]

Runs on CUDA (GPU.DEVICE) unless ``--device cpu``: the shapes and FLOPs do
not depend on the device, and no weight is trained or read.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from ..config import get_default_config, update_config
from ..core.builder import build_system
from ..utils.device import resolve_device
from ..utils.summary import count_params, format_rows, network_summaries


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="per-layer model summary "
                                                 "(PyTorch)")
    parser.add_argument(
        "--cfg",
        default="experiments/cityscapes/vae2_hrnet_w18_small_v2_128x256.yaml",
        type=str)
    parser.add_argument("--depth", default=3, type=int,
                        help="module nesting depth shown in the table")
    parser.add_argument("--device", default="",
                        help="'cuda' (default: GPU.DEVICE) or 'cpu'")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Print the tables; returns {network: {'params', 'flops'}}."""
    args = parse_args(argv)
    config = update_config(get_default_config(), args)
    device = resolve_device(args.device or config.GPU.DEVICE)
    system = build_system(config, seed=0, device=device)
    width, height = config.TRAIN.IMAGE_SIZE
    nets = network_summaries(system, int(height), int(width), device,
                             depth=args.depth)
    for name, info in nets.items():
        print(f"== {name} == {info['params']:,} params, "
              f"{info['flops'] / 1e9:.3f} GFLOPs per forward at batch 1")
        for sub, mod in system.modules[name].named_children():
            print(f"  {sub:<24} {count_params(mod):>12,} params")
        print(format_rows(info["rows"]))
    result = {name: {"params": info["params"], "flops": info["flops"]}
              for name, info in nets.items()}
    print(json.dumps({"image_size": [int(width), int(height)],
                      "networks": result}))
    return result


if __name__ == "__main__":
    main()
