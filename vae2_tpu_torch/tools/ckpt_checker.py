"""Checkpoint surgery and comparison (counterpart of tools/ckpt_checker.py;
reference tools/ckpt_checker.py).

- ``rename``: fix a historical key typo in a reference torch checkpoint
  (``encdec_mode.`` -> ``encdec_model.``, reference ckpt_checker.py:82-95)
  and save the repaired file;
- ``compare``: the two checkpoints' parameter names, shapes and values
  (param_comp, :96-104), each read as a flat {name: array}: a port ``.pt``
  as its state dict, the JAX package's ``.msgpack`` mapped onto the port's
  names (``utils/checkpoint.load_jax_checkpoint``: OIHW kernels, BN
  ``weight``/``bias``/``running_*``), so that a ``.pt`` and a ``.msgpack``
  of the same networks compare name for name; a reference ``.pth`` or
  ``.pth.tar`` with its own names;
- ``import``: a reference torch checkpoint into a port ``.pt`` of the
  configured VAE² system (``utils/torch_import.import_reference_checkpoint``),
  the networks built on ``--device`` (cuda unless ``--device cpu``).

    python -m vae2_tpu_torch.tools.ckpt_checker rename --src old.pth.tar --dst fixed.pth.tar
    python -m vae2_tpu_torch.tools.ckpt_checker compare --src a.msgpack --dst b.pt
    python -m vae2_tpu_torch.tools.ckpt_checker import --cfg exp.yaml --src ref.pth.tar --dst out.pt
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def load_any(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint of any of the three kinds as {name: f32-or-int array}."""
    from ..utils.checkpoint import load_checkpoint
    from ..utils.torch_import import load_torch_state_dict

    if path.endswith((".pt", ".msgpack")):
        state_dict, _ = load_checkpoint(path)
    else:
        state_dict = load_torch_state_dict(path)
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in state_dict.items()}


def cmd_rename(args) -> int:
    ckpt = torch.load(args.src, map_location="cpu", weights_only=True)
    wrapped = isinstance(ckpt, dict) and "state_dict" in ckpt
    sd = ckpt["state_dict"] if wrapped else ckpt
    renamed = {k.replace(args.old, args.new): v for k, v in sd.items()}
    changed = sum(1 for k in sd if args.old in k)
    if wrapped:
        ckpt["state_dict"] = renamed
    else:
        ckpt = renamed
    torch.save(ckpt, args.dst)
    print(f"renamed {changed} keys ({args.old!r} -> {args.new!r}) "
          f"-> {args.dst}")
    return 0


def compare(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray],
            atol: float = 0.0) -> int:
    """Prints the names only one side has and the common names whose shape
    or values (beyond ``atol``) differ; returns how many differ."""
    only_a, only_b = sorted(set(a) - set(b)), sorted(set(b) - set(a))
    print(f"{len(a)} params in src, {len(b)} in dst; "
          f"{len(only_a)} only-src, {len(only_b)} only-dst")
    for k in only_a[:20]:
        print("  only src:", k)
    for k in only_b[:20]:
        print("  only dst:", k)
    n_diff = 0
    for k in sorted(set(a) & set(b)):
        va, vb = a[k], b[k]
        if va.shape != vb.shape:
            print(f"  shape diff {k}: {va.shape} vs {vb.shape}")
            n_diff += 1
        elif not np.allclose(va, vb, atol=atol):
            d = np.abs(va.astype(np.float64) - vb.astype(np.float64)).max()
            print(f"  value diff {k}: max|d|={d}")
            n_diff += 1
    print(f"{n_diff} differing common params")
    return n_diff


def cmd_compare(args) -> int:
    compare(load_any(args.src), load_any(args.dst), args.atol)
    return 0


def cmd_import(args) -> int:
    from ..config import get_default_config, update_config
    from ..core.builder import build_system
    from ..utils.checkpoint import save_checkpoint
    from ..utils.device import resolve_device
    from ..utils.torch_import import import_reference_checkpoint

    config = update_config(get_default_config(), argparse.Namespace(
        cfg=args.cfg, opts=args.opts or []))
    device = resolve_device(args.device or config.GPU.DEVICE)
    system = build_system(config, seed=0, device=device)
    missing = import_reference_checkpoint(system, args.src)
    print(f"imported with {len(missing)} unmatched leaves")
    for m in missing[:20]:
        print("  missing:", m)
    save_checkpoint(args.dst, system.modules.state_dict(), epoch=0)
    print(f"wrote {args.dst}")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("rename")
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--old", default="encdec_mode.")
    p.add_argument("--new", default="encdec_model.")
    p.set_defaults(fn=cmd_rename)

    p = sub.add_parser("compare")
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--atol", type=float, default=0.0)
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser("import")
    p.add_argument("--cfg", required=True)
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--device", default="",
                   help="'cuda' (default: GPU.DEVICE) or 'cpu'")
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    p.set_defaults(fn=cmd_import)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
