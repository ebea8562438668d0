"""Model summary: parameter counts per network and per submodule, and a
per-layer table of shapes, parameters and FLOPs (counterpart of
``vae2_tpu/utils/summary.py``; reference lib/utils/modelsummary.py:19-135).

FLOPs are those of ``torch.utils.flop_counter.FlopCounterMode``: two per
multiply-add of the convolutions and matrix products (what XLA's cost
analysis counts for them on the JAX side); normalization, activations,
resizes and adds are not counted. A layer's FLOPs are read from the
counter before and after its forward, so they include its children's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def log_model_summary(logger, modules: Dict[str, nn.Module],
                      detail: bool = False) -> None:
    """Startup parameter summary; ``detail`` adds each network's
    submodules (summary.py:26-40)."""
    total = 0
    for name, net in modules.items():
        n = count_params(net)
        total += n
        logger.info("model %-8s: %10.2fM params", name, n / 1e6)
        if detail:
            for sub_name, sub in sorted(net.named_children()):
                logger.info("  %-24s %10.3fM", sub_name,
                            count_params(sub) / 1e6)
    logger.info("model total   : %10.2fM params", total / 1e6)


def _shapes(x):
    if isinstance(x, torch.Tensor):
        return list(x.shape)
    if isinstance(x, (list, tuple)):
        return [_shapes(v) for v in x if isinstance(v, (torch.Tensor, list,
                                                        tuple))]
    return None


def layer_rows(module: nn.Module, *args, depth: int = 3,
               **kwargs) -> Tuple[List[dict], int]:
    """One no-grad forward of ``module`` under FlopCounterMode; returns
    (rows, total FLOPs). A row per submodule of at most ``depth`` levels:
    name, type, input and output shapes (first call), parameters
    (recursive), FLOPs (recursive, every call), calls."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    rows: Dict[str, dict] = {}
    started: Dict[str, List[int]] = {}
    handles = []
    for name, sub in module.named_modules():
        if name.count(".") >= depth:
            continue
        label = name or type(module).__name__

        def pre(mod, inputs, label=label):
            started.setdefault(label, []).append(counter.get_total_flops())

        def post(mod, inputs, output, label=label):
            flops = counter.get_total_flops() - started[label].pop()
            row = rows.get(label)
            if row is None:
                rows[label] = {"name": label, "type": type(mod).__name__,
                               "in": _shapes(inputs[:1])[0] if inputs
                               else None,
                               "out": _shapes(output),
                               "params": count_params(mod), "flops": flops,
                               "calls": 1}
            else:
                row["flops"] += flops
                row["calls"] += 1

        handles.append(sub.register_forward_pre_hook(pre))
        handles.append(sub.register_forward_hook(post))
    try:
        with torch.no_grad(), counter:
            module(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    order = [n or type(module).__name__ for n, _ in module.named_modules()]
    return ([rows[n] for n in order if n in rows],
            counter.get_total_flops())


def format_rows(rows: List[dict]) -> str:
    lines = [f"{'layer':<56} {'type':<16} {'input':<22} {'output':<22} "
             f"{'params':>11} {'MFLOPs':>12}"]
    for r in rows:
        lines.append(f"{r['name'][:56]:<56} {r['type'][:16]:<16} "
                     f"{str(r['in'])[:22]:<22} {str(r['out'])[:22]:<22} "
                     f"{r['params']:>11,} {r['flops'] / 1e6:>12.2f}")
    return "\n".join(lines)


def example_inputs(system, height: int, width: int,
                   device: Optional[torch.device] = None
                   ) -> Dict[str, Tuple[tuple, dict]]:
    """(args, kwargs) of one forward of each network at batch 1: clips of
    ``height`` x ``width`` (zeros; a frame for the frame discriminator),
    or the toy family's vectors; z of the prior's shapes, random code
    zeros."""
    from ..core.infer_loop import prior_z_shapes
    from ..core.system import _nchw

    h = system.hyper
    if h.family == "toy":
        clip = torch.zeros(1, 10, device=device)
    else:
        clip = torch.zeros(1, height, width, 3 * h.clip_length, device=device)
    enc_in = _nchw(system._encoder_input(clip, clip))
    shapes = prior_z_shapes(h, height, width) if h.family != "toy" else \
        [(h.z_dim,)]
    if h.deterministic:
        z = None
    elif h.hd_z:
        z = [torch.zeros((1,) + tuple(s), device=device) for s in shapes]
    else:
        z = torch.zeros((1,) + tuple(shapes[0]), device=device)
    out = {}
    if "encz" in system.modules:
        out["encz"] = ((_nchw(system._posterior_input(clip, clip, clip)),),
                       {})
    out["encdec"] = ((enc_in, z), {"rand_code": torch.zeros(
        1, h.z_dim, device=device)})
    out["d_seq"] = ((_nchw(clip),), {})
    if "d_frame" in system.modules:
        out["d_frame"] = ((_nchw(clip[..., :3].contiguous()),), {})
    return out


def network_summaries(system, height: int, width: int,
                      device: Optional[torch.device] = None,
                      depth: int = 3) -> Dict[str, dict]:
    """For each network: its parameters, FLOPs of one forward at batch 1
    (a clip, a frame for d_frame, a vector for the toy family) and the
    per-layer table."""
    out = {}
    inputs = example_inputs(system, height, width, device)
    was_training = {k: m.training for k, m in system.modules.items()}
    system.modules.eval()
    try:
        for name, (args, kwargs) in inputs.items():
            rows, flops = layer_rows(system.modules[name], *args, depth=depth,
                                     **kwargs)
            out[name] = {"params": count_params(system.modules[name]),
                         "flops": flops, "rows": rows}
    finally:
        for k, m in system.modules.items():
            m.train(was_training[k])
    return out
