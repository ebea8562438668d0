"""The numbers that decide ``correct``, each a gap between the program's
reading and the reference's.

Training (per leaf: a parameter tensor):
- ``loss_gap``: the largest relative gap of a loss over the checked steps;
- ``grad_gap``: the worst leaf's gap between the norms of the first
  step's gradient, |‖g_prog‖ - ‖g_ref‖|, over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``update_gap``: the same for the change of the parameters over the
  checked steps.
Both leave out the leaves whose reference gradient is under a thousandth
of the median leaf's: they move by round-off alone (a bias that a BN
follows).
Each of the two leaf numbers is also given over the median leaf
(``*_median``): steadier from seed to seed than the worst leaf.
- ``stats_gap``, ``stats_gap_median`` (training over several ranks, per
  leaf: a BN's running mean or running variance): the gap of the change of
  the running statistics over the checked steps, ‖d_prog - d_ref‖ (the
  norm of the difference, as a running statistic is a reading of the
  batch's statistics itself), over the larger of ‖d_ref‖ of that leaf and
  of the median leaf; the worst leaf and the median leaf.
Evaluation: ``frame_gap``, the relative gap |x_prog - x_ref| / |x_ref| of
the checked samples' predicted frames; ``score_gap``, the widest gap of a
frame score of the program against the reference's score of the same
frames, |s_prog - s_ref| / (1 + |s_ref|).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence


def _median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _finite_or_inf(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def loss_gap(prog: List[Dict[str, float]], ref: List[Dict[str, float]]) -> float:
    worst = 0.0
    for p, r in zip(prog, ref):
        for k, rv in r.items():
            worst = max(worst, _finite_or_inf(abs(p[k] - rv) / max(abs(rv), 1e-12)))
    return worst


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Sequence[str] = None) -> Dict[str, float]:
    names = list(ref) if keep is None else list(keep)
    med = _median([ref[n] for n in names])
    return {n: _finite_or_inf(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30))
            for n in names}


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: Sequence[str] = None) -> float:
    return max(leaf_gaps(prog, ref, keep).values())


def moved_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = _median(list(ref_grad.values()))
    return [n for n, v in ref_grad.items() if v >= 1e-3 * med]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog``/``ref``: {'losses': [...], 'grad': {leaf: norm}, 'update':
    {leaf: norm}}."""
    moved = moved_leaves(ref["grad"])
    grad = leaf_gaps(prog["grad"], ref["grad"], moved)
    update = leaf_gaps(prog["update"], ref["update"], moved)
    return {
        "loss_gap": loss_gap(prog["losses"], ref["losses"]),
        "grad_gap": max(grad.values()),
        "grad_gap_median": _median(list(grad.values())),
        "update_gap": max(update.values()),
        "update_gap_median": _median(list(update.values())),
    }


def stats_gaps(prog: Dict[str, "torch.Tensor"],
               ref: Dict[str, "torch.Tensor"]) -> Dict[str, float]:
    """Each running statistic's gap (``stats_gap``), by leaf."""
    norms = {n: float(r.norm()) for n, r in ref.items()}
    med = _median(list(norms.values()))
    return {n: _finite_or_inf(float((prog[n] - r).norm()) / max(norms[n], med, 1e-30))
            for n, r in ref.items()}


def stats_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    gaps = list(stats_gaps(prog, ref).values())
    return {"stats_gap": max(gaps), "stats_gap_median": _median(gaps)}


def worst_leaves(prog: dict, ref: dict, n: int = 5) -> Dict[str, list]:
    """The leaves behind the worst gaps, with their reference norms."""
    out = {}
    for key in ("grad", "update"):
        gaps = leaf_gaps(prog[key], ref[key], moved_leaves(ref["grad"]))
        top = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
        out[key] = [[name, g, ref[key][name]] for name, g in top]
    return out


def frame_gap(prog, ref) -> float:
    """prog, ref: lists of frame tensors of the same samples."""
    num = sum(float((p.float() - r.float()).pow(2).sum()) for p, r in zip(prog, ref))
    den = sum(float(r.float().pow(2).sum()) for r in ref)
    return _finite_or_inf(math.sqrt(num / max(den, 1e-30)))


def score_gap(prog: Dict[str, list], ref: Dict[str, list]) -> float:
    """The widest gap over the scores ``recon`` (L1 in pixel units),
    ``psnr`` (dB), ``ssim`` and ``msssim`` of flat lists of entries."""
    return max(_finite_or_inf(abs(p - r) / (1.0 + abs(r)))
               for k in ("recon", "psnr", "ssim", "msssim")
               for p, r in zip(prog[k], ref[k]))
