"""Synthetic sigmoid-family toy dataset (a copy of ``vae2_tpu/data/toy.py``).

Reproduces the reference toy task bit-for-bit (reference
tools/toy_example.py:100-113 and lib/core/function.py:448-462): each sample is
a sigmoid curve ``f(h) = 1/(1+exp(-alpha*h))`` evaluated on three segments —

- xt  : 10 fixed points      h in arange(-1.5, -0.5, 0.1)         (the past)
- x2t : 10 random points     h ~ U[-0.5 + i/10, -0.5 + (i+1)/10)  (the middle)
- x3t : 10 random points     h ~ U[ 0.5 + i/10,  0.5 + (i+1)/10)  (the future)

with per-alpha numpy seeds so the "ground truth" randomness is reproducible
across epochs. The alphas enumerate arange(0.001, 10.001, 0.001) (10k curves),
shuffled once and re-organized into fixed batches.
"""

from __future__ import annotations

import math
import random
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np


def make_toy_alphas(shuffle_seed: int | None = None
                    ) -> Tuple[List[float], Dict[float, int]]:
    """Alphas + their per-alpha data seeds (tools/toy_example.py:104-105).

    The reference seeds each alpha with its *pre-shuffle* index.
    """
    alphas = [float(a) for a in np.arange(0.001, 10.001, 0.001)]
    seeds = {a: i for i, a in enumerate(alphas)}
    rng = random.Random(shuffle_seed)
    rng.shuffle(alphas)
    return alphas, seeds


def batch_alphas(alphas: Sequence[float], batch_size: int
                 ) -> List[Tuple[List[float], List[str]]]:
    """Re-organize into (alpha_batch, name_batch) pairs
    (tools/toy_example.py:101-111)."""
    batches = []
    for i in range(0, len(alphas), batch_size):
        chunk = list(alphas[i: i + batch_size])
        names = [f"toyexample_alpha{a}" for a in chunk]
        batches.append((chunk, names))
    return batches


def gen_toy_batch(alphas: Sequence[float], seeds: Dict[float, int]
                  ) -> Dict[str, np.ndarray]:
    """Materialize one batch of (xt, x2t, x3t), each (B, 10) float32
    (reference function.py:448-462)."""
    xt, x2t, x3t = [], [], []
    xt_h = [h for h in np.arange(-1.5, -0.5, 0.1)]
    for alpha in alphas:
        np.random.seed(seeds[alpha])
        x2t_h = [np.random.uniform(-0.5 + i / 10.0, -0.5 + (i + 1) / 10.0)
                 for i in range(10)]
        x3t_h = [np.random.uniform(0.5 + i / 10.0, 0.5 + (i + 1) / 10.0)
                 for i in range(10)]
        sig = lambda h: 1.0 / (1.0 + math.exp(-alpha * h))
        xt.append([sig(h) for h in xt_h])
        x2t.append([sig(h) for h in x2t_h])
        x3t.append([sig(h) for h in x3t_h])
    return {
        "xt": np.asarray(xt, np.float32),
        "x2t": np.asarray(x2t, np.float32),
        "x3t": np.asarray(x3t, np.float32),
    }


class ToyLoader:
    """Iterable over toy batches: yields (batch_dict, names).

    Batches are generated on the fly from alphas+seeds, like the reference's
    in-loop ``_gen_toyexample_data`` (function.py:484-485).
    """

    def __init__(self, batch_size: int = 500, shuffle_seed: int | None = None,
                 num_batches: int | None = None):
        alphas, self.seeds = make_toy_alphas(shuffle_seed)
        self.batches = batch_alphas(alphas, batch_size)
        if num_batches is not None:
            self.batches = self.batches[:num_batches]

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self) -> Iterator[Tuple[Dict[str, np.ndarray], List[str]]]:
        for chunk, names in self.batches:
            yield gen_toy_batch(chunk, self.seeds), names
