"""Repeat the elu case of ``tests/test_torch_port_gpu.py::
test_fused_abn_on_card_matches_cpu`` on one NVIDIA GPU and look for what
could make it fail now and then.

    python -m vae2_tpu_torch.tools.elu_repeat [--repeats 50] [--fresh 50]
        [--out FILE]

It runs the case (the ``fused_abn`` autograd op in f32 on the card, kernels
1-3, against the CPU's plain versions; y to 1e-6, dx/dgamma/dbeta to 1e-5 *
(1 + max), rtol 1e-5) and reports, for each output, the largest ratio of
error to tolerance (a pass is <= 1):

- ``in_process``: ``--repeats`` times in this process, and whether every
  repeat's card outputs equal the first's bit for bit;
- ``fresh``: once in each of ``--fresh`` new processes (4 at a time);
- ``scratch``: the whole card test file under pytest in this process, with
  kernel 2's ticket counter of every (device, stream) scratch buffer read
  before and after each launch (each must be 0: a nonzero counter would let
  a block reduce partial sums that are not all written), then the case;
- ``conditioning``: elu inverted from y, z = log(1 + y), is ill-conditioned
  as y -> -1. The line gives the card's and the CPU's y (the ulps where
  they differ, the least 1 + y), the card's backward from the CPU's own y
  and the CPU's backward from the card's y, each against the CPU's.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
from typing import Dict, List

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAMES = ("y", "dx", "dgamma", "dbeta")


def inputs():
    """The test's inputs (seed 4), on the CPU."""
    g = torch.Generator().manual_seed(4)
    x = (torch.randn(4, 12, 20, 36, generator=g) * 2).permute(0, 3, 1, 2)
    gamma = torch.rand(36, generator=g) + 0.5
    beta = torch.randn(36, generator=g) * 0.3
    dz = torch.randn(4, 12, 20, 36, generator=g).permute(0, 3, 1, 2)
    return x, gamma, beta, dz


def run(device) -> List[torch.Tensor]:
    """(y, dx, dgamma, dbeta) of the fused ABN (elu) on ``device``, on the
    CPU."""
    from vae2_tpu_torch.ops import abn

    x, gamma, beta, dz = inputs()
    xx = x.to(device).detach().clone().requires_grad_(True)
    gg = gamma.to(device).detach().clone().requires_grad_(True)
    bb = beta.to(device).detach().clone().requires_grad_(True)
    y = abn.fused_abn(xx, gg, bb, 1e-5, 0.01, "elu")
    y.backward(dz.to(device))
    return [t.detach().cpu() for t in (y, xx.grad, gg.grad, bb.grad)]


def ratio(got: torch.Tensor, want: torch.Tensor, i: int) -> float:
    """max |got - want| / (atol + rtol |want|), the test's tolerance."""
    atol = (1e-6 if i == 0 else 1e-5) * (1.0 + float(want.abs().max()))
    return float(((got - want).abs() / (atol + 1e-5 * want.abs())).max())


def ratios(got, want) -> Dict[str, float]:
    return {n: ratio(g, w, i) for i, (n, g, w) in
            enumerate(zip(NAMES, got, want))}


def in_process(repeats: int) -> dict:
    want = run("cpu")
    first, rows = None, []
    for _ in range(repeats):
        got = run("cuda")
        torch.cuda.synchronize()
        if first is None:
            first = got
        rows.append({**ratios(got, want), "equal_to_first": all(
            torch.equal(a, b) for a, b in zip(got, first))})
    return {"repeats": repeats,
            "max_ratio": {n: max(r[n] for r in rows) for n in NAMES},
            "min_ratio": {n: min(r[n] for r in rows) for n in NAMES},
            "failures": sum(max(r[n] for n in NAMES) > 1 for r in rows),
            "all_equal_to_first": all(r["equal_to_first"] for r in rows)}


def fresh(count: int) -> dict:
    cmd = [sys.executable, "-m", "vae2_tpu_torch.tools.elu_repeat", "--once"]

    def one(_):
        out = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                             timeout=600, check=True)
        return json.loads(out.stdout.strip().splitlines()[-1])

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        rows = list(pool.map(one, range(count)))
    return {"processes": count,
            "max_ratio": {n: max(r[n] for r in rows) for n in NAMES},
            "min_ratio": {n: min(r[n] for r in rows) for n in NAMES},
            "failures": sum(max(r[n] for n in NAMES) > 1 for r in rows),
            "distinct_dx_ratios": len({r["dx"] for r in rows})}


class CounterProbe:
    """A pytest plugin that wraps kernel 2's launch: every scratch
    buffer's ticket counter is read before and after it (synchronised)."""

    def __init__(self):
        self.calls = self.nonzero = 0
        self.worst = 0

    def _counters(self):
        from vae2_tpu_torch.ops import abn

        torch.cuda.synchronize()
        return [int(t[:1].view(torch.int32).item())
                for t in abn._sums_scratch.values()]

    def pytest_sessionstart(self, session):
        from vae2_tpu_torch.ops import abn

        orig = abn._sums_cuda
        probe = self

        def wrapped(*args, **kwargs):
            if (torch.cuda.is_current_stream_capturing()
                    or torch.autograd._profiler_enabled()):
                # a captured launch never runs; a profiled call must show
                # its own kernel alone
                return orig(*args, **kwargs)
            before = probe._counters()
            out = orig(*args, **kwargs)
            after = probe._counters()
            probe.calls += 1
            bad = [c for c in before + after if c != 0]
            probe.nonzero += bool(bad)
            probe.worst = max([probe.worst] + [abs(c) for c in bad])
            return out

        abn._sums_cuda = wrapped


def scratch() -> dict:
    import pytest

    probe = CounterProbe()
    rc = pytest.main([os.path.join(REPO, "tests", "test_torch_port_gpu.py"),
                      "-m", "gpu", "-q", "-p", "no:cacheprovider", "-x"],
                     plugins=[probe])
    got, want = run("cuda"), run("cpu")
    return {"pytest_rc": int(rc), "sums_launches_probed": probe.calls,
            "launches_with_a_nonzero_counter": probe.nonzero,
            "largest_counter": probe.worst,
            "after_the_file": ratios(got, want)}


def conditioning() -> dict:
    from vae2_tpu_torch.ops import abn

    want = run("cpu")
    got = run("cuda")
    y_cpu, y_card = want[0], got[0]
    differ = y_cpu != y_card
    ulps = (y_cpu.view(torch.int32).long()
            - y_card.view(torch.int32).long()).abs()
    x, gamma, beta, dz = inputs()
    mean, var = abn.batch_stats(x)
    gamma_inv = gamma * torch.rsqrt(var + 1e-5)

    def backward(y, dev):
        args = [t.to(dev) for t in (y, dz.contiguous(
            memory_format=torch.channels_last), gamma, beta)]
        sums = abn.abn_bwd_sums(*args, 0.01, "elu")
        dx = abn.abn_bwd_dx(*args, gamma_inv.to(dev), sums, 0.01, "elu",
                            y.numel() // y.shape[1])
        return [dx.cpu(), sums[1].cpu(), sums[0].cpu()]

    ref = backward(y_cpu, "cpu")
    same_y = backward(y_cpu, "cuda")
    moved_y = backward(y_card, "cpu")
    neg = y_cpu[y_cpu < 0]
    return {"y_elements_differing": int(differ.sum()),
            "y_max_ulps": int(ulps.max()),
            "least_1_plus_y": float((1.0 + neg).min()),
            "least_1_plus_y_where_y_differs": (
                float((1.0 + y_cpu[differ & (y_cpu < 0)]).min())
                if bool((differ & (y_cpu < 0)).any()) else None),
            "card_backward_from_cpu_y": {
                n: ratio(g, w, 1) for n, g, w in
                zip(NAMES[1:], same_y, ref)},
            "cpu_backward_from_card_y": {
                n: ratio(g, w, 1) for n, g, w in
                zip(NAMES[1:], moved_y, ref)},
            "batch_stats_card_vs_cpu": [
                float((a.cpu() - b).abs().max()) for a, b in
                zip(abn.batch_stats(x.to("cuda")), (mean, var))]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repeats", type=int, default=50)
    parser.add_argument("--fresh", type=int, default=50)
    parser.add_argument("--once", action="store_true",
                        help="one case, its ratios as one JSON line")
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("elu_repeat: needs a CUDA device", file=sys.stderr)
        return 1
    if args.once:
        print(json.dumps(ratios(run("cuda"), run("cpu"))))
        return 0
    result = {"device": torch.cuda.get_device_name(0),
              "in_process": in_process(args.repeats),
              "conditioning": conditioning(),
              "fresh": fresh(args.fresh) if args.fresh else None,
              "scratch": scratch()}
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
