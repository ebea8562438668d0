"""A cell of several cards, run as one process a card.

The launcher (:func:`launch`, in the process the command started) starts
``chips`` workers of the same module, each with torchrun's variables
(``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) and a spec as its ``--worker`` argument:
the launcher's start on the wall clock (set-up counts from it), its pid,
the timeouts, and for tests the device type, the cell's parts and a
fault. It waits for all of them, ends every worker as soon as one fails
or the deadline passes, and then passes on what they printed: the other
ranks' standard error, rank 0's, and rank 0's standard output last, so
that the result's line stays the last line and the check lines the last
lines of standard error.

A worker (:func:`join`) takes the card ``cuda:LOCAL_RANK``, joins the
program's process group through the program's own path
(``vae2_tpu_torch.parallel.dist.initialize_distributed``, as the train CLI
does under torchrun), with a finite timeout on every collective, and opens
a gloo side group on the host for the harness's own agreements (the
window's end, the gathered results). A rank that waits longer than the
timeout for the others fails, and the launcher then ends the rest; a
worker whose launcher dies is killed with it.
"""

from __future__ import annotations

import ctypes
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parents[1]
# the longest any collective of a rank may wait for the others (NCCL, gloo)
TIMEOUT_S = 300.0
# the whole run of a cell, its first build in a checkout included
DEADLINE_S = 1150.0
# how long the other ranks may take to end after rank 0 has
GRACE_S = 30.0
# rank 0's code where a rank loaded JAX or the JAX package (``run.report``)
GUARD_RC = 3
PR_SET_PDEATHSIG = 1


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(module: str, argv: List[str], chips: int, spec: dict,
           deadline: float = DEADLINE_S) -> int:
    """Run ``python -m module *argv --worker <spec>`` as ``chips`` ranks;
    returns 0 when every rank exits 0, ``GUARD_RC`` when rank 0 exits
    with it and the others 0, else 1. Rank 0's standard output is passed on only
    when every rank exited 0."""
    spec = {"timeout_s": TIMEOUT_S, **spec, "launcher": os.getpid()}
    cmd = [sys.executable, "-m", module, *argv, "--worker", json.dumps(spec)]
    port = str(free_port())
    procs, files, why = [], [], ""
    previous = signal.signal(signal.SIGTERM, _raise_exit)
    try:
        for r in range(chips):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(chips),
                       LOCAL_WORLD_SIZE=str(chips), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=port)
            env.setdefault("OMP_NUM_THREADS", "1")  # as torchrun sets it
            out, err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
            files.append((out, err))
            procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out, stderr=err,
                                          start_new_session=True))
        why = _wait(procs, time.monotonic() + deadline)
    finally:
        _end(procs)
        signal.signal(signal.SIGTERM, previous)
    rcs = [p.returncode for p in procs]
    for r in list(range(1, len(files))) + [0]:
        sys.stderr.write(_read(files[r][1]))
    if why:
        print(f"benchmark: {why}; exit codes by rank {rcs}", file=sys.stderr)
    if not any(rcs) and not why:
        sys.stdout.write(_read(files[0][0]))
        sys.stdout.flush()
        return 0
    if not why and rcs[0] == GUARD_RC:
        return GUARD_RC
    return 1


def _raise_exit(signum, frame):
    raise SystemExit(128 + signum)


def _wait(procs, deadline: float) -> str:
    """'' once every rank has exited 0, or rank 0 with the JAX guard's
    code (``GUARD_RC``, once the results are gathered) and the others 0;
    otherwise why the run was ended. The others get ``GRACE_S`` to end
    after rank 0 has."""
    grace = None
    while True:
        rcs = [p.poll() for p in procs]
        failed = [r for r, rc in enumerate(rcs)
                  if rc not in (None, 0) and (r, rc) != (0, GUARD_RC)]
        if failed:
            return f"rank {failed[0]} exited with {rcs[failed[0]]}: the others were ended"
        if None not in rcs:
            return ""
        if rcs[0] is not None:
            grace = grace or time.monotonic() + GRACE_S
            if time.monotonic() > grace:
                return f"rank 0 exited with {rcs[0]}: the others were ended"
        if time.monotonic() > deadline:
            return "the ranks passed the run's deadline and were ended"
        time.sleep(0.1)


def _end(procs) -> None:
    """Kill every rank's process group (a rank and whatever it started)
    and wait for each."""
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    for p in procs:
        p.wait()


def _read(f) -> str:
    f.seek(0)
    return f.read().decode(errors="replace")


def _die_with(launcher: int) -> None:
    """This process is killed when its launcher dies (Linux), and ends now
    if that has happened already."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
    except (OSError, AttributeError):
        pass
    if os.getppid() != launcher:
        os._exit(1)


def join(spec: dict):
    """This worker's rank, world size, device and gloo side group, in the
    process group of the program's own initialisation."""
    _die_with(int(spec["launcher"]))
    import torch
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    from vae2_tpu_torch.parallel.dist import initialize_distributed

    kind = spec.get("device", "cuda")
    local = int(os.environ["LOCAL_RANK"])
    device = torch.device(kind, local) if kind == "cuda" else torch.device(kind)
    if kind == "cuda":
        torch.cuda.set_device(device)  # the program's kernels launch on the current card
    timeout = timedelta(seconds=float(spec["timeout_s"]))
    # init_process_group, called without a timeout, takes these
    c10d.default_pg_timeout = c10d.default_pg_nccl_timeout = timeout
    rank, world, _ = initialize_distributed("", kind)
    group = dist.new_group(backend="gloo", timeout=timeout)
    return rank, world, device, group


def leave() -> None:
    from vae2_tpu_torch.parallel.dist import shutdown_distributed

    shutdown_distributed()


def gather(obj, group) -> List:
    """Every rank's ``obj``, in rank order, on every rank."""
    import torch.distributed as dist

    out: List[Optional[object]] = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def rank_of(group) -> int:
    import torch.distributed as dist

    return dist.get_rank(group)
