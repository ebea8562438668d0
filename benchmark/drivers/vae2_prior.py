"""Closed loop over test clips, the paper's evaluation without the files:
per clip, ``samples`` prior samples through ``make_prior_sampler(system,
chunk, H, W)`` (calls of ``chunk``, the last one's first samples kept), x2p
scored against x2t and x3p against x3t by ``make_metric_fn``, and the
scores copied to the host, as ``core.infer_loop.run_inference`` does them.
Each clip draws its noise from a generator seeded by the run's seed and
the clip's index.

BN runs on running statistics. The benchmark sets them: the reference, in
float32, runs the encoder-decoders once on a few of the pool's clips and
keeps each BN's batch statistics; both sides get the same buffers. The
check takes, drawn from the seed, ``checked_clips`` of the window's first
``checked_from`` clips and ``checked_samples`` of their samples; the window
keeps those samples' predicted frames (a copy on the device) besides their
scores. After the window the reference redraws each clip's noise in order
and decodes the samples: ``frame_gap`` holds the program's frames against
its frames, ``score_gap`` the program's scores against the reference's
scores of the program's own frames."""

from __future__ import annotations

import random
import time
from typing import Dict

import torch

from .. import compare, inputs, weights
from ..reference import nets, quant, scores, steps
from .vae2_train import _config, _free

UNIT = "bench.clip"


def counts(recipe: dict, traffic: dict) -> dict:
    """The work of one test clip, from the reference."""
    from .. import counts as c

    return c.vae2_prior(recipe, traffic["samples"])


def _clip_seed(run, i: int) -> int:
    return inputs.sub_seed(run.seed, 100, i)


def calibrated_state(run, recipe, g) -> Dict[str, torch.Tensor]:
    """The benchmark's weights with every encoder-decoder BN's running
    statistics set by the float32 reference from a few seeded clips."""
    t = run.traffic
    w, h = recipe["TRAIN"]["IMAGE_SIZE"]
    z_dim = recipe["MODEL"]["EXTRA"]["Z_DIM"]
    frames, dev, n = recipe["TRAIN"]["CLIP_LENGTH"], run.device, t["calibration_clips"]
    build = lambda: nets.vae2_modules(recipe)  # noqa: E731
    state = weights.make_state(weights.skeleton(build), inputs.sub_seed(run.seed, 1), dev)
    ref = weights.reference_on(dev, build, state)["encdec"]
    xt = inputs.frames_u8(g, n, h, w, 3 * frames, t["coarse"], dev)
    z = [inputs.normal(g, (n, z_dim, h >> k, w >> k), dev) for k in range(4)]
    code = inputs.normal(g, (n, z_dim), dev)
    with torch.no_grad(), nets.calibrating(), quant.exact_f32():
        ref(scores.normalize(xt).permute(0, 3, 1, 2), z, code)
    for name, buf in ref.named_buffers():
        state[f"encdec.{name}"] = buf.detach().clone()
    return state


def setup(run) -> dict:
    from vae2_tpu_torch.core import infer_loop
    from vae2_tpu_torch.core.builder import build_system

    recipe, t, dev = run.config["recipe"], run.traffic, run.device
    w, h = recipe["TRAIN"]["IMAGE_SIZE"]
    g = torch.Generator(device=dev).manual_seed(inputs.sub_seed(run.seed, 2))
    state0 = calibrated_state(run, recipe, g)
    system = build_system(_config(recipe), device=dev)
    system.modules.load_state_dict(state0, strict=True)
    system.modules.eval()
    frames = recipe["TRAIN"]["CLIP_LENGTH"]
    pool = inputs.clips(g, t["pool"], h, w, frames, t["coarse"], dev)
    st = {"run": run, "system": system, "state0": state0, "recipe": recipe,
          "pool": pool, "sampler": infer_loop.make_prior_sampler(system, t["chunk"], h, w),
          "metric_fn": infer_loop.make_metric_fn(), "scores": {}, "frames": {},
          "picks": dict(picks_of(run)), "next": 0}
    for i in range(int(t["warmup_clips"])):
        _clip(st, -1 - i)
    st["scores"].clear()
    return st


def _clip(st, i: int) -> None:
    """One test clip, as run_inference evaluates it; its scores (host
    arrays) are kept for the check."""
    run, t = st["run"], st["run"].traffic
    k = i % t["pool"]
    xt, x2t, x3t = (st["pool"][n][k:k + 1] for n in ("xt", "x2t", "x3t"))
    g = torch.Generator(device=run.device).manual_seed(_clip_seed(run, i))
    out = {"x2": [], "x3": []}
    done = 0
    while done < t["samples"]:
        with torch.profiler.record_function("bench.sample"):
            _, x2p, x3p = st["sampler"](xt, x2t, g)
            st.get("sync", lambda: None)()
        take = min(t["chunk"], t["samples"] - done)
        if i in st["picks"]:
            _keep(st, i, done, take, x2p, x3p)
        with torch.profiler.record_function("bench.score"):
            m2 = st["metric_fn"](x2p[:take].permute(0, 2, 3, 1), x2t)
            m3 = st["metric_fn"](x3p[:take].permute(0, 2, 3, 1), x3t)
            st.get("sync", lambda: None)()
        with torch.profiler.record_function("bench.to_host"):
            out["x2"].append({k2: v.cpu().numpy() for k2, v in m2.items()})
            out["x3"].append({k2: v.cpu().numpy() for k2, v in m3.items()})
        done += take
    st["scores"][i] = out


def _keep(st, i, done, take, x2p, x3p) -> None:
    """A copy of the checked samples of this call (indices into the clip's
    samples), kept on the device for the check."""
    rows = [s - done for s in st["picks"][i] if done <= s < done + take]
    if rows:
        idx = torch.as_tensor(rows, device=x2p.device)
        st["frames"].setdefault(i, []).append((x2p.index_select(0, idx),
                                               x3p.index_select(0, idx)))


def window(st, seconds: float) -> dict:
    run, t = st["run"], st["run"].traffic
    marks = []
    run.sync()
    t0 = time.perf_counter()
    n = 0
    while True:
        _clip(st, st["next"])
        st["next"] += 1
        n += 1
        marks.append(time.perf_counter())
        if marks[-1] - t0 >= seconds and n >= t["checked_from"]:
            break
    run.sync()
    t1 = time.perf_counter()
    bad = sum(1 for out in st["scores"].values()
              for part in out.values() for d in part for v in d.values()
              if not (v == v).all())
    return {"kind": "sample", "attempted": n, "failed": bad, "clips": n,
            "frames": n * t["samples"] * 9, "seconds": t1 - t0,
            "unit_s": [b - a for a, b in zip([t0] + marks, marks)]}


def traced_unit(st) -> None:
    st["sync"] = st["run"].sync
    _clip(st, st["next"])
    st["next"] += 1
    st.pop("sync")


def _flat(out, key: str, idx) -> list:
    """The scores of samples ``idx`` of one clip (x2 then x3), flat."""
    vals = []
    for part in ("x2", "x3"):
        allv = torch.cat([torch.as_tensor(d[key]) for d in out[part]])
        vals += allv[idx].reshape(-1).tolist()
    return vals


def _gt(pool, i, t):
    k = i % t["pool"]
    return tuple(pool[n][k:k + 1] for n in ("xt", "x2t", "x3t"))


def reference_frames(run, recipe, state0, pool, picks, encdec=None) -> list:
    """The reference's (x2p, x3p) of the picked (clip, samples), redrawing
    each clip's noise in the sampler's order."""
    t, dev = run.traffic, run.device
    w, h = recipe["TRAIN"]["IMAGE_SIZE"]
    z_dim = recipe["MODEL"]["EXTRA"]["Z_DIM"]
    if encdec is None:
        encdec = weights.reference_on(dev, lambda: nets.vae2_modules(recipe), state0)["encdec"]
    encdec.eval()
    out = []
    calls = -(-t["samples"] // t["chunk"])
    with quant.exact_f32():
        for i, idx in picks:
            g = torch.Generator(device=dev).manual_seed(_clip_seed(run, i))
            draws = [steps.prior_draws(g, t["chunk"], z_dim, h, w, dev) for _ in range(calls)]
            sel = torch.as_tensor(idx, device=dev)
            z = [torch.cat([d[0][b] for d in draws])[sel] for b in range(4)]
            code = torch.cat([d[1] for d in draws])[sel]
            _, x2p, x3p = steps.prior_samples(encdec, _gt(pool, i, t)[0], z, code)
            out.append((x2p, x3p))
    return out


def reference_scores(run, pool, picks, frames, dtype=torch.float32) -> Dict[str, list]:
    """The reference's scores of the given frames of the picked clips."""
    out = {k: [] for k in ("recon", "psnr", "ssim", "msssim")}
    with quant.exact_f32():
        for (i, _), (x2p, x3p) in zip(picks, frames):
            _, x2t, x3t = _gt(pool, i, run.traffic)
            got = {"x2": scores.frame_scores(x2p.permute(0, 2, 3, 1), x2t, dtype),
                   "x3": scores.frame_scores(x3p.permute(0, 2, 3, 1), x3t, dtype)}
            for key in out:
                for part in ("x2", "x3"):
                    out[key] += got[part][key].reshape(-1).tolist()
    return out


def picks_of(run) -> list:
    """(clip, sorted sample indices) to check, drawn from the seed among the
    window's first ``checked_from`` clips."""
    t = run.traffic
    rng = random.Random(inputs.sub_seed(run.seed, 7))
    clips = sorted(rng.sample(range(t["checked_from"]), t["checked_clips"]))
    return [(c, sorted(rng.sample(range(t["samples"]), t["checked_samples"])))
            for c in clips]


def control(run) -> Dict[str, float]:
    """The check's numbers for the reference in float8 (its scores in
    bfloat16) in the program's place, against the reference in float32
    (``benchmark.calibrate``)."""
    recipe, t, dev = run.config["recipe"], run.traffic, run.device
    w, h = recipe["TRAIN"]["IMAGE_SIZE"]
    g = torch.Generator(device=dev).manual_seed(inputs.sub_seed(run.seed, 2))
    state0 = calibrated_state(run, recipe, g)
    pool = inputs.clips(g, t["pool"], h, w, recipe["TRAIN"]["CLIP_LENGTH"], t["coarse"], dev)
    picks = picks_of(run)
    ref = reference_frames(run, recipe, state0, pool, picks)
    with quant.fp8():
        low = reference_frames(run, recipe, state0, pool, picks)
    judged = reference_scores(run, pool, picks, ref)
    low_scores = reference_scores(run, pool, picks, ref, torch.bfloat16)
    return {"frame_gap": compare.frame_gap([x for f in low for x in f],
                                           [x for f in ref for x in f]),
            "score_gap": compare.score_gap(low_scores, judged)}


def check(st) -> Dict[str, float]:
    run = st["run"]
    st.pop("system"), st.pop("sampler"), st.pop("metric_fn")
    _free(run)
    picks = [(i, idx) for i, idx in st["picks"].items() if i in st["scores"]]
    if len(picks) < len(st["picks"]):
        return {"frame_gap": float("inf"), "score_gap": float("inf")}
    prog_frames = [tuple(torch.cat([f[j] for f in st["frames"][i]]).float() for j in (0, 1))
                   for i, _ in picks]
    ref_frames = reference_frames(run, st["recipe"], st["state0"], st["pool"], picks)
    prog_scores = {k: sum((_flat(st["scores"][i], k, idx) for i, idx in picks), [])
                   for k in ("recon", "psnr", "ssim", "msssim")}
    judged = reference_scores(run, st["pool"], picks, prog_frames)
    return {"frame_gap": compare.frame_gap([x for f in prog_frames for x in f],
                                           [x for f in ref_frames for x in f]),
            "score_gap": compare.score_gap(prog_scores, judged)}
