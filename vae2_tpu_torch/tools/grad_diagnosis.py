"""Per-loss-term gradient attribution for the VAE² generator (counterpart of
tools/grad_diagnosis.py).

Every generator loss term pulls on the predicted middle clip ``x2p``: the
direct L1, both decoder reconstructions (which take x2p as their input,
``VAE2EncDec``) and the two LSGAN terms. The per-pixel gradient that each
term lands on x2p tells which one steers the prediction; the gradient on
the generator's parameters, split encdec / encz, is each term's whole
training signal. Reports, for each lambda-weighted term: the gradient on
x2p (mean |g| per pixel, global norm), the gradient norms on encdec and
encz, and the weighted loss.

    python -m vae2_tpu_torch.tools.grad_diagnosis --cfg experiments/... \
        [--checkpoint ckpt.pt|.msgpack] [--out diag.json] [KEY VALUE ...]

Runs on CUDA (GPU.DEVICE) unless ``--device cpu``. :func:`attribute` is the
measurement; the CLI builds its inputs. As in the JAX tool: part 1 takes
the gradient of each term with respect to the prediction of one posterior
and encoder pass, held as a leaf; part 2 the gradient of each term of one
``generator_loss`` with respect to the generator's parameters. The KL's
lambda is X3RECON_LAMBDA (the image family's, not annealed), the frame GAN
term is 0.5 * (C // 3) * lsgan of the frame discriminator on the folded
frames, and the JSON has the JAX tool's schema. The networks run in train
mode on batch statistics; the running statistics they update on the way
are put back afterwards, so a loaded checkpoint leaves as it came.
"""

from __future__ import annotations

import argparse
import json
import pprint
from typing import Dict, Optional, Sequence

import torch

from ..config import get_default_config, update_config
from ..core import losses
from ..core.builder import build_system
from ..core.system import _nchw, normal_like, reparameterize
from ..data.loader import normalize_clips
from ..ops import abn

# terms on x2p, then the KL, which does not reach x2p (the JAX tool's order)
X2P_TERMS = ("x2_recon", "x1_recon", "x3_recon", "gan_seq", "gan_frame")
TERMS = X2P_TERMS + ("z_kl",)
METRICS = {"x1_recon": "loss_xt_recon", "x2_recon": "loss_x2t_recon",
           "x3_recon": "loss_x3t_recon", "z_kl": "loss_z_KL",
           "gan_seq": "loss_x2t_gan_sequence",
           "gan_frame": "loss_x2t_gan_frame"}
KERNELS = ("abn_rows", "abn_bwd_sums", "abn_bwd_dx")
# the networks that each term's gradient runs through: on x2p (part 1) and
# on the generator's parameters (part 2)
X2P_NETS = {"x2_recon": (), "x1_recon": ("dec_past",),
            "x3_recon": ("dec_future",), "gan_seq": ("d_seq",),
            "gan_frame": ("d_frame",)}
PARAM_NETS = {"x2_recon": ("encoder", "encz"),
              "x1_recon": ("dec_past", "encoder", "encz"),
              "x3_recon": ("dec_future", "encoder", "encz"),
              "gan_seq": ("d_seq", "encoder", "encz"),
              "gan_frame": ("d_frame", "encoder", "encz"),
              "z_kl": ("encz",)}


def lambdas(hyper) -> Dict[str, float]:
    """Each term's weight (grad_diagnosis.py:101-108): the KL takes
    X3RECON_LAMBDA, as the image family's loss does."""
    return {"x1_recon": hyper.x1recon_lambda,
            "x2_recon": hyper.x2recon_lambda,
            "x3_recon": hyper.x3recon_lambda,
            "z_kl": hyper.x3recon_lambda,
            "gan_seq": hyper.gan_lambda, "gan_frame": hyper.gan_lambda}


def _norm(grads) -> float:
    sq = [g.float().pow(2).sum() for g in grads if g is not None]
    return float(torch.stack(sq).sum().sqrt()) if sq else 0.0


def _counts() -> Dict[str, int]:
    return {k: getattr(abn, k).launches for k in KERNELS}


def attribute(system, batch: Dict[str, torch.Tensor], lam: Dict[str, float],
              eps=None, rand_code: Optional[torch.Tensor] = None,
              g_eps=None, g_rand_code: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              launches: Optional[dict] = None) -> Dict[str, dict]:
    """The attribution table: per term of :data:`TERMS`, its weighted loss,
    ``grad_x2p_mean_abs`` and ``grad_x2p_norm`` (part 1; zero for the KL,
    whose loss is that of part 1's posterior), ``grad_encdec_norm`` and
    ``grad_encz_norm`` (part 2).

    ``batch`` holds the clips 'xt', 'x2t', 'x3t' (uint8 or normalized
    NHWC). Part 1's noise is ``eps`` (shaped like the posterior's mus) and
    the encoder's ``rand_code``; part 2's, that of the ``generator_loss``
    call, ``g_eps`` and ``g_rand_code``; each one that is None is drawn
    from ``generator``, in that order. ``launches``, a dict, gets the
    fused-ABN kernels' launches of each stage ('forward_x2p', 'x2p:<term>',
    'forward', 'params:<term>'), as :func:`expected_launches` counts them
    from the model. The parameters, the running statistics, the networks'
    train flags and the discriminators' ``requires_grad`` are as they were
    on return."""
    h = system.hyper
    if h.is_baseline or h.deterministic:
        raise ValueError("the attribution needs the full adversarial VAE² "
                         "graph (IS_BASELINE False, not DETERMINISTIC)")
    mods = system.modules
    batch = {k: normalize_clips(v) if v.dtype == torch.uint8 else v
             for k, v in batch.items()}
    xt, x2t, x3t = batch["xt"], batch["x2t"], batch["x3t"]
    buffers = {k: v.clone() for k, v in mods.named_buffers()}
    was_training = {k: m.training for k, m in mods.items()}
    d_params = list(system.d_parameters())
    d_flags = [p.requires_grad for p in d_params]
    last = [_counts() if launches is not None else None]

    def mark(name):
        if launches is not None:
            now = _counts()
            launches[name] = {k: now[k] - last[0][k] for k in KERNELS}
            last[0] = now

    mods.train()
    try:
        for p in d_params:
            p.requires_grad_(False)
        # part 1: the gradient of each term on the prediction x2p
        with torch.no_grad():
            mus, logvars = system.posterior(xt, x2t, x3t)
            if eps is None:
                eps = normal_like(mus, generator)
            z = reparameterize(mus, logvars, eps)
            x2p0 = mods["encdec"].encode(
                _nchw(system._encoder_input(xt, x2t)), z, rand_code=rand_code,
                generator=generator)
            kl = float(losses.kl_loss(mus, logvars))
        mark("forward_x2p")
        encdec = mods["encdec"]
        on_x2p = {
            "x2_recon": lambda x: losses.l1_loss(x, _nchw(x2t)),
            "x1_recon": lambda x: losses.l1_loss(encdec.dec_past(x, z),
                                                 _nchw(xt)),
            "x3_recon": lambda x: losses.l1_loss(encdec.dec_future(x, z),
                                                 _nchw(x3t)),
            "gan_seq": lambda x: 0.5 * losses.lsgan_loss(mods["d_seq"](x),
                                                         real=True),
            "gan_frame": lambda x: system._frame_gan(x, True),
        }
        table = {}
        for name in X2P_TERMS:
            x2p = x2p0.detach().requires_grad_()
            val = lam[name] * on_x2p[name](x2p)
            g, = torch.autograd.grad(val, x2p)
            g = g.float()
            table[name] = {"loss": float(val.detach()),
                           "grad_x2p_mean_abs": float(g.abs().mean()),
                           "grad_x2p_norm": float(g.norm())}
            mark(f"x2p:{name}")
        table["z_kl"] = {"loss": lam["z_kl"] * kl, "grad_x2p_mean_abs": 0.0,
                         "grad_x2p_norm": 0.0}

        # part 2: the gradient of each term of one generator_loss on the
        # generator's parameters (one forward, a backward per term)
        _, metrics, _ = system.generator_loss(
            batch, generator, eps=g_eps, rand_code=g_rand_code,
            detach_metrics=False)
        mark("forward")
        params = {net: list(mods[net].parameters())
                  for net in ("encdec", "encz")}
        flat = params["encdec"] + params["encz"]
        for i, name in enumerate(TERMS):
            grads = torch.autograd.grad(
                lam[name] * metrics[METRICS[name]], flat, allow_unused=True,
                retain_graph=i < len(TERMS) - 1)
            n = len(params["encdec"])
            table[name] = {"grad_encdec_norm": _norm(grads[:n]),
                           "grad_encz_norm": _norm(grads[n:]),
                           **table[name]}
            mark(f"params:{name}")
        del metrics
    finally:
        with torch.no_grad():
            for k, v in mods.named_buffers():
                v.copy_(buffers[k])
        for k, m in mods.items():
            m.train(was_training[k])
        for p, flag in zip(d_params, d_flags):
            p.requires_grad_(flag)
    return {name: table[name] for name in TERMS}


def relative_pulls(table: Dict[str, dict]) -> Dict[str, float]:
    """Each term's per-pixel pull on x2p over the direct x2 L1's."""
    direct = table["x2_recon"]["grad_x2p_mean_abs"]
    return {k: v["grad_x2p_mean_abs"] / max(direct, 1e-30)
            for k, v in table.items() if k not in ("x2_recon", "z_kl")}


def expected_launches(system) -> Dict[str, Dict[str, int]]:
    """Per stage of :func:`attribute`, the fused-ABN kernels' launches
    counted from the model: a network's forward launches kernel 1 once per
    BN of act None/leaky_relu/elu; a backward through it, kernels 2 and 3
    once per such BN, and kernel 1 once more per such BN inside a
    recomputed region (an HRModule under TPU.REMAT 'stage', the whole
    trunk under 'trunk'). Part 1's forward runs without autograd, so
    without recomputes."""
    from ..ops.norm import BatchNormAct
    from .ddp_check import recomputed as _recomputed

    def abns(net):
        return sum(isinstance(m, BatchNormAct) and m.act != "relu"
                   for m in net.modules())

    def recomputed(net):
        return _recomputed(net, abns)

    encdec = system.modules["encdec"]
    nets = {"encoder": encdec.encoder, "dec_past": encdec.dec_past,
            "dec_future": encdec.dec_future,
            **{k: system.modules[k] for k in ("encz", "d_seq", "d_frame")}}

    def backward(names):
        b = sum(abns(nets[k]) for k in names)
        return {"abn_rows": sum(recomputed(nets[k]) for k in names),
                "abn_bwd_sums": b, "abn_bwd_dx": b}

    out = {"forward_x2p": {"abn_rows": abns(nets["encz"])
                           + abns(nets["encoder"]),
                           "abn_bwd_sums": 0, "abn_bwd_dx": 0}}
    for name, names in X2P_NETS.items():
        row = backward(names)
        row["abn_rows"] += sum(abns(nets[k]) for k in names)
        out[f"x2p:{name}"] = row
    out["forward"] = {"abn_rows": sum(abns(n) for n in nets.values()),
                      "abn_bwd_sums": 0, "abn_bwd_dx": 0}
    for name in TERMS:
        out[f"params:{name}"] = backward(PARAM_NETS[name])
    return out


def format_table(table: Dict[str, dict], lam: Dict[str, float]) -> str:
    hdr = (f"{'term':<10} {'lam':>6} {'loss(w)':>12} {'|g_x2p|/px':>12} "
           f"{'|g_x2p|':>10} {'|g_encdec|':>11} {'|g_encz|':>10}")
    rows = [hdr, "-" * len(hdr)]
    for name, r in table.items():
        rows.append(f"{name:<10} {lam[name]:>6.2f} {r['loss']:>12.2f} "
                    f"{r['grad_x2p_mean_abs']:>12.3e} "
                    f"{r['grad_x2p_norm']:>10.3f} "
                    f"{r['grad_encdec_norm']:>11.3f} "
                    f"{r['grad_encz_norm']:>10.3f}")
    return "\n".join(rows)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="VAE^2 gradient attribution")
    ap.add_argument("--cfg", required=True, type=str)
    ap.add_argument("--checkpoint", default="", type=str,
                    help="diagnose a trained state (.pt, or the JAX "
                         "package's .msgpack: weights only) instead of the "
                         "init")
    ap.add_argument("--batch", default=4, type=int)
    ap.add_argument("--seed", default=0, type=int)
    ap.add_argument("--out", default="", help="also dump the table as JSON")
    ap.add_argument("--device", default="",
                    help="'cuda' (default: GPU.DEVICE) or 'cpu'")
    ap.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return ap.parse_args(argv)


def load_batch(config, b: int, seed: int, device: torch.device):
    """(uint8 clips on ``device``, source): the first batch of a seeded
    shuffled loader of DATASET.TRAIN_SET, or, where the dataset cannot be
    read, seeded random clips."""
    from ..data.loader import ClipLoader
    from ..data.video import make_dataset

    h, w = config.TRAIN.IMAGE_SIZE[1], config.TRAIN.IMAGE_SIZE[0]
    try:
        ds = make_dataset(config, config.DATASET.TRAIN_SET, random_pos=True,
                          seed=seed)
        loader = ClipLoader(ds, batch_size=b, shuffle=True, num_threads=2,
                            seed=seed)
        clips, _ = next(iter(loader))
        source = config.DATASET.TRAIN_SET
        batch = {k: torch.from_numpy(clips[k][:b]).to(device)
                 for k in ("xt", "x2t", "x3t")}
    except Exception as e:  # noqa: BLE001 — as the JAX tool: any failure
        print(f"# dataset unavailable ({e}); using random uint8 clips")
        gen = torch.Generator().manual_seed(seed)
        batch = {k: torch.randint(0, 255, (b, h, w, 9), generator=gen,
                                  dtype=torch.uint8).to(device)
                 for k in ("xt", "x2t", "x3t")}
        source = "random"
    return batch, source


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Measure and print the table; returns what ``--out`` holds."""
    from ..utils.checkpoint import load_checkpoint
    from ..utils.device import resolve_device

    args = parse_args(argv)
    config = update_config(get_default_config(), args)
    device = resolve_device(args.device or config.GPU.DEVICE)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    h, w = config.TRAIN.IMAGE_SIZE[1], config.TRAIN.IMAGE_SIZE[0]
    system = build_system(config, seed=args.seed, device=device)
    batch, source = load_batch(config, args.batch, args.seed, device)
    if args.checkpoint:
        state_dict, epoch = load_checkpoint(args.checkpoint,
                                            map_location=device)
        system.modules.load_state_dict(state_dict, strict=True)
        print(f"# diagnosing checkpoint {args.checkpoint} (epoch {epoch})")
    lam = lambdas(system.hyper)
    table = attribute(system, batch, lam, generator=torch.Generator(
        device=device).manual_seed(args.seed))
    print(f"\n# gradient attribution @ {h}x{w} batch {args.batch} "
          f"(data: {source}; weighted by lambda)")
    print(format_table(table, lam))
    others = relative_pulls(table)
    print("\nper-pixel pull on x2p relative to the direct x2 L1 term:")
    pprint.pprint({k: round(v, 2) for k, v in others.items()})
    result = {"resolution": [h, w], "batch": args.batch, "source": source,
              "lambdas": lam, "terms": table, "rel_pull_vs_x2_l1": others}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
        print(f"# wrote {args.out}")
    return result


if __name__ == "__main__":
    main()
