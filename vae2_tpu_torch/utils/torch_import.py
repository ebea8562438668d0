"""Import reference PyTorch checkpoints into the port's networks
(counterpart of ``vae2_tpu/utils/torch_import.py:39-331``).

The reference names its modules as lib/models/enc_hrnet.py and
lib/models/seg_hrnet.py do; the port's modules carry the JAX package's
(flax) names. Per trunk (port -> reference):

  conv1                                conv1
  layer1.block{i}.conv1                layer1.{i}.conv1
  layer1.block{i}.down_{conv,bn}       layer1.{i}.downsample.{0,1}
  transition{t}.adapt{i}_{conv,bn}     transition{t}.{i}.{0,1}
  transition{t}.new{i}_{j}_{conv,bn}   transition{t}.{i}.{j}.{0,1}
  stage{s}_module{m}.branch{b}.block{i}          stage{s}.{m}.branches.{b}.{i}
  stage{s}_module{m}.fuse.up_{i}_{j}_{conv,bn}   stage{s}.{m}.fuse_layers.{i}.{j}.{0,1}
  stage{s}_module{m}.fuse.down_{i}_{j}_{k}_{conv,bn}
                                       stage{s}.{m}.fuse_layers.{i}.{j}.{k}.{0,1}
  transition3_e.inject{i}_{conv,bn}    transition3_e.{i}.{0,1}
  last_layer_{k}.{conv1,bn,conv2}      last_layer_{k}.{0,1,3}

Leaves keep their names (``weight``, ``bias``, ``running_mean``,
``running_var``): both sides are PyTorch, OIHW kernels, (out, in) linears.
VAE² networks: the port's ``encdec.encoder`` / ``dec_future`` /
``dec_past`` are the reference's ``encdec_model.`` / ``decf_`` / ``decp_``
(enc_hrnet.py:545-751), ``encz``, ``d_seq``, ``d_frame`` its
``encz_model.``, ``D_model_sequence.``, ``D_model_frame.`` (FullModel_encdec,
lib/utils/utils.py:47-61; the historical ``encdec_mode.`` typo is fixed as
ckpt_checker.py:82-95 fixes it). A segmentation checkpoint has no
composite prefix and maps straight onto ``SegHRNet`` (``trunk.`` and
``last_layer.``).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


def load_torch_state_dict(path: str) -> Tensors:
    """Load a reference checkpoint's tensors (unwrapping the {epoch,
    state_dict, ...} of tools/train.py:320-324, dropping a DDP ``module.``
    and fixing the ``encdec_mode.`` typo). Only tensors and plain values
    are unpickled."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    out = {}
    for k, v in raw.items():
        k = k.replace("module.", "")  # DDP wrapper
        k = k.replace("encdec_mode.", "encdec_model.")  # ckpt_checker.py:89
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu()
    return out


# ---------------------------------------------------------------------------
# name translation (copies of torch_import.py:60-169 of the JAX package)
# ---------------------------------------------------------------------------

_DEC_PREFIX = {"encoder": "", "dec_future": "decf_", "dec_past": "decp_"}


def _trunk_key(parts: List[str]) -> Optional[str]:
    """A trunk-relative module path of the port (no leaf) as the reference
    names it."""
    name = parts[0]
    if name in ("conv1", "bn1", "conv2", "bn2"):
        return name
    if name == "layer1":
        blk = re.fullmatch(r"block(\d+)", parts[1]).group(1)
        return f"layer1.{blk}.{_block_sub(parts[2])}"
    m = re.fullmatch(r"transition(\d)", name)
    if m:
        t = m.group(1)
        a = re.fullmatch(r"adapt(\d+)_(conv|bn)", parts[1])
        if a:
            slot = "0" if a.group(2) == "conv" else "1"
            return f"transition{t}.{a.group(1)}.{slot}"
        n = re.fullmatch(r"new(\d+)_(\d+)_(conv|bn)", parts[1])
        if n:
            slot = "0" if n.group(3) == "conv" else "1"
            return f"transition{t}.{n.group(1)}.{n.group(2)}.{slot}"
        raise KeyError(parts)
    m = re.fullmatch(r"stage(\d)_module(\d+)", name)
    if m:
        s, mod = m.group(1), m.group(2)
        if parts[1] == "fuse":
            u = re.fullmatch(r"up_(\d+)_(\d+)_(conv|bn)", parts[2])
            if u:
                slot = "0" if u.group(3) == "conv" else "1"
                return (f"stage{s}.{mod}.fuse_layers.{u.group(1)}."
                        f"{u.group(2)}.{slot}")
            d = re.fullmatch(r"down_(\d+)_(\d+)_(\d+)_(conv|bn)", parts[2])
            if d:
                slot = "0" if d.group(4) == "conv" else "1"
                return (f"stage{s}.{mod}.fuse_layers.{d.group(1)}."
                        f"{d.group(2)}.{d.group(3)}.{slot}")
            raise KeyError(parts)
        b = re.fullmatch(r"branch(\d+)", parts[1]).group(1)
        blk = re.fullmatch(r"block(\d+)", parts[2]).group(1)
        return f"stage{s}.{mod}.branches.{b}.{blk}.{_block_sub(parts[3])}"
    if name == "transition3_e":
        inj = re.fullmatch(r"inject(\d+)_(conv|bn)", parts[1])
        slot = "0" if inj.group(2) == "conv" else "1"
        return f"transition3_e.{inj.group(1)}.{slot}"
    return None


def _block_sub(sub: str) -> str:
    return {
        "conv1": "conv1", "bn1": "bn1", "conv2": "conv2", "bn2": "bn2",
        "conv3": "conv3", "bn3": "bn3",
        "down_conv": "downsample.0", "down_bn": "downsample.1",
    }[sub]


def _head_key(parts: List[str]) -> Optional[str]:
    """ConvHead: last_layer[_k].{conv1 -> 0, bn -> 1, conv2 -> 3}."""
    if not re.fullmatch(r"last_layer(_\d+)?", parts[0]):
        return None
    slot = {"conv1": "0", "bn": "1", "conv2": "3"}[parts[1]]
    return f"{parts[0]}.{slot}"


def _net_torch_module(net: str, parts: List[str]) -> str:
    """The reference module path of a port module path inside one of the
    VAE² networks (``parts`` without the network and the leaf)."""
    if net == "encdec":
        sub_net, rest = parts[0], list(parts[1:])
        key = _trunk_key(rest[1:]) if rest[0] == "trunk" else _head_key(rest)
        if key is None:
            raise KeyError((net, parts))
        return f"encdec_model.{_DEC_PREFIX[sub_net]}{key}"
    if net == "encz":
        if parts[0] == "trunk":
            return f"encz_model.{_trunk_key(parts[1:])}"
        zl = re.fullmatch(r"z_layer_(\d+)", parts[0])
        if zl:  # hd_z per-branch 1x1 (enc_hrnet.py:1008-1017)
            return f"encz_model.last_layer.{zl.group(1)}.0"
        pooled = {"z_fc1": "last_layer.1", "z_bn": "last_layer.2",
                  "z_fc2": "last_layer.4"}
        if parts[0] in pooled:
            return f"encz_model.{pooled[parts[0]]}"
        raise KeyError((net, parts))
    if net in ("d_seq", "d_frame"):
        torch_net = "D_model_sequence" if net == "d_seq" else "D_model_frame"
        key = _seg_torch_module(parts)
        return f"{torch_net}.{key}"
    raise KeyError(net)


def _seg_torch_module(parts: List[str]) -> str:
    """A trunk + one ``last_layer`` head (SegHRNet, the discriminators)."""
    key = _trunk_key(parts[1:]) if parts[0] == "trunk" else _head_key(parts)
    if key is None:
        raise KeyError(parts)
    return key


def system_key(port_key: str) -> str:
    """``VAE2System.modules`` state-dict key -> reference key."""
    parts = port_key.split(".")
    return f"{_net_torch_module(parts[0], parts[1:-1])}.{parts[-1]}"


def seg_key(port_key: str) -> str:
    """``SegHRNet`` state-dict key -> reference key."""
    parts = port_key.split(".")
    return f"{_seg_torch_module(parts[:-1])}.{parts[-1]}"


# ---------------------------------------------------------------------------
# import
# ---------------------------------------------------------------------------


def import_state_dict(target: Tensors, sd: Tensors,
                      key_fn: Callable[[str], str], strict: bool = False
                      ) -> Tuple[Tensors, List[str]]:
    """A copy of ``target`` with every entry that ``sd`` holds under
    ``key_fn(key)`` (reshaped to the target's shape: a reference 1x1 conv
    may stand for a linear), and the list of the entries left as they were;
    ``strict`` raises when that list is not empty."""
    out, missing = dict(target), []
    for key, val in target.items():
        try:
            ref = key_fn(key)
        except KeyError:
            missing.append(key)
            continue
        new = sd.get(ref)
        if new is None:
            missing.append(f"{key} <- {ref}")
            continue
        if new.numel() != val.numel():
            missing.append(f"{key} <- {ref} (shape {tuple(new.shape)} vs "
                           f"{tuple(val.shape)})")
            continue
        out[key] = new.reshape(val.shape).to(val.dtype)
    if strict and missing:
        raise KeyError(f"{len(missing)} unmatched parameters, e.g. "
                       f"{missing[:5]}")
    return out, missing


def _load_into(module: torch.nn.Module, sd: Tensors, key_fn, strict: bool
               ) -> List[str]:
    new, missing = import_state_dict(module.state_dict(), sd, key_fn, strict)
    module.load_state_dict(new, strict=True)
    return missing


def import_reference_checkpoint(system, path: str, strict: bool = False
                                ) -> List[str]:
    """Load a reference FullModel checkpoint into ``system.modules`` (the
    four VAE² networks); returns the entries it did not find."""
    return _load_into(system.modules, load_torch_state_dict(path),
                      system_key, strict)


def import_seg_checkpoint(model: torch.nn.Module, path: str,
                          strict: bool = False) -> List[str]:
    """Load a reference segmentation HRNet checkpoint into a ``SegHRNet``;
    returns the entries it did not find."""
    return _load_into(model, load_torch_state_dict(path), seg_key, strict)


def import_pretrained_trunk(system, path: str, clip_length: int = 3,
                            is_baseline: bool = False) -> List[str]:
    """Seed every network's trunk from a plain (ImageNet or segmentation)
    HRNet checkpoint: the reference's MODEL.PRETRAINED surgery
    (enc_hrnet.py:753-785, 1043-1068, 1156-1183).

    - every weight whose name matches loads as it is; ``last_layer*`` heads
      and ``transition3_e`` are skipped (task heads; z-inject widths differ
      per network), and an optional ``model.`` prefix is dropped;
    - the 3-channel ``conv1.weight`` is replicated across input channels to
      each network's stem width: encoder x(2L if baseline else L), L =
      clip_length, decoders xL, posterior x(3L if baseline else 2L),
      sequence discriminator xL, frame discriminator x1;
    - the same weights clone into both decoders.

    Returns the entries of ``system.modules`` left at their init."""
    sd = {k[len("model."):] if k.startswith("model.") else k: v
          for k, v in load_torch_state_dict(path).items()}
    reps = {
        ("encdec", "encoder"): 2 * clip_length if is_baseline else clip_length,
        ("encdec", "dec_future"): clip_length,
        ("encdec", "dec_past"): clip_length,
        ("encz", None): 3 * clip_length if is_baseline else 2 * clip_length,
        ("d_seq", None): clip_length,
        ("d_frame", None): 1,
    }
    torch_nets = {"encdec": "encdec_model", "encz": "encz_model",
                  "d_seq": "D_model_sequence", "d_frame": "D_model_frame"}
    state = system.modules.state_dict()
    missing: List[str] = []
    for (net, sub), rep in reps.items():
        if net not in system.modules:
            continue
        prefix = f"{net}.{sub}." if sub else f"{net}."
        dec = _DEC_PREFIX[sub] if sub else ""
        view = {}
        for k, v in sd.items():
            if "last_layer" in k or "transition3_e" in k:
                continue
            if k == "conv1.weight" and rep > 1:
                v = v.repeat(1, rep, 1, 1)
            view[f"{torch_nets[net]}.{dec}{k}"] = v
        part = {k: v for k, v in state.items() if k.startswith(prefix)}
        new, miss = import_state_dict(part, view, system_key)
        state.update(new)
        missing += miss
    system.modules.load_state_dict(state, strict=True)
    return missing
