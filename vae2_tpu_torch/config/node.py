"""A small, dependency-free hierarchical config system (a copy of
``vae2_tpu/config/node.py``; the port imports nothing of the JAX package).

Provides the same ergonomics the reference gets from yacs
(reference: lib/config/default.py:17-127): a nested attribute-accessible tree,
YAML-file merge, ``KEY.SUBKEY value`` CLI-override lists, and freezing.
Key names are kept UPPERCASE-compatible so reference experiment YAMLs port 1:1.
"""

from __future__ import annotations

import ast
import copy
from typing import Any, Iterable

import yaml


class ConfigNode(dict):
    """Nested dict with attribute access, freezing, and typed merging.

    ``new_allowed`` nodes accept keys not present in the defaults (used for
    ``MODEL.EXTRA`` which carries per-model stage specs, mirroring the open
    CfgNode at reference lib/config/default.py:38).
    """

    _FROZEN = "_frozen_"
    _NEW_ALLOWED = "_new_allowed_"

    def __init__(self, init: dict | None = None, new_allowed: bool = False):
        super().__init__()
        object.__setattr__(self, ConfigNode._FROZEN, False)
        object.__setattr__(self, ConfigNode._NEW_ALLOWED, new_allowed)
        if init:
            for k, v in init.items():
                self[k] = _wrap(v)

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, ConfigNode._FROZEN):
            raise AttributeError(
                f"ConfigNode is frozen; cannot set {name!r}. Call defrost() first."
            )
        super().__setitem__(name, _wrap(value))

    # -- freeze protocol ----------------------------------------------------
    def freeze(self) -> "ConfigNode":
        object.__setattr__(self, ConfigNode._FROZEN, True)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.freeze()
        return self

    def defrost(self) -> "ConfigNode":
        object.__setattr__(self, ConfigNode._FROZEN, False)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.defrost()
        return self

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, ConfigNode._FROZEN)

    def clone(self) -> "ConfigNode":
        node = ConfigNode(
            new_allowed=object.__getattribute__(self, ConfigNode._NEW_ALLOWED)
        )
        for k, v in self.items():
            node[k] = v.clone() if isinstance(v, ConfigNode) else copy.deepcopy(v)
        return node

    # -- merging ------------------------------------------------------------
    def merge_from_dict(self, other: dict, _path: str = "") -> None:
        new_allowed = object.__getattribute__(self, ConfigNode._NEW_ALLOWED)
        for k, v in other.items():
            path = f"{_path}.{k}" if _path else str(k)
            if k not in self:
                if not new_allowed:
                    raise KeyError(f"Non-existent config key: {path}")
                self[k] = _wrap(v)
                continue
            cur = self[k]
            if isinstance(cur, ConfigNode):
                if not isinstance(v, dict):
                    raise TypeError(f"Cannot overwrite config subtree {path} with {v!r}")
                cur.merge_from_dict(v, path)
            else:
                self[k] = _coerce(v, cur, path)

    def merge_from_file(self, filename: str) -> None:
        with open(filename, "r") as f:
            data = yaml.safe_load(f) or {}
        self.merge_from_dict(data)

    def merge_from_list(self, opts: Iterable[str] | None) -> None:
        """Merge ``[KEY1, val1, KEY2, val2, ...]`` CLI overrides."""
        opts = list(opts or [])
        if len(opts) % 2 != 0:
            raise ValueError(f"Override list must have even length, got {opts}")
        for key, raw in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node or not isinstance(node[p], ConfigNode):
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                if not object.__getattribute__(node, ConfigNode._NEW_ALLOWED):
                    raise KeyError(f"Non-existent config key: {key}")
                node[leaf] = _parse_literal(raw)
            else:
                node[leaf] = _coerce(_parse_literal(raw), node[leaf], key)

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, ConfigNode) else copy.deepcopy(v)
        return out

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.dump()

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"ConfigNode({super().__repr__()})"


def _wrap(value: Any) -> Any:
    if isinstance(value, ConfigNode):
        return value
    if isinstance(value, dict):
        return ConfigNode(value, new_allowed=True)
    if isinstance(value, tuple):
        return list(value)
    return value


def _parse_literal(raw: str) -> Any:
    """Parse a CLI string value into a Python literal if possible."""
    if not isinstance(raw, str):
        return raw
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def _coerce(new: Any, old: Any, path: str) -> Any:
    """Type-check a replacement value against the default's type."""
    if old is None or new is None:
        return _wrap(new)
    if isinstance(old, bool):
        if isinstance(new, bool):
            return new
        if isinstance(new, str):
            if new.lower() in ("true", "1", "yes"):
                return True
            if new.lower() in ("false", "0", "no"):
                return False
        if isinstance(new, int):
            return bool(new)
        raise TypeError(f"Cannot coerce {new!r} to bool for key {path}")
    if isinstance(old, float) and isinstance(new, int):
        return float(new)
    if isinstance(old, int) and isinstance(new, float) and new.is_integer():
        return int(new)
    if isinstance(old, (list, tuple)) and isinstance(new, (list, tuple)):
        return list(new)
    if type(old) is not type(new) and not isinstance(new, type(old)):
        raise TypeError(
            f"Type mismatch for key {path}: default {type(old).__name__}, "
            f"got {type(new).__name__} ({new!r})"
        )
    return _wrap(new)
