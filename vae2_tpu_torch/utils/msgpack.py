"""A reader of flax's msgpack checkpoints in plain Python (no ``msgpack``,
no flax): what ``flax.serialization.msgpack_restore`` returns, for the JAX
package's ``checkpoint.msgpack``, ``model_final_state.msgpack`` and
``seg_final_state.msgpack`` (``vae2_tpu/utils/checkpoint.py:19-31``).

- msgpack's maps, arrays, str, bin, nil, bools, ints and floats; map keys
  and str values decode as ``str``, bin as ``bytes``;
- flax's ext types: 1, an ndarray, itself a msgpack ``(shape, dtype name,
  bytes)``; 2, a Python complex ``(real, imag)``; 3, a numpy scalar (a
  0-d ndarray, returned as its scalar);
- ``bfloat16``, which numpy has no dtype for, arrives as that name: its
  16-bit words become a ``torch.bfloat16`` tensor (every other dtype a
  numpy array);
- flax's ``{'__msgpack_chunked_array__': True, 'shape': ..., 'chunks':
  ...}`` maps, which it writes for arrays over 2**30 bytes, are joined back
  into one array.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"

_FIXED = {  # type byte -> (struct format, size)
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_SIZED = {  # type byte -> (what, struct format of its length, size)
    0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
    0xC7: ("ext", ">B", 1), 0xC8: ("ext", ">H", 2), 0xC9: ("ext", ">I", 4),
    0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
    0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
    0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4),
}


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def value(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.value() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return str(self.take(t & 0x1F), "utf-8")
        if t in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[t]
        if t in _FIXED:
            return self.unpack(*_FIXED[t])
        if t in _FIXEXT:
            code = self.unpack(">b", 1)
            return _ext(code, self.take(_FIXEXT[t]))
        if t not in _SIZED:
            raise ValueError(f"msgpack: unknown type byte 0x{t:02x}")
        what, fmt, size = _SIZED[t]
        n = self.unpack(fmt, size)
        if what == "bin":
            return bytes(self.take(n))
        if what == "str":
            return str(self.take(n), "utf-8")
        if what == "array":
            return [self.value() for _ in range(n)]
        if what == "map":
            return self.map(n)
        code = self.unpack(">b", 1)
        return _ext(code, self.take(n))

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _array(shape, name, data):
    """An ndarray ext's payload: a numpy array, or a torch.bfloat16 tensor
    for flax's 'bfloat16', in C order, writable."""
    name = name.decode() if isinstance(name, bytes) else name
    shape = tuple(shape)
    if name == "bfloat16":
        words = torch.frombuffer(bytearray(data), dtype=torch.int16)
        return words.view(torch.bfloat16).reshape(shape)
    return np.frombuffer(bytearray(data), dtype=np.dtype(name)).reshape(shape)


def _ext(code: int, data: memoryview):
    if code in (EXT_NDARRAY, EXT_NPSCALAR):
        arr = _array(*_Reader(data).value())
        if code == EXT_NDARRAY:
            return arr
        return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
    if code == EXT_COMPLEX:
        real, imag = _Reader(data).value()
        return complex(real, imag)
    raise ValueError(f"msgpack: unknown ext type {code}")


def _ordered(d: dict) -> Tuple:
    """flax's tuple-as-dict {'0': a, '1': b, ...} back to a tuple."""
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(d: dict):
    shape = _ordered(d["shape"])
    chunks = _ordered(d["chunks"])
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return np.concatenate([c.reshape(-1) for c in chunks]).reshape(shape)


def _unchunk_tree(node):
    if isinstance(node, dict):
        if CHUNKED in node:
            return _unchunk(node)
        return {k: _unchunk_tree(v) for k, v in node.items()}
    return node


def loads(data) -> Any:
    """Decode one msgpack object as ``flax.serialization.msgpack_restore``
    does (its ext types, its chunked arrays)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} bytes "
                         "after the object")
    return _unchunk_tree(out)


def load(path: str) -> Any:
    with open(path, "rb") as f:
        return loads(f.read())
