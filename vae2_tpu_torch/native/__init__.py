"""ctypes bindings for the port's copy of the native C++ clip decoder
(counterpart of ``vae2_tpu/native/__init__.py``).

``clip_decoder.cpp`` (libpng/libjpeg decode, then the separable triangle
filter resize, a thread fan-out over a batch) is compiled at first use with
g++ -O3 into ``build/vae2_tpu_torch/`` at the repository root, under a name
that carries a hash of the source, so an edit rebuilds. The flags are the
JAX package's (``-march=native``, dropped on a retry where the compiler
refuses it), so that both builds round alike and decode the same bytes.

- ``decode_frame(bytes, w, h) -> np.uint8 (h, w, 3)`` or None on failure;
- ``decode_batch(list_of_bytes, w, h, threads) -> np.uint8 (n, h, w, 3)``,
  or None when the library is unavailable;
- ``available()`` (and ``AVAILABLE`` once it has been asked): whether the
  library built and loaded. Without g++ or the codec headers (or their
  shared libraries, for a library built elsewhere) it is False and the
  datasets decode with PIL; ``build_log()`` then says why.
  ``VAE2_NO_NATIVE=1`` forces the PIL path.

Nothing is compiled when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

SRC = Path(__file__).resolve().with_name("clip_decoder.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vae2_tpu_torch"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lpng", "-ljpeg", "-lz", "-lpthread")

AVAILABLE = False
_lib: Optional[ctypes.CDLL] = None
_tried = False
_log = ""
_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libclip_decoder_{digest}.so"


def _compile(out: Path) -> str:
    """g++ into ``out`` (with -march=native, then without); returns the
    compiler's output, empty when the library is there."""
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    log = []
    for flags in (GXX_FLAGS, tuple(f for f in GXX_FLAGS
                                   if f != "-march=native")):
        cmd = ["g++", *flags, str(SRC), "-o", str(tmp), *LIBS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=180)
        except (OSError, subprocess.SubprocessError) as e:
            log.append(f"{' '.join(cmd)}: {e}")
            continue
        if proc.returncode == 0:
            os.replace(tmp, out)  # atomic: concurrent builders see all or none
            return ""
        log.append(f"{' '.join(cmd)} (rc {proc.returncode}):\n"
                   f"{proc.stdout}{proc.stderr}")
    tmp.unlink(missing_ok=True)
    return "\n".join(log)


def _load() -> Optional[ctypes.CDLL]:
    global AVAILABLE, _lib, _tried, _log
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        if os.environ.get("VAE2_NO_NATIVE") == "1":
            _log = "VAE2_NO_NATIVE=1: the PIL path is forced"
        else:
            out = library_path()
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                _log = _compile(out)
            lib = None
            if out.exists():
                try:  # a library built elsewhere may miss its codecs here
                    lib = ctypes.CDLL(str(out))
                except OSError as e:
                    _log += f"loading {out}: {e}"
            if lib is not None:
                lib.vae2_decode_frame.restype = ctypes.c_int
                lib.vae2_decode_frame.argtypes = [
                    ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                    ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
                lib.vae2_decode_batch.restype = ctypes.c_int
                lib.vae2_decode_batch.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p),
                    ctypes.POINTER(ctypes.c_size_t), ctypes.c_int,
                    ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
                lib.vae2_native_version.restype = ctypes.c_int
                if lib.vae2_native_version() >= 1:
                    _lib = lib
        AVAILABLE = _lib is not None
        _tried = True
        return _lib


def available() -> bool:
    """Build (once) and load the library; whether it is usable."""
    return _load() is not None


def build_log() -> str:
    """Why the library is unavailable (g++'s output, the loader's error),
    else ''."""
    _load()
    return _log


def decode_frame(data: bytes, width: int, height: int) -> Optional[np.ndarray]:
    """Decode and resize one encoded PNG/JPEG; None on failure."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((height, width, 3), np.uint8)
    rc = lib.vae2_decode_frame(
        data, len(data), width, height,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out if rc == 0 else None


def decode_batch(datas: List[bytes], width: int, height: int,
                 threads: int = 4) -> Optional[np.ndarray]:
    """Decode and resize a batch concurrently (the GIL released for the
    whole batch); None if the library is unavailable. Frames that fail to
    decode come back as zeros."""
    lib = _load()
    if lib is None:
        return None
    n = len(datas)
    out = np.empty((n, height, width, 3), np.uint8)
    bufs = (ctypes.c_char_p * n)(*datas)  # `datas` keeps the bytes alive
    lens = (ctypes.c_size_t * n)(*[len(d) for d in datas])
    lib.vae2_decode_batch(bufs, lens, n, width, height,
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                          threads)
    return out
