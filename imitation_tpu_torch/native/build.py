"""Builds the host env engine (``envengine.cpp``) and loads it with ``ctypes``.

One ``g++`` call at first use, never at import, into
``imitation_tpu_torch/_build/`` (git-ignored) under a name that hashes the
source and the flags, so it is rebuilt only when they change. A failed
build raises with the compiler's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
SOURCE = Path(__file__).resolve().parent / "envengine.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libitt_envengine_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compiles the engine unless a build of this source exists; returns its path."""
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host env engine is built with g++")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed with code {proc.returncode}:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, path)  # atomic: a concurrent build of the same source is harmless
    return path


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.engine_create.restype = c.c_void_p
    lib.engine_create.argtypes = [c.c_int, c.c_int, c.c_int, c.c_int, c.c_uint64, c.c_int, c.c_int]
    lib.engine_destroy.argtypes = [c.c_void_p]
    for fn in ("engine_obs_dim", "engine_act_dim", "engine_n_actions"):
        getattr(lib, fn).restype = c.c_int
        getattr(lib, fn).argtypes = [c.c_void_p]
    fp, u8p, i32p = c.POINTER(c.c_float), c.POINTER(c.c_uint8), c.POINTER(c.c_int32)
    lib.engine_reset.argtypes = [c.c_void_p, fp]
    lib.engine_step.argtypes = [c.c_void_p, fp, fp, fp, fp, u8p, u8p, fp, i32p]


def load_library() -> ctypes.CDLL:
    """The loaded engine, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            _declare(lib)
            _lib = lib
    return _lib
