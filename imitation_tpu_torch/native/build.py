"""Builds the host engines (``envengine.cpp``, ``mjtree.cpp``) and loads them with ``ctypes``.

One ``g++`` call per source at first use, never at import, into
``imitation_tpu_torch/_build/`` (git-ignored) under a name that hashes the
source and the flags, so each is rebuilt only when they change. A failed
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
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parent.parent
SOURCE = Path(__file__).resolve().parent / "envengine.cpp"
MJTREE_SOURCE = Path(__file__).resolve().parent / "mjtree.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_libs: Dict[Path, ctypes.CDLL] = {}


def library_path(source: Optional[Path] = None) -> Path:
    """``_build/libitt_<source stem>_<hash>.so``; ``source`` defaults to ``SOURCE``."""
    source = SOURCE if source is None else source
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"libitt_{source.stem}_{h.hexdigest()[:16]}.so"


def build_library(source: Optional[Path] = None) -> Path:
    """Compiles ``source`` (default ``SOURCE``) unless a build of it exists; returns its path."""
    source = SOURCE if source is None else source
    path = library_path(source)
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host engines are built with g++")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [cxx, *CXX_FLAGS, str(source), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed with code {proc.returncode}:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, path)  # atomic: a concurrent build of the same source is harmless
    return path


def _declare_envengine(lib: ctypes.CDLL) -> None:
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


def _declare_mjtree(lib: ctypes.CDLL) -> None:
    c = ctypes
    dp, ip = c.POINTER(c.c_double), c.POINTER(c.c_int)
    lib.mjt_create.restype = c.c_void_p
    lib.mjt_create.argtypes = [ip, dp, c.c_int]
    lib.mjt_destroy.argtypes = [c.c_void_p]
    lib.mjt_capacity.argtypes = [c.c_void_p, ip]
    lib.mjt_step.restype = c.c_int
    lib.mjt_step.argtypes = [c.c_void_p, c.c_int, dp, dp, dp, c.c_int]
    lib.mjt_inspect.restype = c.c_int
    lib.mjt_inspect.argtypes = [c.c_void_p, dp, dp, dp, ip, dp]


def _load(source: Path, declare) -> ctypes.CDLL:
    with _lock:
        path = build_library(source)
        if path not in _libs:
            lib = ctypes.CDLL(str(path))
            declare(lib)
            _libs[path] = lib
        return _libs[path]


def load_library() -> ctypes.CDLL:
    """The loaded classic-control engine, built on first call."""
    return _load(SOURCE, _declare_envengine)


def load_mjtree() -> ctypes.CDLL:
    """The loaded MuJoCo-compatible engine (``mjtree.cpp``), built on first call."""
    return _load(MJTREE_SOURCE, _declare_mjtree)
