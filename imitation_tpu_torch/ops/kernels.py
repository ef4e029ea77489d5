"""Builds the port's CUDA kernels into one shared library and loads it.

Each ``csrc/*.cu`` source is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and the objects are linked into one plain-C
shared library (no PyTorch headers, so it builds in seconds), which is
loaded with ``ctypes``. The build runs at first use, never at import, and
lands in ``imitation_tpu_torch/_build/`` (git-ignored) under a name that
hashes the sources and flags, so it is rebuilt only when they change.

Each C entry launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises on anything but 0.
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

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("gae.cu", "disc_assembly.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libitt_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> None:
    """Runs the commands as parallel processes; raises if any fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n{out}{err}"
            )


def build() -> Path:
    """Compiles the library unless a build of these sources exists; returns its path."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = find_nvcc()
    stem = f"{path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{stem}.{Path(src).stem}.o" for src in SOURCES]
    tmp = path.with_name(f"{stem}.tmp.so")
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)]
                  for src, obj in zip(SOURCES, objs)])
        _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, path)  # atomic: a concurrent build of the same sources is harmless
    return path


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.itt_gae_forward.argtypes = [ptr] * 7 + [i32, i32, f32, f32, ptr]
    lib.itt_gae_forward.restype = i32
    lib.itt_gae_launch_shape.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.itt_gae_launch_shape.restype = None
    lib.itt_assemble_fields.argtypes = (
        [ctypes.POINTER(ptr)] * 3 + [ctypes.POINTER(i32), i32, ptr, ptr, i64, i64, i32, ptr]
    )
    lib.itt_assemble_fields.restype = i32
    lib.itt_error_string.argtypes = [i32]
    lib.itt_error_string.restype = ctypes.c_char_p


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
    return _lib


def stream(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream


def check(code: int) -> None:
    if code != 0:
        msg = load().itt_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel launch failed: error {code} ({msg})")
