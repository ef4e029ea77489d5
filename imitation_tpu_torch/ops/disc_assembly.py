"""Discriminator-batch assembly: kernel B2 and its plain version.

Port of ``imitation_tpu/ops/disc_assembly.py``: ``concat([demo[e_idx],
gen[g_idx]])``, the ``[expert; generator]`` batch of one discriminator step,
written in one pass with no intermediate expert/gen tensors.

``assemble_fields`` assembles several fields that share the two index
arrays (a disc step's obs, acts, next_obs and dones) in ONE launch of the
CUDA kernel (``csrc/disc_assembly.cu``) for CUDA tensors, and takes
``assemble_rows_plain`` field by field for CPU tensors. ``assemble_rows`` is
the one-field form of the same call. A field may have any dtype and any rank
>= 1, as JAX's ``assemble_rows`` takes it (demo and gen of one dtype and one
row shape); the kernel moves each row as bytes, so every field of a CUDA
disc step goes through it. An index is read as JAX's ``x[idx]`` reads it: a
negative one counts from the end, then it is clamped to ``[0, rows - 1]``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch

from imitation_tpu_torch.ops import kernels

MAX_FIELDS = 8  # kMaxFields in csrc/disc_assembly.cu


def _jax_index(idx: torch.Tensor, rows: int) -> torch.Tensor:
    idx = idx.long()
    idx = torch.where(idx < 0, idx + rows, idx)
    return idx.clamp(0, rows - 1)


def assemble_rows_plain(
    demo: torch.Tensor, gen: torch.Tensor, e_idx: torch.Tensor, g_idx: torch.Tensor
) -> torch.Tensor:
    """``torch.cat([demo[e_idx], gen[g_idx]])`` with JAX's index semantics."""
    return torch.cat([
        demo[_jax_index(e_idx, demo.shape[0])],
        gen[_jax_index(g_idx, gen.shape[0])],
    ])


def _check(fields: Sequence[Tuple[torch.Tensor, torch.Tensor]], e_idx, g_idx) -> None:
    if not 1 <= len(fields) <= MAX_FIELDS:
        raise ValueError(f"assemble_fields takes 1 to {MAX_FIELDS} fields, got {len(fields)}")
    for idx in (e_idx, g_idx):
        if idx.dtype != torch.int32 or idx.dim() != 1:
            raise TypeError(f"indices must be [B] int32, got {idx.dtype} {tuple(idx.shape)}")
    if e_idx.shape != g_idx.shape:
        raise ValueError("e_idx and g_idx must have one length")
    for demo, gen in fields:
        if gen.dtype != demo.dtype:
            raise TypeError(f"demo and gen of a field must share a dtype, got {demo.dtype}, {gen.dtype}")
        if demo.dim() < 1 or gen.shape[1:] != demo.shape[1:]:
            raise ValueError(f"bad field shapes {tuple(demo.shape)}, {tuple(gen.shape)}")
    n_demo, n_gen = fields[0][0].shape[0], fields[0][1].shape[0]
    for demo, gen in fields:
        if demo.shape[0] == 0 or gen.shape[0] == 0:
            raise ValueError("assembly needs at least one demo and one gen row")
        if demo.shape[0] != n_demo or gen.shape[0] != n_gen:
            raise ValueError("every field must have the same demo rows and the same gen rows")
    tensors = [t for pair in fields for t in pair] + [e_idx, g_idx]
    if any(t.device != e_idx.device for t in tensors):
        raise ValueError("assembly inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("assembly inputs must be contiguous")


def assemble_fields(
    fields: Sequence[Tuple[torch.Tensor, torch.Tensor]],  # (demo [N, ...], gen [C, ...])
    e_idx: torch.Tensor,  # [B] int32
    g_idx: torch.Tensor,  # [B] int32
) -> Tuple[torch.Tensor, ...]:
    """For each ``(demo, gen)`` field, ``[2B, ...]``: demo rows at e_idx, then
    gen rows at g_idx. One kernel launch for all fields."""
    fields = [tuple(f) for f in fields]
    _check(fields, e_idx, g_idx)
    dev = e_idx.device
    if dev.type == "cpu":
        return tuple(assemble_rows_plain(demo, gen, e_idx, g_idx) for demo, gen in fields)
    if dev.type != "cuda":
        raise ValueError(f"assembly runs on CPU or CUDA tensors, got {dev}")
    lib = kernels.load()
    B = e_idx.shape[0]
    outs = tuple(
        torch.empty((2 * B,) + tuple(demo.shape[1:]), dtype=demo.dtype, device=dev)
        for demo, _ in fields
    )
    if B == 0:
        return outs
    n = len(fields)
    ptrs = ctypes.c_void_p * n
    kernels.check(lib.itt_assemble_fields(
        ptrs(*(demo.data_ptr() for demo, _ in fields)),
        ptrs(*(gen.data_ptr() for _, gen in fields)),
        ptrs(*(out.data_ptr() for out in outs)),
        (ctypes.c_int * n)(*(math.prod(demo.shape[1:]) * demo.element_size() for demo, _ in fields)),
        n, e_idx.data_ptr(), g_idx.data_ptr(), fields[0][0].shape[0], fields[0][1].shape[0], B,
        kernels.stream(dev),
    ))
    assemble_fields.launches += 1
    return outs


assemble_fields.launches = 0


def assemble_rows(
    demo: torch.Tensor,  # [N, ...], any dtype
    gen: torch.Tensor,  # [C, ...], same dtype and row shape
    e_idx: torch.Tensor,  # [B] int32
    g_idx: torch.Tensor,  # [B] int32
) -> torch.Tensor:
    """Returns ``[2B, ...]``: demo rows at e_idx, then gen rows at g_idx."""
    return assemble_fields([(demo, gen)], e_idx, g_idx)[0]
