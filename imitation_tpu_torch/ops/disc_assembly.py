"""Discriminator-batch assembly: kernel B2 and its plain version.

Port of ``imitation_tpu/ops/disc_assembly.py``: ``concat([demo[e_idx],
gen[g_idx]])``, the ``[expert; generator]`` batch of one discriminator step,
written in one pass with no intermediate expert/gen tensors.

``assemble_rows`` launches the CUDA kernel (``csrc/disc_assembly.cu``) for
CUDA tensors and takes ``assemble_rows_plain`` for CPU tensors. An index is
read as JAX's ``x[idx]`` reads it: a negative one counts from the end, then
it is clamped to ``[0, rows - 1]``.
"""

from __future__ import annotations

import torch

from imitation_tpu_torch.ops import kernels

_WORD_DTYPES = (torch.float32, torch.int32)


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


def assemble_rows(
    demo: torch.Tensor,  # [N] or [N, F], float32 or int32
    gen: torch.Tensor,  # [C] or [C, F], same dtype and row shape
    e_idx: torch.Tensor,  # [B] int32
    g_idx: torch.Tensor,  # [B] int32
) -> torch.Tensor:
    """Returns ``[2B]`` or ``[2B, F]``: demo rows at e_idx, then gen rows at g_idx."""
    if demo.dtype not in _WORD_DTYPES or gen.dtype != demo.dtype:
        raise TypeError(f"assemble_rows takes float32 or int32 fields, got {demo.dtype}, {gen.dtype}")
    if demo.dim() not in (1, 2) or gen.shape[1:] != demo.shape[1:]:
        raise ValueError(f"bad field shapes {tuple(demo.shape)}, {tuple(gen.shape)}")
    if demo.shape[0] == 0 or gen.shape[0] == 0:
        raise ValueError("assemble_rows needs at least one demo and one gen row")
    for idx in (e_idx, g_idx):
        if idx.dtype != torch.int32 or idx.dim() != 1:
            raise TypeError(f"indices must be [B] int32, got {idx.dtype} {tuple(idx.shape)}")
    if e_idx.shape != g_idx.shape:
        raise ValueError("e_idx and g_idx must have one length")
    tensors = (demo, gen, e_idx, g_idx)
    if any(t.device != demo.device for t in tensors):
        raise ValueError("assemble_rows inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("assemble_rows inputs must be contiguous")
    if demo.device.type == "cpu":
        return assemble_rows_plain(*tensors)
    if demo.device.type != "cuda":
        raise ValueError(f"assemble_rows runs on CPU or CUDA tensors, got {demo.device}")
    lib = kernels.load()
    B = e_idx.shape[0]
    F = demo.shape[1] if demo.dim() == 2 else 1
    out = torch.empty((2 * B,) + tuple(demo.shape[1:]), dtype=demo.dtype, device=demo.device)
    kernels.check(lib.itt_assemble_rows(
        demo.data_ptr(), gen.data_ptr(), e_idx.data_ptr(), g_idx.data_ptr(), out.data_ptr(),
        demo.shape[0], gen.shape[0], B, F, kernels.stream(demo.device),
    ))
    assemble_rows.launches += 1
    return out


assemble_rows.launches = 0
