"""Generalized Advantage Estimation: kernel B1 and its plain version.

Port of ``imitation_tpu/ops/gae.py`` and of the TPU kernel in
``imitation_tpu/ops/gae_pallas.py``. The recurrence, in reverse time:

    delta_t = r_t + gamma * V(s'_t) * (1 - term_t) - V(s_t)
    A_t     = delta_t + gamma * lam * (1 - done_t) * A_{t+1}

``next_values`` are V of the true next observation (the terminal one at
episode ends), so time-limit bootstrapping needs no special case.

``gae`` launches the CUDA kernel (``csrc/gae.cu``) for CUDA tensors and takes
``gae_plain`` for CPU tensors. ``discounted_returns`` is plain PyTorch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from imitation_tpu_torch.ops import kernels


def _f32(x: float) -> float:
    return float(np.float32(x))


def gae_plain(
    rews: torch.Tensor,
    values: torch.Tensor,
    next_values: torch.Tensor,
    terminated: torch.Tensor,
    dones: torch.Tensor,
    gamma: float,
    lam: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reverse Python loop over t on [B] rows; the kernel's arithmetic, op for op."""
    g = _f32(gamma)
    gl = float(np.float32(g) * np.float32(lam))
    adv = torch.empty_like(rews)
    a = torch.zeros_like(rews[0]) if rews.shape[0] else None
    for t in range(rews.shape[0] - 1, -1, -1):
        delta = rews[t] + g * next_values[t] * (1 - terminated[t]) - values[t]
        a = delta + gl * (1 - dones[t]) * a
        adv[t] = a
    return adv, adv + values


def gae(
    rews: torch.Tensor,  # [T, B]
    values: torch.Tensor,  # [T, B]   V(obs_t)
    next_values: torch.Tensor,  # [T, B]   V(next_obs_t)
    terminated: torch.Tensor,  # [T, B]   true terminal (no bootstrap), float32
    dones: torch.Tensor,  # [T, B]   terminated | truncated, float32
    gamma: float,
    lam: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (advantages, returns = advantages + values), both [T, B] float32.

    All five panels must be contiguous float32 ``[T, B]`` on one device.
    """
    panels = (rews, values, next_values, terminated, dones)
    for p in panels:
        if p.dtype != torch.float32:
            raise TypeError(f"gae takes float32 panels, got {p.dtype}")
        if p.dim() != 2 or p.shape != rews.shape:
            raise ValueError(f"gae takes [T, B] panels of one shape, got {tuple(p.shape)}")
        if p.device != rews.device:
            raise ValueError("gae panels must be on one device")
        if not p.is_contiguous():
            raise ValueError("gae panels must be contiguous")
    if rews.device.type == "cpu":
        return gae_plain(*panels, gamma, lam)
    if rews.device.type != "cuda":
        raise ValueError(f"gae runs on CPU or CUDA tensors, got {rews.device}")
    lib = kernels.load()
    adv = torch.empty_like(rews)
    ret = torch.empty_like(rews)
    T, B = rews.shape
    kernels.check(lib.itt_gae_forward(
        *(p.data_ptr() for p in panels), adv.data_ptr(), ret.data_ptr(),
        T, B, _f32(gamma), _f32(lam), kernels.stream(rews.device),
    ))
    gae.launches += 1
    return adv, ret


gae.launches = 0


def discounted_returns(
    rews: torch.Tensor,  # [T, B]
    dones: torch.Tensor,  # [T, B]
    gamma: float,
    bootstrap: Optional[torch.Tensor] = None,  # [B] value after the last step
    terminated_last: Optional[torch.Tensor] = None,  # [B]
) -> torch.Tensor:
    """Per-step discounted returns-to-go (plain PyTorch, reverse loop)."""
    dones = dones.to(rews.dtype)
    r = rews.clone()
    if bootstrap is not None:
        term = terminated_last.to(r.dtype) if terminated_last is not None else 0.0
        r[-1] = r[-1] + gamma * bootstrap * (1.0 - term)
    out = torch.empty_like(r)
    acc = torch.zeros_like(r[0]) if r.shape[0] else None
    for t in range(r.shape[0] - 1, -1, -1):
        acc = r[t] + gamma * (1.0 - dones[t]) * acc
        out[t] = acc
    return out
