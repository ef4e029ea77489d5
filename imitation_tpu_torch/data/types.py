"""Trajectory and transition types.

Port of the part of ``imitation_tpu/data/types.py`` this slice runs:

* **Host tier**: ``Trajectory`` and ``TrajectoryWithRew``, frozen numpy
  dataclasses with the reference's validation (``len(obs) == len(acts) + 1``),
  and the flat ``TransitionsMinimal``, ``Transitions`` and
  ``TransitionsWithRew`` (array observations only; ``DictObs`` is not
  ported).
* **Device tier**: ``TransitionBatch``, a struct of ``[B, ...]`` tensors on
  one device, with ``take`` (row gather) and ``from_host``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Trajectory:
    """Observations, actions, infos and a terminal flag for one episode."""

    obs: np.ndarray
    acts: np.ndarray
    infos: Optional[np.ndarray]
    terminal: bool

    def __len__(self) -> int:
        return len(self.acts)

    def __post_init__(self):
        object.__setattr__(self, "acts", np.asarray(self.acts))
        object.__setattr__(self, "obs", np.asarray(self.obs))
        if len(self.acts) == 0:
            raise ValueError("Degenerate trajectory: must have at least one action.")
        if len(self.obs) != len(self.acts) + 1:
            raise ValueError(
                "expected one more observation than actions: "
                f"{len(self.obs)} != {len(self.acts)} + 1",
            )
        if self.infos is not None and len(self.infos) != len(self.acts):
            raise ValueError(
                "infos when present must be present for each action: "
                f"{len(self.infos)} != {len(self.acts)}",
            )


@dataclasses.dataclass(frozen=True, eq=False)
class TrajectoryWithRew(Trajectory):
    """A trajectory with per-step float rewards."""

    rews: np.ndarray

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "rews", np.asarray(self.rews))
        if self.rews.shape != (len(self.acts),):
            raise ValueError(
                "rewards must be 1D array, one entry for each action: "
                f"{self.rews.shape} != ({len(self.acts)},)",
            )
        if not np.issubdtype(self.rews.dtype, np.floating):
            raise ValueError(f"rewards dtype {self.rews.dtype} not a float")


@dataclasses.dataclass(frozen=True, eq=False)
class TransitionsMinimal:
    """A batch of (obs, acts, infos), the minimum BC needs."""

    obs: np.ndarray
    acts: np.ndarray
    infos: Optional[np.ndarray]

    def __len__(self) -> int:
        return len(self.acts)

    def __post_init__(self):
        object.__setattr__(self, "obs", np.asarray(self.obs))
        object.__setattr__(self, "acts", np.asarray(self.acts))
        if len(self.obs) != len(self.acts):
            raise ValueError(
                "obs and acts must have same number of timesteps: "
                f"{len(self.obs)} != {len(self.acts)}",
            )
        if self.infos is not None and len(self.infos) != len(self.obs):
            raise ValueError(
                "obs and infos must have same number of timesteps: "
                f"{len(self.obs)} != {len(self.infos)}",
            )


@dataclasses.dataclass(frozen=True, eq=False)
class Transitions(TransitionsMinimal):
    """obs/acts/next_obs/dones batch; ``dones`` is boolean."""

    next_obs: np.ndarray
    dones: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "next_obs", np.asarray(self.next_obs))
        object.__setattr__(self, "dones", np.asarray(self.dones))
        super().__post_init__()
        if self.obs.shape != self.next_obs.shape:
            raise ValueError(
                "obs and next_obs must have the same shape: "
                f"{self.obs.shape} != {self.next_obs.shape}",
            )
        if self.obs.dtype != self.next_obs.dtype:
            raise ValueError(
                "obs and next_obs must have the same dtype: "
                f"{self.obs.dtype} != {self.next_obs.dtype}",
            )
        if self.dones.shape != (len(self.acts),):
            raise ValueError(
                "dones must be 1D array, one entry for each timestep: "
                f"{self.dones.shape} != ({len(self.acts)},)",
            )
        if self.dones.dtype != bool:
            raise ValueError(f"dones must be boolean, not {self.dones.dtype}")


@dataclasses.dataclass(frozen=True, eq=False)
class TransitionsWithRew(Transitions):
    """Transitions with per-step float rewards."""

    rews: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "rews", np.asarray(self.rews))
        super().__post_init__()
        if self.rews.shape != (len(self.acts),):
            raise ValueError(
                "rewards must be 1D array, one entry for each timestep: "
                f"{self.rews.shape} != ({len(self.acts)},)",
            )
        if not np.issubdtype(self.rews.dtype, np.floating):
            raise ValueError(f"rewards dtype {self.rews.dtype} not a float")


# 64-bit host arrays become 32-bit tensors, as ``jnp.asarray`` makes them.
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32}


def _tensor(x: np.ndarray, dtype=None) -> torch.Tensor:
    x = np.asarray(x)
    x = x.astype(dtype or _NARROW.get(x.dtype, x.dtype))
    return torch.from_numpy(np.ascontiguousarray(x))


@dataclasses.dataclass
class TransitionBatch:
    """A device-resident batch of transitions (struct of tensors).

    All fields share leading dim B. ``dones`` is float32 {0., 1.};
    ``rews`` is zeros when the source had no rewards.
    """

    obs: torch.Tensor
    acts: torch.Tensor
    next_obs: torch.Tensor
    dones: torch.Tensor
    rews: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.acts.shape[0]

    def __len__(self) -> int:
        return self.batch_size

    def fields(self) -> Dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def map(self, fn) -> "TransitionBatch":
        return TransitionBatch(**{k: fn(v) for k, v in self.fields().items()})

    @classmethod
    def from_host(cls, t: TransitionsMinimal) -> "TransitionBatch":
        """A CPU batch of host transitions: ``next_obs`` is ``obs`` and
        ``dones`` zeros where ``t`` has none, ``rews`` zeros where it has
        no rewards."""
        obs = _tensor(t.obs)
        n = len(t)
        if isinstance(t, Transitions):
            next_obs, dones = _tensor(t.next_obs), _tensor(t.dones, np.float32)
        else:
            next_obs, dones = obs, torch.zeros(n, dtype=torch.float32)
        if isinstance(t, TransitionsWithRew):
            rews = _tensor(t.rews, np.float32)
        else:
            rews = torch.zeros(n, dtype=torch.float32)
        return cls(obs=obs, acts=_tensor(t.acts), next_obs=next_obs, dones=dones, rews=rews)

    def take(self, idx: torch.Tensor) -> "TransitionBatch":
        return self.map(lambda x: x[idx.long()])

    def to(self, device: Any) -> "TransitionBatch":
        return self.map(lambda x: x.to(device))
