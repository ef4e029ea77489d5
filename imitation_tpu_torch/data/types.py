"""Trajectory and transition types.

Port of the part of ``imitation_tpu/data/types.py`` this slice runs:

* **Host tier**: ``Trajectory`` and ``TrajectoryWithRew``, frozen numpy
  dataclasses with the reference's validation (``len(obs) == len(acts) + 1``).
* **Device tier**: ``TransitionBatch``, a struct of ``[B, ...]`` tensors on
  one device, with ``take`` (row gather).
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

    def take(self, idx: torch.Tensor) -> "TransitionBatch":
        return self.map(lambda x: x[idx.long()])

    def to(self, device: Any) -> "TransitionBatch":
        return self.map(lambda x: x.to(device))
