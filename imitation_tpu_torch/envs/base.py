"""Core environment protocol for the batched on-device env engine.

Port of ``imitation_tpu/envs/base.py``. Where the JAX package writes one env
instance as a pure function and ``vmap``s it, an ``Env`` here is batched from
the start: ``reset`` and ``step`` take and return ``[B, ...]`` tensors on the
env's device. Episode boundaries keep Gymnasium's terminated/truncated split.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Space:
    """Static description of a box or discrete space.

    ``n`` is None for continuous (box) spaces; ``low``/``high`` are numpy
    arrays on the host.
    """

    shape: Tuple[int, ...]
    dtype: Any
    n: Optional[int] = None
    low: Optional[np.ndarray] = None
    high: Optional[np.ndarray] = None

    @property
    def is_discrete(self) -> bool:
        return self.n is not None

    @property
    def flat_dim(self) -> int:
        if self.is_discrete:
            return int(self.n)
        return int(np.prod(self.shape)) if self.shape else 1

    @classmethod
    def discrete(cls, n: int) -> "Space":
        return cls(shape=(), dtype=np.int32, n=n)

    @classmethod
    def box(cls, low, high, shape: Tuple[int, ...], dtype=np.float32) -> "Space":
        return cls(
            shape=tuple(shape),
            dtype=dtype,
            low=np.asarray(low, dtype),
            high=np.asarray(high, dtype),
        )


@dataclasses.dataclass
class TimeStep:
    """Result of one batched env step (before auto-reset).

    ``terminated``: a true terminal state (value target 0).
    ``truncated``: a time-limit cut (bootstrap from the next value).
    """

    obs: torch.Tensor
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor

    @property
    def done(self) -> torch.Tensor:
        return self.terminated | self.truncated


class Env(abc.ABC):
    """A batched environment whose state is a tensor on one device."""

    max_episode_steps: Optional[int] = None

    @property
    @abc.abstractmethod
    def observation_space(self) -> Space:
        ...

    @property
    @abc.abstractmethod
    def action_space(self) -> Space:
        ...

    @abc.abstractmethod
    def reset(self, n: int, generator: torch.Generator) -> Tuple[torch.Tensor, Any]:
        """Returns (obs, state) for ``n`` fresh episodes on the generator's device."""

    @abc.abstractmethod
    def step(self, state: Any, action: torch.Tensor) -> Tuple[Any, TimeStep]:
        """Returns (state', TimeStep). Does NOT handle time limits: the vector
        engine counts steps and sets ``truncated``."""
