"""Core environment protocol for the batched on-device env engine.

Port of ``imitation_tpu/envs/base.py``. Where the JAX package writes one env
instance as a pure function and ``vmap``s it, an ``Env`` here is batched from
the start: ``reset`` and ``step`` take and return ``[B, ...]`` tensors on the
env's device. Episode boundaries keep Gymnasium's terminated/truncated split.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, Optional, Tuple

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

    def sample(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """``n`` uniform draws, ``[n, *shape]``, on the generator's device:
        int32 in ``[0, n)`` for a discrete space; float32 in ``[low, high)``
        for a box (``[-1, 1)`` where a bound is missing)."""
        dev = generator.device
        shape = (n,) + tuple(self.shape)
        if self.is_discrete:
            return torch.randint(0, self.n, shape, generator=generator, device=dev,
                                 dtype=torch.int32)
        low, high = (
            torch.tensor(np.broadcast_to(default if bound is None else bound, self.shape)
                         .astype(np.float32), device=dev)
            for bound, default in ((self.low, -1.0), (self.high, 1.0))
        )
        return low + torch.rand(shape, generator=generator, device=dev) * (high - low)

    def contains(self, x) -> bool:
        """Whether host array ``x`` (one value or a batch) lies in the space:
        in ``[0, n)`` for a discrete space; for a box, trailing dims equal
        to the shape and values within the bounds, 1e-6 slack."""
        x = np.asarray(x)
        if self.is_discrete:
            return bool((x >= 0).all() and (x < self.n).all())
        ok = x.shape[-len(self.shape):] == tuple(self.shape) if self.shape else True
        if self.low is not None:
            ok = ok and bool((x >= self.low - 1e-6).all())
        if self.high is not None:
            ok = ok and bool((x <= self.high + 1e-6).all())
        return ok

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


@dataclasses.dataclass(frozen=True)
class DictSpace:
    """A dict observation space: name -> ``Space``. Observations are dicts
    of tensors; policies flatten each and concatenate them in sorted key
    order (the reference's ``CombinedExtractor``)."""

    spaces: Dict[str, Space]

    @property
    def is_discrete(self) -> bool:
        return False

    @property
    def flat_dim(self) -> int:
        return sum(s.flat_dim for s in self.spaces.values())

    def keys(self):
        return self.spaces.keys()

    def __getitem__(self, k: str) -> Space:
        return self.spaces[k]

    @property
    def shape(self) -> Dict[str, Tuple[int, ...]]:
        return {k: s.shape for k, s in self.spaces.items()}


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

    @property
    def name(self) -> str:
        return type(self).__name__

    @abc.abstractmethod
    def step(self, state: Any, action: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> Tuple[Any, TimeStep]:
        """Returns (state', TimeStep). Does NOT handle time limits: the vector
        engine counts steps and sets ``truncated``. A stochastic env draws
        its transitions from ``generator`` (the JAX env's per-step key);
        a deterministic one ignores it."""
