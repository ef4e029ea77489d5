"""The ``RewardFn`` protocol: a host reward function over batched numpy
arrays (port of ``imitation_tpu/rewards/reward_function.py``). Relabelling
on the device uses ``rl.common.RelabelRewardFn`` instead, whose first
argument is the reward net it reads."""

from __future__ import annotations

from typing import Protocol

import numpy as np


class RewardFn(Protocol):
    """``(state, action, next_state, done) -> rewards``, numpy in and out."""

    def __call__(
        self,
        state: np.ndarray,
        action: np.ndarray,
        next_state: np.ndarray,
        done: np.ndarray,
    ) -> np.ndarray:
        ...
