"""Reward nets for tests.

Port of ``imitation_tpu/testing/reward_nets.py``: a constant-output reward
net and a small ``BasicRewardNet`` ensemble.
"""

from __future__ import annotations

from typing import Optional

import torch

from imitation_tpu_torch.envs.base import Space
from imitation_tpu_torch.rewards.reward_nets import BasicRewardNet, RewardEnsemble, RewardNet


class MockRewardNet(RewardNet):
    """A reward net whose output is ``value`` for every row, on the
    inputs' device; it has no parameters."""

    def __init__(self, observation_space: Space, action_space: Space, value: float = 0.0):
        super().__init__(observation_space, action_space)
        self.value = value

    def init(self, generator: Optional[torch.Generator] = None) -> "MockRewardNet":
        return self

    def forward(self, obs, acts, next_obs, dones, update_stats: bool = False):
        return torch.full((obs.shape[0],), self.value, dtype=torch.float32, device=obs.device)


def make_ensemble(observation_space: Space, action_space: Space, num_members: int = 2,
                  **kwargs) -> RewardEnsemble:
    """A ``RewardEnsemble`` of ``num_members`` ``BasicRewardNet``s built with
    ``kwargs``."""
    return RewardEnsemble(observation_space, action_space, member_cls=BasicRewardNet,
                          num_members=num_members, member_kwargs=kwargs or None)
