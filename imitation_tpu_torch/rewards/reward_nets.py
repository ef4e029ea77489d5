"""Reward networks.

Port of the part of ``imitation_tpu/rewards/reward_nets.py`` this slice
runs: the ``RewardNet`` base (preprocessing, ``predict_processed``) and
``BasicRewardNet``. A reward net maps ``(obs, acts, next_obs, dones)`` to
rewards ``[B]``; ``predict_processed`` is the inference path (the raw
forward, for the nets here).

Preprocessing matches SB3's ``preprocess_obs`` as the JAX package does it:
discrete spaces one-hot, continuous spaces flattened to float32, integer
(image) spaces scaled to [0, 1].
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from imitation_tpu_torch.envs.base import Space
from imitation_tpu_torch.models import networks


def preprocess_space(space: Space, x: torch.Tensor) -> torch.Tensor:
    """One-hot discrete, flatten + cast continuous."""
    if space.is_discrete:
        return F.one_hot(x.long(), space.n).float()
    x = x.float()
    if np.issubdtype(np.dtype(space.dtype), np.integer):
        hi = float(np.max(space.high)) if space.high is not None else 255.0
        x = x / hi
    return x.reshape(x.shape[0], -1)


class RewardNet(nn.Module):
    """Base reward net: subclasses implement ``forward``."""

    def __init__(self, observation_space: Space, action_space: Space):
        super().__init__()
        self.observation_space = observation_space
        self.action_space = action_space

    def preprocess(self, obs, acts, next_obs, dones):
        return (
            preprocess_space(self.observation_space, obs),
            preprocess_space(self.action_space, acts),
            preprocess_space(self.observation_space, next_obs),
            dones.float(),
        )

    def predict_processed(self, obs, acts, next_obs, dones, update_stats: bool = False):
        return self(obs, acts, next_obs, dones)

    def init(self, generator: Optional[torch.Generator] = None) -> "RewardNet":
        """Re-initialises the weights from ``generator``; returns self."""
        raise NotImplementedError


class BasicRewardNet(RewardNet):
    """MLP over any subset of (s, a, s', done); defaults (s, a), (32, 32) relu."""

    def __init__(
        self,
        observation_space: Space,
        action_space: Space,
        use_state: bool = True,
        use_action: bool = True,
        use_next_state: bool = False,
        use_done: bool = False,
        hid_sizes: Sequence[int] = (32, 32),
        activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
        normalize_input: bool = False,
    ):
        super().__init__(observation_space, action_space)
        self.use_state = use_state
        self.use_action = use_action
        self.use_next_state = use_next_state
        self.use_done = use_done
        in_size = (
            observation_space.flat_dim * (int(use_state) + int(use_next_state))
            + (action_space.flat_dim if use_action else 0)
            + int(use_done)
        )
        self.input_norm = networks.RunningNorm(in_size) if normalize_input else None
        self.mlp = networks.MLP(
            in_size, hid_sizes, out_size=1, activation=activation, squeeze_output=True
        )

    def init(self, generator: Optional[torch.Generator] = None) -> "BasicRewardNet":
        self.mlp.reset_parameters(generator)
        if self.input_norm is not None:
            self.input_norm.reset_stats()
        return self

    def forward(self, obs, acts, next_obs, dones, update_stats: bool = False):
        obs_p, acts_p, next_obs_p, dones_p = self.preprocess(obs, acts, next_obs, dones)
        inputs = []
        if self.use_state:
            inputs.append(obs_p)
        if self.use_action:
            inputs.append(acts_p)
        if self.use_next_state:
            inputs.append(next_obs_p)
        if self.use_done:
            inputs.append(dones_p[:, None])
        x = torch.cat(inputs, dim=-1)
        if self.input_norm is not None:
            x = self.input_norm(x, update_stats=update_stats)
        return self.mlp(x)
