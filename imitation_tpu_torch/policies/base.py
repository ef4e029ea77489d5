"""Policy re-exports, the SAC-sized actor-critic and host policies.

Port of ``imitation_tpu/policies/base.py``: the policies live in
``models/policies.py`` and are re-exported here under the JAX package's
module path; ``NonTrainablePolicy`` is a host policy that chooses actions
one observation at a time.
"""

from __future__ import annotations

import abc

import numpy as np
import torch

from imitation_tpu_torch.envs.base import Space
from imitation_tpu_torch.models.policies import (  # noqa: F401  (re-exports)
    ActorCriticPolicy,
    FeedForward32Policy,
    RandomPolicy,
    ZeroPolicy,
)


def SAC1024Policy(observation_space: Space, action_space: Space, **kwargs) -> ActorCriticPolicy:
    """The actor-critic with one 1024-wide hidden layer (the reference's
    PEBBLE-style torso). The SAC learner itself is ``rl/sac.py``."""
    return ActorCriticPolicy(observation_space, action_space, hid_sizes=(1024,), **kwargs)


class NonTrainablePolicy(abc.ABC):
    """A host policy choosing each action from one numpy observation
    (interactive or hard-coded policies)."""

    def __init__(self, observation_space: Space, action_space: Space):
        self.observation_space = observation_space
        self.action_space = action_space

    @abc.abstractmethod
    def _choose_action(self, obs: np.ndarray):
        ...

    def predict(self, obs: np.ndarray, deterministic: bool = False) -> np.ndarray:
        return np.stack([np.asarray(self._choose_action(o)) for o in np.asarray(obs)])

    def as_rollout_fn(self):
        """The rollout interface ``(obs, generator) -> (acts, {})`` as a
        host function, marked ``host_stateful``: the observations are read
        to the host, and the actions (int32 for a discrete space, float32
        otherwise) return to the observations' device."""
        dtype = np.int32 if self.action_space.is_discrete else np.float32

        def f(obs: torch.Tensor, generator=None):
            acts = self.predict(obs.cpu().numpy()).astype(dtype)
            return torch.from_numpy(acts).to(obs.device), {}

        f.host_stateful = True
        return f
