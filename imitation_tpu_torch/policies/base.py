"""Policy re-exports and the SAC-sized actor-critic.

Port of ``imitation_tpu/policies/base.py``: the policies live in
``models/policies.py`` and are re-exported here under the JAX package's
module path.
"""

from __future__ import annotations

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
