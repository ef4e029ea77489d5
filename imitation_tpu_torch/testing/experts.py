"""Scripted expert policies for testing.

Port of the CartPole part of ``imitation_tpu/testing/experts.py``: a
closed-form controller with the rollout policy interface
``(obs, generator) -> (acts, aux)``, so demonstrations are made on the
device with no download.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from imitation_tpu_torch.data import rollout as rollout_mod
from imitation_tpu_torch.data import types
from imitation_tpu_torch.envs.vector import VectorEnv


def cartpole_expert_fn(
    obs: torch.Tensor, generator: Optional[torch.Generator] = None
) -> Tuple[torch.Tensor, dict]:
    """PD controller on (theta, theta_dot) + cart recentring; balances
    CartPole indefinitely (return 500 on CartPole-v1)."""
    x, x_dot, theta, theta_dot = obs.unbind(-1)
    score = theta + 0.5 * theta_dot + 0.05 * x + 0.1 * x_dot
    return (score > 0).to(torch.int32), {}


EXPERTS = {
    "CartPole-v1": cartpole_expert_fn,
    "CartPole-v0": cartpole_expert_fn,
    "seals/CartPole-v0": cartpole_expert_fn,
}


def expert_for(env_name: str):
    """Returns the scripted expert rollout fn for ``env_name``."""
    if env_name not in EXPERTS:
        raise KeyError(f"no scripted expert for {env_name!r}")
    return EXPERTS[env_name]


def generate_expert_trajectories(
    env_name: str,
    venv: VectorEnv,
    min_episodes: int = 10,
    seed: int = 0,
) -> Sequence[types.TrajectoryWithRew]:
    """Rolls out the scripted expert on ``venv``'s device."""
    return rollout_mod.generate_trajectories(
        expert_for(env_name), venv, rollout_mod.make_min_episodes(min_episodes), rng=seed
    )
