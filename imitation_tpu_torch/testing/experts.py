"""Scripted expert policies for testing.

Port of ``imitation_tpu/testing/experts.py``: closed-form near-optimal
controllers for the classic-control envs, with the rollout policy interface
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


def pendulum_expert_fn(
    obs: torch.Tensor, generator: Optional[torch.Generator] = None
) -> Tuple[torch.Tensor, dict]:
    """Energy-shaping swing-up with a PD stabilizer near the top; ``[B, 1]``
    torques (return around -150 on Pendulum-v1)."""
    cos_th, sin_th, thdot = obs.unbind(-1)
    th = torch.atan2(sin_th, cos_th)
    g, m, l = 10.0, 1.0, 1.0
    # mechanical energy relative to the upright position
    energy = 0.5 * m * l ** 2 * thdot ** 2 + m * g * l * (cos_th - 1.0)
    swing_u = 2.0 * torch.sign(thdot * (-energy))
    pd_u = -16.0 * th - 4.0 * thdot
    near_top = th.abs() < 0.4
    u = torch.where(near_top, pd_u, swing_u)
    return torch.clamp(u, -2.0, 2.0)[:, None], {}


def mountain_car_expert_fn(
    obs: torch.Tensor, generator: Optional[torch.Generator] = None
) -> Tuple[torch.Tensor, dict]:
    """Bang-bang energy pumping: accelerate along the current velocity."""
    vel = obs[:, 1]
    return torch.where(vel >= 0, 2, 0).to(torch.int32), {}


EXPERTS = {
    "CartPole-v1": cartpole_expert_fn,
    "CartPole-v0": cartpole_expert_fn,
    "seals/CartPole-v0": cartpole_expert_fn,
    "Pendulum-v1": pendulum_expert_fn,
    "seals/Pendulum-v0": pendulum_expert_fn,
    "MountainCar-v0": mountain_car_expert_fn,
    "seals/MountainCar-v0": mountain_car_expert_fn,
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
