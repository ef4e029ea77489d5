"""Batched classic-control environments on one device.

Port of ``imitation_tpu/envs/classic.py`` (CartPole only in this slice). The
dynamics follow Gymnasium's classic_control CartPole step for step, over a
``[B, 4]`` state tensor.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from imitation_tpu_torch.envs.base import Env, Space, TimeStep


class CartPole(Env):
    """CartPole-v1 dynamics (Euler integration).

    Gravity 9.8, cart mass 1.0, pole mass 0.1, half-length 0.5, force 10,
    tau 0.02; terminates at |x|>2.4 or |theta|>12deg; reward 1 per step;
    horizon 500. ``fixed_horizon=True`` disables termination (seals).
    """

    max_episode_steps = 500

    def __init__(self, fixed_horizon: bool = False):
        self.fixed_horizon = fixed_horizon
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.total_mass = self.masscart + self.masspole
        self.length = 0.5
        self.polemass_length = self.masspole * self.length
        self.force_mag = 10.0
        self.tau = 0.02
        self.theta_threshold = 12 * 2 * math.pi / 360
        self.x_threshold = 2.4

    @property
    def observation_space(self) -> Space:
        high = np.array(
            [self.x_threshold * 2, np.finfo(np.float32).max,
             self.theta_threshold * 2, np.finfo(np.float32).max],
            dtype=np.float32,
        )
        return Space.box(-high, high, (4,))

    @property
    def action_space(self) -> Space:
        return Space.discrete(2)

    def reset(self, n: int, generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        u = torch.rand((n, 4), generator=generator, device=generator.device)
        x = u * 0.1 - 0.05  # U(-0.05, 0.05)
        return x, x

    def step(self, state: torch.Tensor, action: torch.Tensor) -> Tuple[torch.Tensor, TimeStep]:
        x, x_dot, theta, theta_dot = state.unbind(-1)
        force = torch.where(action == 1, self.force_mag, -self.force_mag)
        costheta = torch.cos(theta)
        sintheta = torch.sin(theta)
        temp = (
            force + self.polemass_length * (theta_dot * theta_dot) * sintheta
        ) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length
            * (4.0 / 3.0 - self.masspole * (costheta * costheta) / self.total_mass)
        )
        xacc = temp - self.polemass_length * thetaacc * costheta / self.total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        new = torch.stack([x, x_dot, theta, theta_dot], dim=-1)
        if self.fixed_horizon:
            terminated = torch.zeros_like(x, dtype=torch.bool)
        else:
            terminated = (x.abs() > self.x_threshold) | (theta.abs() > self.theta_threshold)
        return new, TimeStep(
            obs=new,
            reward=torch.ones_like(x),
            terminated=terminated,
            truncated=torch.zeros_like(terminated),
        )
