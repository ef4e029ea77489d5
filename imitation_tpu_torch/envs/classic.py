"""Batched classic-control environments on one device.

Port of ``imitation_tpu/envs/classic.py``: CartPole, Pendulum, MountainCar,
MountainCarContinuous and Acrobot. The dynamics follow Gymnasium's
classic_control implementations step for step, over a ``[B, k]`` state
tensor, with the JAX package's float32 constants and order of operations.
Angles wrap with ``torch.remainder``, the floor-mod that JAX's ``%`` is.

Each env also has a fixed-horizon "seals-style" variant via
``fixed_horizon=True``: early termination is disabled and episodes always
run to the time limit (Pendulum never terminates early either way).
The dynamics are deterministic: ``step`` ignores its generator.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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

    def step(self, state: torch.Tensor, action: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, TimeStep]:
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


def _wrap_angle(x: torch.Tensor) -> torch.Tensor:
    """``((x + pi) % 2pi) - pi`` with a floor-mod, as JAX's ``%``."""
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


def _uniform(n: int, k: int, lo: float, hi: float, generator: torch.Generator) -> torch.Tensor:
    """``[n, k]`` float32 uniform on ``[lo, hi)``."""
    u = torch.rand((n, k), generator=generator, device=generator.device)
    return lo + (hi - lo) * u


class Pendulum(Env):
    """Pendulum-v1 dynamics. Horizon 200; never terminates early.

    The state is ``[B, 2]`` (theta, theta_dot); the observation
    ``[B, 3]`` (cos, sin, theta_dot); the action ``[B, 1]`` torque.
    """

    max_episode_steps = 200

    def __init__(self, fixed_horizon: bool = True):
        self.max_speed = 8.0
        self.max_torque = 2.0
        self.dt = 0.05
        self.g = 10.0
        self.m = 1.0
        self.l = 1.0

    @property
    def observation_space(self) -> Space:
        high = np.array([1.0, 1.0, self.max_speed], dtype=np.float32)
        return Space.box(-high, high, (3,))

    @property
    def action_space(self) -> Space:
        return Space.box(-self.max_torque, self.max_torque, (1,))

    def reset(self, n: int, generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        th = _uniform(n, 1, -math.pi, math.pi, generator)
        thdot = _uniform(n, 1, -1.0, 1.0, generator)
        state = torch.cat([th, thdot], dim=-1)
        return self.obs_of(state), state

    @staticmethod
    def obs_of(state: torch.Tensor) -> torch.Tensor:
        th, thdot = state.unbind(-1)
        return torch.stack([torch.cos(th), torch.sin(th), thdot], dim=-1)

    def step(self, state: torch.Tensor, action: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, TimeStep]:
        th, thdot = state.unbind(-1)
        u = torch.clamp(action.reshape(-1), -self.max_torque, self.max_torque)
        angle_norm = _wrap_angle(th)
        cost = angle_norm ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        newthdot = thdot + (
            3.0 * self.g / (2.0 * self.l) * torch.sin(th)
            + 3.0 / (self.m * self.l ** 2) * u
        ) * self.dt
        newthdot = torch.clamp(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * self.dt
        new = torch.stack([newth, newthdot], dim=-1)
        f = torch.zeros_like(th, dtype=torch.bool)
        return new, TimeStep(obs=self.obs_of(new), reward=-cost, terminated=f, truncated=f)


class MountainCar(Env):
    """MountainCar-v0 dynamics (discrete actions 0, 1, 2). Horizon 200."""

    max_episode_steps = 200

    def __init__(self, fixed_horizon: bool = False):
        self.fixed_horizon = fixed_horizon
        self.min_position = -1.2
        self.max_position = 0.6
        self.max_speed = 0.07
        self.goal_position = 0.5
        self.force = 0.001
        self.gravity = 0.0025

    @property
    def observation_space(self) -> Space:
        low = np.array([self.min_position, -self.max_speed], dtype=np.float32)
        high = np.array([self.max_position, self.max_speed], dtype=np.float32)
        return Space.box(low, high, (2,))

    @property
    def action_space(self) -> Space:
        return Space.discrete(3)

    def reset(self, n: int, generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        pos = _uniform(n, 1, -0.6, -0.4, generator)
        state = torch.cat([pos, torch.zeros_like(pos)], dim=-1)
        return state, state

    def _finish(self, position, velocity, reward_fn) -> Tuple[torch.Tensor, TimeStep]:
        """Clips the position, stops the car at the left wall, and flags the goal."""
        velocity = torch.clamp(velocity, -self.max_speed, self.max_speed)
        position = torch.clamp(position + velocity, self.min_position, self.max_position)
        velocity = torch.where(
            (position == self.min_position) & (velocity < 0), torch.zeros_like(velocity), velocity
        )
        terminated = (position >= self.goal_position) & (velocity >= 0.0)
        if self.fixed_horizon:
            terminated = torch.zeros_like(terminated)
        new = torch.stack([position, velocity], dim=-1)
        return new, TimeStep(
            obs=new, reward=reward_fn(terminated), terminated=terminated,
            truncated=torch.zeros_like(terminated),
        )

    def step(self, state: torch.Tensor, action: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, TimeStep]:
        position, velocity = state.unbind(-1)
        velocity = velocity + (action - 1) * self.force + torch.cos(3 * position) * (-self.gravity)
        return self._finish(position, velocity, lambda term: torch.full_like(position, -1.0))


class MountainCarContinuous(MountainCar):
    """MountainCarContinuous-v0 dynamics (a ``[B, 1]`` force). Horizon 999."""

    max_episode_steps = 999

    def __init__(self, fixed_horizon: bool = False):
        super().__init__(fixed_horizon)
        self.goal_position = 0.45
        self.power = 0.0015

    @property
    def action_space(self) -> Space:
        return Space.box(-1.0, 1.0, (1,))

    def step(self, state: torch.Tensor, action: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, TimeStep]:
        position, velocity = state.unbind(-1)
        force = torch.clamp(action.reshape(-1), -1.0, 1.0)
        velocity = velocity + force * self.power - 0.0025 * torch.cos(3 * position)

        def reward(terminated):
            return torch.where(terminated, 100.0, 0.0) - 0.1 * force ** 2

        return self._finish(position, velocity, reward)


class Acrobot(Env):
    """Acrobot-v1 dynamics (RK4 integration, book-or-nips='book'). Horizon 500.

    The state is ``[B, 4]`` (theta1, theta2, dtheta1, dtheta2); the
    observation ``[B, 6]`` (cos, sin of both angles, both velocities).
    """

    max_episode_steps = 500

    def __init__(self, fixed_horizon: bool = False):
        self.fixed_horizon = fixed_horizon
        self.dt = 0.2
        self.link_length_1 = 1.0
        self.link_length_2 = 1.0
        self.link_mass_1 = 1.0
        self.link_mass_2 = 1.0
        self.link_com_pos_1 = 0.5
        self.link_com_pos_2 = 0.5
        self.link_moi = 1.0
        self.max_vel_1 = 4 * math.pi
        self.max_vel_2 = 9 * math.pi

    @property
    def observation_space(self) -> Space:
        high = np.array([1.0, 1.0, 1.0, 1.0, 4 * np.pi, 9 * np.pi], dtype=np.float32)
        return Space.box(-high, high, (6,))

    @property
    def action_space(self) -> Space:
        return Space.discrete(3)

    def reset(self, n: int, generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        state = _uniform(n, 4, -0.1, 0.1, generator)
        return self.obs_of(state), state

    @staticmethod
    def obs_of(state: torch.Tensor) -> torch.Tensor:
        th1, th2, dth1, dth2 = state.unbind(-1)
        return torch.stack(
            [torch.cos(th1), torch.sin(th1), torch.cos(th2), torch.sin(th2), dth1, dth2], dim=-1
        )

    def _dsdt(self, s_augmented: torch.Tensor) -> torch.Tensor:
        """Time derivative of ``[B, 5]`` (state, torque); the torque's is 0."""
        m1, m2 = self.link_mass_1, self.link_mass_2
        l1 = self.link_length_1
        lc1, lc2 = self.link_com_pos_1, self.link_com_pos_2
        I1 = I2 = self.link_moi
        g = 9.8
        theta1, theta2, dtheta1, dtheta2, a = s_augmented.unbind(-1)
        d1 = (
            m1 * lc1 ** 2
            + m2 * (l1 ** 2 + lc2 ** 2 + 2 * l1 * lc2 * torch.cos(theta2))
            + I1 + I2
        )
        d2 = m2 * (lc2 ** 2 + l1 * lc2 * torch.cos(theta2)) + I2
        phi2 = m2 * lc2 * g * torch.cos(theta1 + theta2 - math.pi / 2.0)
        phi1 = (
            -m2 * l1 * lc2 * dtheta2 ** 2 * torch.sin(theta2)
            - 2 * m2 * l1 * lc2 * dtheta2 * dtheta1 * torch.sin(theta2)
            + (m1 * lc1 + m2 * l1) * g * torch.cos(theta1 - math.pi / 2)
            + phi2
        )
        ddtheta2 = (
            a + d2 / d1 * phi1 - m2 * l1 * lc2 * dtheta1 ** 2 * torch.sin(theta2) - phi2
        ) / (m2 * lc2 ** 2 + I2 - d2 ** 2 / d1)
        ddtheta1 = -(d2 * ddtheta2 + phi1) / d1
        return torch.stack([dtheta1, dtheta2, ddtheta1, ddtheta2, torch.zeros_like(a)], dim=-1)

    def step(self, state: torch.Tensor, action: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, TimeStep]:
        torque = (action - 1).to(torch.float32)
        s_aug = torch.cat([state, torque[:, None]], dim=-1)
        dt = self.dt
        k1 = self._dsdt(s_aug)
        k2 = self._dsdt(s_aug + dt / 2 * k1)
        k3 = self._dsdt(s_aug + dt / 2 * k2)
        k4 = self._dsdt(s_aug + dt * k3)
        ns = s_aug + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        new = torch.stack([
            _wrap_angle(ns[:, 0]),
            _wrap_angle(ns[:, 1]),
            torch.clamp(ns[:, 2], -self.max_vel_1, self.max_vel_1),
            torch.clamp(ns[:, 3], -self.max_vel_2, self.max_vel_2),
        ], dim=-1)
        terminated = (-torch.cos(new[:, 0]) - torch.cos(new[:, 1] + new[:, 0])) > 1.0
        if self.fixed_horizon:
            terminated = torch.zeros_like(terminated)
        reward = torch.where(terminated, 0.0, -1.0)
        return new, TimeStep(
            obs=self.obs_of(new), reward=reward, terminated=terminated,
            truncated=torch.zeros_like(terminated),
        )
