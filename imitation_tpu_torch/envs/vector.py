"""The batched vector-env engine: B lockstep envs with auto-reset and monitor.

Port of ``imitation_tpu/envs/vector.py``. Semantics kept:

* **Auto-reset with terminal observation**: when an episode ends, ``step``
  returns the reset observation as the next obs, while ``terminal_obs``
  carries the true final observation.
* **Monitor episode stats**: per-env true return and length, valid on the
  step an episode finishes.
* **terminated vs truncated**: truncation at the horizon fires only when the
  step did not terminate (Gymnasium semantics).

The state's generator drives the env's own step draws (a stochastic env
such as ``envs/tabular.py``) and then the auto-resets, in that order.

Unlike the JAX engine, which is pure, ``step`` here returns a new state
object but the tensors it holds are fresh each step; nothing is mutated in
place, so a caller may keep an old state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from imitation_tpu_torch import Device, default_device
from imitation_tpu_torch.envs.base import Env, Space
from imitation_tpu_torch.parallel import distributed


@dataclasses.dataclass
class VecEnvState:
    """Batched state of B environments on one device."""

    env_state: Any  # [B, ...]
    obs: torch.Tensor  # [B, obs...] current observation (post-reset)
    t: torch.Tensor  # [B] int32 steps since episode start
    episode_return: torch.Tensor  # [B] f32 accumulated true reward
    generator: torch.Generator  # drives the auto-resets


@dataclasses.dataclass
class VecStep:
    """Result of one vectorized step, after auto-reset."""

    obs: torch.Tensor  # [B, ...] next obs AFTER auto-reset
    terminal_obs: torch.Tensor  # [B, ...] true next obs (pre-reset)
    reward: torch.Tensor  # [B] f32
    terminated: torch.Tensor  # [B] bool
    truncated: torch.Tensor  # [B] bool
    episode_return: torch.Tensor  # [B] f32, valid where done
    episode_length: torch.Tensor  # [B] int32, valid where done

    @property
    def done(self) -> torch.Tensor:
        return self.terminated | self.truncated


def _where_rows(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-env select; ``cond`` is [B]."""
    return torch.where(cond.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


class VectorEnv:
    """B lockstep instances of a batched ``Env`` with auto-reset + monitor."""

    def __init__(
        self,
        env: Env,
        num_envs: int,
        max_episode_steps: Optional[int] = None,
        device: Optional[Device] = None,  # CUDA unless the caller says "cpu"
    ):
        self.env = env
        self.num_envs = num_envs
        self.max_episode_steps = (
            max_episode_steps if max_episode_steps is not None else env.max_episode_steps
        )
        self.device = default_device(device)
        self.mesh = None  # set on a rank's view (``rows``)
        self.global_num_envs = num_envs

    def rows(self, mesh) -> "VectorEnv":
        """The view of ``mesh``'s rank: its block of the envs (module
        docstring)."""
        mesh.rows(self.num_envs)  # raises where the envs do not divide
        view = VectorEnv(self.env, self.num_envs // mesh.dp, self.max_episode_steps, self.device)
        view.mesh, view.global_num_envs = mesh, self.num_envs
        return view

    def _reset_rows(self, generator: torch.Generator):
        """Fresh episodes for this env's rows: a rank's view draws the whole
        batch's and keeps its block."""
        obs, state = self.env.reset(self.global_num_envs, generator)
        if self.mesh is not None:
            rows = self.mesh.rows(self.global_num_envs)

            def take(x):
                return {k: v[rows] for k, v in x.items()} if isinstance(x, dict) else x[rows]

            obs, state = take(obs), take(state)
        return obs, state

    @property
    def observation_space(self) -> Space:
        return self.env.observation_space

    @property
    def action_space(self) -> Space:
        return self.env.action_space

    def reset(self, generator: torch.Generator) -> VecEnvState:
        if generator.device.type != self.device.type:
            raise ValueError(
                f"generator on {generator.device}, env on {self.device}"
            )
        obs, env_state = self._reset_rows(generator)
        B = self.num_envs
        return VecEnvState(
            env_state=env_state,
            obs=obs,
            t=torch.zeros((B,), dtype=torch.int32, device=self.device),
            episode_return=torch.zeros((B,), dtype=torch.float32, device=self.device),
            generator=generator,
        )

    def step(self, state: VecEnvState, actions: torch.Tensor) -> Tuple[VecEnvState, VecStep]:
        with distributed.local_rows(self.mesh):
            new_env_state, ts = self.env.step(state.env_state, actions, state.generator)
        t = state.t + 1
        truncated = ts.truncated
        if self.max_episode_steps is not None:
            truncated = truncated | ((t >= self.max_episode_steps) & ~ts.terminated)
        done = ts.terminated | truncated

        ep_return = state.episode_return + ts.reward
        ep_length = t

        # Auto-reset the finished envs (all B reset states are drawn, as in
        # the JAX engine, and selected where done).
        reset_obs, reset_state = self._reset_rows(state.generator)
        next_env_state = _where_rows(done, reset_state, new_env_state)
        next_obs = _where_rows(done, reset_obs, ts.obs)

        new_state = VecEnvState(
            env_state=next_env_state,
            obs=next_obs,
            t=torch.where(done, torch.zeros_like(t), t),
            episode_return=torch.where(done, torch.zeros_like(ep_return), ep_return),
            generator=state.generator,
        )
        out = VecStep(
            obs=next_obs,
            terminal_obs=ts.obs,
            reward=ts.reward,
            terminated=ts.terminated,
            truncated=truncated,
            episode_return=ep_return,
            episode_length=ep_length,
        )
        return new_state, out
