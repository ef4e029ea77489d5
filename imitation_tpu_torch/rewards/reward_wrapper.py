"""Reward relabelling: of a rollout chunk, or of a host env at step time.

Port of ``imitation_tpu/rewards/reward_wrapper.py``:

* ``relabel_chunk``: one batched reward-net forward over all ``T * B``
  transitions of a chunk, where the reference wraps the env and relabels
  step by step (the learners' path on device and host envs alike).
* ``RewardVecEnvWrapper``: a host vector env (``is_host``) whose ``step``
  returns a learned reward in place of the env's, the true one kept under
  ``original_env_rew``; it records the true episode returns, which
  ``WrappedRewardCallback`` logs.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from imitation_tpu_torch.data.rollout import RolloutChunk
from imitation_tpu_torch.rewards.reward_function import RewardFn
from imitation_tpu_torch.rl.common import RelabelRewardFn


@torch.no_grad()
def relabel_chunk(chunk: RolloutChunk, reward_fn: RelabelRewardFn, reward_params: Any) -> RolloutChunk:
    """``chunk`` with its ``[T, B]`` rewards replaced by ``reward_fn``'s."""
    T, B = chunk.rews.shape

    def flat(x):
        return x.reshape((T * B,) + tuple(x.shape[2:]))

    rews = reward_fn(
        reward_params, flat(chunk.obs), flat(chunk.acts), flat(chunk.next_obs),
        flat(chunk.dones.float()),
    ).reshape(T, B)
    return chunk.replace(rews=rews)


class WrappedRewardCallback:
    """Logs the mean true episode return seen by a ``RewardVecEnvWrapper``
    as ``rollout/ep_rew_wrapped_mean``."""

    def __init__(self, episode_rewards: List[float], logger=None):
        self.episode_rewards = episode_rewards
        self.logger = logger

    def log(self, step: int = 0) -> None:
        if len(self.episode_rewards) == 0 or self.logger is None:
            return
        mean = sum(self.episode_rewards) / len(self.episode_rewards)
        self.logger.record("rollout/ep_rew_wrapped_mean", mean)
        self.logger.dump(step)


class RewardVecEnvWrapper:
    """A host vector env with ``reward_fn(obs, acts, next_obs, dones)``
    (numpy in and out) substituted for its reward at step time; the true
    next observation at an episode's end is its terminal one. The last
    ``ep_history`` true episode returns are kept in ``episode_rewards``."""

    is_host = True

    def __init__(self, venv, reward_fn: RewardFn, ep_history: int = 100):
        self.venv = venv
        self.reward_fn = reward_fn
        self.episode_rewards: List[float] = []
        self._ep_history = ep_history
        self._cumul_rew = np.zeros(venv.num_envs)
        self._last_obs = None

    num_envs = property(lambda self: self.venv.num_envs)
    observation_space = property(lambda self: self.venv.observation_space)
    action_space = property(lambda self: self.venv.action_space)
    device = property(lambda self: self.venv.device)

    def make_log_callback(self, logger=None) -> WrappedRewardCallback:
        return WrappedRewardCallback(self.episode_rewards, logger)

    def reset(self, **kwargs) -> np.ndarray:
        obs = self.venv.reset(**kwargs)
        self._last_obs = obs
        self._cumul_rew[:] = 0
        return obs

    def step(self, actions) -> dict:
        out = dict(self.venv.step(actions))
        done = out["terminated"] | out["truncated"]
        rews = self.reward_fn(self._last_obs, np.asarray(actions), out["terminal_obs"],
                              done.astype(np.float32))
        self._cumul_rew += out["reward"]
        for i in np.flatnonzero(done):
            self.episode_rewards.append(self._cumul_rew[i])
            self._cumul_rew[i] = 0
        while len(self.episode_rewards) > self._ep_history:
            self.episode_rewards.pop(0)
        out["original_env_rew"] = out["reward"]
        out["reward"] = np.asarray(rews, np.float32)
        self._last_obs = out["obs"]
        return out
