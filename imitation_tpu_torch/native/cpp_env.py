"""``CppVectorEnv``: the C++ classic-control engine as a host vector env.

Port of ``imitation_tpu/native/cpp_env.py``. One ``step`` crosses into C
once for all B envs, which the engine steps on ``min(8, cpu_count)``
threads unless told otherwise. The host-vector-env contract: ``is_host =
True``, ``reset()`` returns numpy observations and ``step(actions)`` a dict
of numpy arrays (``obs``, ``terminal_obs``, ``reward``, ``terminated``,
``truncated``, ``episode_return``, ``episode_length``), with auto-reset:
``obs`` is the reset observation where an episode ended and
``terminal_obs`` its true last one.

``device`` is where the learners and the collected chunks live (the env
itself steps on the host): CUDA unless the caller passes ``device="cpu"``.

``first_env`` makes the envs those from index ``first_env`` on of a larger
batch with the same seed: a data-parallel rank builds
``CppVectorEnv(name, local_env_count(B), seed=s, first_env=rank * B // W)``
and steps exactly its block of the one-process ``CppVectorEnv(name, B,
seed=s)``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from imitation_tpu_torch import Device, default_device
from imitation_tpu_torch.envs.base import Space

# env name -> (engine env type, fixed horizon: terminations ignored)
ENV_TYPES = {
    "CartPole-v1": (0, False),
    "CartPole-v0": (0, False),
    "seals/CartPole-v0": (0, True),
    "Pendulum-v1": (1, False),
    "seals/Pendulum-v0": (1, False),
    "MountainCar-v0": (2, False),
    "seals/MountainCar-v0": (2, True),
    "MountainCarContinuous-v0": (3, False),
}

_SPACES = {
    0: (Space.box(-np.inf, np.inf, (4,)), Space.discrete(2)),
    1: (
        Space.box(np.array([-1, -1, -8], np.float32), np.array([1, 1, 8], np.float32), (3,)),
        Space.box(-2.0, 2.0, (1,)),
    ),
    2: (Space.box(-np.inf, np.inf, (2,)), Space.discrete(3)),
    3: (Space.box(-np.inf, np.inf, (2,)), Space.box(-1.0, 1.0, (1,))),
}


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


class CppVectorEnv:
    """Batched C++ classic-control envs behind the host-vector-env contract."""

    is_host = True

    def __init__(
        self,
        env_name: str,
        num_envs: int = 8,
        max_episode_steps: Optional[int] = None,
        seed: int = 0,
        num_threads: Optional[int] = None,
        device: Optional[Device] = None,
        first_env: int = 0,
    ):
        from imitation_tpu_torch.native.build import load_library

        if env_name not in ENV_TYPES:
            raise KeyError(f"no C++ engine for {env_name!r}; available: {sorted(ENV_TYPES)}")
        env_type, fixed_horizon = ENV_TYPES[env_name]
        self.device = default_device(device)
        self._lib = load_library()
        if num_threads is None:
            num_threads = min(8, os.cpu_count() or 1)
        self.num_threads = num_threads
        self.num_envs = num_envs
        self._handle = self._lib.engine_create(
            env_type, num_envs, max_episode_steps or 0, int(fixed_horizon), seed, num_threads,
            first_env,
        )
        self.observation_space, self.action_space = _SPACES[env_type]
        self._obs_dim = self._lib.engine_obs_dim(self._handle)
        self.max_episode_steps = max_episode_steps

        B, f32 = num_envs, np.float32
        self._obs = np.zeros((B, self._obs_dim), f32)
        self._term_obs = np.zeros((B, self._obs_dim), f32)
        self._reward = np.zeros(B, f32)
        self._terminated = np.zeros(B, np.uint8)
        self._truncated = np.zeros(B, np.uint8)
        self._ep_ret = np.zeros(B, f32)
        self._ep_len = np.zeros(B, np.int32)

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        """Resets every env from its own generator (seeded at construction;
        ``seed`` is accepted for the contract and not used)."""
        self._lib.engine_reset(self._handle, _ptr(self._obs, ctypes.c_float))
        return self._obs.copy()

    def step(self, actions) -> dict:
        acts = np.ascontiguousarray(np.asarray(actions, np.float32).reshape(self.num_envs, -1))
        self._lib.engine_step(
            self._handle,
            _ptr(acts, ctypes.c_float),
            _ptr(self._obs, ctypes.c_float),
            _ptr(self._term_obs, ctypes.c_float),
            _ptr(self._reward, ctypes.c_float),
            _ptr(self._terminated, ctypes.c_uint8),
            _ptr(self._truncated, ctypes.c_uint8),
            _ptr(self._ep_ret, ctypes.c_float),
            _ptr(self._ep_len, ctypes.c_int32),
        )
        return dict(
            obs=self._obs.copy(),
            terminal_obs=self._term_obs.copy(),
            reward=self._reward.copy(),
            terminated=self._terminated.astype(bool),
            truncated=self._truncated.astype(bool),
            episode_return=self._ep_ret.copy(),
            episode_length=self._ep_len.copy(),
        )

    def close(self) -> None:
        if self._handle:
            self._lib.engine_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def make_cpp_vec_env(env_name: str, num_envs: int = 8, **kwargs) -> CppVectorEnv:
    return CppVectorEnv(env_name, num_envs=num_envs, **kwargs)
