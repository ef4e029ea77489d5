"""Batched on-device environment engine."""

from imitation_tpu_torch.envs.base import Env, Space, TimeStep
from imitation_tpu_torch.envs.registry import make_env, make_vec_env, register, registered_envs
from imitation_tpu_torch.envs.vector import VecEnvState, VecStep, VectorEnv

__all__ = [
    "Env",
    "Space",
    "TimeStep",
    "VectorEnv",
    "VecEnvState",
    "VecStep",
    "make_env",
    "make_vec_env",
    "register",
    "registered_envs",
]
