"""Environment registry: name -> batched on-device Env factory.

Port of ``imitation_tpu/envs/registry.py`` for the device envs of this slice
(CartPole). Host (MuJoCo, gym-bridge) envs are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from imitation_tpu_torch import Device, default_device
from imitation_tpu_torch.envs import classic
from imitation_tpu_torch.envs.base import Env
from imitation_tpu_torch.envs.vector import VectorEnv

_REGISTRY: Dict[str, Callable[..., Env]] = {}


def register(name: str, factory: Callable[..., Env]) -> None:
    if name in _REGISTRY:
        raise ValueError(f"env {name!r} already registered")
    _REGISTRY[name] = factory


def registered_envs():
    return sorted(_REGISTRY)


def make_env(name: str, **kwargs) -> Env:
    if name not in _REGISTRY:
        raise KeyError(f"unknown env {name!r}; registered: {registered_envs()}")
    return _REGISTRY[name](**kwargs)


def make_vec_env(
    name: str,
    num_envs: int = 8,
    max_episode_steps: Optional[int] = None,
    device: Optional[Device] = None,
    **env_kwargs,
) -> VectorEnv:
    """Builds a VectorEnv on ``device`` (CUDA unless the caller says "cpu")."""
    env = make_env(name, **env_kwargs)
    return VectorEnv(
        env,
        num_envs=num_envs,
        max_episode_steps=max_episode_steps,
        device=default_device(device),
    )


def _with_horizon(env: Env, horizon: int) -> Env:
    env.max_episode_steps = horizon
    return env


register("CartPole-v0", lambda **kw: _with_horizon(classic.CartPole(**kw), 200))
register("CartPole-v1", classic.CartPole)
register("seals/CartPole-v0", lambda **kw: classic.CartPole(fixed_horizon=True, **kw))
