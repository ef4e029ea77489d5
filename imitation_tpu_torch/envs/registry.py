"""Environment registry: name -> batched on-device Env factory.

Port of ``imitation_tpu/envs/registry.py`` for the device envs: the
classic-control names and their seals fixed-horizon variants, and the
seals MuJoCo envs, which ``make_vec_env`` returns as lockstep host envs
(``envs/mujoco_native.py``). The C++ classic-control engine's host envs are
reached through ``imitation_tpu_torch.native``, as in the JAX package; the
gym bridge is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from imitation_tpu_torch import Device
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
    """Builds a VectorEnv on ``device`` (CUDA unless the caller says "cpu").

    A seals MuJoCo name gives ``mujoco_native.MujocoLockstepVectorEnv``, a
    host vector env whose chunks go to ``device``, as the JAX package
    returns its lockstep env; ``lockstep=False`` or env arguments ask for
    the gym bridge, which the port does not have.
    """
    from imitation_tpu_torch.envs import mujoco_native

    if mujoco_native.supports(name):
        if not env_kwargs.pop("lockstep", True) or env_kwargs:
            raise NotImplementedError(
                f"{name}: lockstep=False or env arguments ({sorted(env_kwargs)}) need the gym bridge, "
                "which is not ported")
        return mujoco_native.MujocoLockstepVectorEnv(
            name, num_envs=num_envs, max_episode_steps=max_episode_steps, device=device
        )
    env = make_env(name, **env_kwargs)
    return VectorEnv(
        env,
        num_envs=num_envs,
        max_episode_steps=max_episode_steps,
        device=device,
    )


def _with_horizon(env: Env, horizon: int) -> Env:
    env.max_episode_steps = horizon
    return env


register("CartPole-v0", lambda **kw: _with_horizon(classic.CartPole(**kw), 200))
register("CartPole-v1", classic.CartPole)
register("Pendulum-v1", classic.Pendulum)
register("MountainCar-v0", classic.MountainCar)
register("MountainCarContinuous-v0", classic.MountainCarContinuous)
register("Acrobot-v1", classic.Acrobot)
register("seals/CartPole-v0", lambda **kw: classic.CartPole(fixed_horizon=True, **kw))
register("seals/MountainCar-v0", lambda **kw: classic.MountainCar(fixed_horizon=True, **kw))
register("seals/Pendulum-v0", classic.Pendulum)  # Pendulum is already fixed-horizon
