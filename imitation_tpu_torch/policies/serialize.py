"""Policy save/load and the policy-type registry.

Port of ``imitation_tpu/policies/serialize.py`` for actor-critic policies
(``features`` ``flatten`` or ``nature_cnn``) and SAC actors
(``rl.sac.SACPolicy``, policy type ``sac_actor``). A saved policy is a
directory holding ``policy_config.json``, with the same schema and values
the JAX package writes (architecture, features and spaces), and
``policy.pt``, a ``torch.save`` of the module's ``state_dict`` with tensors
on the CPU. ``load_policy_from_path`` also reads a directory the JAX package
wrote (``policy_config.json`` and ``variables.msgpack``, flax's msgpack,
read by ``util.flax_msgpack`` and carried over by ``convert``), as the
repo's experts under ``output/experts/<env>/policy`` are.
``load_policy`` looks loaders up by type: ``random``, ``zero``, ``saved``,
``ppo`` and ``sac`` (all three: a Stable-Baselines3 ``model.zip``, or a
directory holding one, through ``sb3_interop``; any other path as
``load_policy_from_path``), and ``ppo-huggingface`` / ``sac-huggingface``,
which name a HuggingFace-hub expert and raise the JAX package's offline
``RuntimeError`` without trying a download (no network, no
``huggingface_hub``); ``SavePolicyCallback`` saves a policy every few
learner updates.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from imitation_tpu_torch import Device, convert, default_device
from imitation_tpu_torch.envs.base import Space
from imitation_tpu_torch.envs.vector import VectorEnv
from imitation_tpu_torch.models.policies import ActorCriticPolicy, RandomPolicy, ZeroPolicy
from imitation_tpu_torch.rl.sac import SACPolicy
from imitation_tpu_torch.util import flax_msgpack

SavedPolicy = Union[ActorCriticPolicy, SACPolicy]

POLICY_CONFIG = "policy_config.json"
POLICY_WEIGHTS = "policy.pt"
POLICY_VARS = "variables.msgpack"  # the JAX package's weights

ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "tanh": torch.tanh, "relu": torch.relu, "sigmoid": torch.sigmoid,
    "gelu": torch.nn.functional.gelu, "elu": torch.nn.functional.elu,
}


def _space_to_json(space: Space) -> Dict[str, Any]:
    return {
        "shape": list(space.shape),
        "dtype": np.dtype(space.dtype).name,
        "n": space.n,
        "low": None if space.low is None else np.asarray(space.low).tolist(),
        "high": None if space.high is None else np.asarray(space.high).tolist(),
    }


def _space_from_json(d: Dict[str, Any]) -> Space:
    return Space(
        shape=tuple(d["shape"]),
        dtype=np.dtype(d["dtype"]).type,
        n=d["n"],
        low=None if d["low"] is None else np.asarray(d["low"], d["dtype"]),
        high=None if d["high"] is None else np.asarray(d["high"], d["dtype"]),
    )


def policy_config(policy: SavedPolicy) -> Dict[str, Any]:
    """The ``policy_config.json`` contents of an actor-critic policy or a
    SAC actor."""
    if isinstance(policy, SACPolicy):
        return {
            "policy_type": "sac_actor",
            "observation_space": _space_to_json(policy.observation_space),
            "action_space": _space_to_json(policy.action_space),
            "hid_sizes": list(policy.hid_sizes),
        }
    if not isinstance(policy, ActorCriticPolicy):
        raise TypeError(f"only ActorCriticPolicy and SACPolicy are saved, not {type(policy).__name__}")
    net = policy.net
    act_name = next((k for k, f in ACTIVATIONS.items() if f is net.activation), None)
    if act_name is None:
        raise ValueError(f"activation {net.activation!r} has no saved name")
    return {
        "policy_type": "actor_critic",
        "observation_space": _space_to_json(policy.observation_space),
        "action_space": _space_to_json(policy.action_space),
        "hid_sizes": list(net.hid_sizes),
        "normalize_features": policy.normalize_features,
        "log_std_init": net.log_std_init,
        "activation": act_name,
        "features": policy.features,
    }


def policy_from_config(config: Dict[str, Any]) -> SavedPolicy:
    """An (uninitialised) policy of the architecture ``config`` describes."""
    if config["policy_type"] == "sac_actor":
        return SACPolicy(
            observation_space=_space_from_json(config["observation_space"]),
            action_space=_space_from_json(config["action_space"]),
            hid_sizes=tuple(config["hid_sizes"]),
        )
    if config["policy_type"] != "actor_critic":
        raise ValueError(f"policy_type {config['policy_type']!r} is not loaded by the port")
    return ActorCriticPolicy(
        observation_space=_space_from_json(config["observation_space"]),
        action_space=_space_from_json(config["action_space"]),
        hid_sizes=tuple(config["hid_sizes"]),
        activation=ACTIVATIONS[config.get("activation", "tanh")],
        normalize_features=config["normalize_features"],
        log_std_init=config["log_std_init"],
        features=config.get("features", "flatten"),
    )


def save_policy(path: str, policy: SavedPolicy) -> None:
    """Saves the policy's architecture and weights to the directory ``path``."""
    config = policy_config(policy)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, POLICY_CONFIG), "w") as f:
        json.dump(config, f, indent=2)
    state = {k: v.detach().cpu() for k, v in policy.state_dict().items()}
    torch.save(state, os.path.join(path, POLICY_WEIGHTS))


def load_policy_from_path(path: str, device: Optional[Device] = None) -> SavedPolicy:
    """Loads a policy ``save_policy`` wrote, or one the JAX package saved
    (``variables.msgpack`` and no ``policy.pt``), onto ``device`` (CUDA
    unless the caller says ``"cpu"``). Every weight must be present."""
    dev = default_device(device)
    with open(os.path.join(path, POLICY_CONFIG)) as f:
        policy = policy_from_config(json.load(f))
    weights = os.path.join(path, POLICY_WEIGHTS)
    if os.path.exists(weights):
        policy.load_state_dict(torch.load(weights, map_location="cpu", weights_only=True))
    elif os.path.exists(os.path.join(path, POLICY_VARS)):
        variables = flax_msgpack.read_msgpack(os.path.join(path, POLICY_VARS))
        if isinstance(policy, SACPolicy):
            policy.actor.load_state_dict(convert.sac_actor_state_dict(variables))
        else:
            policy.load_state_dict(convert.policy_state_dict(variables))
    else:
        raise FileNotFoundError(f"neither {POLICY_WEIGHTS} nor {POLICY_VARS} in {path!r}")
    return policy.to(dev)


def _load_random(venv: VectorEnv, **kwargs) -> RandomPolicy:
    return RandomPolicy(venv.observation_space, venv.action_space)


def _load_zero(venv: VectorEnv, **kwargs) -> ZeroPolicy:
    return ZeroPolicy(venv.observation_space, venv.action_space)


def _load_saved(venv: VectorEnv, path: str, **kwargs) -> SavedPolicy:
    zip_path = None
    if path.endswith(".zip") and os.path.exists(path):
        zip_path = path
    elif os.path.isdir(path) and os.path.exists(os.path.join(path, "model.zip")):
        zip_path = os.path.join(path, "model.zip")
    if zip_path is not None:
        from imitation_tpu_torch.policies import sb3_interop

        return sb3_interop.load_sb3_policy_for_env(zip_path, venv)
    policy = load_policy_from_path(path, device=venv.device)
    if policy.observation_space.shape != venv.observation_space.shape:
        raise ValueError(
            "policy observation space does not match env: "
            f"{policy.observation_space.shape} vs {venv.observation_space.shape}"
        )
    return policy


def _hf_model_name(algo: str, env_name: str) -> str:
    """huggingface_sb3 naming: '/' in env ids becomes '-'."""
    return f"{algo}-{env_name.replace('/', '-')}"


def _load_huggingface(venv: VectorEnv, env_name: str, algo: str = "ppo",
                      organization: str = "HumanCompatibleAI", **kwargs):
    """An SB3 expert of the HuggingFace hub: the port downloads nothing, so
    this raises the JAX package's offline error, which names the way to
    load a model zip fetched by hand."""
    repo_id = f"{organization}/{_hf_model_name(algo, env_name)}"
    raise RuntimeError(
        f"could not fetch {repo_id} from the HuggingFace hub (offline?). "
        "Download the model zip manually and load it with "
        "policy_type='ppo' path=<model.zip>."
    )


policy_registry: Dict[str, Callable[..., Any]] = {
    "random": _load_random,
    "zero": _load_zero,
    "ppo": _load_saved,
    "sac": _load_saved,
    "saved": _load_saved,
    "ppo-huggingface": functools.partial(_load_huggingface, algo="ppo"),
    "sac-huggingface": functools.partial(_load_huggingface, algo="sac"),
}


def load_policy(policy_type: str, venv: VectorEnv, **kwargs):
    """The policy of ``policy_type`` for ``venv`` (``path=`` for ``saved``,
    ``ppo`` and ``sac``)."""
    if policy_type not in policy_registry:
        raise KeyError(f"unknown policy type {policy_type!r}; known: {sorted(policy_registry)}")
    return policy_registry[policy_type](venv, **kwargs)


class SavePolicyCallback:
    """A learner callback (``callback(state, metrics)``) that saves
    ``policy``, whose weights the learner trains in place, to
    ``policy_dir/<count:012d>`` every ``save_interval_updates`` calls."""

    def __init__(self, policy_dir: str, policy: SavedPolicy, save_interval_updates: int = 1):
        self.policy_dir = policy_dir
        self.policy = policy
        self.save_interval = save_interval_updates
        self._count = 0

    def __call__(self, state: Any = None, metrics: Any = None) -> None:
        self._count += 1
        if self._count % self.save_interval == 0:
            save_policy(os.path.join(self.policy_dir, f"{self._count:012d}"), self.policy)
