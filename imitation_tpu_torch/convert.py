"""Carries weights from the JAX package's flax variables into the port.

The flax variables are given as nested dicts of numpy arrays
(``{"params": {...}, "stats": {...}}``, e.g. ``jax.device_get`` of what
``init`` returns, or a msgpack restore). Layer names are kept, so a flax path
``params/pi0/kernel`` becomes the torch key ``net.pi0.weight``. A flax
``Dense.kernel`` is ``[in, out]`` and a torch ``Linear.weight`` is
``[out, in]``, so kernels are transposed. A member-stacked kernel of an
ensemble (``nn.vmap``, ``[M, in, out]``) is the port's ``StackedMLP`` layout
already and is kept as it is. ``RunningNorm`` and ``EMANorm`` statistics
(``stats/<layer>/{running_mean, running_var, count, ...}``, with a leading
member axis in an ensemble) become the module's buffers of the same names.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def flax_to_state_dict(variables: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flattens flax ``params`` and ``stats`` into a torch ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping[str, Any], path: list) -> None:
        for name, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, path + [name])
                continue
            arr = np.asarray(value)
            if name == "kernel":
                name, arr = "weight", (arr.T if arr.ndim == 2 else arr)
            out[prefix + ".".join(path + [name])] = torch.from_numpy(np.array(arr, copy=True))

    for collection in ("params", "stats"):
        walk(variables.get(collection, {}), [])
    return out


def policy_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``ActorCriticPolicy`` variables -> ``imitation_tpu_torch`` policy state_dict."""
    return flax_to_state_dict(variables, prefix="net.")


def reward_net_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Reward-net variables -> ``imitation_tpu_torch`` reward-net state_dict.

    ``BasicRewardNet`` keys are ``mlp.*`` and ``input_norm.*``; a shaped net
    (``BasicShapedRewardNet``) nests them as ``base.*`` and its potential as
    ``potential.mlp.*``; a ``NormalizedRewardNet`` as ``base.*`` beside its
    output statistics ``normalizer.*``; a ``RewardEnsemble`` as
    ``members.*`` (``members.base.*`` and ``members.normalizer.*`` with
    normalized members), every tensor with the member axis first: the flax
    submodule names.
    """
    return flax_to_state_dict(variables)


def sac_actor_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``SACActor`` variables -> ``rl.sac.SACActor`` state_dict (``dense{i}``,
    ``mean``, ``log_std``)."""
    return flax_to_state_dict(variables)


def sac_critic_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``SACCritic`` variables -> ``rl.sac.SACCritic`` state_dict (the twin
    heads ``q{q}_dense{i}``, ``q{q}_out``); a target critic loads the same."""
    return flax_to_state_dict(variables)


def q_network_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``QNetwork`` variables -> ``rl.dqn.QNetwork`` state_dict (``dense{i}``,
    ``q_out``)."""
    return flax_to_state_dict(variables)


def tabular_reward_net_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """MCE IRL reward-net variables -> ``algorithms.mce_irl`` state_dict:
    ``LinearRewardNet`` (``w.weight``, no bias) or ``MLPRewardNet``
    (``dense{i}``, ``out``)."""
    return flax_to_state_dict(variables)
