"""Carries weights from the JAX package's flax variables into the port.

The flax variables are given as nested dicts of numpy arrays
(``{"params": {...}, "stats": {...}}``, e.g. ``jax.device_get`` of what
``init`` returns, or a msgpack restore). Layer names are kept, so a flax path
``params/pi0/kernel`` becomes the torch key ``net.pi0.weight``. Kernels are
re-laid by rank:

* a flax ``Dense.kernel`` ``[in, out]`` is transposed to a torch
  ``Linear.weight`` ``[out, in]``;
* a member-stacked dense kernel of an ensemble (``nn.vmap``,
  ``[M, in, out]``) is the port's member-stacked layout already (``StackedMLP``
  and the dense layers of ``reward_nets.VmapMembers``) and is kept as it is;
* a flax ``Conv.kernel`` HWIO ``[k, k, in, out]`` becomes a torch
  ``Conv2d.weight`` OIHW ``[out, in, k, k]``, and a member-stacked one
  ``[M, k, k, in, out]`` becomes ``[M, out, in, k, k]``.

The port's NatureCNN flattens in flax's (h, w, c) order, so ``cnn_fc``'s
kernel needs no permutation of its rows. ``RunningNorm`` and ``EMANorm`` statistics
(``stats/<layer>/{running_mean, running_var, count, ...}``, with a leading
member axis in an ensemble) become the module's buffers of the same names.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


# flax kernel rank -> the port's layout (rank 3, member-stacked dense, is kept).
_KERNEL_LAYOUT = {
    2: lambda a: a.T,  # [in, out] -> [out, in]
    4: lambda a: a.transpose(3, 2, 0, 1),  # HWIO -> OIHW
    5: lambda a: a.transpose(0, 4, 3, 1, 2),  # [M, k, k, in, out] -> [M, out, in, k, k]
}


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
                name, arr = "weight", _KERNEL_LAYOUT.get(arr.ndim, lambda a: a)(arr)
            out[prefix + ".".join(path + [name])] = torch.from_numpy(np.array(arr, copy=True))

    for collection in ("params", "stats"):
        walk(variables.get(collection, {}), [])
    return out


def policy_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``ActorCriticPolicy`` variables -> ``imitation_tpu_torch`` policy state_dict."""
    return flax_to_state_dict(variables, prefix="net.")


def reward_net_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Reward-net variables -> ``imitation_tpu_torch`` reward-net state_dict.

    ``BasicRewardNet`` keys are ``mlp.*`` and ``input_norm.*``, a
    ``CnnRewardNet``'s ``cnn.*``; a shaped net nests its reward as ``base.*``
    and its potential as ``potential.mlp.*`` (``potential.cnn.*`` for
    ``BasicPotentialCNN``); a ``NormalizedRewardNet`` as ``base.*`` beside its
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
