"""Carries weights from the JAX package's flax variables into the port.

The flax variables are given as nested dicts of numpy arrays
(``{"params": {...}, "stats": {...}}``, e.g. ``jax.device_get`` of what
``init`` returns, or a msgpack restore). Layer names are kept, so a flax path
``params/pi0/kernel`` becomes the torch key ``net.pi0.weight``. A flax
``Dense.kernel`` is ``[in, out]`` and a torch ``Linear.weight`` is
``[out, in]``, so kernels are transposed. ``RunningNorm`` statistics
(``stats/<layer>/{running_mean, running_var, count}``) become the module's
buffers of the same names.
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
                name, arr = "weight", arr.T
            out[prefix + ".".join(path + [name])] = torch.from_numpy(np.array(arr, copy=True))

    for collection in ("params", "stats"):
        walk(variables.get(collection, {}), [])
    return out


def policy_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``ActorCriticPolicy`` variables -> ``imitation_tpu_torch`` policy state_dict."""
    return flax_to_state_dict(variables, prefix="net.")


def reward_net_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``BasicRewardNet`` variables -> ``imitation_tpu_torch`` reward-net state_dict."""
    return flax_to_state_dict(variables)
