"""Load Stable Baselines 3 ``model.zip`` policies into the port.

Port of ``imitation_tpu/policies/sb3_interop.py``. An SB3 zip holds the
policy's torch ``state_dict`` as ``policy.pth`` and its settings as the JSON
member ``data``; both are read with ``zipfile`` and ``torch.load`` (no SB3).
The weights go into the port's own ``ActorCriticPolicy`` under its layer
names, as they are: SB3 and the port both keep torch's ``[out, in]``
weights.

Supported, as in the JAX package: ActorCriticPolicy-family models (PPO/A2C)
with separate pi/vf MLP torsos (SB3's default ``net_arch``), the flatten
feature extractor, tanh or ReLU activations, discrete or diagonal-Gaussian
heads. Shared torsos and CNN or custom feature extractors raise
``NotImplementedError``; a zip without policy layers, or one that does not
fit the env's spaces, raises ``ValueError``, with the JAX package's
messages.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from imitation_tpu_torch import Device, default_device
from imitation_tpu_torch.envs.base import Space
from imitation_tpu_torch.models.policies import ActorCriticPolicy


def _read_sb3_zip(path: str) -> Tuple[Dict[str, torch.Tensor], dict]:
    """(state_dict on the CPU, data-JSON dict) of an SB3 model.zip."""
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        if "policy.pth" not in names:
            raise ValueError(
                f"{path!r} does not look like an SB3 model.zip "
                f"(no policy.pth; members: {names})"
            )
        with zf.open("policy.pth") as f:
            sd = torch.load(io.BytesIO(f.read()), map_location="cpu", weights_only=True)
        data = {}
        if "data" in names:
            try:
                data = json.loads(zf.read("data").decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError):
                data = {}
    return sd, data


def load_sb3_policy(
    path: str,
    observation_space: Space,
    action_space: Space,
    device: Optional[Device] = None,
) -> ActorCriticPolicy:
    """An SB3 ActorCriticPolicy ``model.zip`` as the port's
    ``ActorCriticPolicy`` on ``device`` (CUDA unless the caller says
    ``"cpu"``).

    Weight layout (SB3 -> port): ``mlp_extractor.policy_net.{2i}`` ->
    ``pi{i}``, ``mlp_extractor.value_net.{2i}`` -> ``vf{i}``,
    ``action_net`` -> ``pi_out``, ``value_net`` -> ``vf_out``, ``log_std``
    -> ``log_std``. The activation is ReLU where ``data["activation_fn"]``
    names it, else tanh (SB3's default).
    """
    sd, data = _read_sb3_zip(path)

    shared = [k for k in sd if k.startswith("mlp_extractor.shared_net")]
    if shared:
        raise NotImplementedError(
            "SB3 policies with shared pi/vf torso layers are not supported "
            f"(found {shared[:2]}...); retrain with separate net_arch"
        )
    cnn = [k for k in sd if "features_extractor" in k and "weight" in k]
    if cnn:
        raise NotImplementedError(
            "SB3 CNN/custom feature extractors are not supported "
            f"(found {cnn[:2]}...)"
        )

    hid_sizes = []
    while f"mlp_extractor.policy_net.{2 * len(hid_sizes)}.weight" in sd:
        hid_sizes.append(sd[f"mlp_extractor.policy_net.{2 * len(hid_sizes)}.weight"].shape[0])
    if not hid_sizes:
        raise ValueError(f"no mlp_extractor.policy_net layers found in {sorted(sd)}")

    activation = torch.relu if "ReLU" in str(data.get("activation_fn", "Tanh")) else torch.tanh

    in_dim = sd["mlp_extractor.policy_net.0.weight"].shape[1]
    flat_obs = int(np.prod(observation_space.shape))
    if in_dim != flat_obs:
        raise ValueError(f"SB3 policy expects {in_dim}-dim flat obs; env has {flat_obs}")
    out_dim = sd["action_net.weight"].shape[0]
    expected_out = action_space.n if action_space.is_discrete else action_space.flat_dim
    if out_dim != expected_out:
        raise ValueError(
            f"SB3 action head is {out_dim}-dim; env action space needs {expected_out}"
        )

    policy = ActorCriticPolicy(observation_space, action_space, hid_sizes=tuple(hid_sizes),
                               activation=activation)
    state = {}
    for j in range(len(hid_sizes)):
        for port_name, sb3_name in ((f"pi{j}", f"mlp_extractor.policy_net.{2 * j}"),
                                    (f"vf{j}", f"mlp_extractor.value_net.{2 * j}")):
            state[f"net.{port_name}.weight"] = sd[f"{sb3_name}.weight"]
            state[f"net.{port_name}.bias"] = sd[f"{sb3_name}.bias"]
    for port_name, sb3_name in (("pi_out", "action_net"), ("vf_out", "value_net")):
        state[f"net.{port_name}.weight"] = sd[f"{sb3_name}.weight"]
        state[f"net.{port_name}.bias"] = sd[f"{sb3_name}.bias"]
    if not action_space.is_discrete:
        if "log_std" not in sd:
            raise ValueError("continuous SB3 policy without log_std")
        state["net.log_std"] = sd["log_std"]
    policy.load_state_dict({k: v.float() for k, v in state.items()})
    return policy.to(default_device(device))


def load_sb3_policy_for_env(path: str, venv) -> ActorCriticPolicy:
    """``load_sb3_policy`` for ``venv``'s spaces, on ``venv.device``."""
    return load_sb3_policy(path, venv.observation_space, venv.action_space, device=venv.device)
