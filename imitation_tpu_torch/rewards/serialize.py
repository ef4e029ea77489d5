"""Reward-net save/load and the reward-type registry.

Port of ``imitation_tpu/rewards/serialize.py``. A saved reward net is a
directory holding ``reward_config.json``, with the JAX package's schema
(``net_class``, ``net_kwargs``, a wrapped net's ``base``, the spaces), and
``reward_net.pt``, a ``torch.save`` of the module's ``state_dict`` with
tensors on the CPU. ``load_reward_net`` also reads a directory the JAX
package wrote (``reward_config.json`` and ``variables.msgpack``, read by
``util.flax_msgpack`` and carried over by ``convert``).

The registry maps a reward type to a loader that returns a ``RewardFn``
(numpy in and out) for a checkpoint, checking that the checkpoint's wrappers
suit the type:

* ``RewardNet_shaped``: the forward of a shaped net, shaping included;
* ``RewardNet_unshaped``: its base forward, shaping stripped;
* ``RewardNet_normalized``: ``predict_processed`` of a
  ``NormalizedRewardNet`` with its statistics frozen;
* ``RewardNet_unnormalized``: the forward under any output normalizers;
* ``RewardNet_std_added``: an ensemble's mean + alpha * std;
* ``zero``: zeros.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from imitation_tpu_torch import Device, convert, default_device
from imitation_tpu_torch.models import networks
from imitation_tpu_torch.policies.serialize import _space_from_json, _space_to_json
from imitation_tpu_torch.rewards import reward_nets
from imitation_tpu_torch.rewards.reward_function import RewardFn
from imitation_tpu_torch.util import flax_msgpack, registry

REWARD_CONFIG = "reward_config.json"
REWARD_WEIGHTS = "reward_net.pt"
REWARD_VARS = "variables.msgpack"  # the JAX package's weights

_NET_CLASSES: Dict[str, Callable[..., reward_nets.RewardNet]] = {
    "BasicRewardNet": reward_nets.BasicRewardNet,
    "BasicShapedRewardNet": reward_nets.BasicShapedRewardNet,
    "CnnRewardNet": reward_nets.CnnRewardNet,
    "RewardEnsemble": reward_nets.RewardEnsemble,
}

# (reward net, obs, acts, next_obs, dones) -> rewards, on the net's device.
RewardApply = Callable[[Any, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _net_config(net: reward_nets.RewardNet, net_kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Class name and kwargs of one (possibly wrapped) net, recursively."""
    net_kwargs = dict(net_kwargs)
    if isinstance(net, reward_nets.NormalizedRewardNet):
        return {
            "net_class": "NormalizedRewardNet",
            "net_kwargs": {"normalize_cls": net.normalize_cls.__name__},
            "base": _net_config(net.base, net_kwargs),
        }
    cls_name = type(net).__name__
    if isinstance(net, reward_nets.ShapedRewardNet):
        cls_name = "BasicShapedRewardNet"
    elif isinstance(net, reward_nets.RewardEnsemble):
        net_kwargs.setdefault("num_members", net.num_members)
        net_kwargs.setdefault("member_cls", net.member_cls.__name__)
        if net.member_normalize_cls is not None:
            net_kwargs.setdefault("member_normalize_cls", net.member_normalize_cls.__name__)
    return {"net_class": cls_name, "net_kwargs": net_kwargs}


def save_reward_net(path: str, net: reward_nets.RewardNet, *, net_kwargs: Optional[Dict[str, Any]] = None) -> None:
    """Saves the net's class, spaces and ``net_kwargs`` (the constructor
    arguments ``load_reward_net`` rebuilds it with) and its weights and
    statistics to the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    config = {
        **_net_config(net, dict(net_kwargs or {})),
        "observation_space": _space_to_json(net.observation_space),
        "action_space": _space_to_json(net.action_space),
    }
    with open(os.path.join(path, REWARD_CONFIG), "w") as f:
        json.dump(config, f, indent=2)
    state = {k: v.detach().cpu() for k, v in net.state_dict().items()}
    torch.save(state, os.path.join(path, REWARD_WEIGHTS))


def _build_net(config: Dict[str, Any], obs_space, act_space) -> reward_nets.RewardNet:
    cls_name = config["net_class"]
    kwargs = dict(config.get("net_kwargs", {}))
    if cls_name == "NormalizedRewardNet":
        base = _build_net(config["base"], obs_space, act_space)
        normalize_cls = getattr(networks, kwargs.pop("normalize_cls", "RunningNorm"))
        return reward_nets.NormalizedRewardNet(base, normalize_cls, **kwargs)
    if cls_name not in _NET_CLASSES:
        raise ValueError(f"unknown reward net class {cls_name!r}")
    if cls_name == "RewardEnsemble":
        kwargs["member_cls"] = _NET_CLASSES[kwargs.pop("member_cls", "BasicRewardNet")]
        norm_name = kwargs.pop("member_normalize_cls", None)
        kwargs["member_normalize_cls"] = None if norm_name is None else getattr(networks, norm_name)
    return _NET_CLASSES[cls_name](obs_space, act_space, **kwargs)


def load_reward_net(path: str, device: Optional[Device] = None) -> reward_nets.RewardNet:
    """The net ``save_reward_net`` wrote, or one the JAX package saved
    (``variables.msgpack`` and no ``reward_net.pt``), on ``device`` (CUDA
    unless the caller says ``"cpu"``). Every weight must be present."""
    dev = default_device(device)
    with open(os.path.join(path, REWARD_CONFIG)) as f:
        config = json.load(f)
    net = _build_net(
        config, _space_from_json(config["observation_space"]), _space_from_json(config["action_space"])
    )
    weights = os.path.join(path, REWARD_WEIGHTS)
    if os.path.exists(weights):
        state = torch.load(weights, map_location="cpu", weights_only=True)
    elif os.path.exists(os.path.join(path, REWARD_VARS)):
        state = convert.reward_net_state_dict(flax_msgpack.read_msgpack(os.path.join(path, REWARD_VARS)))
    else:
        raise FileNotFoundError(f"neither {REWARD_WEIGHTS} nor {REWARD_VARS} in {path!r}")
    net.load_state_dict(state)
    return net.to(dev)


def _validate_wrapper_structure(net, required: type, reward_type: str) -> None:
    if not isinstance(net, required):
        raise TypeError(
            f"Reward type {reward_type!r} requires a {required.__name__} "
            f"checkpoint, got {type(net).__name__}",
        )


def _unwrap_normalized(net):
    """The net under any outer ``NormalizedRewardNet``s (which sit
    outermost), and how many were stripped."""
    depth = 0
    while isinstance(net, reward_nets.NormalizedRewardNet):
        net = net.base
        depth += 1
    return net, depth


def _inner(net, depth: int):
    for _ in range(depth):
        net = net.base
    return net


def load_reward_apply(
    reward_type: str, path: str, alpha: float = 0.0, device: Optional[Device] = None
) -> Tuple[RewardApply, Optional[reward_nets.RewardNet]]:
    """``(apply, net)`` for a saved reward of ``reward_type``: ``apply(net, s,
    a, ns, d)`` computes the reward on the net's device (``net`` is None for
    ``zero``), so callers can relabel on the device with it."""
    if reward_type == "zero":
        return (lambda net, s, a, ns, d: torch.zeros(s.shape[0], device=s.device)), None
    net = load_reward_net(path, device)
    inner_net, depth = _unwrap_normalized(net)
    if reward_type == "RewardNet_shaped":
        _validate_wrapper_structure(inner_net, reward_nets.ShapedRewardNet, reward_type)
        apply = lambda n, s, a, ns, d: _inner(n, depth)(s, a, ns, d)
    elif reward_type == "RewardNet_unshaped":
        _validate_wrapper_structure(inner_net, reward_nets.ShapedRewardNet, reward_type)
        apply = lambda n, s, a, ns, d: _inner(n, depth).base_forward(s, a, ns, d)
    elif reward_type == "RewardNet_normalized":
        _validate_wrapper_structure(net, reward_nets.NormalizedRewardNet, reward_type)
        apply = lambda n, s, a, ns, d: n.predict_processed(s, a, ns, d, update_stats=False)
    elif reward_type == "RewardNet_unnormalized":
        apply = lambda n, s, a, ns, d: _inner(n, depth)(s, a, ns, d)
    elif reward_type == "RewardNet_std_added":
        _validate_wrapper_structure(net, reward_nets.RewardEnsemble, reward_type)

        def apply(n, s, a, ns, d):
            mean, var = n.predict_reward_moments(s, a, ns, d)
            return mean + alpha * torch.sqrt(var)
    else:
        raise ValueError(f"unknown reward type {reward_type!r}")
    return apply, net


def _make_fn(apply: RewardApply, net: reward_nets.RewardNet) -> RewardFn:
    """A numpy-in, numpy-out ``RewardFn`` over ``apply`` on ``net``'s device."""
    device = next(iter(net.state_dict().values())).device

    @torch.no_grad()
    def fn(state, action, next_state, done):
        args = (torch.as_tensor(x, device=device) for x in (state, action, next_state, done))
        return apply(net, *args).cpu().numpy()

    return fn


def _device(venv, device: Optional[Device]):
    return venv.device if venv is not None else device


def _loader(reward_type: str):
    def load(path: str, venv=None, device: Optional[Device] = None, **kwargs) -> RewardFn:
        apply, net = load_reward_apply(reward_type, path, device=_device(venv, device))
        return _make_fn(apply, net)

    return load


def _load_std_added(path: str, venv=None, alpha: float = 0.0, device: Optional[Device] = None,
                    **kwargs) -> RewardFn:
    apply, net = load_reward_apply("RewardNet_std_added", path, alpha=alpha, device=_device(venv, device))
    return _make_fn(apply, net)


def _load_zero(path: str = "", venv=None, **kwargs) -> RewardFn:
    def fn(state, action, next_state, done):
        return np.zeros(len(state), np.float32)

    return fn


reward_registry: "registry.Registry[Callable[..., RewardFn]]" = registry.Registry()
reward_registry.register("RewardNet_std_added", value=_load_std_added)
for _type in ("RewardNet_shaped", "RewardNet_unshaped", "RewardNet_normalized", "RewardNet_unnormalized"):
    reward_registry.register(_type, value=_loader(_type))
reward_registry.register("zero", value=_load_zero)


def load_reward(reward_type: str, reward_path: str, venv=None, **kwargs) -> RewardFn:
    """The ``RewardFn`` of ``reward_type`` for the checkpoint at
    ``reward_path`` (``alpha=`` for ``RewardNet_std_added``; the net goes to
    ``venv``'s device, else to ``device=``, CUDA by default)."""
    return reward_registry.get(reward_type)(reward_path, venv=venv, **kwargs)
