"""Reward-net serialization and the reward-type registry of
imitation_tpu_torch against the JAX package.

Saved reward nets (basic, shaped, normalized, a normalized shaped net, an
ensemble) load back exactly, and their ``reward_config.json`` equals the
JAX package's for the same net; the registry has the JAX package's reward
types, each loader computes the reward its type names, exactly as the
saved net does, and refuses the checkpoints the JAX package refuses.
"""

import json

import jax
import numpy as np
import pytest
import torch

from imitation_tpu.models import networks as jax_networks
from imitation_tpu.rewards import reward_nets as jax_nets
from imitation_tpu.rewards import serialize as jax_serialize
from imitation_tpu_torch.rewards import reward_nets, serialize
from tests.test_torch_reward_wrappers import _ensemble, _inputs, _normalized, _t
from tests.torch_parity import spaces

torch.set_num_threads(1)


def _nets(kind):
    """(port net, JAX net, net_kwargs) of each saved kind."""
    jo, ja, to, ta = spaces("box")
    if kind == "basic":
        kw = {"hid_sizes": [8, 8], "normalize_input": True}
        return (reward_nets.BasicRewardNet(to, ta, **kw),
                jax_nets.BasicRewardNet(observation_space=jo, action_space=ja, **kw), kw)
    if kind == "shaped":
        kw = {"reward_hid_sizes": [8], "potential_hid_sizes": [8, 8]}
        return (reward_nets.BasicShapedRewardNet(to, ta, **kw),
                jax_nets.BasicShapedRewardNet(jo, ja, **kw), kw)
    if kind == "normalized":
        jnet, net = _normalized("box", "ema")
        return net, jnet, {}
    if kind == "normalized_shaped":
        kw = {"reward_hid_sizes": [8]}
        net = reward_nets.NormalizedRewardNet(reward_nets.BasicShapedRewardNet(to, ta, **kw))
        jnet = jax_nets.NormalizedRewardNet(observation_space=jo, action_space=ja,
                                            base=jax_nets.BasicShapedRewardNet(jo, ja, **kw),
                                            normalize_cls=jax_networks.RunningNorm)
        return net, jnet, kw
    jnet, net = _ensemble("box", "running")
    return net, jnet, {}


@pytest.mark.parametrize("kind", ["basic", "shaped", "normalized", "normalized_shaped", "ensemble"])
def test_save_and_load_reward_net(tmp_path, kind):
    net, jnet, kw = _nets(kind)
    net.init(torch.Generator().manual_seed(0))
    x = _t(_inputs("box", 6, 0))
    with torch.no_grad():
        if hasattr(net, "predict_processed"):
            net.predict_processed(*x, update_stats=True)  # non-trivial statistics
    serialize.save_reward_net(str(tmp_path / "port"), net, net_kwargs=kw)
    jax_serialize.save_reward_net(str(tmp_path / "jax"), jnet, jnet.init_variables(jax.random.key(0)),
                                  net_kwargs=kw)
    with open(tmp_path / "port" / serialize.REWARD_CONFIG) as f:
        got = json.load(f)
    with open(tmp_path / "jax" / jax_serialize.REWARD_CONFIG) as f:
        want = json.load(f)
    assert got == want
    loaded = serialize.load_reward_net(str(tmp_path / "port"), device="cpu")
    assert type(loaded) is type(net)
    for k, v in net.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    torch.testing.assert_close(loaded(*x), net(*x), rtol=0, atol=0)


def _saved(tmp_path, kind):
    net, _, kw = _nets(kind)
    net.init(torch.Generator().manual_seed(1))
    path = str(tmp_path / kind)
    serialize.save_reward_net(path, net, net_kwargs=kw)
    return net, path


@pytest.mark.parametrize("reward_type,kind", [
    ("RewardNet_shaped", "shaped"), ("RewardNet_unshaped", "shaped"),
    ("RewardNet_shaped", "normalized_shaped"), ("RewardNet_unshaped", "normalized_shaped"),
    ("RewardNet_normalized", "normalized"), ("RewardNet_unnormalized", "normalized"),
    ("RewardNet_unnormalized", "basic"), ("RewardNet_std_added", "ensemble"),
])
def test_reward_registry_loaders(tmp_path, reward_type, kind):
    net, path = _saved(tmp_path, kind)
    x = _inputs("box", 7, 3)
    tx = _t(x)
    inner = net.base if kind.startswith("normalized") else net
    with torch.no_grad():
        want = {
            "RewardNet_shaped": lambda: inner(*tx),
            "RewardNet_unshaped": lambda: inner.base_forward(*tx),
            "RewardNet_normalized": lambda: net.predict_processed(*tx, update_stats=False),
            "RewardNet_unnormalized": lambda: inner(*tx),
            "RewardNet_std_added": lambda: (lambda mv: mv[0] + 0.5 * torch.sqrt(mv[1]))(
                net.predict_reward_moments(*tx)),
        }[reward_type]().numpy()
    kwargs = {"alpha": 0.5} if reward_type == "RewardNet_std_added" else {}
    fn = serialize.load_reward(reward_type, path, device="cpu", **kwargs)
    got = fn(*x)
    assert isinstance(got, np.ndarray) and got.shape == (7,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("reward_type,kind,error", [
    ("RewardNet_shaped", "basic", "ShapedRewardNet"),
    ("RewardNet_unshaped", "normalized", "ShapedRewardNet"),
    ("RewardNet_normalized", "basic", "NormalizedRewardNet"),
    ("RewardNet_std_added", "basic", "RewardEnsemble"),
])
def test_reward_registry_checks_the_wrappers(tmp_path, reward_type, kind, error):
    _, path = _saved(tmp_path, kind)
    with pytest.raises(TypeError, match=error):
        serialize.load_reward(reward_type, path, device="cpu")
    with pytest.raises(TypeError, match=error):
        jax_net = _nets(kind)[1]
        jpath = str(tmp_path / ("jax_" + kind))
        jax_serialize.save_reward_net(jpath, jax_net, jax_net.init_variables(jax.random.key(0)),
                                      net_kwargs=_nets(kind)[2])
        jax_serialize.load_reward(reward_type, jpath)


def test_reward_registry_types_and_zero(tmp_path):
    assert serialize.reward_registry.keys() == jax_serialize.reward_registry.keys()
    fn = serialize.load_reward("zero", "")
    out = fn(*_inputs("box", 5, 0))
    np.testing.assert_array_equal(out, jax_serialize.load_reward("zero", "")(*_inputs("box", 5, 0)))
    assert out.dtype == np.float32
    with pytest.raises(KeyError):
        serialize.load_reward("nope", "")
    apply, net = serialize.load_reward_apply("zero", "")
    assert net is None and apply(None, torch.zeros(3, 2), None, None, None).shape == (3,)
    with pytest.raises(ValueError, match="unknown reward type"):
        serialize.load_reward_apply("nope", _saved(tmp_path, "basic")[1], device="cpu")
