"""The repo's seals experts, loaded by imitation_tpu_torch, against the JAX
package.

``output/experts/<env>/policy`` holds what the JAX package's
``save_policy`` wrote: ``policy_config.json`` and ``variables.msgpack``
(HalfCheetah a ``sac_actor``, the other four ``actor_critic`` policies with
feature normalization). The port's ``load_policy_from_path`` reads them
with its own msgpack reader; on 1,000 demo observations of each env the
deterministic action and the log-probability of the demo actions equal the
JAX package's within 1e-5 of the largest value (float32 forward passes of
one network in two libraries). A policy the JAX package saves round-trips
the same way, and ``SavePolicyCallback`` saves every n-th call.
"""

import os

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from imitation_tpu.envs import base as jax_base
from imitation_tpu.models.policies import ActorCriticPolicy as JaxPolicy
from imitation_tpu.policies import serialize as jax_serialize
from imitation_tpu_torch.data import serialize as data_serialize
from imitation_tpu_torch.envs.base import Space
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.policies import serialize
from imitation_tpu_torch.rl.sac import SACPolicy
from tests.torch_parity import host

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERTS = os.path.join(REPO, "output", "experts")
ENVS = ["seals_ant", "seals_half_cheetah", "seals_hopper", "seals_swimmer", "seals_walker2d"]
N_OBS = 1000


def close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1.0, float(np.abs(want).max())))


def jax_log_prob(policy, variables, obs, acts):
    """log pi(a|s) of env-scaled demo actions under a JAX policy: the SAC
    actor's as ``SAC.log_prob_fn`` computes it, the actor-critic's
    distribution's."""
    if isinstance(policy, JaxPolicy):
        return policy.distribution(variables, obs).log_prob(acts)
    dist = policy.actor.apply(variables, obs)
    a = (acts - policy._act_center.reshape(-1)) / policy._act_scale.reshape(-1)
    return dist.log_prob(jax.numpy.clip(a, -1 + 1e-6, 1 - 1e-6)) - float(np.sum(np.log(policy._act_scale)))


@pytest.mark.parametrize("env", ENVS)
def test_expert_matches_jax_on_its_demos(env):
    path = os.path.join(EXPERTS, env, "policy")
    policy = serialize.load_policy_from_path(path, device="cpu")
    jpolicy, jvars = jax_serialize.load_policy_from_path(path)
    assert isinstance(policy, SACPolicy if env == "seals_half_cheetah" else ActorCriticPolicy)
    demos = data_serialize.load(os.path.join(EXPERTS, env, "rollouts"))
    obs = np.array(demos[0].obs[:N_OBS], np.float32)
    acts = np.array(demos[0].acts[:N_OBS], np.float32)
    assert obs.shape[0] == N_OBS and policy.observation_space.dtype == np.float64  # float32 obs, float64 space

    # The demo actions, and the same actions pushed to the bounds +-1, where
    # a tanh-squashed actor's log-prob is finite only through its clamp.
    edge = np.sign(acts).astype(np.float32)
    want_acts = np.asarray(jpolicy.deterministic_fn()(jvars, obs, jax.random.key(0))[0])
    want_lp = [np.asarray(jax_log_prob(jpolicy, jvars, obs, a)) for a in (acts, edge)]
    with torch.no_grad():
        got_acts = policy.deterministic_fn()(torch.from_numpy(obs))[0].numpy()
        if isinstance(policy, SACPolicy):
            got_lp = [policy.log_prob(torch.from_numpy(obs), torch.from_numpy(a)).numpy() for a in (acts, edge)]
        else:
            got_lp = [policy.distribution(torch.from_numpy(obs)).log_prob(torch.from_numpy(a)).numpy()
                      for a in (acts, edge)]
    assert got_acts.shape == want_acts.shape == (N_OBS,) + tuple(policy.action_space.shape)
    close(got_acts, want_acts)
    for got, want in zip(got_lp, want_lp):
        assert np.isfinite(want).all() and got.shape == (N_OBS,)
        close(got, want)


def test_jax_saved_actor_critic_round_trips(tmp_path):
    """An actor-critic with relu, normalized features and non-trivial
    statistics, saved by the JAX package, loads in the port with equal
    weights, statistics and outputs."""
    obs_space = jax_base.Space.box(-3.0, 3.0, (5,))
    act_space = jax_base.Space.box(-1.0, 1.0, (2,))
    jpolicy = JaxPolicy(obs_space, act_space, hid_sizes=(16, 8), normalize_features=True,
                        log_std_init=-0.5, activation=nn.relu)
    jvars = host(jpolicy.init(jax.random.key(3)))
    rng = np.random.default_rng(0)
    stats = jvars["stats"]["feat_norm"]
    jvars["stats"]["feat_norm"] = dict(stats, running_mean=rng.normal(size=5).astype(np.float32),
                                       running_var=rng.uniform(0.5, 2.0, 5).astype(np.float32),
                                       count=np.asarray(37, np.int32))
    jax_serialize.save_policy(str(tmp_path), jpolicy, jvars)
    policy = serialize.load_policy_from_path(str(tmp_path), device="cpu")
    assert policy.net.activation is torch.relu and policy.normalize_features
    np.testing.assert_array_equal(policy.net.feat_norm.running_mean.numpy(),
                                  jvars["stats"]["feat_norm"]["running_mean"])
    assert int(policy.net.feat_norm.count) == 37
    obs = rng.normal(size=(64, 5)).astype(np.float32)
    acts = rng.uniform(-1, 1, (64, 2)).astype(np.float32)
    jdist, jval = jpolicy.dist_and_value(jvars, obs)
    with torch.no_grad():
        dist, val = policy.dist_and_value(torch.from_numpy(obs))
        close(dist.log_prob(torch.from_numpy(acts)).numpy(), jdist.log_prob(acts))
    close(val.numpy(), jval)
    close(dist.mean.numpy(), jdist.mean)
    # The port saves its own format beside the JAX package's; its own wins.
    serialize.save_policy(str(tmp_path / "port"), policy)
    again = serialize.load_policy_from_path(str(tmp_path / "port"), device="cpu")
    for k, v in policy.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def test_missing_weights_are_refused(tmp_path):
    jpolicy = JaxPolicy(jax_base.Space.box(-1.0, 1.0, (3,)), jax_base.Space.discrete(2))
    jax_serialize.save_policy(str(tmp_path), jpolicy, jpolicy.init(jax.random.key(0)))
    os.remove(tmp_path / "variables.msgpack")
    with pytest.raises(FileNotFoundError, match="variables.msgpack"):
        serialize.load_policy_from_path(str(tmp_path), device="cpu")


def test_save_policy_callback(tmp_path):
    """Every ``save_interval_updates``-th call saves the policy's current
    weights under a zero-padded count, as the JAX package's callback does."""
    space = Space.box(-1.0, 1.0, (3,))
    policy = ActorCriticPolicy(space, Space.discrete(2)).init(torch.Generator().manual_seed(0))
    cb = serialize.SavePolicyCallback(str(tmp_path), policy, save_interval_updates=2)
    for _ in range(5):
        with torch.no_grad():
            policy.net.pi_out.bias.add_(1.0)
        cb(None, {})
    assert sorted(os.listdir(tmp_path)) == ["000000000002", "000000000004"]
    saved = serialize.load_policy_from_path(str(tmp_path / "000000000004"), device="cpu")
    assert torch.equal(saved.net.pi_out.bias, policy.net.pi_out.bias - 1.0)
