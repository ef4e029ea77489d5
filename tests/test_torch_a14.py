"""Small pieces of imitation_tpu_torch against the JAX package:
``SAC1024Policy``, ``MockRewardNet``, ``make_ensemble``, ``Space.contains``,
``Env.name`` and ``discounted_sum_torch`` (the JAX package's
``discounted_sum_jax``). Outputs within 1e-5 (relative and absolute), or
exactly where they are not computed in floating point."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imitation_tpu.data.rollout import discounted_sum_jax
from imitation_tpu.envs.base import Space as JaxSpace
from imitation_tpu.envs.classic import Pendulum as JaxPendulum
from imitation_tpu.policies.base import SAC1024Policy as JaxSAC1024Policy
from imitation_tpu.testing.reward_nets import MockRewardNet as JaxMockRewardNet
from imitation_tpu.testing.reward_nets import make_ensemble as jax_make_ensemble
from imitation_tpu_torch import convert
from imitation_tpu_torch.data.rollout import discounted_sum, discounted_sum_torch
from imitation_tpu_torch.envs.base import Space
from imitation_tpu_torch.envs.classic import CartPole, Pendulum
from imitation_tpu_torch.policies.base import ActorCriticPolicy, SAC1024Policy
from imitation_tpu_torch.rewards.reward_nets import BasicRewardNet, RewardEnsemble
from imitation_tpu_torch.testing.reward_nets import MockRewardNet, make_ensemble
from tests.torch_parity import host

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def test_sac1024_policy_matches_jax():
    jo, ja = JaxSpace.box(-1.0, 1.0, (3,)), JaxSpace.box(-2.0, 2.0, (1,))
    jpol = JaxSAC1024Policy(jo, ja)
    variables = jpol.init(jax.random.key(0))
    pol = SAC1024Policy(Space.box(-1.0, 1.0, (3,)), Space.box(-2.0, 2.0, (1,)))
    assert isinstance(pol, ActorCriticPolicy) and pol.net.hid_sizes == (1024,) == tuple(jpol.hid_sizes)
    pol.load_state_dict(convert.policy_state_dict(host(variables)))
    obs = np.random.default_rng(0).normal(size=(8, 3)).astype(np.float32)
    jdist, jvalue = jpol.dist_and_value(variables, jnp.asarray(obs))
    dist, value = pol.dist_and_value(torch.from_numpy(obs))
    np.testing.assert_allclose(dist.mean.detach().numpy(), np.asarray(jdist.mean), **TOL)
    np.testing.assert_allclose(value.detach().numpy(), np.asarray(jvalue), **TOL)


def test_mock_reward_net_matches_jax():
    jo, ja = JaxSpace.box(-1, 1, (3,)), JaxSpace.discrete(2)
    jnet = JaxMockRewardNet(observation_space=jo, action_space=ja, value=2.5)
    jout = jnet.apply(jnet.init_variables(jax.random.key(0)), jnp.zeros((4, 3)), jnp.zeros(4, jnp.int32),
                      jnp.zeros((4, 3)), jnp.zeros(4))
    net = MockRewardNet(Space.box(-1, 1, (3,)), Space.discrete(2), value=2.5).init()
    out = net(torch.zeros(4, 3), torch.zeros(4, dtype=torch.int32), torch.zeros(4, 3), torch.zeros(4))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert out.dtype == torch.float32 and list(net.parameters()) == []
    np.testing.assert_array_equal(net.predict(np.zeros((2, 3)), np.zeros(2), np.zeros((2, 3)), np.zeros(2)),
                                  [2.5, 2.5])


@pytest.mark.parametrize("kwargs", [{}, {"hid_sizes": (5,), "use_next_state": True}])
def test_make_ensemble_matches_jax(kwargs):
    jo, ja = JaxSpace.box(-1, 1, (3,)), JaxSpace.discrete(2)
    jens = jax_make_ensemble(jo, ja, num_members=2, **kwargs)
    variables = jens.init_variables(jax.random.key(0))
    ens = make_ensemble(Space.box(-1, 1, (3,)), Space.discrete(2), num_members=2, **kwargs)
    assert isinstance(ens, RewardEnsemble) and ens.member_cls is BasicRewardNet and ens.num_members == 2
    ens.load_state_dict(convert.reward_net_state_dict(host(variables)))
    rng = np.random.default_rng(1)
    args = (rng.normal(size=(4, 3)).astype(np.float32), rng.integers(0, 2, 4).astype(np.int32),
            rng.normal(size=(4, 3)).astype(np.float32), np.zeros(4, np.float32))
    out = ens(*(torch.from_numpy(a) for a in args))
    assert out.shape == (2, 4)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jens.apply(variables, *map(jnp.asarray, args))),
                               **TOL)


SPACES = [
    ("discrete", dict(n=3)),
    ("box", dict(low=-1.0, high=2.0, shape=(2,))),
    ("image", dict(low=0, high=255, shape=(4, 4, 1), dtype=np.uint8)),
]
VALUES = [0, 2, 3, -1, [0, 1, 2], [[0.5, 1.0]], [[0.5, 2.0000005]], [[0.5, 2.1]], [[-1.0, 0.0]],
          np.zeros((2, 4, 4, 1)), np.full((4, 4, 1), 255), np.full((4, 4, 1), 256.0), np.zeros((3, 3, 1)),
          np.zeros((5, 3))]


@pytest.mark.parametrize("kind,kw", SPACES, ids=[k for k, _ in SPACES])
def test_space_contains_matches_jax(kind, kw):
    if kind == "discrete":
        space, jspace = Space.discrete(kw["n"]), JaxSpace.discrete(kw["n"])
    else:
        space, jspace = Space.box(**kw), JaxSpace.box(**kw)
    for value in VALUES:
        x = np.asarray(value)
        try:
            want = jspace.contains(x)
        except ValueError:  # numpy refuses to broadcast the bounds
            with pytest.raises(ValueError):
                space.contains(x)
            continue
        assert space.contains(x) == want, (kind, value)


def test_env_name_matches_jax():
    assert Pendulum().name == JaxPendulum().name == "Pendulum"
    assert CartPole().name == "CartPole"


@pytest.mark.parametrize("shape,axis", [((7,), 0), ((6, 3), 0), ((4, 9), 1), ((3, 5, 2), 1)])
@pytest.mark.parametrize("gamma", [1.0, 0.9])
def test_discounted_sum_torch_matches_jax(shape, axis, gamma):
    arr = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    got = discounted_sum_torch(torch.from_numpy(arr), gamma, axis=axis)
    want = np.asarray(discounted_sum_jax(jnp.asarray(arr), gamma, axis=axis))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if axis == 0:
        np.testing.assert_allclose(got.numpy(), discounted_sum(arr, gamma), **TOL)
