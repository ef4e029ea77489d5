"""Dict observations and the host data types of imitation_tpu_torch against
the JAX package, on the same seeded numpy inputs.

``DictObs`` (indexing, iteration, ``stack``, ``concatenate``, ``__eq__``),
trajectories' equality and slicing, transitions' indexing,
``dataclass_quick_asdict``, ``transitions_collate_fn``,
``flatten_trajectories`` over ``DictObs``, ``TransitionBatch.from_host``
and ``TrajectoryBatch.from_host`` / ``mask`` / ``flatten`` equal the JAX
package's exactly; the dict branch of ``ActorCriticNet`` (sorted keys
flattened and concatenated before ``feat_norm``) matches the JAX net within
1e-6; ``DictSpace`` and the ``util/util.py`` helpers behave as the JAX
package's.
"""

import os
import pathlib

import jax
import numpy as np
import pytest
import torch

from imitation_tpu.data import rollout as jax_rollout
from imitation_tpu.data import types as jax_types
from imitation_tpu.envs import base as jax_envs
from imitation_tpu.models.policies import ActorCriticPolicy as JaxPolicy
from imitation_tpu.util import util as jax_util
from imitation_tpu_torch import convert
from imitation_tpu_torch.data import rollout, types
from imitation_tpu_torch.envs import base as envs
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.util import util
from tests.torch_parity import host

torch.set_num_threads(1)


def _dict_obs(rng, n):
    return {"pos": rng.normal(size=(n, 3)).astype(np.float32),
            "img": rng.integers(0, 255, (n, 2, 2)).astype(np.uint8),
            "vel": rng.normal(size=(n, 2)).astype(np.float64)}


def _trajs(mod, dict_obs, seed=0, lengths=(4, 7, 1, 5), terminal=(True, False, True, False), rews=True):
    rng = np.random.default_rng(seed)
    out = []
    for length, term in zip(lengths, terminal):
        obs = _dict_obs(rng, length + 1) if dict_obs else rng.normal(size=(length + 1, 3)).astype(np.float32)
        kw = dict(obs=mod.DictObs(obs) if dict_obs else obs, acts=rng.integers(0, 3, length),
                  infos=np.array([{"t": i} for i in range(length)]), terminal=term)
        out.append(mod.TrajectoryWithRew(rews=rng.normal(size=length), **kw) if rews else mod.Trajectory(**kw))
    return out


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_equal_tree(got, want):
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            assert_equal_tree(got[k], want[k])
        return
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def test_dictobs_matches_jax():
    d = _dict_obs(np.random.default_rng(0), 6)
    obs, jobs = types.DictObs(d), jax_types.DictObs(d)
    assert len(obs) == len(jobs) == 6 and obs.shape == jobs.shape and obs.dtype == jobs.dtype
    for idx in (2, -1, slice(1, 4), np.array([0, 5, 3]), np.arange(6) % 2 == 0):
        assert_equal_tree(obs[idx].unwrap, jobs[idx].unwrap)
    assert [o.unwrap.keys() for o in obs] == [o.unwrap.keys() for o in jobs]
    stacked = types.DictObs.stack([obs[i] for i in range(6)])
    assert stacked == obs and stacked != obs[:5] and obs != d
    assert_equal_tree(stacked.unwrap, jax_types.DictObs.stack([jobs[i] for i in range(6)]).unwrap)
    cat = types.DictObs.concatenate([obs[:2], obs[2:]])
    assert cat == obs
    assert_equal_tree(types.concatenate_maybe_dictobs([obs[:1], obs[1:]]).unwrap,
                      jax_types.concatenate_maybe_dictobs([jobs[:1], jobs[1:]]).unwrap)
    assert_equal_tree(obs.map_arrays(lambda a: a[::-1]).unwrap, jobs.map_arrays(lambda a: a[::-1]).unwrap)
    assert types.maybe_unwrap_dictobs(types.maybe_wrap_in_dictobs(d)).keys() == d.keys()
    with pytest.raises(RuntimeError, match="conflicting lengths"):
        len(types.DictObs({"a": np.zeros(2), "b": np.zeros(3)}))
    with pytest.raises(ValueError, match="keys must match"):
        types.DictObs.stack([obs[0], types.DictObs({"pos": np.zeros(3)})])
    with pytest.raises(ValueError):
        types.assert_not_dictobs(obs)


@pytest.mark.parametrize("dict_obs", [False, True])
def test_trajectory_eq_and_slicing_match_jax(dict_obs):
    t, jt = _trajs(types, dict_obs)[1], _trajs(jax_types, dict_obs)[1]
    assert t == _trajs(types, dict_obs)[1] and t != _trajs(types, dict_obs, seed=1)[1]
    assert t != _trajs(types, dict_obs, rews=False)[1]
    for key in (slice(0, 3), slice(2, None), slice(None, None)):
        got, want = t[key], jt[key]
        assert len(got) == len(want) and got.terminal == want.terminal
        assert_equal_tree(types.maybe_unwrap_dictobs(got.obs), jax_types.maybe_unwrap_dictobs(want.obs))
        assert_equal_tree(got.acts, want.acts)
        assert_equal_tree(got.rews, want.rews)
        assert list(got.infos) == list(want.infos)
    step, jstep = t[2], jt[2]
    assert step.keys() == jstep.keys() and step["infos"] == jstep["infos"]
    with pytest.raises(ValueError, match="step 1"):
        t[::2]
    with pytest.raises(ValueError, match="one more observation"):
        types.Trajectory(obs=t.obs[:3], acts=t.acts, infos=None, terminal=False)


@pytest.mark.parametrize("dict_obs", [False, True])
def test_flatten_trajectories_and_indexing_match_jax(dict_obs):
    got = rollout.flatten_trajectories_with_rew(_trajs(types, dict_obs))
    want = jax_rollout.flatten_trajectories_with_rew(_trajs(jax_types, dict_obs))
    assert type(got.obs) is (types.DictObs if dict_obs else np.ndarray)
    for name, value in types.dataclass_quick_asdict(got).items():
        if name == "infos":
            assert list(value) == list(want.infos)
        else:
            assert_equal_tree(types.maybe_unwrap_dictobs(value),
                              jax_types.maybe_unwrap_dictobs(getattr(want, name)))
    assert list(types.dataclass_quick_asdict(got)) == list(jax_types.dataclass_quick_asdict(want))
    for key in (slice(3, 9), np.array([0, 4, 2]), [1, 2]):
        sub, jsub = got[key], want[key]
        assert type(sub) is types.TransitionsWithRew and len(sub) == len(jsub)
        assert_equal_tree(types.maybe_unwrap_dictobs(sub.obs), jax_types.maybe_unwrap_dictobs(jsub.obs))
        assert_equal_tree(sub.dones, jsub.dones)
    item, jitem = got[5], want[5]
    assert_equal_tree(item["obs"], jitem["obs"])
    assert_equal_tree(item["acts"], jitem["acts"])
    assert item["infos"] == jitem["infos"]
    if dict_obs:
        assert isinstance(item["next_obs"], dict)  # unwrapped too, so a collate can stack it


@pytest.mark.parametrize("dict_obs", [False, True])
def test_transitions_collate_fn_matches_jax(dict_obs):
    got = rollout.flatten_trajectories(_trajs(types, dict_obs))
    want = jax_rollout.flatten_trajectories(_trajs(jax_types, dict_obs))
    minimal = types.TransitionsMinimal(obs=types.maybe_unwrap_dictobs(got.obs), acts=got.acts, infos=got.infos)
    jminimal = jax_types.TransitionsMinimal(obs=jax_types.maybe_unwrap_dictobs(want.obs), acts=want.acts,
                                            infos=want.infos)
    rows = [3, 0, 7, 7, 15]
    batch = types.transitions_collate_fn([minimal[i] for i in rows])
    jbatch = jax_types.transitions_collate_fn([jminimal[i] for i in rows])
    assert batch.keys() == jbatch.keys() and batch["infos"] == jbatch["infos"]
    assert_equal_tree(batch["obs"], jbatch["obs"])
    assert_equal_tree(batch["acts"], jbatch["acts"])
    full = types.transitions_collate_fn([got[i] for i in rows])  # with next_obs
    assert_equal_tree(full["next_obs"], types.maybe_unwrap_dictobs(got.next_obs[np.array(rows)]))


@pytest.mark.parametrize("dict_obs", [False, True])
def test_transition_batch_from_host_matches_jax(dict_obs):
    got = types.TransitionBatch.from_host(rollout.flatten_trajectories_with_rew(_trajs(types, dict_obs)))
    want = jax_types.TransitionBatch.from_host(
        jax_rollout.flatten_trajectories_with_rew(_trajs(jax_types, dict_obs)))
    for name in ("obs", "acts", "next_obs", "dones", "rews"):
        assert_equal_tree(getattr(got, name), getattr(want, name))
    taken = got.take(torch.tensor([2, 0]))
    assert_equal_tree(taken.obs, jax.tree.map(lambda x: x[np.array([2, 0])], want.obs))
    assert_equal_tree(got.to("cpu").next_obs, want.next_obs)


@pytest.mark.parametrize("dict_obs", [False, True])
@pytest.mark.parametrize("max_length", [None, 9])
@pytest.mark.parametrize("rews", [True, False])
def test_trajectory_batch_matches_jax(dict_obs, max_length, rews):
    got = types.TrajectoryBatch.from_host(_trajs(types, dict_obs, rews=rews), max_length=max_length, device="cpu")
    want = jax_types.TrajectoryBatch.from_host(_trajs(jax_types, dict_obs, rews=rews), max_length=max_length)
    for name in ("obs", "acts", "rews", "lengths", "terminal"):
        assert_equal_tree(getattr(got, name), getattr(want, name))
    assert got.max_length == want.max_length and got.batch_size == want.batch_size
    assert_equal_tree(got.mask, want.mask)
    flat, jflat = got.flatten(), want.flatten()
    for name in ("obs", "acts", "next_obs", "dones", "rews"):
        assert_equal_tree(getattr(flat, name), getattr(jflat, name))
    # the flattened batch is the host flatten's, with float32 rewards and dones
    host = types.TransitionBatch.from_host(rollout.flatten_trajectories(_trajs(types, dict_obs, rews=rews)))
    assert_equal_tree(flat.obs, host.obs)
    assert_equal_tree(flat.dones, host.dones)
    with pytest.raises(ValueError, match="longer than max_length"):
        types.TrajectoryBatch.from_host(_trajs(types, dict_obs), max_length=3, device="cpu")


def test_dict_space_matches_jax():
    spaces = {"a": envs.Space.box(-1, 1, (3,)), "b": envs.Space.discrete(4), "c": envs.Space.box(0, 1, (2, 2))}
    jspaces = {"a": jax_envs.Space.box(-1, 1, (3,)), "b": jax_envs.Space.discrete(4),
               "c": jax_envs.Space.box(0, 1, (2, 2))}
    ds, jds = envs.DictSpace(spaces=spaces), jax_envs.DictSpace(spaces=jspaces)
    assert ds.flat_dim == jds.flat_dim == 11
    assert ds.shape == jds.shape and list(ds.keys()) == list(jds.keys())
    assert not ds.is_discrete and ds["b"].n == 4


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("discrete", [False, True])
def test_actor_critic_dict_branch_matches_jax(normalize, discrete):
    """Sorted keys, each flattened, concatenated, then ``feat_norm``: the
    JAX net's weights carried over unchanged give its outputs (1e-6)."""
    box = dict(low=-5.0, high=5.0)
    jobs = jax_envs.DictSpace(spaces={"vel": jax_envs.Space.box(shape=(2,), **box),
                                      "img": jax_envs.Space.box(shape=(2, 2), **box),
                                      "pos": jax_envs.Space.box(shape=(3,), **box)})
    tobs = envs.DictSpace(spaces={"vel": envs.Space.box(shape=(2,), **box),
                                  "img": envs.Space.box(shape=(2, 2), **box),
                                  "pos": envs.Space.box(shape=(3,), **box)})
    jact = jax_envs.Space.discrete(3) if discrete else jax_envs.Space.box(-1.0, 1.0, (2,))
    tact = envs.Space.discrete(3) if discrete else envs.Space.box(-1.0, 1.0, (2,))
    jpolicy = JaxPolicy(jobs, jact, normalize_features=normalize)
    jvars = host(jpolicy.init(jax.random.key(1)))
    rng = np.random.default_rng(0)
    obs = {"vel": rng.normal(size=(32, 2)).astype(np.float32), "img": rng.normal(size=(32, 2, 2)).astype(np.float32),
           "pos": rng.normal(loc=2.0, size=(32, 3)).astype(np.float32)}
    if normalize:  # statistics from one update pass, in both packages
        (_, _), mutated = jpolicy.net.apply(jvars, obs, update_stats=True, mutable=["stats"])
        jvars = dict(jvars, stats=host(mutated["stats"]))
    policy = ActorCriticPolicy(tobs, tact, normalize_features=normalize)
    assert policy.net.pi0.in_features == 9
    policy.load_state_dict(convert.policy_state_dict(jvars))
    tobs_t = {k: torch.from_numpy(v) for k, v in obs.items()}
    jdist, jval = jpolicy.dist_and_value(jvars, obs)
    with torch.no_grad():
        dist, val = policy.dist_and_value(tobs_t)
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), **tol)
    if discrete:
        np.testing.assert_allclose(dist.logits.numpy(), np.asarray(jdist.logits), **tol)
    else:
        np.testing.assert_allclose(dist.mean.numpy(), np.asarray(jdist.mean), **tol)
    acts = policy.predict(obs, deterministic=True)
    jacts = jpolicy.predict(jvars, obs, deterministic=True)
    np.testing.assert_allclose(acts, jacts, **tol)
    if normalize:
        fresh = ActorCriticPolicy(tobs, tact, normalize_features=True)
        fresh.load_state_dict(convert.policy_state_dict(host(jpolicy.init(jax.random.key(1)))))
        fresh.net.update_feature_stats(tobs_t)
        np.testing.assert_allclose(fresh.net.feat_norm.running_mean.numpy(),
                                   jvars["stats"]["feat_norm"]["running_mean"], **tol)


def test_util_helpers_match_jax(tmp_path):
    assert util.make_seeds(np.random.default_rng(3), 5) == jax_util.make_seeds(np.random.default_rng(3), 5)
    assert util.make_seeds(np.random.default_rng(3)) == jax_util.make_seeds(np.random.default_rng(3))
    for x in (0, 1, 7, 10):
        assert util.split_in_half(x) == jax_util.split_in_half(x)
    for args in (("a/b",), (b"a/b",), ("/abs",), ("rel", True, tmp_path)):
        assert util.parse_path(*args) == jax_util.parse_path(*args)
    with pytest.raises(ValueError, match="not absolute"):
        util.parse_path("rel", allow_relative=False)
    with pytest.raises(ValueError, match="base_directory"):
        util.parse_path("rel", allow_relative=False, base_directory=tmp_path)
    assert util.parse_optional_path(None) is None
    assert util.parse_optional_path("x", base_directory=pathlib.Path("/b")) == pathlib.Path("/b/x")
    it = util.endless_iter([1, 2])
    assert [next(it) for _ in range(5)] == [1, 2, 1, 2, 1]
    with pytest.raises(ValueError):
        util.endless_iter([])
    first, rest = util.get_first_iter_element(iter([4, 5]))
    assert first == 4 and list(rest) == [4, 5]
    first, rest = util.get_first_iter_element([6, 7])
    assert first == 6 and rest == [6, 7]
    with pytest.raises(ValueError):
        util.get_first_iter_element([])
    stamp = util.make_unique_timestamp()
    assert len(stamp) == len(jax_util.make_unique_timestamp()) and stamp != util.make_unique_timestamp()
    assert util.safe_to_numpy(None) is None
    np.testing.assert_array_equal(util.safe_to_numpy(torch.arange(3)), np.arange(3))
    with pytest.warns(UserWarning, match="host"):
        util.safe_to_numpy(torch.ones(2), warn=True)
    assert util.safe_to_numpy([1.5, 2.0]).dtype == np.float64
    assert os.path.isabs(util.parse_path("x"))
