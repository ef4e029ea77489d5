"""The host rollout helpers, the reward-improvement test and the logger
additions of imitation_tpu_torch against the JAX package.

Sample-until conditions, flattening, ``discounted_sum`` and the
permutation test are host numpy code on both sides: compared exactly, or
within 1e-12 for the float64 discounted sums. ``rollout`` and
``generate_transitions`` run the port's device collector on the CPU.
"""

import numpy as np
import pytest
import torch

from imitation_tpu.data import rollout as jax_rollout
from imitation_tpu.data import types as jax_types
from imitation_tpu.testing import reward_improvement as jax_ri
from imitation_tpu_torch.data import rollout, types
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.testing import experts
from imitation_tpu_torch.testing import reward_improvement as ri
from imitation_tpu_torch.util.logger import configure

torch.set_num_threads(1)


def _trajs(mod, lengths=(3, 7, 1, 4), seed=0):
    rng = np.random.default_rng(seed)
    return [mod.TrajectoryWithRew(obs=rng.normal(size=(n + 1, 2)).astype(np.float32),
                                  acts=rng.integers(0, 3, n), rews=rng.normal(size=n),
                                  infos=None, terminal=bool(i % 2))
            for i, n in enumerate(lengths)]


@pytest.mark.parametrize("kw", [dict(min_timesteps=10), dict(min_episodes=3),
                                dict(min_timesteps=14, min_episodes=2), dict(min_timesteps=16)])
def test_sample_until_matches_jax(kw):
    trajs, jtrajs = _trajs(types), _trajs(jax_types)
    cond, jcond = rollout.make_sample_until(**kw), jax_rollout.make_sample_until(**kw)
    for k in range(len(trajs) + 1):
        assert cond(trajs[:k]) == jcond(jtrajs[:k]), k
    for n in (1, 5, 15, 16):
        assert rollout.make_min_timesteps(n)(trajs) == jax_rollout.make_min_timesteps(n)(jtrajs)


@pytest.mark.parametrize("kw,match", [(dict(), "At least one"), (dict(min_timesteps=0), "min_timesteps"),
                                      (dict(min_episodes=-1), "min_episodes")])
def test_sample_until_errors(kw, match):
    with pytest.raises(ValueError, match=match):
        rollout.make_sample_until(**kw)
    with pytest.raises(ValueError, match=match):
        jax_rollout.make_sample_until(**kw)
    with pytest.raises(ValueError):
        rollout.make_min_timesteps(0)


def test_flatten_trajectories_with_rew_matches_jax():
    got = rollout.flatten_trajectories_with_rew(_trajs(types))
    want = jax_rollout.flatten_trajectories_with_rew(_trajs(jax_types))
    assert isinstance(got, types.TransitionsWithRew) and len(got) == len(want) == 15
    for name in ("obs", "next_obs", "acts", "dones", "rews"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
        assert getattr(got, name).dtype == getattr(want, name).dtype, name
    assert list(got.infos) == list(want.infos)
    batch = types.TransitionBatch.from_host(got)
    assert batch.obs.dtype == torch.float32 and batch.acts.dtype == torch.int32
    np.testing.assert_array_equal(batch.dones.numpy(), got.dones.astype(np.float32))
    np.testing.assert_array_equal(batch.rews.numpy(), got.rews.astype(np.float32))


def test_transitions_validation():
    obs = np.zeros((3, 2), np.float32)
    with pytest.raises(ValueError, match="same number of timesteps"):
        types.Transitions(obs=obs, acts=np.zeros(2), infos=None, next_obs=obs, dones=np.zeros(3, bool))
    with pytest.raises(ValueError, match="boolean"):
        types.Transitions(obs=obs, acts=np.zeros(3), infos=None, next_obs=obs, dones=np.zeros(3))
    with pytest.raises(ValueError, match="float"):
        types.TransitionsWithRew(obs=obs, acts=np.zeros(3), infos=None, next_obs=obs,
                                 dones=np.zeros(3, bool), rews=np.zeros(3, int))


@pytest.mark.parametrize("gamma", [1.0, 0.9, 0.0])
@pytest.mark.parametrize("shape", [(6,), (6, 3)])
def test_discounted_sum_matches_jax(gamma, shape):
    arr = np.random.default_rng(1).normal(size=shape)
    np.testing.assert_allclose(rollout.discounted_sum(arr, gamma), jax_rollout.discounted_sum(arr, gamma),
                               rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        rollout.discounted_sum(np.float64(1.0), gamma)


def test_rollout_and_generate_transitions(capsys):
    venv = make_vec_env("CartPole-v1", num_envs=4, max_episode_steps=30, device="cpu")
    expert = experts.cartpole_expert_fn
    trajs = rollout.rollout(expert, venv, rollout.make_sample_until(min_episodes=5), rng=0, verbose=True)
    assert len(trajs) >= 5 and "Rollout stats" in capsys.readouterr().out
    tr = rollout.generate_transitions(expert, venv, 70, rng=0)
    assert isinstance(tr, types.TransitionsWithRew) and len(tr) == 70
    full = rollout.generate_transitions(expert, venv, 70, rng=0, truncate=False)
    assert len(full) >= 70 and len(full) % 30 == 0
    np.testing.assert_array_equal(full.obs[:70], tr.obs)


@pytest.mark.parametrize("shift", [0.0, 0.5, 3.0])
def test_reward_improvement_matches_jax(shift):
    rng = np.random.default_rng(2)
    old, new = rng.normal(size=12), rng.normal(loc=shift, size=15)
    assert ri.mean_difference_p_value(old, new, 499) == jax_ri.mean_difference_p_value(old, new, 499)
    assert ri.is_significant_reward_improvement(old, new) == jax_ri.is_significant_reward_improvement(old, new)
    assert ri.is_significant_reward_improvement(old, new) == (shift == 3.0)


def test_logger_record_mean_and_info(capsys):
    logger = configure(format_strs=())
    rows = []
    logger.default_logger.output_formats.append(type("Capture", (), {
        "write": lambda self, kvs, step: rows.append(dict(kvs)), "close": lambda self: None})())
    for v in (1.0, 2.0, 6.0):
        logger.record_mean("dagger/mean_episode_reward", v)
    logger.info("hello")
    logger.dump(step=1)
    assert rows == [{"dagger/mean_episode_reward": 3.0}]
    assert capsys.readouterr().out == "hello\n"
