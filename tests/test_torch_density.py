"""algorithms/density.py in imitation_tpu_torch against the JAX package.

Demonstrations are made with numpy from a seed and handed to both
packages. Tolerances:
* ``gaussian_kde_logpdf``: 1e-5 (relative and absolute) against the JAX
  package's, which expands the squared distances the same way in float32;
  1e-4 against a float64 numpy formula over direct distances (the float32
  expansion cancels; sklearn's tolerance in the JAX package's test);
* the fitted datasets (scaled, stacked, padded by tiling): 1e-6; the
  rewards of each density type, stationary or not: 1e-5;
* one ``train_policy`` PPO iteration from the same weights, with the JAX
  package's draws fed in (its policy noise through
  ``distributions._standard_normal``, its epoch permutations through
  ``ppo._epoch_permutation``, every reset pinned to one Pendulum state by
  ``tests/torch_parity.py`` ``fixed_resets``): every parameter within
  ``param_tolerance`` of the largest update, as ``tests/test_torch_ppo.py``
  holds PPO.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imitation_tpu.algorithms.density as jax_density
import imitation_tpu_torch.models.distributions as torch_dist
import imitation_tpu_torch.rl.ppo as torch_ppo_mod
from imitation_tpu.data import types as jax_types
from imitation_tpu.envs import make_vec_env as jax_make_vec_env
from imitation_tpu.envs.classic import Pendulum as JaxPendulum
from imitation_tpu.rl.ppo import PPOConfig as JaxPPOConfig
from imitation_tpu.util.logger import configure as jax_configure
from imitation_tpu_torch import convert
from imitation_tpu_torch.algorithms import density
from imitation_tpu_torch.data import rollout, types
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.rl.ppo import PPOConfig
from imitation_tpu_torch.testing import experts
from imitation_tpu_torch.util.logger import configure
from tests.torch_parity import (
    feed, feed_arrays, fixed_resets, host, jax_epoch_perms, jax_rollout_noise, param_tolerance, snapshot,
    nudge_, assert_params_close, update_floors,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
TYPES = ["STATE_DENSITY", "STATE_ACTION_DENSITY", "STATE_STATE_DENSITY"]


def test_kde_matches_jax_and_float64():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(4, 50, 3)).astype(np.float32)
    x = rng.normal(size=(7, 3)).astype(np.float32)
    h = 0.7
    got = density.gaussian_kde_logpdf(torch.from_numpy(x), torch.from_numpy(data), h)
    assert got.shape == (4, 7)
    want = jax.vmap(lambda d: jax_density.gaussian_kde_logpdf(jnp.asarray(x), d, h))(jnp.asarray(data))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    one = density.gaussian_kde_logpdf(torch.from_numpy(x), torch.from_numpy(data[0]), h)
    np.testing.assert_array_equal(one.numpy(), got[0].numpy())
    x64, d64 = x.astype(np.float64), data.astype(np.float64)
    sq = ((x64[None, :, None, :] - d64[:, None, :, :]) ** 2).sum(-1)  # [4, 7, 50]
    log_k = -sq / (2 * h * h)
    m = log_k.max(-1, keepdims=True)
    exact = (m[..., 0] + np.log(np.exp(log_k - m).sum(-1)) - np.log(50) - 1.5 * np.log(2 * np.pi * h * h))
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-4, atol=1e-4)


def _demos(lengths, seed=0):
    """(jax, torch) trajectories of Pendulum's shapes with the given lengths."""
    rng = np.random.default_rng(seed)
    jtrajs, trajs = [], []
    for n in lengths:
        arrays = dict(obs=rng.normal(size=(n + 1, 3)).astype(np.float32),
                      acts=rng.uniform(-2, 2, size=(n, 1)).astype(np.float32),
                      rews=rng.normal(size=n), infos=None, terminal=False)
        jtrajs.append(jax_types.TrajectoryWithRew(**arrays))
        trajs.append(types.TrajectoryWithRew(**arrays))
    return jtrajs, trajs


def _algos(jdemos, demos, density_type, **kw):
    jvenv = jax_make_vec_env("Pendulum-v1", num_envs=4)
    venv = make_vec_env("Pendulum-v1", num_envs=4, device="cpu")
    cfg = dict(n_steps=16, n_minibatches=2, n_epochs=1)
    jalgo = jax_density.DensityAlgorithm(
        demonstrations=jdemos, venv=jvenv, density_type=jax_density.DensityType[density_type],
        rl_config=JaxPPOConfig(**cfg), custom_logger=jax_configure(format_strs=[]), **kw)
    algo = density.DensityAlgorithm(
        demonstrations=demos, venv=venv, density_type=density.DensityType[density_type],
        rl_config=PPOConfig(**cfg), custom_logger=configure(format_strs=()), **kw)
    return jalgo, algo


def _queries(seed=1, n=9):
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(n, 3)).astype(np.float32)
    return obs, rng.uniform(-2, 2, (n, 1)).astype(np.float32), rng.normal(size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("standardise", [True, False])
@pytest.mark.parametrize("stationary", [True, False])
@pytest.mark.parametrize("density_type", TYPES)
def test_rewards_match_jax(density_type, stationary, standardise):
    """Trajectories of unequal length: with non-stationary density the
    later timesteps hold fewer rows and are padded by tiling (5 rows to
    the first timesteps' 6, 4, 3...)."""
    jdemos, demos = _demos([6, 6, 4, 5, 3, 6], seed=2)
    jalgo, algo = _algos(jdemos, demos, density_type, is_stationary=stationary,
                         standardise_inputs=standardise, allow_variable_horizon=True)
    jalgo.train()
    algo.train()
    assert sorted(algo.transitions, key=str) == sorted(jalgo.transitions, key=str)
    for k, v in algo.transitions.items():
        np.testing.assert_array_equal(v, jalgo.transitions[k])
    jparams, params = jalgo._reward_params(), algo._reward_params()
    for k in ("data", "scale_mean", "scale_std"):
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-6, err_msg=k)
    assert params["data"].shape[0] == (1 if stationary else 6)
    obs, acts, next_obs = _queries()
    dones = np.zeros(len(obs))
    got = algo(obs, acts, next_obs, dones)
    np.testing.assert_allclose(got, np.asarray(jalgo(obs, acts, next_obs, dones)), **TOL)
    assert got.shape == (len(obs),) and got.dtype == np.float32


def test_tiling_pads_unequal_timesteps_as_jax():
    """A timestep with 4 rows padded to 6 repeats its first 2 rows."""
    _, demos = _demos([3, 3, 3, 3, 2, 2], seed=4)
    algo = density.DensityAlgorithm(demonstrations=demos, venv=make_vec_env("Pendulum-v1", num_envs=2, device="cpu"),
                                    is_stationary=False, standardise_inputs=False, allow_variable_horizon=True,
                                    rl_config=PPOConfig(n_steps=4, n_minibatches=2),
                                    custom_logger=configure(format_strs=()))
    algo.train()
    data = algo._reward_params()["data"]
    assert data.shape == (3, 6, 4)
    last = torch.from_numpy(algo.transitions[2])
    assert last.shape[0] == 4
    torch.testing.assert_close(data[2], torch.cat([last, last[:2]]), rtol=0, atol=0)


@pytest.mark.parametrize("density_type", TYPES)
def test_transitions_match_jax(density_type):
    jdemos, demos = _demos([5, 5, 5], seed=3)
    from imitation_tpu.data.rollout import flatten_trajectories_with_rew as jflat

    jalgo, algo = _algos(jflat(jdemos), rollout.flatten_trajectories_with_rew(demos), density_type)
    jalgo.train()
    algo.train()
    obs, acts, next_obs = _queries(seed=5)
    np.testing.assert_allclose(algo(obs, acts, next_obs, np.zeros(9)),
                               np.asarray(jalgo(obs, acts, next_obs, np.zeros(9))), **TOL)
    with pytest.raises(ValueError, match="[Nn]on-stationary"):
        _algos(jflat(jdemos), rollout.flatten_trajectories_with_rew(demos), density_type, is_stationary=False)


def test_refit_takes_effect_as_in_jax():
    """A refit on shifted demonstrations changes the rewards at the same
    point, in the port as in the JAX package, with no new PPO object."""
    jdemos, demos = _demos([8] * 4, seed=6)
    jalgo, algo = _algos(jdemos, demos, "STATE_ACTION_DENSITY", standardise_inputs=False)
    obs, acts = np.zeros((3, 3), np.float32), np.zeros((3, 1), np.float32)
    for a in (jalgo, algo):
        a.train()
    r1 = algo(obs, acts, obs, np.zeros(3))
    rl_algo = algo.rl_algo
    shifted = [(jax_types, t) for t in jdemos], [(types, t) for t in demos]
    for a, trajs in zip((jalgo, algo), shifted):
        a.set_demonstrations([mod.TrajectoryWithRew(obs=np.asarray(t.obs) + 5.0, acts=t.acts, rews=t.rews,
                                                    infos=t.infos, terminal=t.terminal) for mod, t in trajs])
        a.train()
    r2 = algo(obs, acts, obs, np.zeros(3))
    assert not np.allclose(r1, r2)
    np.testing.assert_allclose(r2, np.asarray(jalgo(obs, acts, obs, np.zeros(3))), **TOL)
    assert algo.rl_algo is rl_algo and rl_algo.reward_fn == algo._reward_relabel_fn
    with pytest.raises(ValueError, match="gaussian"):
        density.DensityAlgorithm(demonstrations=demos, venv=algo.venv, kernel="tophat")


def test_expert_scores_higher_than_noise():
    """The port's own scripted Pendulum expert: its transitions score
    higher than random ones (the JAX package's test)."""
    venv = make_vec_env("Pendulum-v1", num_envs=8, device="cpu")
    demos = experts.generate_expert_trajectories("Pendulum-v1", venv, min_episodes=8)
    algo = density.DensityAlgorithm(demonstrations=demos, venv=make_vec_env("Pendulum-v1", num_envs=4, device="cpu"),
                                    rl_config=PPOConfig(n_steps=16, n_minibatches=2, n_epochs=1),
                                    custom_logger=configure(format_strs=()))
    algo.train()
    t = demos[0]
    expert = algo(t.obs[:-1], t.acts, t.obs[1:], np.zeros(len(t)))
    noise_obs = np.random.default_rng(0).uniform(-5, 5, (len(t), 3)).astype(np.float32)
    noise_act = np.random.default_rng(1).uniform(-2, 2, (len(t), 1)).astype(np.float32)
    noise = algo(noise_obs, noise_act, noise_obs, np.zeros(len(t)))
    assert expert.mean() > noise.mean() + 1.0
    algo.train_policy(n_timesteps=64)
    stats = algo.test_policy(n_trajectories=2)
    assert stats["n_traj"] >= 2 and np.isfinite(stats["return_mean"])


def test_train_policy_iteration_matches_jax(monkeypatch):
    """One PPO iteration on the KDE reward, from the same policy weights."""
    T, B, n_epochs = 8, 4, 2
    x0 = np.array([0.4, -0.2], np.float32)
    jdemos, demos = _demos([10] * 5, seed=7)
    cfg = dict(n_steps=T, n_minibatches=2, n_epochs=n_epochs, learning_rate=1e-3, gamma=0.95)
    jvenv = jax_make_vec_env("Pendulum-v1", num_envs=B)
    venv = make_vec_env("Pendulum-v1", num_envs=B, device="cpu")
    fixed_resets(monkeypatch, JaxPendulum, venv, x0)
    jalgo = jax_density.DensityAlgorithm(demonstrations=jdemos, venv=jvenv, rl_config=JaxPPOConfig(**cfg),
                                         custom_logger=jax_configure(format_strs=[]))
    jalgo.train()
    jalgo.rl_state = jalgo.rl_algo.init_state()
    jinit = host(jalgo.rl_state.variables)
    _, k_roll, k_proc = jax.random.split(jalgo.rl_state.key, 3)
    jalgo.train_policy(T * B)

    def run(rel):
        algo = density.DensityAlgorithm(demonstrations=demos, venv=venv, rl_config=PPOConfig(**cfg),
                                        custom_logger=configure(format_strs=()))
        algo.train()
        algo.rl_state = algo.rl_algo.init_state()
        algo.policy.load_state_dict(convert.policy_state_dict(jinit))
        nudge_([algo.policy], rel)
        noise = feed_arrays(jax_rollout_noise(k_roll, T, B, 1))
        perms = feed(jax_epoch_perms(k_proc, n_epochs, T * B))
        monkeypatch.setattr(torch_dist, "_standard_normal", noise)
        monkeypatch.setattr(torch_ppo_mod, "_epoch_permutation", perms)
        init = snapshot(algo.policy)
        algo.train_policy(T * B)
        assert noise.remaining == [] and perms.remaining == []
        return {"policy": (init, snapshot(algo.policy)), "algo": algo}

    runs = {}

    def updates(rel):
        out = run(rel)
        runs[rel] = out.pop("algo")
        return out

    floors = update_floors(updates)
    algo = runs[0.0]
    assert algo.rl_state.timesteps == T * B and algo.rl_state.n_updates == 1
    assert_params_close(algo.policy, jalgo.rl_state.variables["params"], jinit["params"], "net.",
                        param_tolerance(floors["policy"]))
