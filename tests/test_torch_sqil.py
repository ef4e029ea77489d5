"""SQIL in imitation_tpu_torch against the JAX package.

The mixed batch, and one SQIL step with each inner learner (DQN on
CartPole-v1, SAC on Pendulum-v1), start from the JAX package's weights and
take its draws, recomputed from its keys: the fresh-row indices through
``data.buffer._uniform_indices``, the expert-row indices through
``algorithms.sqil._expert_indices``, and the learners' own draws as in
tests/test_torch_dqn.py and tests/test_torch_sac.py, whose step helpers are
reused here.

Tolerances: the mixed batch exactly (a gather); parameters and metrics as
in those two files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imitation_tpu_torch.algorithms.sqil as torch_sqil
import imitation_tpu_torch.data.buffer as torch_buffer
from imitation_tpu.algorithms.sqil import SQIL as JaxSQIL
from imitation_tpu.data.types import TransitionBatch as JaxBatch
from imitation_tpu.envs import make_vec_env as jax_make_vec_env
from imitation_tpu.rl.dqn import DQNConfig as JaxDQNConfig
from imitation_tpu.rl.sac import SACConfig as JaxSACConfig
from imitation_tpu.util.logger import configure as jax_configure
from imitation_tpu_torch.algorithms.sqil import SQIL
from imitation_tpu_torch.data.types import TransitionBatch
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.rl.dqn import DQNConfig
from imitation_tpu_torch.rl.sac import SACConfig, SACPolicy
from imitation_tpu_torch.testing import experts
from imitation_tpu_torch.util.logger import configure
from tests import test_torch_dqn as dqn_case
from tests import test_torch_sac as sac_case
from tests.torch_parity import feed, update_floors

torch.set_num_threads(1)

N_DEMO = 96
DQN_KW = dict(dqn_case.SMALL, gradient_steps=2, learning_starts=0, target_update_interval=24)
SAC_KW = dict(sac_case.SMALL, gradient_steps=2, learning_starts=0)


def _demos(env_id, n, seed):
    """``n`` expert transitions shaped like ``env_id``'s, as (jax, torch) batches."""
    rng = np.random.default_rng(seed)
    if env_id == "Pendulum-v1":
        obs_dim, acts = 3, rng.uniform(-2.0, 2.0, (n, 1)).astype(np.float32)
    else:
        obs_dim, acts = 4, rng.integers(0, 2, n).astype(np.int32)
    arrays = dict(obs=rng.normal(scale=0.1, size=(n, obs_dim)).astype(np.float32), acts=acts,
                  next_obs=rng.normal(scale=0.1, size=(n, obs_dim)).astype(np.float32),
                  dones=(rng.random(n) < 0.05).astype(np.float32),
                  rews=rng.normal(size=n).astype(np.float32))
    return (JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            TransitionBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


def _trainers(tmp_path, env_id):
    jdemo, tdemo = _demos(env_id, N_DEMO, seed=1)
    n_envs = sac_case.NUM_ENVS
    kw = dict(dqn_config=JaxDQNConfig(**DQN_KW), sac_config=JaxSACConfig(**SAC_KW))
    jsqil = JaxSQIL(venv=jax_make_vec_env(env_id, num_envs=n_envs), demonstrations=jdemo,
                    custom_logger=jax_configure(str(tmp_path), format_strs=[]), **kw)

    def port():
        return SQIL(venv=make_vec_env(env_id, num_envs=n_envs, device="cpu"), demonstrations=tdemo,
                    dqn_config=DQNConfig(**DQN_KW), sac_config=SACConfig(**SAC_KW),
                    custom_logger=configure(format_strs=()))

    return jsqil, port


@pytest.mark.parametrize("batch_size", [15, 16])
def test_mixed_batch_matches_jax(tmp_path, monkeypatch, batch_size):
    """``batch_size // 2`` fresh rows relabelled 0, then expert rows
    relabelled 1, in that order; the same rows as the JAX package's for the
    same indices."""
    jsqil, port = _trainers(tmp_path, "CartPole-v1")
    sqil = port()
    jfresh, tfresh = _demos("CartPole-v1", 40, seed=2)
    jrl, rl = jsqil.rl, sqil.rl
    jbuf = jrl.replay.store(jsqil.state.buffer_state, jfresh)
    buf = rl.replay.store(sqil.state.buffer_state, tfresh)
    key = jax.random.key(9)
    jbatch = jrl.sample_hook(jrl.replay, jbuf, key, batch_size)
    k_new, k_exp = jax.random.split(key)
    half = batch_size // 2
    monkeypatch.setattr(torch_buffer, "_uniform_indices",
                        feed([jax.random.randint(k_new, (half,), 0, 40)]))
    monkeypatch.setattr(torch_sqil, "_expert_indices",
                        feed([jax.random.randint(k_exp, (batch_size - half,), 0, N_DEMO)]))
    batch = sqil.sample_hook(rl.replay, buf, torch.Generator(), batch_size)
    assert batch.batch_size == batch_size
    want_rews = np.r_[np.zeros(half), np.ones(batch_size - half)].astype(np.float32)
    np.testing.assert_array_equal(batch.rews.numpy(), want_rews)
    for k, v in batch.fields().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(getattr(jbatch, k)), err_msg=k)


def test_sqil_dqn_step_matches_jax(tmp_path, monkeypatch):
    jsqil, port = _trainers(tmp_path, "CartPole-v1")
    assert jsqil.rl_algo_name == "dqn" and port().rl_algo_name == "dqn"
    jstate = jsqil.state
    jinit = dqn_case._jax_params(jstate)
    step = jax.jit(jsqil.rl.train_step)
    j1, jm1 = step(jstate)
    j2, jm2 = step(j1)
    run, runs = dqn_case._run_port(
        monkeypatch, jsqil.rl, jstate, 2, lambda: port().rl, n_expert=N_DEMO,
        expert_setter=lambda f: monkeypatch.setattr(torch_sqil, "_expert_indices", f))
    floors = update_floors(run)
    dqn, state, metrics = runs[0.0]
    dqn_case.assert_matches(dqn_case._params(dqn), dqn_case._jax_params(j2), jinit, floors)
    dqn_case.assert_metrics(metrics[0], jm1)
    dqn_case.assert_metrics(metrics[1], jm2)


def test_sqil_sac_step_matches_jax(tmp_path, monkeypatch):
    jsqil, port = _trainers(tmp_path, "Pendulum-v1")
    assert jsqil.rl_algo_name == "sac" and port().rl_algo_name == "sac"
    jstate = jsqil.state
    jinit = sac_case._jax_params(jstate)
    jnext, jmetrics = jax.jit(jsqil.rl.train_step)(jstate)
    rows = sac_case.TRAIN_FREQ * sac_case.NUM_ENVS
    run, runs = sac_case._run_port(monkeypatch, jsqil.rl, jstate, 1, lambda: port().rl, [rows],
                                   n_expert=N_DEMO)
    floors = update_floors(run)
    sac, _, metrics = runs[0.0]
    sac_case._assert_matches(sac, jnext, jinit, floors)
    sac_case._assert_metrics(metrics[0], jmetrics)


@pytest.mark.parametrize("env_id", ["CartPole-v1", "Pendulum-v1"])
def test_sqil_train_cpu(env_id):
    """A short ``SQIL.train`` on scripted-expert demos; the policy is the
    greedy DQN's or SAC's actor."""
    demo_venv = make_vec_env(env_id, num_envs=4, device="cpu", max_episode_steps=50)
    demos = experts.generate_expert_trajectories(env_id, demo_venv, min_episodes=4, seed=0)
    venv = make_vec_env(env_id, num_envs=4, device="cpu")
    sqil = SQIL(venv=venv, demonstrations=demos, allow_variable_horizon=True,
                dqn_config=DQNConfig(**dict(DQN_KW, learning_starts=32)),
                sac_config=SACConfig(**dict(SAC_KW, learning_starts=32)),
                custom_logger=configure(format_strs=()))
    assert sqil._expert_batch.batch_size == sum(len(t) for t in demos) >= 200
    sqil.train(total_timesteps=96)
    assert sqil.state.timesteps == 96 and sqil.state.n_updates == 12
    assert sqil.policy_variables is sqil.state.variables
    obs = venv.reset(torch.Generator().manual_seed(0)).obs
    acts, _ = sqil.policy.sample_fn()(obs, torch.Generator())
    if env_id == "CartPole-v1":
        assert acts.dtype == torch.int32 and torch.equal(acts, sqil.rl.greedy_fn()(obs)[0])
        params = list(sqil.rl.q_net.parameters())
    else:
        assert isinstance(sqil.policy, SACPolicy) and acts.shape == (4, 1)
        params = list(sqil.rl.actor.parameters()) + list(sqil.rl.critic.parameters())
    assert all(torch.isfinite(p).all() for p in params)


def test_rl_algo_choice():
    _, tdemo = _demos("CartPole-v1", 16, seed=0)
    venv = make_vec_env("CartPole-v1", num_envs=2, device="cpu")
    with pytest.raises(ValueError, match="rl_algo"):
        SQIL(venv=venv, demonstrations=tdemo, rl_algo="ppo", custom_logger=configure(format_strs=()))
    with pytest.raises(ValueError, match="continuous"):
        SQIL(venv=venv, demonstrations=tdemo, rl_algo="sac", custom_logger=configure(format_strs=()))
