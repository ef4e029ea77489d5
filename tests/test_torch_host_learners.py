"""SAC, DQN and GAIL over a host vector env in imitation_tpu_torch against
the JAX package.

Both packages step their own build of the C++ engine from the same seed.
Weights are the JAX package's, carried across with ``convert``; the random
draws are the JAX package's own, fed to the port: the host collector's
(``tests.torch_parity.jax_host_noise`` / ``jax_host_explore``, from the
learner's seed) through ``distributions._standard_normal`` and
``rl.dqn._explore_draws``, and the updates' (``jax_sac_draws`` /
``jax_dqn_draws`` with ``host=True``: from ``k_proc``) through the same
helpers and ``data.buffer._uniform_indices``; GAIL's PPO permutations and
disc indices through ``_epoch_permutation`` and ``_disc_indices``.

Tolerances as in tests/test_torch_sac.py, tests/test_torch_dqn.py and
tests/test_torch_gail.py: parameters within 1e-5 of the largest update, or
4x the case's own float32 floor; metrics 1e-4. ``train_fused`` refuses a
host generator in both packages; SQIL runs over a host DQN.
"""

import shutil

import jax
import numpy as np
import pytest
import torch

import imitation_tpu_torch.algorithms.adversarial.common as torch_common
import imitation_tpu_torch.data.buffer as torch_buffer
import imitation_tpu_torch.models.distributions as torch_dist
import imitation_tpu_torch.rl.dqn as torch_dqn
import imitation_tpu_torch.rl.ppo as torch_ppo_mod
from imitation_tpu.algorithms.adversarial.gail import GAIL as JaxGAIL
from imitation_tpu.data.types import TransitionBatch as JaxBatch
from imitation_tpu.models.policies import ActorCriticPolicy as JaxPolicy
from imitation_tpu.native.cpp_env import CppVectorEnv as JaxCppVectorEnv
from imitation_tpu.rewards.reward_nets import BasicRewardNet as JaxRewardNet
from imitation_tpu.rl.dqn import DQN as JaxDQN
from imitation_tpu.rl.dqn import DQNConfig as JaxDQNConfig
from imitation_tpu.rl.ppo import PPOConfig as JaxPPOConfig
from imitation_tpu.rl.sac import SAC as JaxSAC
from imitation_tpu.rl.sac import SACConfig as JaxSACConfig
from imitation_tpu.util.logger import configure as jax_configure
from imitation_tpu_torch import convert
from imitation_tpu_torch.algorithms.adversarial.gail import GAIL
from imitation_tpu_torch.algorithms.sqil import SQIL
from imitation_tpu_torch.data.types import TransitionBatch
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.native import CppVectorEnv
from imitation_tpu_torch.rewards.reward_nets import BasicRewardNet
from imitation_tpu_torch.rl.dqn import DQN, DQNConfig
from imitation_tpu_torch.rl.ppo import PPOConfig
from imitation_tpu_torch.rl.sac import SAC, SACConfig
from imitation_tpu_torch.util.logger import configure
from tests import test_torch_dqn as dqn_case
from tests import test_torch_sac as sac_case
from tests.torch_parity import (
    assert_params_close, feed, feed_arrays, host, jax_disc_indices, jax_dqn_draws, jax_epoch_perms,
    jax_host_explore, jax_host_noise, jax_sac_draws, nudge_, param_tolerance, snapshot, update_floors,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="the engine is built with g++")

NUM_ENVS = 4


def _envs(env_name, num_envs=NUM_ENVS, seed=11):
    kw = dict(num_envs=num_envs, seed=seed, num_threads=1)
    return JaxCppVectorEnv(env_name, **kw), lambda: CppVectorEnv(env_name, device="cpu", **kw)


def test_sac_train_step_host_matches_jax(monkeypatch):
    """One host step that learns from the start."""
    cfg = dict(sac_case.SMALL, learning_starts=0, gradient_steps=2)
    jvenv, make_venv = _envs("Pendulum-v1")
    jsac = JaxSAC(jvenv, JaxSACConfig(**cfg), seed=0)
    jstate = jsac.init_state()
    jinit = sac_case._jax_params(jstate)
    jnext, jmetrics = jsac.train_step_host(jstate)
    rows = cfg["train_freq"] * NUM_ENVS
    noise, replay_idx, _, _ = jax_sac_draws(
        jstate.key, train_freq=cfg["train_freq"], num_envs=NUM_ENVS, act_dim=1,
        gradient_steps=2, batch=cfg["batch_size"], size=rows, host=True)
    noise = jax_host_noise(0, cfg["train_freq"], NUM_ENVS, 1) + noise
    runs = {}

    def run(rel):
        sac = SAC(make_venv(), SACConfig(**cfg), seed=0)
        state = sac_case._load(sac, sac.init_state(), jstate)
        init = sac_case._nudge(sac_case._params(sac), rel)
        sac_case._set(sac, init)
        draws, idx = feed_arrays(noise), feed(replay_idx)
        monkeypatch.setattr(torch_dist, "_standard_normal", draws)
        monkeypatch.setattr(torch_buffer, "_uniform_indices", idx)
        state, metrics = sac.train_step(state)
        assert draws.remaining == [] and idx.remaining == []
        runs[rel] = (sac, state, metrics)
        final = sac_case._params(sac)
        return {label: (init[label], final[label]) for label in init}

    floors = update_floors(run)
    sac, state, metrics = runs[0.0]
    assert state.timesteps == rows and state.env_state is None and sac.is_host_env
    acts = state.buffer_state.data.acts[:rows]
    np.testing.assert_allclose(acts.numpy(), np.asarray(jnext.buffer_state.data.acts[:rows]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state.buffer_state.data.obs[:rows].numpy(),
                               np.asarray(jnext.buffer_state.data.obs[:rows]), rtol=1e-5, atol=1e-5)
    sac_case._assert_matches(sac, jnext, jinit, floors)
    sac_case._assert_metrics(metrics, jmetrics)


def test_dqn_train_step_host_matches_jax(monkeypatch):
    cfg = dict(dqn_case.SMALL, learning_starts=0, gradient_steps=2, target_update_interval=16)
    jvenv, make_venv = _envs("CartPole-v1")
    jdqn = JaxDQN(jvenv, JaxDQNConfig(**cfg), total_timesteps_hint=dqn_case.HINT, seed=0)
    jstate = jdqn.init_state()
    jinit = dqn_case._jax_params(jstate)
    jnext, jmetrics = jdqn.train_step_host(jstate)
    rows = cfg["train_freq"] * NUM_ENVS
    _, replay_idx, _, _ = jax_dqn_draws(
        jstate.key, train_freq=cfg["train_freq"], num_envs=NUM_ENVS, n_actions=2, gradient_steps=2,
        batch=cfg["batch_size"], size=rows, host=True)
    explore = jax_host_explore(0, cfg["train_freq"], NUM_ENVS, 2)
    runs = {}

    def run(rel):
        dqn = DQN(make_venv(), DQNConfig(**cfg), total_timesteps_hint=dqn_case.HINT, seed=0)
        state = dqn.init_state()
        with torch.no_grad():
            dqn.q_net.load_state_dict(dqn_case._q_state_dict(jstate.variables["params"]))
            dqn.target_q_net.load_state_dict(dqn_case._q_state_dict(jstate.target_params))
            for m in (dqn.q_net, dqn.target_q_net):
                for p in m.parameters():
                    p.mul_(1 + rel)
        init = dqn_case._params(dqn)
        draws, idx = feed(explore), feed(replay_idx)
        monkeypatch.setattr(torch_dqn, "_explore_draws", draws)
        monkeypatch.setattr(torch_buffer, "_uniform_indices", idx)
        state, metrics = dqn.train_step(state)
        assert draws.remaining == [] and idx.remaining == []
        runs[rel] = (dqn, state, metrics)
        final = dqn_case._params(dqn)
        return {label: (init[label], final[label]) for label in init}

    floors = update_floors(run)
    dqn, state, metrics = runs[0.0]
    assert state.timesteps == rows and state.env_state is None
    np.testing.assert_array_equal(state.buffer_state.data.acts[:rows].numpy(),
                                  np.asarray(jnext.buffer_state.data.acts[:rows]))
    np.testing.assert_array_equal(state.buffer_state.data.obs[:rows].numpy(),
                                  np.asarray(jnext.buffer_state.data.obs[:rows]))
    dqn_case.assert_matches(dqn_case._params(dqn), dqn_case._jax_params(jnext), jinit, floors)
    dqn_case.assert_metrics(metrics, jmetrics)


@pytest.mark.parametrize("learner", ["sac", "dqn"])
def test_first_overlapped_step_matches_serialized_bitwise(learner):
    """The overlapped path's first step collects synchronously from the same
    weights, envs and generators, so it equals the serialized step; later
    steps train on chunks one update stale, and ``learn`` joins the last."""
    runs = []
    for overlap in (False, True):
        if learner == "sac":
            algo = SAC(_envs("Pendulum-v1")[1](), SACConfig(**dict(
                sac_case.SMALL, learning_starts=0, overlap_collection=overlap)), seed=0)
            modules = (algo.actor, algo.critic, algo.target_critic)
        else:
            algo = DQN(_envs("CartPole-v1")[1](), DQNConfig(**dict(
                dqn_case.SMALL, learning_starts=0, overlap_collection=overlap)), seed=0)
            modules = (algo.q_net, algo.target_q_net)
        state, metrics = algo.train_step(algo.init_state())
        assert (algo._pending_chunk is not None) == overlap
        runs.append(([{k: v.clone() for k, v in m.state_dict().items()} for m in modules], metrics))
        state = algo.learn(state, 3 * algo.config.train_freq * NUM_ENVS)
        assert algo._pending_chunk is None and state.timesteps == 4 * algo.config.train_freq * NUM_ENVS
    (sds_s, m_s), (sds_o, m_o) = runs
    for sd_s, sd_o in zip(sds_s, sds_o):
        for k in sd_s:
            assert torch.equal(sd_s[k], sd_o[k]), k
    for k in m_s:
        assert torch.equal(m_s[k], m_o[k]) or (m_s[k].isnan() and m_o[k].isnan()), k


def _pendulum_transitions(n, seed):
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, n)
    obs = np.stack([np.cos(th), np.sin(th), rng.uniform(-8, 8, n)], -1).astype(np.float32)
    arrays = dict(obs=obs, acts=rng.uniform(-2, 2, (n, 1)).astype(np.float32),
                  next_obs=np.roll(obs, 1, axis=0), dones=np.zeros(n, np.float32),
                  rews=np.zeros(n, np.float32))
    return (JaxBatch(**{k: jax.numpy.asarray(v) for k, v in arrays.items()}),
            TransitionBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


def _gail_trainers(tmp_path, T=16, Bv=8, n_demo=300, demo_batch_size=64):
    jdemo, tdemo = _pendulum_transitions(n_demo, seed=1)
    jvenv, make_venv = _envs("Pendulum-v1", num_envs=Bv)
    ppo_kw = dict(n_steps=T, n_minibatches=4, n_epochs=2, learning_rate=1e-3)
    common = dict(demo_batch_size=demo_batch_size, n_disc_updates_per_round=2,
                  allow_variable_horizon=True, seed=0)
    net_kw = dict(observation_space=jvenv.observation_space, action_space=jvenv.action_space)
    jtr = JaxGAIL(demonstrations=jdemo, venv=jvenv, gen_config=JaxPPOConfig(**ppo_kw),
                  policy=JaxPolicy(hid_sizes=(16, 16), normalize_features=True, **net_kw),
                  reward_net=JaxRewardNet(normalize_input=True, **net_kw),
                  custom_logger=jax_configure(str(tmp_path), format_strs=[]), **common)
    jreward = host(jtr.disc_state.variables)

    def port_trainer(overlap=False):
        venv = make_venv()
        tr = GAIL(demonstrations=tdemo, venv=venv,
                  gen_config=PPOConfig(**dict(ppo_kw, overlap_collection=overlap)),
                  policy=ActorCriticPolicy(venv.observation_space, venv.action_space, hid_sizes=(16, 16),
                                           normalize_features=True),
                  reward_net=BasicRewardNet(venv.observation_space, venv.action_space, normalize_input=True),
                  custom_logger=configure(format_strs=()), **common)
        tr.reward_net.load_state_dict(convert.reward_net_state_dict(jreward))
        return tr

    return jtr, port_trainer


def test_gail_round_over_host_env_matches_jax(tmp_path, monkeypatch):
    T, Bv, n_demo, B = 16, 8, 300, 64
    jtr, port_trainer = _gail_trainers(tmp_path, T, Bv, n_demo, B)
    jtr.gen_state = jtr.gen_algo.init_state()
    jgen0 = jtr.gen_state.variables
    jdisc0 = jtr.disc_state.variables["params"]
    disc_key = jtr.disc_state.key
    _, k_proc = jax.random.split(jtr.gen_state.key)  # ppo.py train_step_host
    jtr.train(T * Bv)
    noise = jax_host_noise(0, T, Bv, 1)  # PPO's collector, seeded with PPO's seed

    def port(rel):
        tr = port_trainer()
        tr.gen_state = tr.gen_algo.init_state()
        tr.policy.load_state_dict(convert.policy_state_dict(host(jgen0)))
        nudge_([tr.policy, tr.reward_net], rel)
        draws = feed_arrays(noise)
        perms = feed(jax_epoch_perms(k_proc, 2, T * Bv))
        indices = feed(jax_disc_indices(disc_key, 2, B, n_demo, T * Bv))
        monkeypatch.setattr(torch_dist, "_standard_normal", draws)
        monkeypatch.setattr(torch_ppo_mod, "_epoch_permutation", perms)
        monkeypatch.setattr(torch_common, "_disc_indices", indices)
        init = {"policy": snapshot(tr.policy), "disc": snapshot(tr.reward_net)}
        tr.train(T * Bv)
        assert draws.remaining == [] and perms.remaining == [] and indices.remaining == []
        assert tr._gen_buffer_state.size == T * Bv and tr.disc_state.step == 2
        return tr, init

    tr, _ = port(0.0)
    assert tr.gen_algo.is_host_env and tr.gen_state.env_state is None

    def port_updates(rel):
        nudged, init = port(rel)
        return {"policy": (init["policy"], snapshot(nudged.policy)),
                "disc": (init["disc"], snapshot(nudged.reward_net))}

    floors = update_floors(port_updates)
    assert_params_close(tr.policy, jtr.gen_state.variables["params"], jgen0["params"], "net.",
                        param_tolerance(floors["policy"]))
    assert_params_close(tr.reward_net, jtr.disc_state.variables["params"], jdisc0, "",
                        param_tolerance(floors["disc"]))
    jbuf = jtr._gen_buffer_state.data
    np.testing.assert_allclose(tr._gen_buffer_state.data.obs.numpy(), np.asarray(jbuf.obs),
                               rtol=1e-5, atol=1e-5)


def test_gail_overlapped_and_train_fused_refused(tmp_path):
    jtr, port_trainer = _gail_trainers(tmp_path)
    with pytest.raises(ValueError, match="device"):
        jtr.train_fused(jtr.gen_train_timesteps)
    tr = port_trainer(overlap=True)
    with pytest.raises(ValueError, match="device env"):
        tr.train_fused(tr.gen_train_timesteps)
    tr.train(3 * tr.gen_train_timesteps)
    assert tr.gen_state.timesteps == 3 * tr.gen_train_timesteps and tr.disc_state.step == 6
    assert tr.gen_algo._pending_chunk is None  # train joins the background collection
    assert all(torch.isfinite(p).all() for p in tr.policy.parameters())


def test_sqil_over_host_dqn():
    venv = CppVectorEnv("CartPole-v1", num_envs=4, seed=0, num_threads=1, device="cpu")
    _, demos = _cartpole_demos()
    sqil = SQIL(venv=venv, demonstrations=demos,
                dqn_config=DQNConfig(**dict(dqn_case.SMALL, learning_starts=16, overlap_collection=True)),
                custom_logger=configure(format_strs=()))
    assert sqil.rl.is_host_env
    sqil.train(total_timesteps=64)
    assert sqil.state.timesteps == 64 and sqil.state.buffer_state.size == 64
    assert sqil.rl._pending_chunk is None
    assert all(torch.isfinite(p).all() for p in sqil.rl.q_net.parameters())


def _cartpole_demos():
    from imitation_tpu_torch.data import rollout
    from imitation_tpu_torch.testing import experts

    venv = CppVectorEnv("CartPole-v1", num_envs=4, seed=1, num_threads=1, device="cpu",
                        max_episode_steps=50)
    demos = rollout.generate_trajectories(experts.cartpole_expert_fn, venv,
                                          rollout.make_min_episodes(4), rng=0)
    return venv, demos
