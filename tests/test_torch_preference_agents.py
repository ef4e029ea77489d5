"""The generators of preference comparisons in imitation_tpu_torch against
the JAX package: one ``AgentTrainer`` (PPO) and one ``SACAgentTrainer``
(PEBBLE) iteration on device Pendulum-v1, then ``sample`` with its
exploration share.

Weights are the JAX package's, carried across with ``convert``; both
packages reset every episode to one fixed Pendulum state. The device draws
are the JAX package's own, recomputed from its keys and fed to the port:
PPO's rollout is one fixed chunk given to both (as in
``tests/test_torch_airl.py``) and its epoch permutations are JAX's;
SAC's noise and replay indices come from ``jax_sac_draws``; the fold's
replay sample, the rollout of ``sample`` and the exploration mixture from
the seeds the shared numpy ``Generator`` hands both packages.

Tolerances: buffered episodes, sampled agent episodes' actions and every
mode exactly; observations and policy actions 1e-5; the output
normalizer's statistics after the fold 1e-5; learner parameters within
``tests/torch_parity.py``'s float32 floor; PPO's relabelled and true reward
means 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

import imitation_tpu_torch.data.buffer as torch_buffer
import imitation_tpu_torch.models.distributions as torch_dist
import imitation_tpu_torch.policies.exploration_wrapper as torch_explore
import imitation_tpu_torch.rl.ppo as torch_ppo_mod
from imitation_tpu.algorithms import preference_comparisons as jpc
from imitation_tpu.data import rollout as jax_rollout
from imitation_tpu.envs import make_vec_env as jax_make_vec_env
from imitation_tpu.envs.classic import Pendulum as JaxPendulum
from imitation_tpu.models import networks as jax_networks
from imitation_tpu.models.policies import ActorCriticPolicy as JaxPolicy
from imitation_tpu.rewards import reward_nets as jax_nets
from imitation_tpu.rl.ppo import PPO as JaxPPO
from imitation_tpu.rl.ppo import PPOConfig as JaxPPOConfig
from imitation_tpu.rl.sac import SAC as JaxSAC
from imitation_tpu.rl.sac import SACConfig as JaxSACConfig
from imitation_tpu.util.logger import configure as jax_configure
from imitation_tpu_torch import convert
from imitation_tpu_torch.algorithms import preference_comparisons as pc
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.models import networks
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.rewards import reward_nets
from imitation_tpu_torch.rl.ppo import PPO, PPOConfig
from imitation_tpu_torch.rl.sac import SAC, SACConfig
from imitation_tpu_torch.util.logger import configure
from tests.torch_parity import (
    assert_params_close, feed, feed_arrays, fixed_resets, host, jax_epoch_perms, jax_explore_draws,
    jax_rollout_noise, jax_sac_draws, nudge_, on_policy_aux, param_tolerance, random_chunk, snapshot,
    update_floors,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
B, HORIZON = 4, 10
X0 = np.array([0.5, -0.3], np.float32)


class _Recorder:
    """A numpy ``Generator`` that keeps what ``integers`` returned."""

    def __init__(self, rng):
        self.rng, self.ints = rng, []

    def integers(self, *args, **kwargs):
        value = self.rng.integers(*args, **kwargs)
        self.ints.append(int(value))
        return value

    def __getattr__(self, name):
        return getattr(self.rng, name)


def _venvs(monkeypatch):
    jvenv = jax_make_vec_env("Pendulum-v1", num_envs=B, max_episode_steps=HORIZON)
    venv = make_vec_env("Pendulum-v1", num_envs=B, max_episode_steps=HORIZON, device="cpu")
    fixed_resets(monkeypatch, JaxPendulum, venv, X0)
    return jvenv, venv


def _reward_nets(jvenv, venv):
    jnet = jax_nets.NormalizedRewardNet(
        observation_space=jvenv.observation_space, action_space=jvenv.action_space,
        base=jax_nets.BasicRewardNet(observation_space=jvenv.observation_space,
                                     action_space=jvenv.action_space, normalize_input=True),
        normalize_cls=jax_networks.RunningNorm)
    net = reward_nets.NormalizedRewardNet(
        reward_nets.BasicRewardNet(venv.observation_space, venv.action_space, normalize_input=True),
        networks.RunningNorm)
    jvars = host(jnet.init_variables(jax.random.key(2)))
    net.load_state_dict(convert.reward_net_state_dict(jvars))
    return jnet, jvars, net


def _explore_feeds(seed, space, chunks=2):
    """The port's feeds for ``_explore`` from ``seed``: its initial mode,
    and per 128-step chunk the policy noise and the mixture's draws."""
    key = jax.random.key(seed)
    key, _, k_mode = jax.random.split(key, 3)
    noise, mix = [], []
    for _ in range(chunks):
        key, sub = jax.random.split(key)
        n, m = jax_explore_draws(sub, pc._EXPLORE_CHUNK, space, B, 1)
        noise += n
        mix += m
    return np.asarray(jax.random.uniform(k_mode, (B,))), noise, mix


def _feed_explore(monkeypatch, mode_u, mix):
    monkeypatch.setattr(torch_explore, "_mode_uniform", feed_arrays([mode_u]))
    queue = list(mix)
    monkeypatch.setattr(torch_explore, "_explore_draws", lambda space, n, generator: tuple(
        torch.from_numpy(np.array(x)) for x in queue.pop(0)))


def _assert_trajs(got, want, exact_acts=True):
    assert len(got) == len(want) > 0
    for t, jt in zip(got, want):
        assert len(t) == len(jt) and t.terminal == jt.terminal
        np.testing.assert_allclose(t.obs, np.asarray(jt.obs), **TOL)
        np.testing.assert_allclose(t.rews, np.asarray(jt.rews), **TOL)
        if exact_acts:
            np.testing.assert_array_equal(t.acts, np.asarray(jt.acts))
        else:
            np.testing.assert_allclose(t.acts, np.asarray(jt.acts), **TOL)


def test_agent_trainer_iteration_matches_jax(monkeypatch):
    """PPO on the normalized reward: relabel with frozen statistics, GAE,
    the epochs, the fold of the chunk's rows into the output normalizer,
    the episodes buffered; then ``sample`` from the buffer plus exploration."""
    T = 16
    jvenv, venv = _venvs(monkeypatch)
    jnet, jvars, _ = _reward_nets(jvenv, venv)
    cfg = dict(n_steps=T, n_minibatches=4, n_epochs=2, learning_rate=1e-3)
    jpol = JaxPolicy(jvenv.observation_space, jvenv.action_space, normalize_features=True)
    jtr = jpc.AgentTrainer(JaxPPO(jvenv, jpol, JaxPPOConfig(**cfg), seed=0), jnet, jvenv, rng=0,
                           exploration_frac=0.25, custom_logger=jax_configure(format_strs=()))
    jtr.rng = _Recorder(jtr.rng)
    jtr.reward_variables = jvars
    jpol0 = jtr.state.variables
    jchunk, tchunk = random_chunk(T, B, seed=5, obs_dim=3, act_dim=1)
    jchunk, tchunk = on_policy_aux(jpol, jpol0, jchunk, tchunk)
    _, _, k_proc = jax.random.split(jtr.state.key, 3)
    monkeypatch.setattr(jax_rollout, "collect", lambda venv, fn, params, state, n, key: (state, jchunk))
    monkeypatch.setattr(torch_ppo_mod.rollout_mod, "collect", lambda venv, fn, state, n, generator: (state, tchunk))
    jtr.train(T * B)
    jbuffered = list(jtr._buffered)
    steps = sum(len(t) for t in jbuffered)
    jout = jtr.sample(steps)
    seed = jtr.rng.ints[-1]
    mode_u, noise, mix = _explore_feeds(seed, jvenv.action_space)

    runs = {}

    def run(rel):
        _, _, net = _reward_nets(jvenv, venv)
        tr = pc.AgentTrainer(PPO(venv, ActorCriticPolicy(venv.observation_space, venv.action_space,
                                                         normalize_features=True), PPOConfig(**cfg), seed=0),
                             net, venv, rng=0, exploration_frac=0.25, custom_logger=configure(format_strs=()))
        tr.policy.load_state_dict(convert.policy_state_dict(jpol0))
        nudge_([tr.policy], rel)
        monkeypatch.setattr(torch_ppo_mod, "_epoch_permutation", feed(jax_epoch_perms(k_proc, 2, T * B)))
        init = snapshot(tr.policy)
        tr.train(T * B)
        runs[rel] = tr
        return {"policy": (init, snapshot(tr.policy))}

    floors = update_floors(run)
    tr = runs[0.0]
    assert_params_close(tr.policy, jtr.state.variables["params"], jpol0["params"], "net.",
                        param_tolerance(floors["policy"]))
    # The fold moved the output statistics as JAX's did, and nothing else.
    want = convert.reward_net_state_dict(host(jtr.reward_variables))
    for k, v in tr.reward_net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), **TOL, err_msg=k)
    assert int(tr.reward_net.normalizer.count) == T * B
    assert all(p.grad is None for p in tr.reward_net.parameters())
    got = tr.logger.default_logger.name_to_value
    wanted = jtr.logger.default_logger.name_to_value
    assert sorted(got) == sorted(wanted)
    for k in ("relabeled_rew_mean", "true_rew_mean", "n_episodes"):
        np.testing.assert_allclose(got[k], wanted[k], **TOL, err_msg=k)
    _assert_trajs(tr._buffered, jbuffered)

    _feed_explore(monkeypatch, mode_u, mix)
    monkeypatch.setattr(torch_dist, "_standard_normal", feed_arrays(noise))
    tr.rng = _Recorder(tr.rng)
    out = tr.sample(steps)
    assert tr.rng.ints == jtr.rng.ints[-1:]
    # The buffered episodes first (their actions exactly), then the mixture's.
    n_agent = int(np.argmax(np.cumsum([len(t) for t in out]) >= int(steps * 0.75))) + 1
    _assert_trajs(out[:n_agent], jout[:n_agent])
    _assert_trajs(out[n_agent:], jout[n_agent:], exact_acts=False)
    assert len(tr._buffered) == len(jtr._buffered)


def test_sac_agent_trainer_iteration_matches_jax(monkeypatch):
    """PEBBLE: three SAC steps whose replay batches are relabelled by the
    normalized reward (masked updates before ``learning_starts``, then
    learning), one replay sample folded into the output normalizer; then
    ``sample``: a rollout of the actor and the exploration mixture."""
    freq, batch, steps = 4, 8, 3
    jvenv, venv = _venvs(monkeypatch)
    jnet, jvars, _ = _reward_nets(jvenv, venv)
    cfg = dict(buffer_size=256, batch_size=batch, train_freq=freq, learning_starts=2 * freq * B,
               learning_rate=1e-3, actor_hid_sizes=(16, 16), critic_hid_sizes=(16, 16))
    jsac = JaxSAC(jvenv, JaxSACConfig(**cfg), seed=0)
    jtr = jpc.SACAgentTrainer(jsac, jnet, jvenv, rng=0, exploration_frac=0.25,
                              custom_logger=jax_configure(format_strs=()))
    jtr.rng = _Recorder(jtr.rng)
    jtr.reward_variables = jvars
    jstate0 = jtr.state
    feeds, key = [], jstate0.key
    for i in range(steps):
        noise, replay_idx, _, key = jax_sac_draws(key, train_freq=freq, num_envs=B, act_dim=1,
                                                  gradient_steps=1, batch=batch, size=(i + 1) * freq * B)
        feeds.append((noise, replay_idx))
    jtr.train(steps * freq * B)
    fold_seed = jtr.rng.ints[-1]
    fold_idx = np.asarray(jax.random.randint(jax.random.key(fold_seed), (batch,), 0, steps * freq * B))
    runs = {}

    def run(rel):
        _, _, net = _reward_nets(jvenv, venv)
        sac = SAC(venv, SACConfig(**cfg), seed=0)
        tr = pc.SACAgentTrainer(sac, net, venv, rng=0, exploration_frac=0.25,
                                custom_logger=configure(format_strs=()))
        sac.actor.load_state_dict(convert.sac_actor_state_dict({"params": host(jstate0.actor_params)}))
        sac.critic.load_state_dict(convert.sac_critic_state_dict({"params": host(jstate0.critic_params)}))
        sac.target_critic.load_state_dict(
            convert.sac_critic_state_dict({"params": host(jstate0.target_critic_params)}))
        nudge_([sac.actor, sac.critic], rel)
        noise = feed_arrays([n for f in feeds for n in f[0]])
        idx = feed([i for f in feeds for i in f[1]] + [fold_idx])
        monkeypatch.setattr(torch_dist, "_standard_normal", noise)
        monkeypatch.setattr(torch_buffer, "_uniform_indices", idx)
        init = {"actor": snapshot(sac.actor), "critic": snapshot(sac.critic)}
        tr.train(steps * freq * B)
        assert noise.remaining == [] and idx.remaining == []
        runs[rel] = tr
        return {k: (init[k], snapshot(getattr(sac, k))) for k in init}

    floors = update_floors(run)
    tr = runs[0.0]
    for which in ("actor", "critic"):
        assert_params_close(getattr(tr.algorithm, which), getattr(jtr.state, f"{which}_params"),
                            getattr(jstate0, f"{which}_params"), "", param_tolerance(floors[which]))
    assert tr.state.buffer_state.size == int(jtr.state.buffer_state.size) == steps * freq * B
    want = convert.reward_net_state_dict(host(jtr.reward_variables))
    for k, v in tr.reward_net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), **TOL, err_msg=k)
    assert int(tr.reward_net.normalizer.count) == batch
    assert all(p.grad is None for p in tr.reward_net.parameters())

    # sample: the actor's rollout (one 256-step chunk), then exploration.
    n = 60
    jout = jtr.sample(n)
    roll_seed, explore_seed = jtr.rng.ints[-2:]
    k_collect = jax.random.split(jax.random.split(jax.random.key(roll_seed))[0])[1]
    rollout_noise = jax_rollout_noise(k_collect, 256, B, 1)
    mode_u, explore_noise, mix = _explore_feeds(explore_seed, jvenv.action_space)
    _feed_explore(monkeypatch, mode_u, mix)
    monkeypatch.setattr(torch_dist, "_standard_normal", feed_arrays(rollout_noise + explore_noise))
    out = tr.sample(n)
    _assert_trajs(out, jout, exact_acts=False)


def test_fold_reads_the_newest_replay_state(monkeypatch):
    """The port's ring is written in place, so a replay state kept from
    before a store would see newer rows; the fold samples the trainer's
    current state, the newest."""
    venv = make_vec_env("Pendulum-v1", num_envs=B, device="cpu")
    net = reward_nets.NormalizedRewardNet(reward_nets.BasicRewardNet(venv.observation_space, venv.action_space))
    sac = SAC(venv, SACConfig(buffer_size=64, batch_size=8, train_freq=4, learning_starts=8,
                              actor_hid_sizes=(8,), critic_hid_sizes=(8,)), seed=0)
    tr = pc.SACAgentTrainer(sac, net, venv, rng=0, custom_logger=configure(format_strs=()))
    sampled = []
    sample = torch_buffer.ReplayBuffer.sample
    monkeypatch.setattr(torch_buffer.ReplayBuffer, "sample",
                        lambda self, state, n, g: sampled.append(state) or sample(self, state, n, g))
    for rows in (16, 32):
        tr.train(4 * B)
        assert sampled[-1] is tr.state.buffer_state and sampled[-1].size == rows
        assert int(net.normalizer.count) == rows // 2


def test_relabel_alpha_and_refusals():
    venv = make_vec_env("Pendulum-v1", num_envs=B, device="cpu")
    ens = reward_nets.RewardEnsemble(venv.observation_space, venv.action_space)
    fn = pc._make_relabel_fn(ens, 0.5)
    x = (torch.randn(5, 3), torch.randn(5, 1), torch.randn(5, 3), torch.zeros(5))
    mean, var = ens.predict_reward_moments(*x)
    torch.testing.assert_close(fn(ens, *x), mean + 0.5 * torch.sqrt(var))
    basic = reward_nets.BasicRewardNet(venv.observation_space, venv.action_space)
    with pytest.raises(TypeError, match="ensemble"):
        pc._make_relabel_fn(basic, 0.5)
    assert not pc._has_output_norm(basic) and not pc._has_output_norm(ens)
    assert pc._has_output_norm(reward_nets.NormalizedRewardNet(basic))
