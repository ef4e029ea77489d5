"""The host-env pieces of DAgger, the wrappers, exploration and host
policies in imitation_tpu_torch against the JAX package.

Both packages step their own build of the C++ engine from the same seed.

* DAgger's ``InteractiveTrajectoryCollector`` on a host env: a
  deterministic robot (the JAX weights, ``convert``) and the scripted
  expert, with the JAX collector's mixture uniforms (its per-step key split
  in three) fed through ``dagger._mixture_mask``: the same episodes,
  labelled with the expert's actions, saved alike.
* ``BufferingWrapper``: finished and partial trajectories, transitions and
  the error on a premature reset; ``RolloutInfoWrapper`` on one env.
* ``AgentTrainer.sample`` on a host env with ``exploration_frac=1``: the
  exploration wrapper's ``host_policy_fn`` through the host rollout path,
  with the JAX draws (the policy's noise, the random actions) fed through
  ``distributions._standard_normal`` and ``exploration_wrapper.
  _random_actions``; the mode's uniforms are numpy's in both.
* ``RewardVecEnvWrapper`` and ``WrappedRewardCallback``.
* ``NonTrainablePolicy.as_rollout_fn`` through ``generate_trajectories``.

Observations and actions agree exactly where both packages run the same
float32 arithmetic in numpy or the engine, else within 1e-5.
"""

import shutil

import jax
import numpy as np
import pytest
import torch

import imitation_tpu.algorithms.preference_comparisons as jpc
import imitation_tpu_torch.algorithms.dagger as torch_dagger
import imitation_tpu_torch.models.distributions as torch_dist
import imitation_tpu_torch.policies.exploration_wrapper as torch_explore
from imitation_tpu.algorithms import dagger as jax_dagger
from imitation_tpu.data import rollout as jax_rollout
from imitation_tpu.data import wrappers as jax_wrappers
from imitation_tpu.models.policies import ActorCriticPolicy as JaxPolicy
from imitation_tpu.native.cpp_env import CppVectorEnv as JaxCppVectorEnv
from imitation_tpu.policies.base import NonTrainablePolicy as JaxNonTrainable
from imitation_tpu.rewards import reward_wrapper as jax_reward_wrapper
from imitation_tpu.rewards.reward_nets import BasicRewardNet as JaxRewardNet
from imitation_tpu.rl.ppo import PPO as JaxPPO
from imitation_tpu.rl.ppo import PPOConfig as JaxPPOConfig
from imitation_tpu.testing import experts as jax_experts
from imitation_tpu.util.logger import configure as jax_configure
from imitation_tpu_torch import convert
from imitation_tpu_torch.algorithms import preference_comparisons as pc
from imitation_tpu_torch.data import rollout, serialize, wrappers
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.native import CppVectorEnv
from imitation_tpu_torch.policies.base import NonTrainablePolicy
from imitation_tpu_torch.rewards import reward_wrapper
from imitation_tpu_torch.rewards.reward_nets import BasicRewardNet
from imitation_tpu_torch.rl.ppo import PPO, PPOConfig
from imitation_tpu_torch.testing import experts
from imitation_tpu_torch.util.logger import configure
from tests.torch_parity import feed_arrays, host

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="the engine is built with g++")


def _envs(env_name, num_envs=4, seed=2, **kw):
    kw.update(num_envs=num_envs, seed=seed, num_threads=1)
    return JaxCppVectorEnv(env_name, **kw), CppVectorEnv(env_name, device="cpu", **kw)


def _assert_trajs(trajs, jtrajs, exact=True):
    assert len(trajs) == len(jtrajs) > 0
    check = np.testing.assert_array_equal if exact else (
        lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5))
    for t, j in zip(trajs, jtrajs):
        assert t.terminal == j.terminal and len(t) == len(j)
        for f in ("obs", "acts", "rews"):
            check(np.asarray(getattr(t, f)), np.asarray(getattr(j, f)))


def test_dagger_host_collection_matches_jax(tmp_path, monkeypatch):
    B, beta, seed = 4, 0.5, 3
    jvenv, venv = _envs("CartPole-v1", B, max_episode_steps=30)
    jpolicy = JaxPolicy(jvenv.observation_space, jvenv.action_space, hid_sizes=(16,))
    variables = jpolicy.init(jax.random.key(1))
    policy = ActorCriticPolicy(venv.observation_space, venv.action_space, hid_sizes=(16,))
    policy.load_state_dict(convert.policy_state_dict(host(variables)))
    jcol = jax_dagger.InteractiveTrajectoryCollector(
        jvenv, jpolicy.deterministic_fn(), variables, beta, str(tmp_path / "jax"), np.random.default_rng(0))
    col = torch_dagger.InteractiveTrajectoryCollector(
        venv, policy.deterministic_fn(), beta, str(tmp_path / "port"), np.random.default_rng(0))
    chunk = 32
    jtrajs = jcol.collect_trajectories(jax_experts.cartpole_expert_fn, None,
                                       jax_rollout.make_min_episodes(6), chunk_size=chunk, seed=seed)
    key, masks = jax.random.key(seed), []
    for _ in range(10 * chunk):  # more steps than the chunks run
        key, k_act = jax.random.split(key)
        _, _, k_mix = jax.random.split(k_act, 3)
        masks.append(np.asarray(jax.random.uniform(k_mix, (B,)) < beta))
    monkeypatch.setattr(torch_dagger, "_mixture_mask", feed_arrays(masks))
    trajs = col.collect_trajectories(experts.cartpole_expert_fn, rollout.make_min_episodes(6),
                                     chunk_size=chunk, seed=seed)
    _assert_trajs(trajs, jtrajs)
    for t in trajs:  # demonstrations record the expert's actions
        want, _ = experts.cartpole_expert_fn(torch.from_numpy(t.obs[:-1]))
        np.testing.assert_array_equal(t.acts, want.numpy())
    saved = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(saved) == len(trajs) == col.traj_index
    np.testing.assert_array_equal(serialize.load(str(tmp_path / "port" / saved[0]))[0].acts,
                                  trajs[int(saved[0].rsplit("-", 1)[1])].acts)


def test_buffering_wrapper_matches_jax():
    B = 4
    jvenv, venv = _envs("Pendulum-v1", B, max_episode_steps=15)
    jbuf, buf = jax_wrappers.BufferingWrapper(jvenv), wrappers.BufferingWrapper(venv)
    assert buf.is_host and buf.device == venv.device and buf.num_envs == B
    with pytest.raises(RuntimeError, match="reset"):
        buf.step(np.zeros((B, 1), np.float32))
    np.testing.assert_array_equal(buf.reset(), jbuf.reset())
    rng = np.random.default_rng(0)

    def steps(n):
        for _ in range(n):
            acts = rng.uniform(-2, 2, (B, 1)).astype(np.float32)
            jout, out = jbuf.step(acts), buf.step(acts)
            np.testing.assert_array_equal(out["obs"], jout["obs"])

    steps(20)
    assert buf.n_transitions == jbuf.n_transitions == 20 * B
    _assert_trajs(buf.pop_finished_trajectories(), jbuf.pop_finished_trajectories())
    assert buf.n_transitions == jbuf.n_transitions == 5 * B
    steps(7)
    with pytest.raises(RuntimeError, match="before samples were accessed"):
        buf.reset()
    with pytest.raises(RuntimeError, match="before samples were accessed"):
        jbuf.reset()
    jtr, tr = jbuf.pop_transitions(), buf.pop_transitions()
    assert len(tr) == len(jtr) == 12 * B and buf.n_transitions == 0
    for f in ("obs", "acts", "next_obs", "dones", "rews"):
        np.testing.assert_array_equal(getattr(tr, f), getattr(jtr, f), err_msg=f)
    buf.reset()  # everything was popped: allowed


def test_rollout_info_wrapper_matches_jax():
    class OneEnv:
        """One Pendulum env of the engine behind the single-env API."""

        def __init__(self, venv):
            self.venv, self.spec = venv, "pendulum"

        def reset(self, **kwargs):
            return self.venv.reset()[0], {}

        def step(self, action):
            out = self.venv.step(np.asarray(action, np.float32).reshape(1, 1))
            done = out["terminated"][0] or out["truncated"][0]
            return out["obs"][0], float(out["reward"][0]), bool(out["terminated"][0]), \
                bool(out["truncated"][0]), {"done": done}

    jvenv, venv = _envs("Pendulum-v1", 1, max_episode_steps=5)
    jenv, env = jax_wrappers.RolloutInfoWrapper(OneEnv(jvenv)), wrappers.RolloutInfoWrapper(OneEnv(venv))
    assert env.spec == "pendulum"
    np.testing.assert_array_equal(env.reset()[0], jenv.reset()[0])
    for i in range(5):
        *_, jinfo = jenv.step(0.5)
        *_, info = env.step(0.5)
    for k in ("obs", "rews"):
        np.testing.assert_array_equal(info["rollout"][k], jinfo["rollout"][k])
    assert info["rollout"]["monitor_return"] == jinfo["rollout"]["monitor_return"]
    assert info["rollout"]["obs"].shape == (6, 3)


def test_agent_trainer_host_exploration_matches_jax(monkeypatch):
    B, steps = 4, 200
    jvenv, venv = _envs("Pendulum-v1", B, max_episode_steps=20)
    cfg = dict(n_steps=8, n_minibatches=2, n_epochs=1)
    jpol = JaxPolicy(jvenv.observation_space, jvenv.action_space, hid_sizes=(16,))
    jnet = JaxRewardNet(observation_space=jvenv.observation_space, action_space=jvenv.action_space)
    jtr = jpc.AgentTrainer(JaxPPO(jvenv, jpol, JaxPPOConfig(**cfg), seed=0), jnet, jvenv, rng=0,
                           exploration_frac=1.0, custom_logger=jax_configure(format_strs=()))
    jout = jtr.sample(steps)
    net = BasicRewardNet(venv.observation_space, venv.action_space)
    tr = pc.AgentTrainer(PPO(venv, ActorCriticPolicy(venv.observation_space, venv.action_space, hid_sizes=(16,)),
                             PPOConfig(**cfg), seed=0),
                         net, venv, rng=0, exploration_frac=1.0, custom_logger=configure(format_strs=()))
    tr.policy.load_state_dict(convert.policy_state_dict(host(jtr.state.variables)))

    # The JAX collector's stateful path: one chunk of 256 steps, per-step keys
    # split(key(seed), 257)[1:], each split into the policy's and the random
    # actions' (imitation_tpu/policies/exploration_wrapper.py host_policy_fn).
    seed = int(np.random.default_rng(0).integers(0, 2**31 - 1))
    space, noise, rand = jvenv.action_space, [], []
    for k in jax.random.split(jax.random.key(seed), 257)[1:]:
        k_act, k_rand = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(k_act, (B, 1))))
        rand.append(np.asarray(jax.vmap(space.sample)(jax.random.split(k_rand, B))))
    draws, rand_draws = feed_arrays(noise), feed_arrays(rand)
    monkeypatch.setattr(torch_dist, "_standard_normal", draws)
    monkeypatch.setattr(torch_explore, "_random_actions", rand_draws)
    out = tr.sample(steps)
    assert draws.remaining == [] and rand_draws.remaining == []
    _assert_trajs(out, jout, exact=False)
    assert len(out) == B * (256 // 20)  # one chunk of 256 steps: 12 episodes of 20 per env


def test_reward_vec_env_wrapper_matches_jax():
    B = 4
    jvenv, venv = _envs("CartPole-v1", B, max_episode_steps=12)

    def reward_fn(obs, acts, next_obs, dones):
        return (obs[:, 0] - next_obs[:, 2] + 0.5 * acts + dones).astype(np.float32)

    jw = jax_reward_wrapper.RewardVecEnvWrapper(jvenv, reward_fn, ep_history=5)
    w = reward_wrapper.RewardVecEnvWrapper(venv, reward_fn, ep_history=5)
    assert w.is_host and w.device == venv.device and w.action_space.n == 2
    np.testing.assert_array_equal(w.reset(), jw.reset())
    rng = np.random.default_rng(1)
    for _ in range(30):
        acts = rng.integers(0, 2, B)
        jout, out = jw.step(acts), w.step(acts)
        assert sorted(out) == sorted(jout)
        for k in out:
            np.testing.assert_array_equal(out[k], jout[k], err_msg=k)
    assert w.episode_rewards == jw.episode_rewards and len(w.episode_rewards) == 5

    rows = []
    logger = configure(format_strs=())
    logger.default_logger.output_formats.append(type("Capture", (), {
        "write": lambda self, kvs, step: rows.append(dict(kvs)), "close": lambda self: None})())
    w.make_log_callback(logger).log(step=3)
    assert rows == [{"rollout/ep_rew_wrapped_mean": np.mean(jw.episode_rewards)}]


class _Sign(NonTrainablePolicy):
    def _choose_action(self, obs):
        return int(obs[2] + 0.3 * obs[3] > 0)


class _JaxSign(JaxNonTrainable):
    def _choose_action(self, obs):
        return int(obs[2] + 0.3 * obs[3] > 0)


def test_non_trainable_policy_matches_jax():
    jvenv, venv = _envs("CartPole-v1", 4, max_episode_steps=40)
    fn = _Sign(venv.observation_space, venv.action_space).as_rollout_fn()
    assert fn.host_stateful
    jfn = _JaxSign(jvenv.observation_space, jvenv.action_space).as_rollout_fn()
    kw = dict(chunk_size=32)
    jtrajs = jax_rollout.generate_trajectories(jfn, None, jvenv, jax_rollout.make_min_episodes(5), 7, **kw)
    trajs = rollout.generate_trajectories(fn, venv, rollout.make_min_episodes(5), 7, **kw)
    _assert_trajs(trajs, jtrajs)
    acts, aux = fn(torch.zeros((3, 4)), None)
    assert aux == {} and acts.dtype == torch.int32 and acts.shape == (3,)
