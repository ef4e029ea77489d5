"""Host-env collection and PPO's host paths in imitation_tpu_torch against
the JAX package, and the port's own overlap contract.

Both packages step their own build of the same C++ engine from the same
seed, so their envs agree exactly (tests/test_torch_host_envs.py).

* ``HostCollector`` with a deterministic policy built from the JAX
  package's weights (``convert``): CartPole chunks equal exactly; Pendulum's
  actions are the Gaussian's mean, computed by two float32 MLPs, so its
  chunks and the aux (log-prob, value) agree within 1e-5.
* ``generate_trajectories`` over a host venv (``generate_trajectories_host``)
  with the scripted expert: the same episodes in the same order.
* One ``PPO.train_step_host`` on Pendulum: the JAX collector's Gaussian
  noise (its key split once per step) is fed through
  ``distributions._standard_normal`` and its epoch permutations through
  ``_epoch_permutation``; parameters within ``tests/torch_parity.py``'s
  ``param_tolerance`` of the case's own float32 floor (``update_floors``,
  the nudge reaching the collection too), the chunk within 1e-5.
* The overlap contract (after tests/rl/test_ppo_overlap.py): the first
  overlapped iteration equals the serialized one bit for bit; the chunk
  that iteration k+1 trains on equals one collected from the weights (and
  the feature normalizer's statistics) saved before update k; timesteps
  are counted; ``discard_pending_collection`` and ``learn`` leave nothing
  in flight; the phase timer's spans.
"""

import shutil

import jax
import numpy as np
import pytest
import torch

import imitation_tpu.rl.ppo as jax_ppo_mod
import imitation_tpu_torch.models.distributions as torch_dist
import imitation_tpu_torch.rl.ppo as torch_ppo_mod
from imitation_tpu.data import rollout as jax_rollout
from imitation_tpu.models.policies import ActorCriticPolicy as JaxPolicy
from imitation_tpu.native.cpp_env import CppVectorEnv as JaxCppVectorEnv
from imitation_tpu.testing import experts as jax_experts
from imitation_tpu_torch import convert
from imitation_tpu_torch.data import rollout
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.native import CppVectorEnv
from imitation_tpu_torch.testing import experts
from imitation_tpu_torch.util.profiling import PhaseTimer
from tests.torch_parity import (
    assert_params_close, feed, feed_arrays, host, jax_epoch_perms, jax_host_noise, nudge_, param_tolerance,
    snapshot, update_floors,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="the engine is built with g++")

FIELDS = rollout.CHUNK_FIELDS


def _envs(env_name, B, seed=3, **kw):
    kw.update(num_envs=B, seed=seed, num_threads=1)
    return JaxCppVectorEnv(env_name, **kw), CppVectorEnv(env_name, device="cpu", **kw)


def _policies(jvenv, venv, normalize_features=False, seed=0):
    jpolicy = JaxPolicy(jvenv.observation_space, jvenv.action_space, hid_sizes=(16, 16),
                        normalize_features=normalize_features)
    variables = jpolicy.init(jax.random.key(seed))
    policy = ActorCriticPolicy(venv.observation_space, venv.action_space, hid_sizes=(16, 16),
                               normalize_features=normalize_features)
    policy.load_state_dict(convert.policy_state_dict(host(variables)))
    return jpolicy, variables, policy


@pytest.mark.parametrize("env_name", ["CartPole-v1", "Pendulum-v1"])
def test_host_collector_matches_jax(env_name):
    T, B = 40, 8
    jvenv, venv = _envs(env_name, B, max_episode_steps=30)  # episodes end in both chunks
    jpolicy, variables, policy = _policies(jvenv, venv)
    jcol = jax_rollout.HostCollector(jvenv, jpolicy.deterministic_fn(), variables, seed=0)
    col = rollout.HostCollector(venv, policy.deterministic_fn(), seed=0)
    exact = env_name == "CartPole-v1"
    for _ in range(2):  # the second chunk continues the first's episodes
        jchunk, chunk = jcol.collect(T), col.collect(T)
        for k in FIELDS:
            got, want = getattr(chunk, k).numpy(), np.asarray(getattr(jchunk, k))
            assert got.dtype == want.dtype and got.shape == want.shape, k
            if exact:
                np.testing.assert_array_equal(got, want, err_msg=k)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=k)
        assert sorted(chunk.aux) == sorted(jchunk.aux) == ["log_prob", "value"]
        for k in chunk.aux:
            np.testing.assert_allclose(chunk.aux[k].numpy(), np.asarray(jchunk.aux[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    assert chunk.dones.any()


def test_host_collector_snapshot_and_device():
    """The forward reads a CPU snapshot: the module's later in-place updates
    reach it only through ``refresh``."""
    venv = CppVectorEnv("CartPole-v1", num_envs=4, device="cpu", num_threads=1)
    policy = ActorCriticPolicy(venv.observation_space, venv.action_space, hid_sizes=(8,))
    fn = policy.deterministic_fn()
    col = rollout.HostCollector(venv, fn, seed=0)
    assert col._snapshot is not policy and fn.module is policy
    with torch.no_grad():
        for p in policy.parameters():
            p.add_(1.0)
    assert not torch.equal(col._snapshot.net.vf_out.weight, policy.net.vf_out.weight)
    col.refresh()
    for (k, a), b in zip(col._snapshot.state_dict().items(), policy.state_dict().values()):
        assert torch.equal(a, b), k
    chunk = col.collect(3, device="cpu")
    assert chunk.obs.shape == (3, 4, 4) and chunk.acts.dtype == torch.int32


def test_generate_trajectories_host_matches_jax():
    jvenv, venv = _envs("Pendulum-v1", 8)
    kw = dict(chunk_size=64)
    jtrajs = jax_rollout.generate_trajectories(
        jax_experts.pendulum_expert_fn, None, jvenv, jax_rollout.make_min_episodes(10), 5, **kw)
    trajs = rollout.generate_trajectories(
        experts.pendulum_expert_fn, venv, rollout.make_min_episodes(10), 5, **kw)
    assert len(trajs) == len(jtrajs) >= 10
    for t, j in zip(trajs, jtrajs):
        assert len(t) == len(j) == 200 and t.terminal == j.terminal
        np.testing.assert_allclose(t.obs, j.obs, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(t.acts, j.acts, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(t.rews, j.rews, rtol=1e-5, atol=1e-5)
    # One collector is cached on the venv and reused by the next call.
    collector = venv._gen_traj_collector
    rollout.generate_trajectories(experts.pendulum_expert_fn, venv, rollout.make_min_timesteps(8), 1)
    assert venv._gen_traj_collector is collector


def test_ppo_train_step_host_matches_jax(monkeypatch):
    T, B = 16, 8
    cfg_kw = dict(n_steps=T, n_minibatches=4, n_epochs=3, learning_rate=1e-3, ent_coef=0.01)
    jvenv, _ = _envs("Pendulum-v1", B, seed=5)
    jpolicy = JaxPolicy(jvenv.observation_space, jvenv.action_space, hid_sizes=(16, 16),
                        normalize_features=True)
    jppo = jax_ppo_mod.PPO(jvenv, jpolicy, jax_ppo_mod.PPOConfig(**cfg_kw), return_transitions=True)
    jstate = jppo.init_state(jax.random.key(0))
    _, k_proc = jax.random.split(jstate.key)  # ppo.py train_step_host
    jnew, jmetrics, jchunk = jppo.train_step_host(jstate)
    noise = jax_host_noise(0, T, B, 1)  # PPO's collector is seeded with PPO's seed, 0

    def port(rel):
        venv = CppVectorEnv("Pendulum-v1", num_envs=B, seed=5, num_threads=1, device="cpu")
        policy = ActorCriticPolicy(venv.observation_space, venv.action_space, hid_sizes=(16, 16),
                                   normalize_features=True)
        ppo = torch_ppo_mod.PPO(venv, policy, torch_ppo_mod.PPOConfig(**cfg_kw),
                                return_transitions=True)
        state = ppo.init_state()
        policy.load_state_dict(convert.policy_state_dict(host(jstate.variables)))
        nudge_([policy], rel)
        draws = feed_arrays(noise)
        perms = feed(jax_epoch_perms(k_proc, cfg_kw["n_epochs"], T * B))
        monkeypatch.setattr(torch_dist, "_standard_normal", draws)
        monkeypatch.setattr(torch_ppo_mod, "_epoch_permutation", perms)
        init = snapshot(policy)
        new, metrics, chunk = ppo.train_step(state)
        assert draws.remaining == [] and perms.remaining == []
        return policy, new, metrics, chunk, init

    policy, new, metrics, chunk, _ = port(0.0)
    for k in FIELDS:
        np.testing.assert_allclose(getattr(chunk, k).numpy(), np.asarray(getattr(jchunk, k)),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    def port_updates(rel):
        nudged, _, _, _, init = port(rel)
        return {"policy": (init, snapshot(nudged))}

    floor = update_floors(port_updates)["policy"]
    assert_params_close(policy, jnew.variables["params"], jstate.variables["params"], "net.",
                        param_tolerance(floor))
    stats = host(jnew.variables["stats"])["feat_norm"]
    np.testing.assert_allclose(policy.net.feat_norm.running_mean.numpy(), stats["running_mean"],
                               rtol=1e-5, atol=1e-6)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-3, atol=1e-5, err_msg=k)
    assert new.timesteps == T * B and new.env_state is None


def _ppo(overlap, normalize_features=True):
    venv = CppVectorEnv("Pendulum-v1", num_envs=8, seed=1, num_threads=1, device="cpu")
    policy = ActorCriticPolicy(venv.observation_space, venv.action_space, hid_sizes=(16, 16),
                               normalize_features=normalize_features)
    cfg = torch_ppo_mod.PPOConfig(n_steps=16, n_minibatches=4, n_epochs=2,
                                  overlap_collection=overlap)
    return torch_ppo_mod.PPO(venv, policy, cfg, seed=0)


def test_first_overlapped_iteration_matches_serialized_bitwise():
    runs = []
    for overlap in (False, True):
        ppo = _ppo(overlap)
        state, metrics = ppo.train_step(ppo.init_state())
        ppo.discard_pending_collection()
        runs.append((ppo.policy.state_dict(), metrics, state.timesteps))
    (sd_s, m_s, t_s), (sd_o, m_o, t_o) = runs
    for k in sd_s:
        assert torch.equal(sd_s[k], sd_o[k]), k
    for k in m_s:
        assert torch.equal(m_s[k], m_o[k]) or (m_s[k].isnan() and m_o[k].isnan()), k
    assert t_s == t_o == 16 * 8


def test_overlapped_chunks_come_from_pre_update_weights(monkeypatch):
    ppo = _ppo(True)
    state = ppo.init_state()
    trained, weights = [], []
    process = ppo.process_chunk

    def recording(state, env_state, chunk, generator, reward_params=None):
        trained.append(chunk)
        return process(state, env_state, chunk, generator, reward_params)

    monkeypatch.setattr(ppo, "process_chunk", recording)
    for _ in range(3):
        weights.append({k: v.clone() for k, v in ppo.policy.state_dict().items()})
        state, _ = ppo.train_step(state)
        assert ppo._pending_chunk is not None
    assert state.timesteps == 3 * 16 * 8
    ppo.discard_pending_collection()
    assert ppo._pending_chunk is None
    # The feature normalizer's statistics moved: buffers ride in the snapshot.
    assert not torch.equal(weights[0]["net.feat_norm.running_mean"],
                           weights[1]["net.feat_norm.running_mean"])

    # A twin collector, stepped alike: iteration 0 trains on a chunk from
    # W0; iteration k+1 on one collected from W_k, the weights before update k.
    twin = _ppo(False)
    twin.init_state()
    col = twin._host_collector
    for k, w in enumerate([weights[0], weights[0], weights[1]]):
        twin.policy.load_state_dict(w)
        col.refresh()
        want = col.collect(16)
        for f in FIELDS:
            assert torch.equal(getattr(trained[k], f), getattr(want, f)), (k, f)
        for f in want.aux:
            assert torch.equal(trained[k].aux[f], want.aux[f]), (k, f)


def test_learn_joins_and_phase_timer_spans():
    ppo = _ppo(True)
    ppo.phase_timer = PhaseTimer()
    state = ppo.learn(ppo.init_state(), 3 * 16 * 8)
    assert ppo._pending_chunk is None and state.timesteps == 3 * 16 * 8
    report = ppo.phase_timer.report()
    assert set(report) == {"time/collect_join_s", "time/collect_join_mean_s"}  # 2 joins, no barrier
    assert ppo.phase_timer.totals == {}

    ppo = _ppo(False)
    ppo.phase_timer = PhaseTimer()
    ppo.learn(ppo.init_state(), 2 * 16 * 8)
    report = ppo.phase_timer.report()
    assert report["time/host_collect_s"] > 0 and report["time/device_update_s"] > 0
    assert ppo.phase_timer.counts == {}

    with pytest.raises(RuntimeError, match="init_state"):
        _ppo(False).train_step(None)
