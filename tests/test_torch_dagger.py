"""DAgger in imitation_tpu_torch against the JAX package.

The beta schedules are compared value for value. The collectors of both
packages run the same mixture on CartPole with every reset at one fixed
state, the scripted expert and the same deterministic robot (the JAX
policy's weights carried across with ``convert``): with beta 0 and 1 no
random draw picks an action, and at beta 0.5 the JAX package's own mixture
draws (its collector's key chain, imitation_tpu/algorithms/dagger.py
``collect_trajectories`` and ``_mixture_policy_apply``) are recomputed and
fed to the port through ``dagger._mixture_mask``.

Tolerances: observations 1e-5 (the same float32 dynamics, with cos and sin
from two libraries); actions, terminal flags, rewards, lengths and file
names exactly.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imitation_tpu_torch.algorithms.dagger as torch_dagger
from imitation_tpu.algorithms import dagger as jax_dagger
from imitation_tpu.envs import make_vec_env as jax_make_vec_env
from imitation_tpu.envs.classic import ArrayState as JaxArrayState
from imitation_tpu.envs.classic import CartPole as JaxCartPole
from imitation_tpu.models.policies import ActorCriticPolicy as JaxPolicy
from imitation_tpu.testing import experts as jax_experts
from imitation_tpu.util.logger import configure as jax_configure
from imitation_tpu_torch import convert
from imitation_tpu_torch.algorithms.bc import BC
from imitation_tpu_torch.data import rollout
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.policies.serialize import load_policy_from_path
from imitation_tpu_torch.testing import experts
from imitation_tpu_torch.util.logger import configure
from tests.torch_parity import host

torch.set_num_threads(1)

OBS_TOL = dict(rtol=1e-5, atol=1e-5)
S0 = np.array([0.03, -0.02, 0.04, 0.01], np.float32)


@pytest.mark.parametrize("make", [
    lambda m: m.LinearBetaSchedule(15), lambda m: m.LinearBetaSchedule(10),
    lambda m: m.LinearBetaSchedule(1), lambda m: m.ExponentialBetaSchedule(0.7),
    lambda m: m.ExponentialBetaSchedule(0.5), lambda m: m.ExponentialBetaSchedule(1.0),
])
def test_beta_schedules_match_jax(make):
    jsched, sched = make(jax_dagger), make(torch_dagger)
    for r in range(31):
        assert sched(r) == jsched(r), r
    assert sched(0) == 1.0


def test_exponential_beta_schedule_range():
    for bad in (1.5, -0.1):
        with pytest.raises(ValueError, match="decay_probability"):
            torch_dagger.ExponentialBetaSchedule(bad)
        with pytest.raises(ValueError, match="decay_probability"):
            jax_dagger.ExponentialBetaSchedule(bad)
    assert torch_dagger.ExponentialBetaSchedule(1.0)(3) == 1.0
    assert torch_dagger.ExponentialBetaSchedule(0.0)(1) == 0.0


def jax_mixture_masks(seed, n_chunks, chunk_size, batch, beta):
    """The per-step expert masks of the JAX collector with ``seed``."""
    key = jax.random.key(seed)
    key, _ = jax.random.split(key)  # the reset key
    masks = []
    for _ in range(n_chunks):
        key, sub = jax.random.split(key)
        for step_key in jax.random.split(sub, chunk_size):
            k_act, _ = jax.random.split(step_key)
            _, _, k_mix = jax.random.split(k_act, 3)
            masks.append(np.asarray(jax.random.uniform(k_mix, (batch,)) < beta))
    return masks


def _fixed_resets(monkeypatch, venv):
    """Every reset, in both packages, starts at ``S0``."""
    monkeypatch.setattr(JaxCartPole, "reset",
                        lambda self, key: (jnp.asarray(S0), JaxArrayState(x=jnp.asarray(S0))))

    def reset(n, generator):
        x = torch.from_numpy(np.tile(S0, (n, 1)))
        return x, x.clone()

    monkeypatch.setattr(venv.env, "reset", reset)


def _robots(jvenv, venv):
    jpol = JaxPolicy(jvenv.observation_space, jvenv.action_space)
    variables = jpol.init(jax.random.key(1))
    pol = ActorCriticPolicy(venv.observation_space, venv.action_space)
    pol.load_state_dict(convert.policy_state_dict(host(variables)))
    return jpol, variables, pol


def _assert_same_trajs(got, want):
    assert len(got) == len(want) > 0
    for t, jt in zip(got, want):
        assert len(t) == len(jt) and t.terminal == jt.terminal
        np.testing.assert_array_equal(t.acts, np.asarray(jt.acts))
        np.testing.assert_array_equal(t.rews, np.asarray(jt.rews))
        np.testing.assert_allclose(t.obs, np.asarray(jt.obs), **OBS_TOL)


@pytest.mark.parametrize("beta", [0.0, 1.0, 0.5])
def test_collector_matches_jax(tmp_path, monkeypatch, beta):
    B, horizon, seed = 4, 60, 7
    jvenv = jax_make_vec_env("CartPole-v1", num_envs=B, max_episode_steps=horizon)
    venv = make_vec_env("CartPole-v1", num_envs=B, max_episode_steps=horizon, device="cpu")
    _fixed_resets(monkeypatch, venv)
    jpol, variables, pol = _robots(jvenv, venv)
    until = 6
    jcol = jax_dagger.InteractiveTrajectoryCollector(
        jvenv, jpol.deterministic_fn(), variables, beta, str(tmp_path / "jax"), np.random.default_rng(0))
    jtrajs = jcol.collect_trajectories(jax_experts.cartpole_expert_fn, {},
                                       rollout.make_min_episodes(until), chunk_size=32, seed=seed)
    col = torch_dagger.InteractiveTrajectoryCollector(
        venv, pol.deterministic_fn(), beta, str(tmp_path / "port"), np.random.default_rng(0))
    masks = jax_mixture_masks(seed, 8, 32, B, beta)
    monkeypatch.setattr(torch_dagger, "_mixture_mask",
                        lambda n, b, generator: torch.from_numpy(masks.pop(0).copy()))
    trajs = col.collect_trajectories(experts.cartpole_expert_fn, rollout.make_min_episodes(until),
                                     chunk_size=32, seed=seed)
    _assert_same_trajs(trajs, jtrajs)
    # The demos record the expert's actions, whatever was stepped.
    for t in trajs:
        want, _ = experts.cartpole_expert_fn(torch.from_numpy(t.obs[:-1]))
        np.testing.assert_array_equal(t.acts, want.numpy())
    # Under the robot alone the episodes are the robot's, not the expert's.
    if beta == 0.0:
        assert any(t.terminal for t in trajs)
    if beta == 1.0:
        assert all(len(t) == horizon and not t.terminal for t in trajs)
    # The same file names in the save dir.
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


def test_mixture_apply_matches_jax(tmp_path, monkeypatch):
    """One mixture step on a batch: the stepped and the recorded actions."""
    B = 256
    jvenv = jax_make_vec_env("CartPole-v1", num_envs=B)
    venv = make_vec_env("CartPole-v1", num_envs=B, device="cpu")
    jpol, variables, pol = _robots(jvenv, venv)
    obs = np.random.default_rng(2).normal(scale=0.2, size=(B, 4)).astype(np.float32)
    key = jax.random.key(4)
    jcol = jax_dagger.InteractiveTrajectoryCollector(
        jvenv, jpol.deterministic_fn(), variables, 0.5, str(tmp_path), np.random.default_rng(0))
    jacts, jaux = jcol._mixture_policy_apply(jax_experts.cartpole_expert_fn)(
        ({}, variables), jnp.asarray(obs), key)
    _, _, k_mix = jax.random.split(key, 3)
    mask = np.asarray(jax.random.uniform(k_mix, (B,)) < 0.5)
    monkeypatch.setattr(torch_dagger, "_mixture_mask", lambda n, b, generator: torch.from_numpy(mask.copy()))
    col = torch_dagger.InteractiveTrajectoryCollector(
        venv, pol.deterministic_fn(), 0.5, str(tmp_path), np.random.default_rng(0))
    acts, aux = col._mixture_policy_apply(experts.cartpole_expert_fn)(torch.from_numpy(obs), torch.Generator())
    np.testing.assert_array_equal(acts.numpy(), np.asarray(jacts))
    np.testing.assert_array_equal(aux["expert_acts"].numpy(), np.asarray(jaux["expert_acts"]))
    assert 0 < mask.sum() < B and (acts != aux["expert_acts"]).any()


def test_mixture_mask_draws_beta():
    g = torch.Generator().manual_seed(0)
    assert not torch_dagger._mixture_mask(1000, 0.0, g).any()
    assert torch_dagger._mixture_mask(1000, 1.0, g).all()
    assert abs(torch_dagger._mixture_mask(100000, 0.3, g).float().mean().item() - 0.3) < 0.01


def make_trainer(scratch, beta_schedule=None, **kwargs):
    venv = make_vec_env("CartPole-v1", num_envs=4, max_episode_steps=60, device="cpu")
    bc = BC(observation_space=venv.observation_space, action_space=venv.action_space, rng=0,
            device="cpu", custom_logger=configure(format_strs=()))
    return torch_dagger.SimpleDAggerTrainer(
        venv=venv, scratch_dir=scratch, expert_policy_apply=experts.cartpole_expert_fn, rng=0,
        beta_schedule=beta_schedule, bc_trainer=bc, custom_logger=configure(format_strs=()), **kwargs)


def test_round_dir_names_match_jax(tmp_path):
    jvenv = jax_make_vec_env("CartPole-v1", num_envs=2)
    jtr = jax_dagger.SimpleDAggerTrainer(venv=jvenv, scratch_dir=str(tmp_path / "j"),
                                         expert_policy_apply=jax_experts.cartpole_expert_fn,
                                         custom_logger=jax_configure(str(tmp_path / "log"), []))
    tr = make_trainer(str(tmp_path / "t"))
    for r in (0, 1, 7, 123):
        assert (tr._demo_dir_path_for_round(r).relative_to(tmp_path / "t")
                == jtr._demo_dir_path_for_round(r).relative_to(tmp_path / "j"))
    assert tr._demo_dir_path_for_round() == tr.scratch_dir / "demos" / "round-000"
    assert tr.DEFAULT_N_EPOCHS == jax_dagger.DAggerTrainer.DEFAULT_N_EPOCHS == 4


def test_needs_demos_exception(tmp_path):
    trainer = make_trainer(str(tmp_path / "d"))
    with pytest.raises(torch_dagger.NeedsDemosException):
        trainer.extend_and_update(dict(n_epochs=1))


def test_extend_and_update_ingests_every_round(tmp_path):
    """Rounds not yet loaded are all loaded, each once; JAX's trainer reads
    the same round dirs to the same demos."""
    scratch = str(tmp_path / "d")
    tr = make_trainer(scratch)
    venv = tr.venv
    demos = experts.generate_expert_trajectories("CartPole-v1", venv, min_episodes=9, seed=0)[:9]
    for r, chunk in enumerate((demos[:2], demos[2:5], demos[5:9])):
        for i, t in enumerate(chunk):
            torch_dagger._save_dagger_demo(t, i, str(tr._demo_dir_path_for_round(r)))
    assert tr.extend_and_update(dict(n_epochs=1, log_rollouts_venv=None)) == 1
    assert len(tr._all_demos) == 2
    tr.round_num = 2  # round 1 was never trained on: both rounds load now
    assert tr.extend_and_update(dict(n_epochs=1, log_rollouts_venv=None)) == 3
    assert len(tr._all_demos) == 9 and tr._last_loaded_round == 2
    assert tr.bc_trainer._demo_store.num_samples == sum(len(t) for t in demos)
    # The JAX trainer ingests the port's round dirs to the same demos.
    jvenv = jax_make_vec_env("CartPole-v1", num_envs=4, max_episode_steps=60)
    jtr = jax_dagger.SimpleDAggerTrainer(venv=jvenv, scratch_dir=scratch,
                                         expert_policy_apply=jax_experts.cartpole_expert_fn,
                                         custom_logger=jax_configure(str(tmp_path / "log"), []))
    jtr.round_num = 2
    jtr._try_load_demos()
    assert len(jtr._all_demos) == 9
    for t, jt in zip(tr._all_demos, jtr._all_demos):
        np.testing.assert_array_equal(t.obs, jt.obs)
        np.testing.assert_array_equal(t.acts, jt.acts)
        np.testing.assert_array_equal(t.rews, jt.rews)
        assert t.terminal == jt.terminal


def test_initial_expert_trajs(tmp_path):
    venv = make_vec_env("CartPole-v1", num_envs=4, max_episode_steps=60, device="cpu")
    demos = experts.generate_expert_trajectories("CartPole-v1", venv, min_episodes=2)[:2]
    tr = make_trainer(str(tmp_path / "d"), expert_trajs=demos)
    names = sorted(os.listdir(tr._demo_dir_path_for_round(0)))
    assert names == ["initial_data-dagger-demo-0", "initial_data-dagger-demo-1"]


def test_save_and_reconstruct_continue_identically(tmp_path):
    scratch = str(tmp_path / "d")
    tr = make_trainer(scratch, beta_schedule=torch_dagger.LinearBetaSchedule(4))
    tr.train(total_timesteps=200, rollout_round_min_timesteps=100, rollout_round_min_episodes=2,
             bc_train_kwargs=dict(n_epochs=2, log_rollouts_venv=None))
    assert tr.round_num >= 1
    ckpt, policy_path = tr.save_trainer()
    assert ckpt.name == "checkpoint-latest.pt" and policy_path.name == "policy-latest"
    assert (tr.scratch_dir / f"checkpoint-{tr.round_num:03d}.pt").exists()
    assert (tr.scratch_dir / f"policy-{tr.round_num:03d}").is_dir()
    saved = {k: v.clone() for k, v in tr.policy.state_dict().items()}
    for k, v in load_policy_from_path(str(policy_path), device="cpu").state_dict().items():
        assert torch.equal(v, saved[k])

    def one_round(trainer):
        trainer.train(total_timesteps=1, rollout_round_min_timesteps=100, rollout_round_min_episodes=2,
                      bc_train_kwargs=dict(n_epochs=2, log_rollouts_venv=None))
        return {k: v.clone() for k, v in trainer.policy.state_dict().items()}

    shutil.copytree(scratch, str(tmp_path / "backup"))
    after = one_round(tr)
    shutil.rmtree(scratch)
    shutil.copytree(str(tmp_path / "backup"), scratch)
    loaded = torch_dagger.reconstruct_trainer(scratch, tr.venv, configure(format_strs=()))
    assert type(loaded) is torch_dagger.SimpleDAggerTrainer
    assert loaded.round_num == tr.round_num - 1 and loaded.scratch_dir == tr.scratch_dir
    assert isinstance(loaded.beta_schedule, torch_dagger.LinearBetaSchedule)
    for k, v in loaded.policy.state_dict().items():
        assert torch.equal(v, saved[k]), k
    for k, v in one_round(loaded).items():
        assert torch.equal(v, after[k]), k
    assert loaded.round_num == tr.round_num and len(loaded._all_demos) == len(tr._all_demos)


def test_collector_reproducible(tmp_path):
    def collect(seed, tag):
        tr = make_trainer(str(tmp_path / f"d{tag}"), beta_schedule=lambda r: 0.5)
        return tr.create_trajectory_collector().collect_trajectories(
            experts.cartpole_expert_fn, rollout.make_min_episodes(2), seed=seed)

    a, b, c = collect(3, "a"), collect(3, "b"), collect(4, "c")
    assert len(a) == len(b)
    for t1, t2 in zip(a, b):
        np.testing.assert_array_equal(t1.obs, t2.obs)
    assert len(a) != len(c) or any(not np.array_equal(t1.obs, t2.obs) for t1, t2 in zip(a, c))


def test_simple_dagger_improves(tmp_path):
    """The JAX package's learning test at its size: 4 envs, 60 steps, 4000
    timesteps."""
    trainer = make_trainer(str(tmp_path / "d"))
    venv = trainer.venv
    novice = rollout.generate_trajectories(trainer.policy.sample_fn(), venv,
                                           rollout.make_min_episodes(10), rng=0)
    novice_ret = np.mean([t.rews.sum() for t in novice])
    rounds = []
    trainer.train(total_timesteps=4000, rollout_round_min_episodes=3, rollout_round_min_timesteps=400,
                  bc_train_kwargs=dict(n_epochs=4), on_round_end=lambda r, n: rounds.append((r, n)))
    trained = rollout.generate_trajectories(trainer.policy.sample_fn(), venv,
                                            rollout.make_min_episodes(10), rng=1)
    trained_ret = np.mean([t.rews.sum() for t in trained])
    assert trained_ret > novice_ret + 10, f"{novice_ret} -> {trained_ret}"
    assert rounds[-1][0] == trainer.round_num == len(rounds) and rounds[-1][1] >= 4000
