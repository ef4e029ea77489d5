"""GAIL and AIRL with a SAC generator in imitation_tpu_torch against the JAX
package, on Pendulum-v1.

The reward net's, the SAC actor's and critics' weights are the JAX
package's, carried across with ``convert`` (the actor by
``warm_start_generator``). The random draws are the JAX package's own,
recomputed from its keys: the disc-step indices through ``_disc_indices``
(tests/test_torch_airl.py), and SAC's noise and replay indices through
``models.distributions._standard_normal`` and ``data.buffer.
_uniform_indices`` (tests/test_torch_sac.py). Both packages step from the
same initial Pendulum states; no episode ends in these rounds.

A SAC generator relabels each sampled batch with the current reward net
(``relabel_fn``) and returns its fresh transitions, which the trainer
stores in its own ring; each disc step assembles its batch with kernel B2's
``assemble_fields`` (its plain version on the CPU), and AIRL's log pi(a|s)
comes from ``SAC.log_prob_fn``.

Tolerances: disc stats 1e-5; parameters 1e-5 of the largest update, raised
where needed to 4x the case's own float32 floor (``tests.torch_parity.
update_floors``); the metrics ``train_fused`` logs 1e-4.
"""

import types

import jax
import numpy as np
import pytest
import torch

import imitation_tpu_torch.algorithms.adversarial.common as torch_common
import imitation_tpu_torch.data.buffer as torch_buffer
import imitation_tpu_torch.models.distributions as torch_dist
from imitation_tpu.algorithms.adversarial.airl import AIRL as JaxAIRL
from imitation_tpu.algorithms.adversarial.gail import GAIL as JaxGAIL
from imitation_tpu.envs import make_vec_env as jax_make_vec_env
from imitation_tpu.rl.sac import SAC as JaxSAC
from imitation_tpu.rl.sac import SACConfig as JaxSACConfig
from imitation_tpu.util.logger import configure as jax_configure
from imitation_tpu_torch import convert
from imitation_tpu_torch.algorithms.adversarial.airl import AIRL
from imitation_tpu_torch.algorithms.adversarial.gail import GAIL
from imitation_tpu_torch.data.types import TransitionBatch
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.rl.sac import SAC, SACConfig, SACPolicy
from imitation_tpu_torch.testing import experts
from imitation_tpu_torch.util.logger import configure
from tests import test_torch_sac as sac_case
from tests.test_torch_airl import _recorded, _transitions
from tests.torch_parity import (
    assert_params_close, feed, feed_arrays, host, inject_resets, jax_disc_indices, jax_sac_draws,
    nudge_, param_tolerance, snapshot, update_floors,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
NUM_ENVS, T, B, N_DEMO = 4, 8, 16, 64
ROWS = NUM_ENVS * T
SAC_KW = dict(buffer_size=256, batch_size=16, train_freq=T, learning_rate=1e-3, gradient_steps=2,
              actor_hid_sizes=(32, 32), critic_hid_sizes=(32, 32))
ALGOS = {"airl": (JaxAIRL, AIRL), "gail": (JaxGAIL, GAIL)}


def _trainers(tmp_path, monkeypatch, algo, learning_starts=0):
    """The JAX trainer with a SAC generator (its state initialised), and a
    maker of port trainers that start from its weights and initial states."""
    jcls, cls = ALGOS[algo]
    jdemo, tdemo = _transitions("Pendulum-v1", N_DEMO, seed=1)
    sac_kw = dict(SAC_KW, learning_starts=learning_starts)
    common = dict(demo_batch_size=B, n_disc_updates_per_round=2, seed=0)
    jvenv = jax_make_vec_env("Pendulum-v1", num_envs=NUM_ENVS)
    jtr = jcls(demonstrations=jdemo, venv=jvenv, gen_algo=JaxSAC(jvenv, JaxSACConfig(**sac_kw), seed=0),
               custom_logger=jax_configure(str(tmp_path), format_strs=[]), **common)
    jtr.gen_state = jtr.gen_algo.init_state()
    # Host copies: train_fused donates the states it is given.
    jstate = types.SimpleNamespace(**{k: host(getattr(jtr.gen_state, k)) for k in (
        "actor_params", "critic_params", "target_critic_params", "log_alpha")})
    jreward = host(jtr.disc_state.variables)
    x0 = np.asarray(jtr.gen_state.env_state.env_state.x)

    def port_trainer():
        venv = make_vec_env("Pendulum-v1", num_envs=NUM_ENVS, device="cpu")
        inject_resets(monkeypatch, venv, x0)
        tr = cls(demonstrations=tdemo, venv=venv, gen_algo=SAC(venv, SACConfig(**sac_kw), seed=0),
                 custom_logger=configure(format_strs=()), **common)
        tr.reward_net.load_state_dict(convert.reward_net_state_dict(jreward))
        tr.warm_start_generator(convert.sac_actor_state_dict({"params": host(jstate.actor_params)}))
        sac_case._load(tr.gen_algo, tr.gen_state, jstate)
        return tr

    return jtr, port_trainer


def _sac_params(tr):
    return sac_case._params(tr.gen_algo)


@pytest.mark.parametrize("algo", list(ALGOS))
def test_trainer_takes_a_sac_generator(tmp_path, monkeypatch, algo):
    jtr, port_trainer = _trainers(tmp_path, monkeypatch, algo)
    tr = port_trainer()
    assert tr._gen_steps_per_iter == jtr._gen_steps_per_iter == ROWS
    assert tr.gen_train_timesteps == ROWS and tr._gen_replay_buffer.capacity == ROWS
    assert tr.gen_algo.return_transitions and tr.gen_algo.relabel_fn is not None
    assert isinstance(tr.policy, SACPolicy) and tr.policy.actor is tr.gen_algo.actor
    assert tr.gen_algo.replay is not tr._gen_replay_buffer  # separate rings
    assert tr.needs_policy_log_prob == (algo == "airl")


@pytest.mark.parametrize("algo", list(ALGOS))
def test_disc_step_matches_jax(tmp_path, monkeypatch, algo):
    """One disc step with a SAC generator: AIRL's logit takes log pi(a|s)
    from ``SAC.log_prob_fn`` on the [2B] batch, with no gradient."""
    jtr, port_trainer = _trainers(tmp_path, monkeypatch, algo)
    jgen, tgen = _transitions("Pendulum-v1", ROWS, seed=2)
    jbuf = jtr._gen_replay_buffer.store(jtr._gen_replay_buffer.init_state(jgen), jgen)
    jds, jstats = jtr._disc_step(jtr.disc_state, jbuf, jtr.gen_state.variables, jtr._demo_store.batch)

    def port(rel):
        tr = port_trainer()
        nudge_([tr.reward_net], rel)
        buf = tr._gen_replay_buffer.store(tr._gen_replay_buffer.init_state(tgen), tgen)
        indices = feed(jax_disc_indices(jtr.disc_state.key, 1, B, N_DEMO, ROWS))
        monkeypatch.setattr(torch_common, "_disc_indices", indices)
        init = snapshot(tr.reward_net)
        actor_before = {k: v.clone() for k, v in tr.gen_algo.actor.state_dict().items()}
        ds, stats = tr._disc_step(tr.disc_state, buf, tr.policy, tr._demo_store.batch)
        assert indices.remaining == [] and ds.step == 1
        assert all(torch.equal(v, tr.gen_algo.actor.state_dict()[k]) for k, v in actor_before.items())
        assert all(p.grad is None for p in tr.gen_algo.actor.parameters())
        return tr, stats, init

    tr, stats, _ = port(0.0)
    assert sorted(stats) == sorted(jstats)
    for k, v in jstats.items():
        np.testing.assert_allclose(float(stats[k]), float(v), **TOL, err_msg=k)

    def port_updates(rel):
        nudged, _, init = port(rel)
        return {"disc": (init, snapshot(nudged.reward_net))}

    floor = update_floors(port_updates)["disc"]
    assert_params_close(tr.reward_net, jds.variables["params"], jtr.disc_state.variables["params"], "",
                        param_tolerance(floor))


def _round_feeds(jtr, rounds):
    """The SAC noise and replay indices of ``rounds`` rounds, and the disc
    indices of their disc steps, from the JAX trainer's keys."""
    noise, replay_idx, key = [], [], jtr.gen_state.key
    for r in range(rounds):
        n, idx, _, key = jax_sac_draws(key, train_freq=T, num_envs=NUM_ENVS, act_dim=1,
                                       gradient_steps=SAC_KW["gradient_steps"],
                                       batch=SAC_KW["batch_size"], size=(r + 1) * ROWS)
        noise += n
        replay_idx += idx
    disc = jax_disc_indices(jtr.disc_state.key, 2 * rounds, B, N_DEMO, ROWS)
    return noise, replay_idx, disc


def _jax_snapshot(jtr):
    return {"disc": host(jtr.disc_state.variables["params"]), **sac_case._jax_params(jtr.gen_state)}


def _check_round(tr, jtr, jinit, run):
    floors = update_floors(run)
    assert_params_close(tr.reward_net, jtr.disc_state.variables["params"], jinit["disc"], "",
                        param_tolerance(floors["disc"]))
    got, want = _sac_params(tr), sac_case._jax_params(jtr.gen_state)
    for label in ("actor", "critic", "target", "alpha"):
        upd = max(np.abs(want[label][k] - jinit[label][k]).max() for k in want[label])
        err = max(np.abs(got[label][k] - want[label][k]).max() for k in want[label])
        assert upd > 0 and err <= param_tolerance(floors[label]) * upd, (label, err, upd)


def _port_runner(monkeypatch, port_trainer, feeds, drive):
    noise, replay_idx, disc = feeds
    runs = {}

    def run(rel):
        tr = port_trainer()
        nudge_([tr.reward_net], rel)
        sac_case._set(tr.gen_algo, sac_case._nudge(_sac_params(tr), rel))
        init = {"disc": snapshot(tr.reward_net), **_sac_params(tr)}
        fed = (feed_arrays(noise), feed(replay_idx), feed(disc))
        monkeypatch.setattr(torch_dist, "_standard_normal", fed[0])
        monkeypatch.setattr(torch_buffer, "_uniform_indices", fed[1])
        monkeypatch.setattr(torch_common, "_disc_indices", fed[2])
        out = drive(tr)
        assert all(f.remaining == [] for f in fed)
        runs[rel] = (tr, out)
        final = {"disc": snapshot(tr.reward_net), **_sac_params(tr)}
        return {label: (init[label], final[label]) for label in init}

    return run, runs


def test_airl_sac_round_matches_jax(tmp_path, monkeypatch):
    """One AIRL round through ``train``: SAC collects 8 steps of 4 envs,
    stores them, takes 2 updates on batches relabelled by the shaped net;
    the trainer stores the fresh transitions in its ring; 2 disc steps."""
    jtr, port_trainer = _trainers(tmp_path, monkeypatch, "airl")
    jinit = _jax_snapshot(jtr)
    feeds = _round_feeds(jtr, 1)
    jtr.train(ROWS)
    run, runs = _port_runner(monkeypatch, port_trainer, feeds, lambda tr: tr.train(ROWS))
    run(0.0)
    tr = runs[0.0][0]
    assert tr.gen_state.timesteps == ROWS and tr.disc_state.step == 2
    assert tr._gen_buffer_state.size == ROWS and tr.gen_state.buffer_state.size == ROWS
    # The trainer's ring holds the raw transitions (true rewards), as JAX's does.
    np.testing.assert_allclose(tr._gen_buffer_state.data.rews.numpy(),
                               np.asarray(jtr._gen_buffer_state.data.rews), **TOL)
    _check_round(tr, jtr, jinit, run)


@pytest.mark.parametrize("algo", list(ALGOS))
def test_train_fused_sac_matches_jax(tmp_path, monkeypatch, algo):
    """Two rounds of ``train_fused(rounds_per_sync=2)``; SAC's
    ``learning_starts=40`` masks round 1's updates (32 rows stored), so
    round 2's are the first to learn."""
    jtr, port_trainer = _trainers(tmp_path, monkeypatch, algo, learning_starts=40)
    jinit = _jax_snapshot(jtr)  # train_fused donates the states it is given
    feeds = _round_feeds(jtr, 2)
    jrows = _recorded(jtr.logger)
    jtr.train_fused(2 * ROWS, rounds_per_sync=2)

    def drive(tr):
        rows = _recorded(tr.logger)
        tr.train_fused(2 * ROWS, rounds_per_sync=2)
        return rows

    run, runs = _port_runner(monkeypatch, port_trainer, feeds, drive)
    run(0.0)
    tr, rows = runs[0.0]
    assert tr.gen_state.timesteps == 2 * ROWS and tr.disc_state.step == 4 and tr._global_step == 2
    assert tr.gen_state.actor_opt.count == 4
    assert sorted(rows) == sorted(jrows)
    for k in jrows:
        np.testing.assert_allclose(rows[k], jrows[k], rtol=1e-4, atol=1e-5, err_msg=k)
    _check_round(tr, jtr, jinit, run)


def test_warm_start_generator_with_a_sac_actor(tmp_path, monkeypatch):
    """The actor takes the given weights (as the JAX package replaces
    ``actor_params``); the critics and the optimizers' state are kept."""
    jtr, port_trainer = _trainers(tmp_path, monkeypatch, "airl")
    tr = port_trainer()
    jactor = JaxSAC(jax_make_vec_env("Pendulum-v1", num_envs=2),
                    JaxSACConfig(**SAC_KW)).init_state(jax.random.key(5)).actor_params
    critic_before = {k: v.clone() for k, v in tr.gen_algo.critic.state_dict().items()}
    opt = tr.gen_state.actor_opt
    tr.warm_start_generator(convert.sac_actor_state_dict({"params": host(jactor)}))
    jtr.warm_start_generator({"params": jactor})
    got = {k: v.numpy() for k, v in tr.gen_algo.actor.state_dict().items()}
    for k, v in convert.sac_actor_state_dict({"params": host(jtr.gen_state.actor_params)}).items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    assert all(torch.equal(v, tr.gen_algo.critic.state_dict()[k]) for k, v in critic_before.items())
    assert tr.gen_state.actor_opt is opt
    obs = np.random.default_rng(0).normal(size=(8, 3)).astype(np.float32)
    det, _ = tr.policy.deterministic_fn()(torch.from_numpy(obs))
    jdet, _ = jtr.gen_algo.deterministic_fn()(jtr.gen_state.variables, jax.numpy.asarray(obs), None)
    np.testing.assert_allclose(det.numpy(), np.asarray(jdet), **TOL)


@pytest.mark.parametrize("algo", list(ALGOS))
def test_adversarial_sac_train_and_train_fused_smoke_cpu(algo):
    demo_venv = make_vec_env("Pendulum-v1", num_envs=4, device="cpu")
    demos = experts.generate_expert_trajectories("Pendulum-v1", demo_venv, min_episodes=4, seed=0)
    venv = make_vec_env("Pendulum-v1", num_envs=8, device="cpu")
    sac = SAC(venv, SACConfig(**dict(SAC_KW, train_freq=16, learning_starts=100, buffer_size=512)), seed=0)
    tr = ALGOS[algo][1](demonstrations=demos, demo_batch_size=64, venv=venv, gen_algo=sac,
                        n_disc_updates_per_round=2, custom_logger=configure(format_strs=()), seed=0)
    tr.train(128)
    tr.train_fused(2 * 128, rounds_per_sync=2)
    assert tr.gen_state.timesteps == 3 * 128 and tr.disc_state.step == 6
    assert tr.gen_state.buffer_state.size == 3 * 128 and tr._gen_buffer_state.size == 128
    assert isinstance(tr._gen_buffer_state.data, TransitionBatch)
    params = [*sac.actor.parameters(), *sac.critic.parameters(), *tr.reward_net.parameters()]
    assert all(torch.isfinite(p).all() for p in params)
