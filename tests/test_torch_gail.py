"""GAIL in imitation_tpu_torch against the JAX package.

The discriminator step and one whole GAIL round (relabel -> GAE -> PPO ->
buffer store -> 2 disc steps, through ``train``) start from the same
weights, carried across with ``convert``. The random draws are the JAX
package's own: its PPO epoch permutations (imitation_tpu/rl/ppo.py:274,423,
458) and its disc-step indices (imitation_tpu/algorithms/adversarial/
common.py:299-305) are recomputed from its keys and fed to the port through
``_epoch_permutation`` and ``_disc_indices``. The rollout is one fixed chunk
for both.

Tolerances: disc loss and stats 1e-5 (the same float32 forward);
parameters 1e-5 of the largest parameter update, raised where needed to 4x
the case's own float32 floor, as in tests/test_torch_ppo.py (the floor is
measured in each test by nudging the port's initial weights by about one
ulp; here it is about 7e-6 to 3e-5, the float32 resolution of the weights
against an update of one or two Adam steps).
"""

import jax
import numpy as np
import pytest
import torch

import imitation_tpu.data.rollout as jax_rollout
import imitation_tpu_torch.algorithms.adversarial.common as torch_common
import imitation_tpu_torch.rl.ppo as torch_ppo_mod
from imitation_tpu.algorithms.adversarial.gail import GAIL as JaxGAIL
from imitation_tpu.data.types import TransitionBatch as JaxBatch
from imitation_tpu.envs import make_vec_env as jax_make_vec_env
from imitation_tpu.rewards.reward_nets import BasicRewardNet as JaxRewardNet
from imitation_tpu.rl.ppo import PPOConfig as JaxPPOConfig
from imitation_tpu.util.logger import configure as jax_configure
from imitation_tpu_torch import convert
from imitation_tpu_torch.algorithms.adversarial.gail import GAIL
from imitation_tpu_torch.data.types import TransitionBatch
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.rewards.reward_nets import BasicRewardNet
from imitation_tpu_torch.rl.ppo import PPOConfig
from imitation_tpu_torch.testing import experts
from imitation_tpu_torch.util.logger import configure
from tests.torch_parity import (
    assert_params_close, feed, host, jax_disc_indices, jax_epoch_perms, nudge_, param_tolerance,
    random_chunk, snapshot, update_floors,
)

torch.set_num_threads(1)

STAT_TOL = dict(rtol=1e-5, atol=1e-5)


def _transitions(n, seed):
    rng = np.random.default_rng(seed)
    arrays = dict(
        obs=rng.normal(scale=0.5, size=(n, 4)).astype(np.float32),
        acts=rng.integers(0, 2, n).astype(np.int32),
        next_obs=rng.normal(scale=0.5, size=(n, 4)).astype(np.float32),
        dones=(rng.random(n) < 0.1).astype(np.float32),
        rews=np.zeros(n, np.float32),
    )
    return (JaxBatch(**{k: jax.numpy.asarray(v) for k, v in arrays.items()}),
            TransitionBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


def _trainers(tmp_path, *, normalize=False, demo_batch_size=64, minibatch=None, n_demo=300,
              n_steps=16, num_envs=8, n_epochs=2):
    """The JAX trainer, and a maker of port trainers that start from its
    reward net's weights."""
    jdemo, tdemo = _transitions(n_demo, seed=1)
    ppo_kw = dict(n_steps=n_steps, n_minibatches=4, n_epochs=n_epochs, learning_rate=1e-3)
    common = dict(demo_batch_size=demo_batch_size, demo_minibatch_size=minibatch,
                  n_disc_updates_per_round=2, allow_variable_horizon=True, seed=0)
    jvenv = jax_make_vec_env("CartPole-v1", num_envs=num_envs)
    jtr = JaxGAIL(
        demonstrations=jdemo, venv=jvenv, gen_config=JaxPPOConfig(**ppo_kw),
        reward_net=JaxRewardNet(observation_space=jvenv.observation_space,
                                action_space=jvenv.action_space, normalize_input=normalize),
        custom_logger=jax_configure(str(tmp_path), format_strs=[]), **common,
    )
    jreward = host(jtr.disc_state.variables)

    def port_trainer():
        venv = make_vec_env("CartPole-v1", num_envs=num_envs, device="cpu")
        tr = GAIL(
            demonstrations=tdemo, venv=venv, gen_config=PPOConfig(**ppo_kw),
            reward_net=BasicRewardNet(venv.observation_space, venv.action_space,
                                      normalize_input=normalize),
            custom_logger=configure(format_strs=()), **common,
        )
        tr.reward_net.load_state_dict(convert.reward_net_state_dict(jreward))
        return tr

    return jtr, port_trainer


@pytest.mark.parametrize("minibatch", [None, 16])
@pytest.mark.parametrize("normalize", [False, True])
def test_disc_step_matches_jax(tmp_path, monkeypatch, minibatch, normalize):
    B, n_demo, n_gen = 64, 300, 128
    jtr, port_trainer = _trainers(tmp_path, normalize=normalize, minibatch=minibatch, n_demo=n_demo)
    jgen, tgen = _transitions(n_gen, seed=2)
    jbuf = jtr._gen_replay_buffer.store(jtr._gen_replay_buffer.init_state(jgen), jgen)
    jds, jstats = jtr._disc_step(jtr.disc_state, jbuf, None, jtr._demo_store.batch)

    def port(rel):
        tr = port_trainer()
        nudge_([tr.reward_net], rel)
        buf = tr._gen_replay_buffer.store(tr._gen_replay_buffer.init_state(tgen), tgen)
        assert buf.size == int(jbuf.size) == n_gen
        indices = feed(jax_disc_indices(jtr.disc_state.key, 1, B, n_demo, n_gen))
        monkeypatch.setattr(torch_common, "_disc_indices", indices)
        init = snapshot(tr.reward_net)
        ds, stats = tr._disc_step(tr.disc_state, buf, tr.policy, tr._demo_store.batch)
        assert indices.remaining == [] and ds.step == 1
        return tr, stats, init

    tr, stats, _ = port(0.0)
    assert sorted(stats) == sorted(jstats)
    for k, v in jstats.items():
        np.testing.assert_allclose(float(stats[k]), float(v), **STAT_TOL, err_msg=k)

    def port_updates(rel):
        nudged, _, init = port(rel)
        return {"disc": (init, snapshot(nudged.reward_net))}

    floor = update_floors(port_updates)["disc"]
    assert_params_close(tr.reward_net, jds.variables["params"],
                        jtr.disc_state.variables["params"], "", param_tolerance(floor))
    if normalize:
        want = host(jds.variables["stats"])["input_norm"]
        np.testing.assert_allclose(tr.reward_net.input_norm.running_mean.numpy(),
                                   want["running_mean"], **STAT_TOL)
        np.testing.assert_allclose(tr.reward_net.input_norm.running_var.numpy(),
                                   want["running_var"], **STAT_TOL)


def test_gail_round_matches_jax(tmp_path, monkeypatch):
    T, Bv, n_demo, B = 16, 8, 300, 64
    jtr, port_trainer = _trainers(tmp_path, n_steps=T, num_envs=Bv, n_demo=n_demo)
    jchunk, tchunk = random_chunk(T, Bv, seed=3)

    jtr.gen_state = jtr.gen_algo.init_state()
    jgen0 = jtr.gen_state.variables["params"]
    jdisc0 = jtr.disc_state.variables["params"]
    disc_key = jtr.disc_state.key
    _, _, k_proc = jax.random.split(jtr.gen_state.key, 3)  # ppo.py train_step
    monkeypatch.setattr(jax_rollout, "collect", lambda venv, fn, params, state, n, key: (state, jchunk))
    jtr.train(T * Bv)
    monkeypatch.setattr(torch_ppo_mod.rollout_mod, "collect",
                        lambda venv, fn, state, n, generator: (state, tchunk))

    def port(rel):
        tr = port_trainer()
        tr.gen_state = tr.gen_algo.init_state()
        tr.policy.load_state_dict(convert.policy_state_dict(host({"params": jgen0})))
        nudge_([tr.policy, tr.reward_net], rel)
        perms = feed(jax_epoch_perms(k_proc, 2, T * Bv))
        indices = feed(jax_disc_indices(disc_key, 2, B, n_demo, T * Bv))
        monkeypatch.setattr(torch_ppo_mod, "_epoch_permutation", perms)
        monkeypatch.setattr(torch_common, "_disc_indices", indices)
        init = {"policy": snapshot(tr.policy), "disc": snapshot(tr.reward_net)}
        tr.train(T * Bv)
        assert perms.remaining == [] and indices.remaining == []
        assert tr._gen_buffer_state.size == T * Bv and tr.disc_state.step == 2
        return tr, init

    tr, _ = port(0.0)

    def port_updates(rel):
        nudged, init = port(rel)
        return {"policy": (init["policy"], snapshot(nudged.policy)),
                "disc": (init["disc"], snapshot(nudged.reward_net))}

    floors = update_floors(port_updates)
    assert_params_close(tr.policy, jtr.gen_state.variables["params"], jgen0, "net.",
                        param_tolerance(floors["policy"]))
    assert_params_close(tr.reward_net, jtr.disc_state.variables["params"], jdisc0, "",
                        param_tolerance(floors["disc"]))


def test_gail_train_smoke_cpu():
    demo_venv = make_vec_env("CartPole-v1", num_envs=4, max_episode_steps=50, device="cpu")
    demos = experts.generate_expert_trajectories("CartPole-v1", demo_venv, min_episodes=8, seed=0)
    assert len(demos) >= 8 and all(len(d) == 50 and not d.terminal for d in demos)
    venv = make_vec_env("CartPole-v1", num_envs=8, device="cpu")
    logger = configure(format_strs=())
    rows = []
    logger.default_logger.output_formats.append(type("Capture", (), {
        "write": lambda self, kvs, step: rows.append(dict(kvs)), "close": lambda self: None})())
    tr = GAIL(demonstrations=demos, demo_batch_size=32, venv=venv,
              gen_config=PPOConfig(n_steps=16, n_minibatches=4, n_epochs=2),
              custom_logger=logger, seed=0)
    with pytest.raises(RuntimeError, match="train_gen"):
        tr.train_disc()
    tr.train(2 * 16 * 8)
    assert tr.gen_state.timesteps == 256 and tr.disc_state.step == 4
    assert len(rows) == 2
    for row in rows:
        for k in ("mean/gen/loss", "mean/disc/disc_loss", "mean/gen/relabeled_rew_mean"):
            assert np.isfinite(row[k]), k
    assert all(torch.isfinite(p).all() for p in tr.reward_net.parameters())


def test_demonstration_checks():
    venv = make_vec_env("CartPole-v1", num_envs=2, device="cpu")
    demo_venv = make_vec_env("CartPole-v1", num_envs=4, device="cpu")
    demos = experts.generate_expert_trajectories("CartPole-v1", demo_venv, min_episodes=2, seed=0)
    from imitation_tpu_torch.data.types import TrajectoryWithRew

    short = TrajectoryWithRew(obs=demos[0].obs[:4], acts=demos[0].acts[:3],
                              rews=demos[0].rews[:3], infos=None, terminal=True)
    with pytest.raises(ValueError, match="different length"):
        GAIL(demonstrations=[demos[0], short], demo_batch_size=2, venv=venv,
             gen_config=PPOConfig(n_steps=4, n_minibatches=2), custom_logger=configure(()))
    with pytest.raises(ValueError, match="exceeds demonstration"):
        GAIL(demonstrations=demos, demo_batch_size=10**6, venv=venv,
             gen_config=PPOConfig(n_steps=4, n_minibatches=2), custom_logger=configure(()))
