"""AIRL and its shaped reward net in imitation_tpu_torch against the JAX package.

The reward net's weights are the JAX package's, carried across with
``convert``; the policy's too where a case needs log pi(a|s). The random
draws are the JAX package's own: its PPO epoch permutations and its disc-step
indices are recomputed from its keys and fed to the port through
``_epoch_permutation`` and ``_disc_indices`` (as in tests/test_torch_gail.py).
The rollout is one fixed chunk for both, with the JAX policy's own
log-probabilities and values.

Tolerances: reward-net outputs, logits and disc stats 1e-5 (the same
float32 forward); parameters 1e-5 of the largest parameter update, raised
where needed to 4x the case's own float32 floor, measured in each test by
``tests.torch_parity.update_floors`` (how far the port's own update moves
when its initial weights are nudged by about one ulp); the metrics that
``train_fused`` logs after its two rounds 1e-4 (they ride on the updated
weights).
"""

import jax
import numpy as np
import pytest
import torch

import imitation_tpu.data.rollout as jax_rollout
import imitation_tpu_torch.algorithms.adversarial.common as torch_common
import imitation_tpu_torch.rl.ppo as torch_ppo_mod
from imitation_tpu.algorithms.adversarial.airl import AIRL as JaxAIRL
from imitation_tpu.data.types import TransitionBatch as JaxBatch
from imitation_tpu.envs import make_vec_env as jax_make_vec_env
from imitation_tpu.rewards.reward_nets import BasicShapedRewardNet as JaxShapedNet
from imitation_tpu.rl.ppo import PPOConfig as JaxPPOConfig
from imitation_tpu.util.logger import configure as jax_configure
from imitation_tpu_torch import convert
from imitation_tpu_torch.algorithms.adversarial.airl import AIRL
from imitation_tpu_torch.algorithms.adversarial.gail import GAIL
from imitation_tpu_torch.data.types import TransitionBatch
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.rewards.reward_nets import BasicShapedRewardNet, ShapedRewardNet
from imitation_tpu_torch.rl.ppo import PPOConfig
from imitation_tpu_torch.testing import experts
from imitation_tpu_torch.util.logger import configure
from tests.torch_parity import (
    assert_params_close, feed, host, jax_disc_indices, jax_epoch_perms, nudge_, on_policy_aux,
    param_tolerance, random_chunk, snapshot, update_floors,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
ENVS = ("CartPole-v1", "Pendulum-v1")


def _arrays(env_id, n, seed):
    """``n`` transitions shaped like ``env_id``'s, as numpy arrays."""
    rng = np.random.default_rng(seed)
    obs_dim = 3 if env_id == "Pendulum-v1" else 4
    if env_id == "Pendulum-v1":
        acts = rng.uniform(-2.0, 2.0, (n, 1)).astype(np.float32)
    else:
        acts = rng.integers(0, 2, n).astype(np.int32)
    return dict(
        obs=rng.normal(scale=0.5, size=(n, obs_dim)).astype(np.float32),
        acts=acts,
        next_obs=rng.normal(scale=0.5, size=(n, obs_dim)).astype(np.float32),
        dones=(rng.random(n) < 0.1).astype(np.float32),
        rews=np.zeros(n, np.float32),
    )


def _transitions(env_id, n, seed):
    arrays = _arrays(env_id, n, seed)
    return (JaxBatch(**{k: jax.numpy.asarray(v) for k, v in arrays.items()}),
            TransitionBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


def _trainers(tmp_path, env_id, *, normalize=False, demo_batch_size=64, minibatch=None,
              n_demo=300, n_steps=16, num_envs=8, n_epochs=2):
    """The JAX AIRL trainer (its generator state initialised), and a maker of
    port trainers that start from its reward net's and its policy's weights."""
    jdemo, tdemo = _transitions(env_id, n_demo, seed=1)
    ppo_kw = dict(n_steps=n_steps, n_minibatches=4, n_epochs=n_epochs, learning_rate=1e-3)
    common = dict(demo_batch_size=demo_batch_size, demo_minibatch_size=minibatch,
                  n_disc_updates_per_round=2, allow_variable_horizon=True, seed=0)
    jvenv = jax_make_vec_env(env_id, num_envs=num_envs)
    jtr = JaxAIRL(
        demonstrations=jdemo, venv=jvenv, gen_config=JaxPPOConfig(**ppo_kw),
        reward_net=JaxShapedNet(jvenv.observation_space, jvenv.action_space,
                                normalize_input=normalize),
        custom_logger=jax_configure(str(tmp_path), format_strs=[]), **common,
    )
    jtr.gen_state = jtr.gen_algo.init_state()
    jreward = host(jtr.disc_state.variables)
    jpolicy = host(jtr.gen_state.variables)

    def port_trainer():
        venv = make_vec_env(env_id, num_envs=num_envs, device="cpu")
        tr = AIRL(
            demonstrations=tdemo, venv=venv, gen_config=PPOConfig(**ppo_kw),
            reward_net=BasicShapedRewardNet(venv.observation_space, venv.action_space,
                                            normalize_input=normalize),
            custom_logger=configure(format_strs=()), **common,
        )
        tr.reward_net.load_state_dict(convert.reward_net_state_dict(jreward))
        tr.warm_start_generator(convert.policy_state_dict(jpolicy))
        return tr

    return jtr, port_trainer


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("env_id", ENVS)
def test_shaped_reward_net_matches_jax(env_id, normalize):
    jvenv = jax_make_vec_env(env_id, num_envs=2)
    jnet = JaxShapedNet(jvenv.observation_space, jvenv.action_space, normalize_input=normalize)
    variables = jnet.init_variables(jax.random.key(4))
    venv = make_vec_env(env_id, num_envs=2, device="cpu")
    net = BasicShapedRewardNet(venv.observation_space, venv.action_space, normalize_input=normalize)
    state_dict = convert.reward_net_state_dict(host(variables))
    assert sorted(state_dict) == sorted(net.state_dict())
    assert any(k.startswith("potential.mlp.") for k in state_dict)
    net.load_state_dict(state_dict)
    assert net.base.mlp.hid_sizes == (32,) and net.potential.mlp.hid_sizes == (32, 32)
    arrays = _arrays(env_id, 40, seed=6)
    args = [arrays[k] for k in ("obs", "acts", "next_obs", "dones")]
    targs = [torch.from_numpy(a) for a in args]
    jargs = [jax.numpy.asarray(a) for a in args]
    with torch.no_grad():
        np.testing.assert_allclose(net(*targs).numpy(), np.asarray(jnet.apply(variables, *jargs)), **TOL)
        np.testing.assert_allclose(net.base_forward(*targs).numpy(),
                                   np.asarray(jnet.apply(variables, *jargs, method="base_forward")),
                                   **TOL)
        np.testing.assert_allclose(net.predict_processed(*targs).numpy(),
                                   np.asarray(jnet.apply(variables, *jargs, method="predict_processed")),
                                   **TOL)
    if normalize:
        # update_stats reaches the base's normalizer (the potential has none).
        _, mutated = jnet.apply(variables, *jargs, update_stats=True, mutable=["stats"])
        with torch.no_grad():
            net(*targs, update_stats=True)
        want = host(mutated["stats"])["base"]["input_norm"]
        np.testing.assert_allclose(net.base.input_norm.running_mean.numpy(), want["running_mean"], **TOL)
        np.testing.assert_allclose(net.base.input_norm.running_var.numpy(), want["running_var"], **TOL)
        assert int(net.base.input_norm.count) == int(want["count"]) == 40


@pytest.mark.parametrize("env_id", ENVS)
def test_airl_logits_and_rewards_match_jax(tmp_path, env_id):
    jtr, port_trainer = _trainers(tmp_path, env_id)
    tr = port_trainer()
    arrays = _arrays(env_id, 32, seed=9)
    lp = np.random.default_rng(10).normal(size=32).astype(np.float32)
    args = [arrays[k] for k in ("obs", "acts", "next_obs", "dones")]
    targs = [torch.from_numpy(a) for a in args]
    jargs = [jax.numpy.asarray(a) for a in args]
    jvars = jtr.disc_state.variables
    assert jtr.needs_policy_log_prob and tr.needs_policy_log_prob
    assert not GAIL.needs_policy_log_prob.fget(tr)
    with torch.no_grad():
        logits = tr.logits_expert_is_high(tr.reward_net, *targs, torch.from_numpy(lp))
        train = tr.reward_train_fn()(tr.reward_net, *targs)
        test = tr.reward_test_fn()(tr.reward_net, *targs)
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(jtr.logits_expert_is_high(jvars, *jargs, jax.numpy.asarray(lp))), **TOL)
    np.testing.assert_allclose(train.numpy(), np.asarray(jtr.reward_train_fn()(jvars, *jargs)), **TOL)
    np.testing.assert_allclose(test.numpy(), np.asarray(jtr.reward_test_fn()(jvars, *jargs)), **TOL)
    np.testing.assert_allclose(logits.numpy(), train.numpy() - lp, rtol=1e-6, atol=1e-6)
    assert not np.allclose(test.numpy(), train.numpy())  # the test reward strips the shaping


def test_airl_requires_the_log_prob(tmp_path):
    jtr, port_trainer = _trainers(tmp_path, "Pendulum-v1")
    tr = port_trainer()
    targs = [torch.from_numpy(v) for k, v in _arrays("Pendulum-v1", 4, 0).items() if k != "rews"]
    with pytest.raises(TypeError, match="log_policy_act_prob"):
        tr.logits_expert_is_high(tr.reward_net, *targs)
    with pytest.raises(TypeError, match="log_policy_act_prob"):
        jtr.logits_expert_is_high(jtr.disc_state.variables, *(jax.numpy.asarray(t.numpy()) for t in targs))


def test_reward_test_fn_of_an_unshaped_net_is_the_train_fn():
    from imitation_tpu_torch.rewards.reward_nets import BasicRewardNet

    venv = make_vec_env("CartPole-v1", num_envs=2, device="cpu")
    _, tdemo = _transitions("CartPole-v1", 64, seed=1)
    tr = AIRL(demonstrations=tdemo, demo_batch_size=16, venv=venv,
              reward_net=BasicRewardNet(venv.observation_space, venv.action_space),
              gen_config=PPOConfig(n_steps=4, n_minibatches=2), custom_logger=configure(format_strs=()))
    assert not isinstance(tr.reward_net, ShapedRewardNet)
    targs = [torch.from_numpy(v) for k, v in _arrays("CartPole-v1", 8, 0).items() if k != "rews"]
    with torch.no_grad():
        assert torch.equal(tr.reward_test_fn()(tr.reward_net, *targs),
                           tr.reward_train_fn()(tr.reward_net, *targs))
    gail = GAIL(demonstrations=tdemo, demo_batch_size=16, venv=venv,
                gen_config=PPOConfig(n_steps=4, n_minibatches=2), custom_logger=configure(format_strs=()))
    with torch.no_grad():
        assert torch.equal(gail.reward_test_fn()(gail.reward_net, *targs),
                           gail.reward_train_fn()(gail.reward_net, *targs))


@pytest.mark.parametrize("minibatch", [None, 16])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("env_id", ENVS)
def test_disc_step_matches_jax(tmp_path, monkeypatch, env_id, normalize, minibatch):
    B, n_demo, n_gen = 64, 300, 128
    jtr, port_trainer = _trainers(tmp_path, env_id, normalize=normalize, minibatch=minibatch,
                                  n_demo=n_demo)
    jgen, tgen = _transitions(env_id, n_gen, seed=2)
    jbuf = jtr._gen_replay_buffer.store(jtr._gen_replay_buffer.init_state(jgen), jgen)
    jds, jstats = jtr._disc_step(jtr.disc_state, jbuf, jtr.gen_state.variables, jtr._demo_store.batch)

    def port(rel):
        tr = port_trainer()
        nudge_([tr.reward_net], rel)
        buf = tr._gen_replay_buffer.store(tr._gen_replay_buffer.init_state(tgen), tgen)
        indices = feed(jax_disc_indices(jtr.disc_state.key, 1, B, n_demo, n_gen))
        monkeypatch.setattr(torch_common, "_disc_indices", indices)
        init = snapshot(tr.reward_net)
        policy_before = {k: v.clone() for k, v in tr.policy.state_dict().items()}
        ds, stats = tr._disc_step(tr.disc_state, buf, tr.policy, tr._demo_store.batch)
        assert indices.remaining == [] and ds.step == 1
        # log pi(a|s) takes no gradient into the policy and folds no stats.
        assert all(torch.equal(v, tr.policy.state_dict()[k]) for k, v in policy_before.items())
        assert all(p.grad is None for p in tr.policy.parameters())
        return tr, stats, init

    tr, stats, _ = port(0.0)
    assert sorted(stats) == sorted(jstats)
    for k, v in jstats.items():
        np.testing.assert_allclose(float(stats[k]), float(v), **TOL, err_msg=k)

    def port_updates(rel):
        nudged, _, init = port(rel)
        return {"disc": (init, snapshot(nudged.reward_net))}

    floor = update_floors(port_updates)["disc"]
    assert_params_close(tr.reward_net, jds.variables["params"],
                        jtr.disc_state.variables["params"], "", param_tolerance(floor))
    if normalize:
        want = host(jds.variables["stats"])["base"]["input_norm"]
        np.testing.assert_allclose(tr.reward_net.base.input_norm.running_mean.numpy(),
                                   want["running_mean"], **TOL)
        np.testing.assert_allclose(tr.reward_net.base.input_norm.running_var.numpy(),
                                   want["running_var"], **TOL)


def _fixed_chunk(jtr, T, Bv, env_id):
    shape = dict(obs_dim=3, act_dim=1) if env_id == "Pendulum-v1" else {}
    return on_policy_aux(jtr.policy, jtr.gen_state.variables, *random_chunk(T, Bv, seed=3, **shape))


def test_airl_round_matches_jax(tmp_path, monkeypatch):
    """One AIRL round on Pendulum through ``train``: relabel by the shaped
    net, GAE, PPO, buffer store, and two disc steps with log pi(a|s)."""
    T, Bv, n_demo, B = 16, 8, 300, 64
    env_id = "Pendulum-v1"
    jtr, port_trainer = _trainers(tmp_path, env_id, n_steps=T, num_envs=Bv, n_demo=n_demo)
    jchunk, tchunk = _fixed_chunk(jtr, T, Bv, env_id)
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
        nudge_([tr.policy, tr.reward_net], rel)
        perms = feed(jax_epoch_perms(k_proc, 2, T * Bv))
        indices = feed(jax_disc_indices(disc_key, 2, B, n_demo, T * Bv))
        monkeypatch.setattr(torch_ppo_mod, "_epoch_permutation", perms)
        monkeypatch.setattr(torch_common, "_disc_indices", indices)
        init = {"policy": snapshot(tr.policy), "disc": snapshot(tr.reward_net)}
        tr.train(T * Bv)
        assert perms.remaining == [] and indices.remaining == []
        assert tr._gen_buffer_state.size == T * Bv and tr.disc_state.step == 2
        assert tr._gen_buffer_state.data.acts.shape == (T * Bv, 1)
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


def _recorded(logger):
    """Wraps ``logger.record`` to keep what it is given."""
    rows = {}
    record = logger.record

    def wrapped(key, value, *args, **kwargs):
        rows[key] = value
        return record(key, value, *args, **kwargs)

    logger.record = wrapped
    return rows


@pytest.mark.parametrize("env_id", ENVS)
def test_train_fused_matches_jax(tmp_path, monkeypatch, env_id):
    """Two rounds of ``train_fused(rounds_per_sync=2)``: one host read, the
    replay ring sized from ``_example_transitions``."""
    T, Bv, n_demo, B, rounds = 16, 8, 300, 64, 2
    jtr, port_trainer = _trainers(tmp_path, env_id, n_steps=T, num_envs=Bv, n_demo=n_demo)
    jchunk, tchunk = _fixed_chunk(jtr, T, Bv, env_id)
    # train_fused donates its carry, so everything read from the initial
    # states is taken before it runs.
    jgen0 = host(jtr.gen_state.variables["params"])
    jdisc0 = host(jtr.disc_state.variables["params"])
    # Round 1's train_step splits the state's key; process_chunk's own split
    # of k_proc gives the key that round 2's train_step splits (ppo.py).
    _, _, k_proc1 = jax.random.split(jtr.gen_state.key, 3)
    _, _, k_proc2 = jax.random.split(jax.random.split(k_proc1)[0], 3)
    jperms = jax_epoch_perms(k_proc1, 2, T * Bv) + jax_epoch_perms(k_proc2, 2, T * Bv)
    jindices = jax_disc_indices(jtr.disc_state.key, 2 * rounds, B, n_demo, T * Bv)
    monkeypatch.setattr(jax_rollout, "collect", lambda venv, fn, params, state, n, key: (state, jchunk))
    jrows = _recorded(jtr.logger)
    jtr.train_fused(rounds * T * Bv, rounds_per_sync=rounds)
    monkeypatch.setattr(torch_ppo_mod.rollout_mod, "collect",
                        lambda venv, fn, state, n, generator: (state, tchunk))

    def port(rel):
        tr = port_trainer()
        nudge_([tr.policy, tr.reward_net], rel)
        perms = feed(jperms)
        indices = feed(jindices)
        monkeypatch.setattr(torch_ppo_mod, "_epoch_permutation", perms)
        monkeypatch.setattr(torch_common, "_disc_indices", indices)
        init = {"policy": snapshot(tr.policy), "disc": snapshot(tr.reward_net)}
        rows = _recorded(tr.logger)
        tr.train_fused(rounds * T * Bv, rounds_per_sync=rounds)
        assert perms.remaining == [] and indices.remaining == []
        assert tr._gen_buffer_state.size == T * Bv and tr.disc_state.step == 2 * rounds
        assert tr.gen_state.timesteps == rounds * T * Bv and tr._global_step == rounds
        return tr, init, rows

    tr, _, rows = port(0.0)
    assert sorted(rows) == sorted(jrows)
    for k in ("mean/disc/disc_loss", "mean/disc/disc_acc", "mean/gen/loss",
              "mean/gen/relabeled_rew_mean", "mean/gen/value_loss"):
        np.testing.assert_allclose(rows[k], jrows[k], rtol=1e-4, atol=1e-5, err_msg=k)

    def port_updates(rel):
        nudged, init, _ = port(rel)
        return {"policy": (init["policy"], snapshot(nudged.policy)),
                "disc": (init["disc"], snapshot(nudged.reward_net))}

    floors = update_floors(port_updates)
    assert_params_close(tr.policy, jtr.gen_state.variables["params"], jgen0, "net.",
                        param_tolerance(floors["policy"]))
    assert_params_close(tr.reward_net, jtr.disc_state.variables["params"], jdisc0, "",
                        param_tolerance(floors["disc"]))


def test_airl_train_and_train_fused_smoke_cpu():
    demo_venv = make_vec_env("Pendulum-v1", num_envs=4, device="cpu")
    demos = experts.generate_expert_trajectories("Pendulum-v1", demo_venv, min_episodes=4, seed=0)
    venv = make_vec_env("Pendulum-v1", num_envs=8, device="cpu")
    tr = AIRL(demonstrations=demos, demo_batch_size=32, venv=venv,
              gen_config=PPOConfig(n_steps=16, n_minibatches=4, n_epochs=2),
              custom_logger=configure(format_strs=()), seed=0)
    assert isinstance(tr.reward_net, ShapedRewardNet)
    with pytest.raises(ValueError, match="No updates"):
        tr.train_fused(10)
    tr.train(2 * 128)
    tr.train_fused(3 * 128, rounds_per_sync=2)
    assert tr.gen_state.timesteps == 5 * 128 and tr.disc_state.step == 10 and tr._global_step == 5
    params = list(tr.policy.parameters()) + list(tr.reward_net.parameters())
    assert all(torch.isfinite(p).all() for p in params)
