"""PPO.process_chunk in imitation_tpu_torch against the JAX package.

Both learners start from the same weights (carried across with ``convert``)
and process the same [T, B] chunk, relabelled by the same reward net. The
epoch permutations are the JAX package's own, recomputed from its key
(imitation_tpu/rl/ppo.py: ``key, k_perm = split(key)`` and one
``permutation`` per epoch key) and fed to the port through its
``_epoch_permutation`` helper.

Tolerances:
* relabelled rewards: 1e-5, the same float32 forward;
* advantages and returns: 1e-4, as in tests/rl/test_gae_pallas.py (the JAX
  package sums GAE with an associative scan, the port sequentially);
* parameters after the epochs: 1e-5 of the largest parameter update
  (``PARAM_REL``), raised where needed to 4x the case's own float32 floor,
  measured in the test by ``tests.torch_parity.update_floors``: how far the
  port's own update moves when its initial weights are nudged by about one
  ulp. Adam divides each coordinate's step by its own running gradient
  scale, so where a coordinate's moments nearly cancel, last-bit
  differences of the gradients (the two frameworks sum matrix products in
  another order) move its step by far more than an ulp; and a parameter of
  size 0.5 has an ulp of 6e-8, already 3e-5 of a 2e-3 update. The floors
  run from about 5e-6 to 2e-4 of the update across these cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import imitation_tpu.rl.ppo as jax_ppo_mod
import imitation_tpu_torch.rl.ppo as torch_ppo_mod
from imitation_tpu.envs import make_vec_env as jax_make_vec_env
from imitation_tpu.models.policies import ActorCriticPolicy as JaxPolicy
from imitation_tpu.rewards.reward_nets import BasicRewardNet as JaxRewardNet
from imitation_tpu_torch import convert
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.rewards.reward_nets import BasicRewardNet
from tests.torch_parity import (
    FLOOR_NUDGES, assert_params_close, feed, host, jax_epoch_perms, nudge_, on_policy_aux, param_tolerance,
    random_chunk, snapshot, update_floors,
)

torch.set_num_threads(1)


def _recording(fn, sink):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        sink.append((args, out))
        return out

    return wrapped


OPTIONS = {
    "defaults": {},
    "vf-clip+reward-norm+target-kl": dict(clip_range_vf=0.2, normalize_rewards=True, target_kl=0.005),
}


@pytest.mark.parametrize("normalize_features", [False, True])
@pytest.mark.parametrize("options", list(OPTIONS))
def test_process_chunk_matches_jax(monkeypatch, normalize_features, options):
    _process_chunk_case(monkeypatch, "CartPole-v1", normalize_features, OPTIONS[options])


@pytest.mark.parametrize("normalize_features", [False, True])
@pytest.mark.parametrize("options", ["defaults", "linear-lr"])
def test_process_chunk_continuous_matches_jax(monkeypatch, normalize_features, options):
    """Pendulum: [T, B, 1] float32 actions through DiagGaussian, and
    truncations that differ from terminations in GAE's flag panels."""
    extra = dict(lr_schedule="linear", total_updates_hint=2) if options == "linear-lr" else {}
    _process_chunk_case(monkeypatch, "Pendulum-v1", normalize_features, extra)


def _process_chunk_case(monkeypatch, env_id, normalize_features, options):
    T, B = 16, 8
    cfg_kw = dict(n_steps=T, n_minibatches=4, n_epochs=3, learning_rate=1e-3, ent_coef=0.01,
                  **options)
    jvenv = jax_make_vec_env(env_id, num_envs=B)
    jpolicy = JaxPolicy(jvenv.observation_space, jvenv.action_space,
                        normalize_features=normalize_features)
    jnet = JaxRewardNet(observation_space=jvenv.observation_space, action_space=jvenv.action_space)
    jreward = jnet.init_variables(jax.random.key(3))

    def jrew_fn(params, obs, acts, next_obs, dones):
        return jax.nn.softplus(jnet.apply(params, obs, acts, next_obs, dones))

    jppo = jax_ppo_mod.PPO(jvenv, jpolicy, jax_ppo_mod.PPOConfig(**cfg_kw), reward_fn=jrew_fn)
    jstate = jppo.init_state(jax.random.key(0))
    continuous = not jvenv.action_space.is_discrete
    shape = dict(obs_dim=3, act_dim=1) if continuous else {}
    jchunk, tchunk = on_policy_aux(jpolicy, jstate.variables, *random_chunk(T, B, seed=11, **shape))
    if continuous:
        assert (tchunk.terminated != tchunk.dones).any()  # truncations: the bootstrap path
    key = jax.random.key(5)

    jgae, tgae = [], []
    monkeypatch.setattr(jax_ppo_mod, "gae", _recording(jax_ppo_mod.gae, jgae))
    jnew, jmetrics = jppo.process_chunk(jstate, None, jchunk, key, jreward)
    monkeypatch.setattr(torch_ppo_mod, "gae", _recording(torch_ppo_mod.gae, tgae))

    def port(rel):
        venv = make_vec_env(env_id, num_envs=B, device="cpu")
        policy = ActorCriticPolicy(venv.observation_space, venv.action_space,
                                   normalize_features=normalize_features)
        net = BasicRewardNet(venv.observation_space, venv.action_space)
        net.load_state_dict(convert.reward_net_state_dict(host(jreward)))
        ppo = torch_ppo_mod.PPO(
            venv, policy, torch_ppo_mod.PPOConfig(**cfg_kw),
            reward_fn=lambda n, o, a, no, d: F.softplus(n(o, a, no, d)),
        )
        state = ppo.init_state()
        policy.load_state_dict(convert.policy_state_dict(host(jstate.variables)))
        nudge_([policy], rel)
        perms = feed(jax_epoch_perms(key, cfg_kw["n_epochs"], T * B))
        monkeypatch.setattr(torch_ppo_mod, "_epoch_permutation", perms)
        init = snapshot(policy)
        new, metrics = ppo.process_chunk(state, None, tchunk, torch.Generator(), net)
        assert perms.remaining == []
        return policy, new, metrics, init

    policy, new, metrics, _ = port(0.0)
    (jargs, (jadv, jret)), = jgae
    (targs, (adv, ret)), = tgae
    np.testing.assert_allclose(targs[0].numpy(), np.asarray(jargs[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), rtol=1e-4, atol=1e-4)

    def port_updates(rel):
        nudged, _, _, init = port(rel)
        return {"policy": (init, snapshot(nudged))}

    floor = update_floors(port_updates)["policy"]
    assert_params_close(policy, jnew.variables["params"], jstate.variables["params"], "net.",
                        param_tolerance(floor))
    if normalize_features:
        stats = host(jnew.variables["stats"])["feat_norm"]
        np.testing.assert_allclose(policy.net.feat_norm.running_mean.numpy(), stats["running_mean"], rtol=1e-5)
        np.testing.assert_allclose(policy.net.feat_norm.running_var.numpy(), stats["running_var"], rtol=1e-5)
    if cfg_kw.get("target_kl"):
        assert float(jmetrics["early_stop"]) == float(metrics["early_stop"]) == 1.0
    if cfg_kw.get("lr_schedule") == "linear":
        # 12 of the 24 scheduled updates done: the next one takes half the rate.
        assert new.optimizer.count == 12 and new.optimizer.learning_rate == pytest.approx(5e-4)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-3, atol=1e-5, err_msg=k)
    assert new.timesteps == T * B and new.n_updates == 1


def test_optimizer_matches_optax():
    """Clip-by-global-norm then Adam, step for step, against optax."""
    import optax

    from imitation_tpu_torch.rl.common import global_norm, make_optimizer

    rng = np.random.default_rng(0)
    params = [rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=(3,)).astype(np.float32)]
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(1e-2))
    jparams = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = make_optimizer(tparams, 1e-2, max_grad_norm=0.5)
    for step in range(6):
        scale = 0.1 if step % 2 else 3.0  # below and above the clip norm
        grads = [(rng.normal(size=p.shape) * scale).astype(np.float32) for p in params]
        updates, opt_state = tx.update([jnp.asarray(g) for g in grads], opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(tparams, grads):
            p.grad = torch.from_numpy(g)
        norm = opt.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
        np.testing.assert_allclose(float(norm), float(global_norm(torch.from_numpy(g) for g in grads)))
        for p, jp in zip(tparams, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)


def test_train_step_smoke_and_target_kl():
    venv = make_vec_env("CartPole-v1", num_envs=8, device="cpu")
    policy = ActorCriticPolicy(venv.observation_space, venv.action_space)
    cfg = torch_ppo_mod.PPOConfig(n_steps=16, n_minibatches=4, n_epochs=2, target_kl=1e-9,
                                  normalize_rewards=True)
    ppo = torch_ppo_mod.PPO(venv, policy, cfg, seed=1)
    state = ppo.init_state()
    before = [p.detach().clone() for p in policy.parameters()]
    state, metrics = ppo.train_step(state)
    assert state.timesteps == 128
    # The first minibatch sees the rollout policy (approx_kl ~ 0) and is
    # applied; a later one exceeds the tiny target and stops the iteration.
    assert float(metrics["early_stop"]) == 1.0
    assert all(np.isfinite(float(v)) or k.startswith("ep_") for k, v in metrics.items())
    assert any(not torch.equal(a, b) for a, b in zip(before, policy.parameters()))


def test_update_sensitivity_to_float32_noise():
    """The float32 floor that the parity tests measure is rounding alone.

    ``update_floors`` compares the port's update from its exact initial
    weights with updates from weights nudged by about one ulp. That is a
    measure of rounding only if the same weights give the same update bit
    for bit, which this checks, together with the nudge reaching the update.
    """
    T, B = 16, 8

    def run(rel):
        venv = make_vec_env("CartPole-v1", num_envs=B, device="cpu")
        policy = ActorCriticPolicy(venv.observation_space, venv.action_space,
                                   normalize_features=True)
        net = BasicRewardNet(venv.observation_space, venv.action_space)
        net.init(torch.Generator().manual_seed(1))
        ppo = torch_ppo_mod.PPO(
            venv, policy,
            torch_ppo_mod.PPOConfig(n_steps=T, n_minibatches=4, n_epochs=1,
                                    learning_rate=1e-3, ent_coef=0.01),
            reward_fn=lambda n, o, a, no, d: F.softplus(n(o, a, no, d)),
        )
        state = ppo.init_state(torch.Generator().manual_seed(0))
        _, chunk = random_chunk(T, B, seed=11)
        with torch.no_grad():
            dist, value = policy.dist_and_value(chunk.obs.reshape(T * B, -1))
            chunk = chunk.replace(aux=dict(
                log_prob=dist.log_prob(chunk.acts.reshape(-1)).reshape(T, B),
                value=value.reshape(T, B)))
        nudge_([policy], rel)
        init = snapshot(policy)
        ppo.process_chunk(state, None, chunk, torch.Generator().manual_seed(5), net)
        final = snapshot(policy)
        return {k: final[k] - init[k] for k in init}

    first, again, nudged = run(0.0), run(0.0), run(FLOOR_NUDGES[0])
    assert all(np.array_equal(first[k], again[k]) for k in first)
    assert any(not np.array_equal(first[k], nudged[k]) for k in first)


def test_linear_schedule_matches_optax():
    """The linear learning rate, value by value and inside Adam, against
    ``optax.linear_schedule``: the first update takes the full rate, the
    last of the horizon 1/n of it, and every later one 0."""
    import optax

    from imitation_tpu_torch.rl.common import linear_schedule, make_optimizer

    horizon = 5
    want = optax.linear_schedule(2e-2, 0.0, horizon)
    got = linear_schedule(2e-2, 0.0, horizon)
    for count in range(horizon + 3):
        assert got(count) == float(want(jnp.asarray(count, jnp.int32))), count
    assert got(0) == np.float32(2e-2) and got(horizon) == 0.0

    rng = np.random.default_rng(0)
    params = [rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=(3,)).astype(np.float32)]
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(want))
    jparams = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = make_optimizer(tparams, got, max_grad_norm=0.5)
    for step in range(horizon + 2):
        assert opt.learning_rate == got(step)
        grads = [(rng.normal(size=p.shape) * (0.1 if step % 2 else 3.0)).astype(np.float32)
                 for p in params]
        updates, opt_state = tx.update([jnp.asarray(g) for g in grads], opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        before = [p.detach().clone() for p in tparams]
        for p, g in zip(tparams, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        for p, jp in zip(tparams, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
        if step >= horizon:  # past the horizon the rate is 0: nothing moves
            assert all(torch.equal(a, b) for a, b in zip(before, tparams))


def test_ppo_config_fields_match_jax():
    import dataclasses

    fields = {f.name: f.default for f in dataclasses.fields(torch_ppo_mod.PPOConfig)}
    want = {f.name: f.default for f in dataclasses.fields(jax_ppo_mod.PPOConfig)}
    assert fields == want
    venv = make_vec_env("CartPole-v1", num_envs=4, device="cpu")
    policy = ActorCriticPolicy(venv.observation_space, venv.action_space)
    with pytest.raises(ValueError, match="lr_schedule"):
        torch_ppo_mod.PPO(venv, policy, torch_ppo_mod.PPOConfig(n_steps=4, n_minibatches=2,
                                                                lr_schedule="cosine"))
    # overlap_collection pipelines host envs, which the port lacks: refused, not ignored.
    with pytest.raises(NotImplementedError, match="overlap_collection"):
        torch_ppo_mod.PPO(venv, policy, torch_ppo_mod.PPOConfig(n_steps=4, n_minibatches=2,
                                                                overlap_collection=True))


def test_learn_runs_ceil_iterations_and_logs():
    venv = make_vec_env("Pendulum-v1", num_envs=4, device="cpu")
    policy = ActorCriticPolicy(venv.observation_space, venv.action_space)
    cfg = torch_ppo_mod.PPOConfig(n_steps=8, n_minibatches=2, n_epochs=2, lr_schedule="linear",
                                  total_updates_hint=4, learning_rate=1e-3)
    ppo = torch_ppo_mod.PPO(venv, policy, cfg, seed=0)
    from imitation_tpu_torch.util.logger import configure

    logger = configure(format_strs=())
    rows, seen = [], []
    logger.default_logger.output_formats.append(type("Capture", (), {
        "write": lambda self, kvs, step: rows.append((step, dict(kvs))), "close": lambda self: None})())
    state = ppo.learn(ppo.init_state(), 2 * 32 + 1, callback=lambda s, m: seen.append((s.timesteps, m)),
                      logger=logger)
    assert state.timesteps == 3 * 32 and state.n_updates == 3  # ceil(65 / 32) iterations
    assert [t for t, _ in seen] == [32, 64, 96] == [step for step, _ in rows]
    assert all(np.isfinite(row["rollout/loss"]) for _, row in rows)
    assert seen[0][1]["loss"] == rows[0][1]["rollout/loss"]
    # 3 of the 4 hinted train steps, 4 updates each: the rate is down to a quarter.
    assert state.optimizer.count == 12
    assert state.optimizer.learning_rate == pytest.approx(2.5e-4)
    state = ppo.learn(state, 1)  # at least one iteration, no host read
    assert state.timesteps == 4 * 32 and state.optimizer.learning_rate == 0.0
