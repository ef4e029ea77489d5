"""SAC and SquashedGaussian in imitation_tpu_torch against the JAX package.

Weights are the JAX package's, carried across with ``convert``. The random
draws are the JAX package's own, recomputed from its keys
(``tests.torch_parity.jax_sac_draws``) and fed to the port: the squashed
Gaussian's noise through ``models.distributions._standard_normal`` (the
collect's, then each update's next-action and policy noise) and the replay
indices through ``data.buffer._uniform_indices``. Both step from the same
initial Pendulum states (``inject_resets``); no episode ends in these
steps.

Tolerances: distribution and network outputs 1e-5 (the same float32
forward); parameters 1e-5 of the largest parameter update, raised where
needed to 4x the case's own float32 floor (``tests.torch_parity.
update_floors``), for the actor, the critic, the target critic and
``log_alpha`` alike; metrics 1e-4 (from gradient step two on they ride on
updated weights).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imitation_tpu_torch.data.buffer as torch_buffer
import imitation_tpu_torch.models.distributions as torch_dist
from imitation_tpu.envs import make_vec_env as jax_make_vec_env
from imitation_tpu.models.distributions import SquashedGaussian as JaxSquashed
from imitation_tpu.rl.sac import SAC as JaxSAC
from imitation_tpu.rl.sac import SACActor as JaxActor
from imitation_tpu.rl.sac import SACConfig as JaxSACConfig
from imitation_tpu.rl.sac import SACCritic as JaxCritic
from imitation_tpu_torch import convert
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.models.distributions import SquashedGaussian
from imitation_tpu_torch.rl.sac import SAC, SACActor, SACConfig, SACCritic
from tests.torch_parity import (
    feed, feed_arrays, host, inject_resets, jax_sac_draws, param_tolerance, update_floors,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
NUM_ENVS, TRAIN_FREQ, BATCH = 4, 4, 16
SMALL = dict(buffer_size=512, batch_size=BATCH, train_freq=TRAIN_FREQ, learning_rate=1e-3,
             actor_hid_sizes=(32, 32), critic_hid_sizes=(32, 32))


def _gaussian(n, d, seed):
    rng = np.random.default_rng(seed)
    mean = rng.normal(scale=1.5, size=(n, d)).astype(np.float32)
    log_std = rng.uniform(-2.0, 1.0, (n, d)).astype(np.float32)
    return mean, log_std


def test_squashed_gaussian_matches_jax(monkeypatch):
    mean, log_std = _gaussian(64, 2, seed=0)
    jd = JaxSquashed(mean=jnp.asarray(mean), log_std=jnp.asarray(log_std))
    td = SquashedGaussian(mean=torch.from_numpy(mean), log_std=torch.from_numpy(log_std))
    key = jax.random.key(3)
    jact, jlp = jd.sample_and_log_prob(key)
    noise = jax.random.normal(key, mean.shape)
    monkeypatch.setattr(torch_dist, "_standard_normal", feed_arrays([noise, noise]))
    act, lp = td.sample_and_log_prob(torch.Generator())
    np.testing.assert_allclose(act.numpy(), np.asarray(jact), **TOL)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), **TOL)
    np.testing.assert_allclose(td.sample(torch.Generator()).numpy(), np.asarray(jd.sample(key)), **TOL)
    np.testing.assert_allclose(td.mode().numpy(), np.asarray(jd.mode()), **TOL)
    # log_prob, actions at the clip included (+-1 and beyond are clipped to 1 - 1e-6).
    acts = np.random.default_rng(1).uniform(-0.999, 0.999, mean.shape).astype(np.float32)
    acts[:4] = [[1.0, -1.0], [1.5, -2.0], [0.9999999, -0.9999999], [0.0, 0.0]]
    np.testing.assert_allclose(td.log_prob(torch.from_numpy(acts)).numpy(),
                               np.asarray(jd.log_prob(jnp.asarray(acts))), **TOL)
    # The sample's log-prob is log_prob of the sample where the tanh is not saturated.
    inside = np.abs(act.numpy()).max(-1) < 0.99
    np.testing.assert_allclose(td.log_prob(act).numpy()[inside], lp.numpy()[inside], rtol=1e-4, atol=1e-4)


def test_actor_and_critic_match_jax():
    obs = np.random.default_rng(2).normal(size=(40, 3)).astype(np.float32)
    acts = np.random.default_rng(3).uniform(-2, 2, (40, 1)).astype(np.float32)
    jactor, jcritic = JaxActor(1, (32, 32)), JaxCritic((32, 32))
    aparams = jactor.init(jax.random.key(0), jnp.asarray(obs))
    cparams = jcritic.init(jax.random.key(1), jnp.asarray(obs), jnp.asarray(acts))
    # Scale the log_std head so the clip at [-20, 2] is reached.
    aparams = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 400.0 if "log_std" in jax.tree_util.keystr(path) else x, aparams)
    actor, critic = SACActor(3, 1, (32, 32)), SACCritic(3, 1, (32, 32))
    actor.load_state_dict(convert.sac_actor_state_dict(host(aparams)))
    critic.load_state_dict(convert.sac_critic_state_dict(host(cparams)))
    assert sorted(actor.state_dict()) == sorted(convert.sac_actor_state_dict(host(aparams)))
    assert "q1_out.weight" in critic.state_dict()
    jd = jactor.apply(aparams, jnp.asarray(obs))
    with torch.no_grad():
        d = actor(torch.from_numpy(obs))
        qs = critic(torch.from_numpy(obs), torch.from_numpy(acts))
    np.testing.assert_allclose(d.mean.numpy(), np.asarray(jd.mean), **TOL)
    np.testing.assert_allclose(d.log_std.numpy(), np.asarray(jd.log_std), **TOL)
    assert d.log_std.max() == 2.0 and d.log_std.min() == -20.0
    assert qs.shape == (2, 40)
    np.testing.assert_allclose(qs.numpy(), np.asarray(jcritic.apply(cparams, jnp.asarray(obs), jnp.asarray(acts))),
                               **TOL)


def _pair(**kw):
    """A JAX SAC on Pendulum-v1 with its initial state, and a port SAC of the
    same config (its ``init_state`` still to be called)."""
    cfg = dict(SMALL, **kw)
    jvenv = jax_make_vec_env("Pendulum-v1", num_envs=NUM_ENVS)
    jsac = JaxSAC(jvenv, JaxSACConfig(**cfg), seed=0)
    venv = make_vec_env("Pendulum-v1", num_envs=NUM_ENVS, device="cpu")
    return jsac, jsac.init_state(), SAC(venv, SACConfig(**cfg), seed=0)


def _load(sac, state, jstate):
    """The JAX state's weights and temperature into the port's modules."""
    sac.actor.load_state_dict(convert.sac_actor_state_dict({"params": host(jstate.actor_params)}))
    sac.critic.load_state_dict(convert.sac_critic_state_dict({"params": host(jstate.critic_params)}))
    sac.target_critic.load_state_dict(
        convert.sac_critic_state_dict({"params": host(jstate.target_critic_params)}))
    with torch.no_grad():
        sac.log_alpha.fill_(float(jstate.log_alpha))
    return state


def _params(sac):
    """{label: {name: numpy}} of everything a SAC step updates."""
    out = {label: {k: v.detach().clone().numpy() for k, v in m.named_parameters()}
           for label, m in (("actor", sac.actor), ("critic", sac.critic))}
    out["target"] = {k: v.clone().numpy() for k, v in sac.target_critic.state_dict().items()}
    out["alpha"] = {"log_alpha": sac.log_alpha.detach().clone().numpy()}
    return out


def _jax_params(jstate):
    flat = lambda tree: {k: v.numpy() for k, v in convert.flax_to_state_dict({"params": host(tree)}).items()}
    return {"actor": flat(jstate.actor_params), "critic": flat(jstate.critic_params),
            "target": flat(jstate.target_critic_params),
            "alpha": {"log_alpha": np.asarray(jstate.log_alpha)}}


def _nudge(params, rel):
    return {label: {k: v * np.float32(1 + rel) for k, v in p.items()} for label, p in params.items()}


def _set(sac, params):
    with torch.no_grad():
        for label, m in (("actor", sac.actor), ("critic", sac.critic)):
            for k, v in m.named_parameters():
                v.copy_(torch.from_numpy(params[label][k]))
        for k, v in sac.target_critic.state_dict().items():
            v.copy_(torch.from_numpy(params["target"][k]))
        sac.log_alpha.fill_(float(params["alpha"]["log_alpha"]))


def _run_port(monkeypatch, jsac, jstate, steps, make_sac, sizes, n_expert=None,
              reward_params=None):
    """Runs ``steps`` port train steps from the JAX state's weights (nudged
    by ``rel``) with the JAX draws fed in; returns a ``run(rel)`` for
    ``update_floors`` and, by ``rel``, the port's SAC, state and metrics."""
    cfg = jsac.config
    feeds, key = [], jstate.key
    for step in range(steps):
        noise, replay_idx, expert_idx, key = jax_sac_draws(
            key, train_freq=cfg.train_freq, num_envs=NUM_ENVS, act_dim=1,
            gradient_steps=cfg.gradient_steps, batch=cfg.batch_size, size=sizes[step],
            n_expert=n_expert)
        feeds.append((noise, replay_idx, expert_idx))
    x0 = np.asarray(jstate.env_state.env_state.x)
    runs = {}

    def run(rel):
        sac = make_sac()
        inject_resets(monkeypatch, sac.venv, x0)
        state = sac.init_state()
        _load(sac, state, jstate)
        init = _nudge(_params(sac), rel)
        _set(sac, init)
        noise = feed_arrays([n for f in feeds for n in f[0]])
        idx = feed([i for f in feeds for i in f[1]])
        monkeypatch.setattr(torch_dist, "_standard_normal", noise)
        monkeypatch.setattr(torch_buffer, "_uniform_indices", idx)
        if n_expert is not None:
            import imitation_tpu_torch.algorithms.sqil as torch_sqil

            monkeypatch.setattr(torch_sqil, "_expert_indices",
                                feed([i for f in feeds for i in f[2]]))
        metrics = []
        for _ in range(steps):
            state, m = sac.train_step(state, reward_params)[:2]
            metrics.append(m)
        assert noise.remaining == [] and idx.remaining == []
        runs[rel] = (sac, state, metrics)
        final = _params(sac)
        return {label: (init[label], final[label]) for label in init}

    return run, runs


def _assert_matches(sac, jstate, jinit, floors):
    got, want, init = _params(sac), _jax_params(jstate), jinit
    for label in got:
        upd = max(np.abs(want[label][k] - init[label][k]).max() for k in want[label])
        assert upd > 0, label
        err = max(np.abs(got[label][k] - want[label][k]).max() for k in want[label])
        rel = param_tolerance(floors[label])
        assert err <= rel * upd, f"{label}: error {err:.3g} vs update {upd:.3g} (limit {rel:.3g})"


def _assert_metrics(metrics, jmetrics):
    m = {k: float(v) for k, v in metrics.items()}
    assert sorted(m) == sorted(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(m[k], float(v), **METRIC_TOL, err_msg=k)


@pytest.mark.parametrize("gradient_steps", [1, 4])
def test_train_step_matches_jax(monkeypatch, gradient_steps):
    """One train step that learns from the start: collect, store and
    ``gradient_steps`` updates (critic, actor, temperature, Polyak)."""
    jsac, jstate, _ = _pair(learning_starts=0, gradient_steps=gradient_steps)
    jinit = _jax_params(jstate)
    jnext, jmetrics = jax.jit(jsac.train_step)(jstate)
    rows = TRAIN_FREQ * NUM_ENVS
    make = lambda: _pair(learning_starts=0, gradient_steps=gradient_steps)[2]
    run, runs = _run_port(monkeypatch, jsac, jstate, 1, make, [rows])
    floors = update_floors(run)
    sac, state, metrics = runs[0.0]
    assert state.timesteps == rows and state.n_updates == gradient_steps
    assert state.buffer_state.size == rows and state.actor_opt.count == gradient_steps
    # The replay holds env-scaled actions (Pendulum's torque in [-2, 2]).
    acts = state.buffer_state.data.acts[:rows]
    np.testing.assert_allclose(acts.numpy(), np.asarray(jnext.buffer_state.data.acts[:rows]), **TOL)
    assert acts.abs().max() > 1.0
    _assert_matches(sac, jnext, jinit, floors)
    _assert_metrics(metrics[0], jmetrics)


def test_step_crossing_learning_starts_matches_jax(monkeypatch):
    """Step 1 stores 16 rows, under ``learning_starts``: its two updates are
    masked (the counts advance, nothing moves, the losses are reported).
    Step 2 learns; its first update's bias corrections count the masked
    ones."""
    kw = dict(learning_starts=20, gradient_steps=2)
    jsac, jstate, _ = _pair(**kw)
    jinit = _jax_params(jstate)
    step = jax.jit(jsac.train_step)
    j1, jm1 = step(jstate)
    j2, jm2 = step(j1)
    rows = TRAIN_FREQ * NUM_ENVS
    run, runs = _run_port(monkeypatch, jsac, jstate, 2, lambda: _pair(**kw)[2], [rows, 2 * rows])
    floors = update_floors(run)
    sac, state, metrics = runs[0.0]
    assert state.actor_opt.count == state.critic_opt.count == state.alpha_opt.count == 4
    assert int(j2.actor_opt[0].count) == 4
    _assert_matches(sac, j2, jinit, floors)
    _assert_metrics(metrics[0], jm1)
    _assert_metrics(metrics[1], jm2)


def test_fixed_ent_coef_matches_jax(monkeypatch):
    kw = dict(learning_starts=0, gradient_steps=2, ent_coef="0.1")
    jsac, jstate, _ = _pair(**kw)
    jinit = _jax_params(jstate)
    jnext, jmetrics = jax.jit(jsac.train_step)(jstate)
    run, runs = _run_port(monkeypatch, jsac, jstate, 1, lambda: _pair(**kw)[2], [TRAIN_FREQ * NUM_ENVS])
    floors = update_floors(lambda rel: {k: v for k, v in run(rel).items() if k != "alpha"})
    sac, state, metrics = runs[0.0]
    assert float(metrics[0]["alpha"]) == pytest.approx(0.1) and float(sac.log_alpha.detach()) == 0.0
    assert state.alpha_opt.count == 0  # the temperature is not stepped
    got = _params(sac)
    got.pop("alpha")
    want = _jax_params(jnext)
    assert float(want["alpha"]["log_alpha"]) == 0.0
    for label in got:
        upd = max(np.abs(want[label][k] - jinit[label][k]).max() for k in want[label])
        err = max(np.abs(got[label][k] - want[label][k]).max() for k in want[label])
        assert err <= param_tolerance(floors[label]) * upd, label
    _assert_metrics(metrics[0], jmetrics)


def test_relabel_fn_and_sample_hook_match_jax(monkeypatch):
    """A relabel function and a sample hook, the same on both sides: the
    hook is reached once per update and the relabelled rewards train the
    critic."""
    calls = {"jax": 0, "torch": 0}

    def jrelabel(params, batch):
        return batch.replace(rews=params * batch.obs[:, 0] - batch.acts[:, 0])

    def trelabel(params, batch):
        import dataclasses

        return dataclasses.replace(batch, rews=params * batch.obs[:, 0] - batch.acts[:, 0])

    def jhook(replay, buffer_state, key, batch_size):
        calls["jax"] += 1  # counted at trace time: once per traced update body
        return replay.sample(buffer_state, key, batch_size)

    def thook(replay, buffer_state, generator, batch_size):
        calls["torch"] += 1
        return replay.sample(buffer_state, batch_size, generator)

    cfg = dict(SMALL, learning_starts=0, gradient_steps=2)
    jvenv = jax_make_vec_env("Pendulum-v1", num_envs=NUM_ENVS)
    jsac = JaxSAC(jvenv, JaxSACConfig(**cfg), relabel_fn=jrelabel, sample_hook=jhook, seed=0)
    jstate = jsac.init_state()
    jinit = _jax_params(jstate)
    jnext, jmetrics = jsac.train_step(jstate, jnp.float32(3.0))

    def make():
        venv = make_vec_env("Pendulum-v1", num_envs=NUM_ENVS, device="cpu")
        return SAC(venv, SACConfig(**cfg), relabel_fn=trelabel, sample_hook=thook, seed=0)

    run, runs = _run_port(monkeypatch, jsac, jstate, 1, make, [TRAIN_FREQ * NUM_ENVS], reward_params=3.0)
    floors = update_floors(run)
    sac, _, metrics = runs[0.0]
    assert calls["torch"] == 2 * 4  # two updates in each of the 4 runs of the port
    assert calls["jax"] >= 1
    _assert_matches(sac, jnext, jinit, floors)
    _assert_metrics(metrics[0], jmetrics)


def test_log_prob_fn_matches_jax():
    """log pi(a|s) of env-scaled actions, with the rescale's Jacobian."""
    jsac, jstate, sac = _pair()
    sac.init_state()
    sac.actor.load_state_dict(convert.sac_actor_state_dict({"params": host(jstate.actor_params)}))
    rng = np.random.default_rng(5)
    obs = rng.normal(size=(32, 3)).astype(np.float32)
    acts = rng.uniform(-2.0, 2.0, (32, 1)).astype(np.float32)
    acts[:2] = [[2.0], [-2.0]]  # the bounds: clipped inside (-1, 1) after the rescale
    want = jsac.log_prob_fn()({"params": jstate.actor_params}, jnp.asarray(obs), jnp.asarray(acts))
    with torch.no_grad():
        got = sac.log_prob_fn()(torch.from_numpy(obs), torch.from_numpy(acts))
        plain = sac.actor(torch.from_numpy(obs)).log_prob(torch.from_numpy(acts / 2.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy() - np.log(2.0), rtol=1e-5, atol=1e-5)


def test_policy_fns_match_jax(monkeypatch):
    """``SACPolicy``'s env-scaled rollout closures against JAX's."""
    jsac, jstate, sac = _pair()
    sac.init_state()
    sac.actor.load_state_dict(convert.sac_actor_state_dict({"params": host(jstate.actor_params)}))
    obs = np.random.default_rng(6).normal(size=(24, 3)).astype(np.float32)
    jvars = {"params": jstate.actor_params}
    key = jax.random.key(7)
    jacts, jaux = jsac.policy.sample_fn()(jvars, jnp.asarray(obs), key)
    monkeypatch.setattr(torch_dist, "_standard_normal", feed_arrays([jax.random.normal(key, (24, 1))]))
    acts, aux = sac.policy.sample_fn()(torch.from_numpy(obs), torch.Generator())
    np.testing.assert_allclose(acts.numpy(), np.asarray(jacts), **TOL)
    np.testing.assert_allclose(aux["log_prob"].numpy(), np.asarray(jaux["log_prob"]), **TOL)
    det, _ = sac.policy.deterministic_fn()(torch.from_numpy(obs))
    np.testing.assert_allclose(det.numpy(), np.asarray(jsac.policy.deterministic_fn()(jvars, jnp.asarray(obs), key)[0]),
                               **TOL)
    assert det.shape == (24, 1) and det.abs().max() <= 2.0


def test_learn_and_logging_cpu():
    """``learn`` runs ceil(total / (train_freq * num_envs)) steps and reads
    metrics only to log them."""
    from imitation_tpu_torch.util.logger import configure

    venv = make_vec_env("Pendulum-v1", num_envs=NUM_ENVS, device="cpu")
    sac = SAC(venv, SACConfig(**dict(SMALL, learning_starts=32, gradient_steps=2)), seed=1)
    state = sac.init_state()
    seen = []
    logger = configure(format_strs=())
    state = sac.learn(state, 100, callback=lambda s, m: seen.append(m), logger=logger, log_every=2)
    assert len(seen) == 7 and state.timesteps == 112 and state.n_updates == 14
    assert all(isinstance(v, torch.Tensor) for v in seen[-1].values())
    assert all(np.isfinite(float(m["critic_loss"])) for m in seen)
    assert state.actor_opt.count == 14
    params = list(sac.actor.parameters()) + list(sac.critic.parameters())
    assert all(torch.isfinite(p).all() for p in params)


def test_sac_refuses_discrete_envs_and_host_overlap():
    with pytest.raises(ValueError, match="continuous"):
        SAC(make_vec_env("CartPole-v1", num_envs=2, device="cpu"), SACConfig(**SMALL))
    with pytest.raises(ValueError, match="continuous"):
        JaxSAC(jax_make_vec_env("CartPole-v1", num_envs=2), JaxSACConfig(**SMALL))
    with pytest.raises(NotImplementedError, match="host"):
        SAC(make_vec_env("Pendulum-v1", num_envs=2, device="cpu"),
            SACConfig(**dict(SMALL, overlap_collection=True)))


def test_state_variables_alias_and_rebind():
    _, _, sac = _pair()
    state = sac.init_state()
    assert state.variables is sac.actor is sac.policy.actor
    sac.rebind()  # a no-op kept for callers
    assert state.target_critic is not state.critic
    for (k, a), b in zip(sac.critic.state_dict().items(), sac.target_critic.state_dict().values()):
        assert torch.equal(a, b), k
