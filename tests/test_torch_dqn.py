"""DQN in imitation_tpu_torch against the JAX package.

The Q-network's weights are the JAX package's, carried across with
``convert``. The random draws are the JAX package's own, recomputed from its
keys (``tests.torch_parity.jax_dqn_draws``) and fed to the port: each
epsilon-greedy step's uniforms and random actions through
``rl.dqn._explore_draws`` and the replay indices through
``data.buffer._uniform_indices``. Both step from the same initial CartPole
states (``inject_resets``); no episode ends in these steps.

Tolerances: Q-values 1e-5; epsilon exact against the JAX package's
``epsilon`` (both compute it in float32);
parameters 1e-5 of the largest parameter update, raised where needed to 4x
the case's own float32 floor (``tests.torch_parity.update_floors``), for
the Q-network and its target; metrics 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imitation_tpu_torch.data.buffer as torch_buffer
import imitation_tpu_torch.rl.dqn as torch_dqn
from imitation_tpu.envs import make_vec_env as jax_make_vec_env
from imitation_tpu.rl.dqn import DQN as JaxDQN
from imitation_tpu.rl.dqn import DQNConfig as JaxDQNConfig
from imitation_tpu_torch import convert
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.rl.dqn import DQN, DQNConfig
from tests.torch_parity import (
    feed, host, inject_resets, jax_dqn_draws, param_tolerance, update_floors,
)

torch.set_num_threads(1)

METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
NUM_ENVS, TRAIN_FREQ, BATCH = 4, 4, 16
ROWS = NUM_ENVS * TRAIN_FREQ
SMALL = dict(buffer_size=512, batch_size=BATCH, train_freq=TRAIN_FREQ, learning_rate=1e-3,
             hid_sizes=(32, 32), exploration_fraction=0.5)
HINT = 100  # total_timesteps_hint: epsilon falls over 50 steps


def _pair(**kw):
    cfg = dict(SMALL, **kw)
    jdqn = JaxDQN(jax_make_vec_env("CartPole-v1", num_envs=NUM_ENVS), JaxDQNConfig(**cfg),
                  total_timesteps_hint=HINT, seed=0)
    venv = make_vec_env("CartPole-v1", num_envs=NUM_ENVS, device="cpu")
    return jdqn, jdqn.init_state(), DQN(venv, DQNConfig(**cfg), total_timesteps_hint=HINT, seed=0)


def _q_state_dict(tree):
    return convert.q_network_state_dict({"params": host(tree)})


def _params(dqn):
    return {"q": {k: v.detach().clone().numpy() for k, v in dqn.q_net.named_parameters()},
            "target": {k: v.clone().numpy() for k, v in dqn.target_q_net.state_dict().items()}}


def _jax_params(jstate):
    return {"q": {k: v.numpy() for k, v in _q_state_dict(jstate.variables["params"]).items()},
            "target": {k: v.numpy() for k, v in _q_state_dict(jstate.target_params).items()}}


def test_epsilon_schedule_matches_jax():
    jdqn, _, dqn = _pair()
    for t in (0, 1, 7, 16, 25, 33, 49, 50, 51, 200, 10**6):
        want = jdqn.epsilon(jnp.asarray(t, jnp.int32))
        assert np.float32(dqn.epsilon(t)) == np.asarray(want), t
    assert dqn.epsilon(0) == 1.0 and dqn.epsilon(10**6) == pytest.approx(0.05, abs=1e-7)


def test_q_network_and_greedy_fn_match_jax():
    jdqn, jstate, dqn = _pair()
    dqn.init_state()
    dqn.q_net.load_state_dict(_q_state_dict(jstate.variables["params"]))
    assert sorted(dqn.q_net.state_dict()) == ["dense0.bias", "dense0.weight", "dense1.bias",
                                              "dense1.weight", "q_out.bias", "q_out.weight"]
    obs = np.random.default_rng(0).normal(scale=0.5, size=(64, 4)).astype(np.float32)
    with torch.no_grad():
        q = dqn.q_net(torch.from_numpy(obs))
    np.testing.assert_allclose(q.numpy(), np.asarray(jdqn.q_net.apply(jstate.variables, jnp.asarray(obs))),
                               rtol=1e-5, atol=1e-5)
    acts, aux = dqn.greedy_fn()(torch.from_numpy(obs))
    jacts, _ = jdqn.greedy_fn()(jstate.variables, jnp.asarray(obs), jax.random.key(0))
    assert aux == {} and acts.dtype == torch.int32
    np.testing.assert_array_equal(acts.numpy(), np.asarray(jacts))


def _run_port(monkeypatch, jdqn, jstate, steps, make, n_expert=None, expert_setter=None):
    """``run(rel)`` for ``update_floors``: ``steps`` port train steps from
    the JAX weights (nudged by ``rel``) with the JAX draws fed in; the exact
    run's DQN, state and metrics land in ``runs[rel]``."""
    cfg = jdqn.config
    feeds, key = [], jstate.key
    for step in range(steps):
        explore, replay_idx, expert_idx, key = jax_dqn_draws(
            key, train_freq=cfg.train_freq, num_envs=NUM_ENVS, n_actions=2,
            gradient_steps=cfg.gradient_steps, batch=cfg.batch_size, size=(step + 1) * ROWS,
            n_expert=n_expert)
        feeds.append((explore, replay_idx, expert_idx))
    x0 = np.asarray(jstate.env_state.env_state.x)
    runs = {}

    def run(rel):
        dqn = make()
        inject_resets(monkeypatch, dqn.venv, x0)
        state = dqn.init_state()
        with torch.no_grad():
            dqn.q_net.load_state_dict(_q_state_dict(jstate.variables["params"]))
            dqn.target_q_net.load_state_dict(_q_state_dict(jstate.target_params))
            for m in (dqn.q_net, dqn.target_q_net):
                for p in m.parameters():
                    p.mul_(1 + rel)
        init = _params(dqn)
        explore = feed([e for f in feeds for e in f[0]])
        idx = feed([i for f in feeds for i in f[1]])
        monkeypatch.setattr(torch_dqn, "_explore_draws", explore)
        monkeypatch.setattr(torch_buffer, "_uniform_indices", idx)
        if n_expert is not None:
            expert_setter(feed([i for f in feeds for i in f[2]]))
        metrics = []
        for _ in range(steps):
            state, m = dqn.train_step(state)
            metrics.append(m)
        assert explore.remaining == [] and idx.remaining == []
        runs[rel] = (dqn, state, metrics)
        final = _params(dqn)
        return {label: (init[label], final[label]) for label in init}

    return run, runs


def assert_matches(got, want, init, floors, labels=("q", "target")):
    for label in labels:
        upd = max(np.abs(want[label][k] - init[label][k]).max() for k in want[label])
        assert upd > 0, label
        err = max(np.abs(got[label][k] - want[label][k]).max() for k in want[label])
        rel = param_tolerance(floors[label])
        assert err <= rel * upd, f"{label}: error {err:.3g} vs update {upd:.3g} (limit {rel:.3g})"


def assert_metrics(metrics, jmetrics):
    m = {k: float(v) for k, v in metrics.items()}
    assert sorted(m) == sorted(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(m[k], float(v), **METRIC_TOL, err_msg=k)


@pytest.mark.parametrize("learning_starts,tau", [(0, 1.0), (20, 1.0), (20, 0.5)])
def test_train_steps_match_jax(monkeypatch, learning_starts, tau):
    """Two train steps of 16 rows, 2 TD updates each. With
    ``learning_starts=20`` step 1 is masked (the count advances, nothing
    moves, the loss is reported); step 2 learns. Step 2 crosses ``target_update_interval=24``, so
    the target takes a hard (tau 1) or Polyak (tau 0.5) copy after it."""
    kw = dict(learning_starts=learning_starts, tau=tau, gradient_steps=2, target_update_interval=24)
    jdqn, jstate, _ = _pair(**kw)
    jinit = _jax_params(jstate)
    step = jax.jit(jdqn.train_step)
    j1, jm1 = step(jstate)
    j2, jm2 = step(j1)
    run, runs = _run_port(monkeypatch, jdqn, jstate, 2, lambda: _pair(**kw)[2])
    floors = update_floors(run)
    dqn, state, metrics = runs[0.0]
    assert state.timesteps == 2 * ROWS and state.n_updates == 4 and state.optimizer.count == 4
    assert int(j2.opt_state[1][0].count) == 4
    np.testing.assert_array_equal(state.buffer_state.data.acts[:2 * ROWS].numpy(),
                                  np.asarray(j2.buffer_state.data.acts[:2 * ROWS]))
    # Step 1 does not cross the interval: the target is untouched after it.
    assert np.array_equal(np.asarray(j1.target_params["q_out"]["kernel"]),
                          np.asarray(jstate.target_params["q_out"]["kernel"]))
    assert_matches(_params(dqn), _jax_params(j2), jinit, floors)
    if tau == 1.0:  # a hard copy
        for k, v in dqn.q_net.state_dict().items():
            assert torch.equal(v, dqn.target_q_net.state_dict()[k]), k
    assert_metrics(metrics[0], jm1)
    assert_metrics(metrics[1], jm2)
    # The jitted JAX step may fuse epsilon's multiply-add (one ulp off its
    # eager ``epsilon``, which the port's equals exactly).
    assert float(metrics[1]["epsilon"]) == dqn.epsilon(ROWS) == float(jdqn.epsilon(jnp.int32(ROWS)))


def test_learn_cpu():
    from imitation_tpu_torch.util.logger import configure

    venv = make_vec_env("CartPole-v1", num_envs=NUM_ENVS, device="cpu")
    dqn = DQN(venv, DQNConfig(**dict(SMALL, learning_starts=32, target_update_interval=64)),
              total_timesteps_hint=HINT, seed=1)
    state = dqn.init_state()
    seen = []
    state = dqn.learn(state, 150, callback=lambda s, m: seen.append(m),
                      logger=configure(format_strs=()), log_every=3)
    assert len(seen) == 10 and state.timesteps == 160 and state.optimizer.count == 10
    assert all(np.isfinite(float(m["loss"])) for m in seen)
    assert float(seen[-1]["epsilon"]) == pytest.approx(0.05)
    assert all(torch.isfinite(p).all() for p in dqn.q_net.parameters())


def test_dqn_refuses_continuous_envs_and_host_overlap():
    with pytest.raises(ValueError, match="discrete"):
        DQN(make_vec_env("Pendulum-v1", num_envs=2, device="cpu"), DQNConfig(**SMALL))
    with pytest.raises(ValueError, match="discrete"):
        JaxDQN(jax_make_vec_env("Pendulum-v1", num_envs=2), JaxDQNConfig(**SMALL))
    with pytest.raises(NotImplementedError, match="host"):
        DQN(make_vec_env("CartPole-v1", num_envs=2, device="cpu"),
            DQNConfig(**dict(SMALL, overlap_collection=True)))


@pytest.mark.parametrize("max_grad_norm", [None, 10.0])
def test_adam_step_masked_matches_optax(max_grad_norm):
    """A masked update is optax's update of all-zero gradients: before any
    real step only the count moves; after one, the moments move the
    parameters too."""
    import optax

    from imitation_tpu_torch.rl.common import make_optimizer

    rng = np.random.default_rng(0)
    params = [rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=(3,)).astype(np.float32)]
    chain = [optax.clip_by_global_norm(max_grad_norm)] if max_grad_norm else []
    tx = optax.chain(*chain, optax.adam(1e-2))
    jparams = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = make_optimizer(tparams, 1e-2, max_grad_norm=max_grad_norm)
    for masked in (True, True, False, True, False, True):
        grads = [np.zeros_like(p) if masked else rng.normal(size=p.shape).astype(np.float32)
                 for p in params]
        updates, opt_state = tx.update([jnp.asarray(g) for g in grads], opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        if masked:
            before = [p.detach().clone() for p in tparams]
            opt.step_masked()
            if not opt.state[tparams[0]]:  # nothing real yet: the count alone moves
                assert all(torch.equal(a, b) for a, b in zip(before, tparams))
        else:
            for p, g in zip(tparams, grads):
                p.grad = torch.from_numpy(g)
            opt.step()
        for p, jp in zip(tparams, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    assert opt.count == 6 == int(opt_state[-1][0].count)
