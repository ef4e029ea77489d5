"""envs/tabular.py in imitation_tpu_torch against the JAX package.

``random_mdp`` builds the JAX package's matrices exactly (both draw them
with numpy from the same seed). Steps and resets through ``VectorEnv``
are exact with the JAX package's uniforms fed in through
``_tabular_uniforms``: each draw is ``jax.random.choice(key, S, p=...)``,
whose uniform is ``jax.random.uniform(key, ())`` for the env's own key
(``VectorEnv.reset`` splits one key per env, ``step`` a step key and a
reset key per env). Frequencies under the port's own generator are held
against ``T`` by a binomial bound (4 standard deviations).
"""

import jax
import numpy as np
import pytest
import torch

import imitation_tpu_torch.envs.tabular as torch_tabular
from imitation_tpu.envs.tabular import TabularMDP as JaxTabularMDP
from imitation_tpu.envs.tabular import random_mdp as jax_random_mdp
from imitation_tpu.envs.vector import VectorEnv as JaxVectorEnv
from imitation_tpu_torch.envs.tabular import TabularMDP, random_mdp
from imitation_tpu_torch.envs.vector import VectorEnv
from tests.torch_parity import feed_arrays

torch.set_num_threads(1)


@pytest.mark.parametrize("args", [
    dict(n_states=5, n_actions=3, horizon=7, seed=0),
    dict(n_states=16, n_actions=4, horizon=16, seed=0),
    dict(n_states=9, n_actions=2, horizon=4, obs_dim=6, branch_factor=3, seed=5),
])
def test_random_mdp_matrices_equal_jax(args):
    got, want = random_mdp(**args), jax_random_mdp(**args)
    for name in ("transition_matrix", "reward_matrix", "initial_state_dist", "observation_matrix"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert (got.n_states, got.n_actions, got.obs_dim, got.horizon, got.max_episode_steps) == (
        want.n_states, want.n_actions, want.obs_dim, want.horizon, want.max_episode_steps)
    assert got.observation_space.shape == want.observation_space.shape
    assert got.action_space.n == want.action_space.n


@pytest.mark.parametrize("case", ["not-square", "rows", "reward"])
def test_validation_errors_match_jax(case):
    T = np.full((3, 2, 3), 1.0 / 3, np.float32)
    R = np.zeros(3, np.float32)
    if case == "not-square":
        T, match = np.full((3, 2, 4), 0.25, np.float32), "not square"
    elif case == "rows":
        T, match = T * 0.5, "sum to 1"
    else:
        R, match = np.zeros(4, np.float32), "reward matrix"
    for cls in (TabularMDP, JaxTabularMDP):
        with pytest.raises(ValueError, match=match):
            cls(T, R, 3)


def test_defaults_match_jax():
    T = np.full((4, 2, 4), 0.25, np.float32)
    got, want = TabularMDP(T, np.arange(4.0), 5), JaxTabularMDP(T, np.arange(4.0), 5)
    np.testing.assert_array_equal(got.initial_state_dist, want.initial_state_dist)
    np.testing.assert_array_equal(got.observation_matrix, want.observation_matrix)


def _jax_uniforms(keys):
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, ()))(keys))


def test_vector_steps_with_jax_draws_equal_jax(monkeypatch):
    """Resets, steps and auto-resets at the horizon through ``VectorEnv``,
    state for state, with the JAX engine's uniforms."""
    B, horizon, n_steps = 6, 4, 11
    jenv = jax_random_mdp(7, 3, horizon=horizon, obs_dim=3, seed=2)
    env = random_mdp(7, 3, horizon=horizon, obs_dim=3, seed=2)
    jvenv, venv = JaxVectorEnv(jenv, B), VectorEnv(env, B, device="cpu")
    actions = np.random.default_rng(0).integers(0, 3, (n_steps, B)).astype(np.int32)

    key = jax.random.key(4)
    jstate = jvenv.reset(key)
    _, sub = jax.random.split(key)
    draws = [_jax_uniforms(jax.random.split(sub, B))]
    jouts = []
    for a in actions:
        _, k_step, k_reset = jax.random.split(jstate.key, 3)
        draws += [_jax_uniforms(jax.random.split(k_step, B)), _jax_uniforms(jax.random.split(k_reset, B))]
        jstate, out = jvenv.step(jstate, jax.numpy.asarray(a))
        jouts.append((jstate, out))

    fed = feed_arrays(draws)
    monkeypatch.setattr(torch_tabular, "_tabular_uniforms", fed)
    state = venv.reset(torch.Generator())
    n_trunc = 0
    for a, (jst, jout) in zip(actions, jouts):
        state, out = venv.step(state, torch.from_numpy(a))
        np.testing.assert_array_equal(state.env_state[:, 0].numpy(), np.asarray(jst.env_state.s))
        np.testing.assert_array_equal(state.env_state[:, 1].numpy(), np.asarray(jst.env_state.t))
        for name in ("obs", "terminal_obs", "reward", "terminated", "truncated",
                     "episode_return", "episode_length"):
            np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(jout, name)),
                                          err_msg=name)
        np.testing.assert_array_equal(state.t.numpy(), np.asarray(jst.t))
        n_trunc += int(out.truncated.sum())
    assert fed.remaining == []
    assert n_trunc == B * (n_steps // horizon)


def test_truncates_once_per_episode_at_the_horizon():
    """The port's own draws: never terminated, every env truncated at each
    multiple of the horizon and nowhere else, the step count reset."""
    B, horizon = 32, 5
    venv = VectorEnv(random_mdp(10, 2, horizon=horizon, seed=1), B, device="cpu")
    g = torch.Generator().manual_seed(0)
    state = venv.reset(g)
    for step in range(1, 3 * horizon + 1):
        state, out = venv.step(state, torch.randint(0, 2, (B,), generator=g))
        assert not out.terminated.any()
        assert bool((out.truncated == (step % horizon == 0)).all())
        assert bool((out.episode_length == (step - 1) % horizon + 1).all())
        assert bool((state.env_state[:, 1] == step % horizon).all())


def test_step_frequencies_follow_the_transition_matrix():
    """One step from every state under every action, 2,000 times each: the
    next-state frequencies within 4 binomial standard deviations of T."""
    env = random_mdp(6, 2, horizon=3, seed=3)
    S, A, n = env.n_states, env.n_actions, 2000
    s = torch.arange(S).repeat_interleave(A).repeat(n)
    a = torch.arange(A).repeat(S).repeat(n)
    state = torch.stack([s, torch.zeros_like(s)], dim=-1)
    new, ts = env.step(state, a, torch.Generator().manual_seed(1))
    counts = torch.zeros((S, A, S), dtype=torch.float64)
    counts.index_put_((s, a, new[:, 0]), torch.ones(len(s), dtype=torch.float64), accumulate=True)
    freq = counts.numpy() / n
    p = env.transition_matrix.astype(np.float64)
    assert np.all(np.abs(freq - p) <= 4 * np.sqrt(p * (1 - p) / n) + 1e-12)
    np.testing.assert_array_equal(ts.reward.numpy(), env.reward_matrix[new[:, 0].numpy()])
    np.testing.assert_array_equal(ts.obs.numpy(), env.observation_matrix[new[:, 0].numpy()])


def test_step_needs_a_generator():
    env = random_mdp(4, 2, horizon=3, seed=0)
    obs, state = env.reset(2, torch.Generator())
    with pytest.raises(ValueError, match="generator"):
        env.step(state, torch.zeros(2, dtype=torch.int32))
