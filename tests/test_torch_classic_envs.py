"""The other device classic-control envs and their scripted experts in
imitation_tpu_torch against the JAX package.

Tolerances on observations, states and Pendulum's reward (stated per env,
relative and absolute): Pendulum, MountainCar and MountainCarContinuous
1e-6; Acrobot 1e-5. XLA and PyTorch evaluate cos, sin and atan2 with
different approximations (a few ulp apart); Acrobot's RK4 step calls them
sixteen times and divides by the mass matrix, so a step's last bits differ
more (measured up to ~8 ulp of a velocity near its limit). Every comparison
is one step, or a few steps from the JAX package's own states: the chaotic
Acrobot amplifies ulps over long horizons. Flags and the other rewards match
exactly, except for rows within float noise of a threshold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imitation_tpu.envs import make_vec_env as jax_make_vec_env
from imitation_tpu.envs import classic as jax_classic
from imitation_tpu.testing import experts as jax_experts
from imitation_tpu_torch.data.rollout import rollout_stats
from imitation_tpu_torch.envs import classic, make_vec_env, registered_envs
from imitation_tpu_torch.testing import experts

torch.set_num_threads(1)

TOL = {
    "Pendulum": dict(rtol=1e-6, atol=1e-6),
    "MountainCar": dict(rtol=1e-6, atol=1e-6),
    "MountainCarContinuous": dict(rtol=1e-6, atol=1e-6),
    "Acrobot": dict(rtol=1e-5, atol=1e-5),
}


def _states_and_actions(name: str, B: int, seed: int):
    """``B`` seeded states across each env's range (angles past +-pi and
    negative ones included, positions at the walls) and actions."""
    rng = np.random.default_rng(seed)
    if name == "Pendulum":
        state = np.stack([rng.uniform(-7.0, 7.0, B), rng.uniform(-8.0, 8.0, B)], -1)
        acts = rng.uniform(-3.0, 3.0, (B, 1))  # beyond the torque limit too
    elif name.startswith("MountainCar"):
        state = np.stack([rng.uniform(-1.2, 0.6, B), rng.uniform(-0.07, 0.07, B)], -1)
        state[:4, 0] = [-1.2, -1.2, 0.6, 0.5]
        state[:4, 1] = [-0.07, 0.01, 0.07, 0.0]
        acts = (rng.integers(0, 3, B) if name == "MountainCar" else rng.uniform(-1.5, 1.5, (B, 1)))
    else:
        lim = np.array([np.pi, np.pi, 4 * np.pi, 9 * np.pi])
        state = rng.uniform(-1.0, 1.0, (B, 4)) * lim
        acts = rng.integers(0, 3, B)
    acts = acts.astype(np.int32 if acts.dtype.kind == "i" else np.float32)
    return state.astype(np.float32), acts


@pytest.mark.parametrize("fixed_horizon", [False, True])
@pytest.mark.parametrize("name", list(TOL))
def test_step_matches_jax(name, fixed_horizon):
    B = 64
    state, acts = _states_and_actions(name, B, seed=len(name))
    jenv = getattr(jax_classic, name)(fixed_horizon=fixed_horizon)
    env = getattr(classic, name)(fixed_horizon=fixed_horizon)
    keys = jax.random.split(jax.random.key(0), B)
    jstate, jts = jax.vmap(jenv.step)(
        jax_classic.ArrayState(x=jnp.asarray(state)), jnp.asarray(acts), keys)
    new, ts = env.step(torch.from_numpy(state), torch.from_numpy(acts))
    tol = TOL[name]
    np.testing.assert_allclose(new.numpy(), np.asarray(jstate.x), **tol)
    np.testing.assert_allclose(ts.obs.numpy(), np.asarray(jts.obs), **tol)
    assert ts.obs.dtype == ts.reward.dtype == torch.float32
    assert ts.obs.shape == (B,) + env.observation_space.shape
    assert ts.terminated.dtype == ts.truncated.dtype == torch.bool and not ts.truncated.any()
    want_term = np.asarray(jts.terminated)
    if name == "Acrobot":
        # Skip rows whose tip height lies within float noise of the line.
        th1, th2 = np.asarray(jstate.x)[:, 0], np.asarray(jstate.x)[:, 1]
        clear = np.abs(-np.cos(th1) - np.cos(th1 + th2) - 1.0) > 1e-4
    else:
        clear = np.ones(B, bool)
    np.testing.assert_array_equal(ts.terminated.numpy()[clear], want_term[clear])
    if name == "Pendulum":
        np.testing.assert_allclose(ts.reward.numpy(), np.asarray(jts.reward), **tol)
        assert not ts.terminated.any()
    else:
        np.testing.assert_array_equal(ts.reward.numpy()[clear], np.asarray(jts.reward)[clear])
    if fixed_horizon:
        assert not ts.terminated.any()
    elif name.startswith("MountainCar"):
        assert ts.terminated.any()  # the rows at the right wall reach the goal


def test_pendulum_wraps_negative_angles_as_jax():
    # theta + pi below zero: a floor-mod keeps the normalized angle in
    # [-pi, pi), where a truncating mod would leave it below -pi.
    th = np.array([-np.pi - 0.5, -3 * np.pi - 0.1, -10.0, -0.2, 7.5], np.float32)
    state = np.stack([th, np.zeros_like(th)], -1)
    acts = np.zeros((len(th), 1), np.float32)
    _, ts = classic.Pendulum().step(torch.from_numpy(state), torch.from_numpy(acts))
    keys = jax.random.split(jax.random.key(0), len(th))
    _, jts = jax.vmap(jax_classic.Pendulum().step)(
        jax_classic.ArrayState(x=jnp.asarray(state)), jnp.asarray(acts), keys)
    np.testing.assert_allclose(ts.reward.numpy(), np.asarray(jts.reward), **TOL["Pendulum"])
    norm = np.remainder(th.astype(np.float64) + np.pi, 2 * np.pi) - np.pi
    np.testing.assert_allclose(-ts.reward.numpy(), norm ** 2, rtol=1e-5)


RESETS = {  # env: (state columns' low, high), observation width
    "Pendulum": ([-np.pi, -1.0], [np.pi, 1.0], 3),
    "MountainCar": ([-0.6, 0.0], [-0.4, 0.0], 2),
    "MountainCarContinuous": ([-0.6, 0.0], [-0.4, 0.0], 2),
    "Acrobot": ([-0.1] * 4, [0.1] * 4, 6),
}


@pytest.mark.parametrize("name", list(RESETS))
def test_reset_draws_what_jax_draws(name):
    env = getattr(classic, name)()
    n = 4096
    obs, state = env.reset(n, torch.Generator().manual_seed(3))
    obs2, _ = env.reset(n, torch.Generator().manual_seed(3))
    assert torch.equal(obs, obs2)
    lo, hi, width = RESETS[name]
    assert obs.shape == (n, width) and obs.dtype == state.dtype == torch.float32
    s = state.numpy()
    assert (s >= np.float32(lo)).all() and (s <= np.float32(hi)).all()
    spread = np.asarray(hi) - np.asarray(lo)
    moving = spread > 0
    assert (s.max(0) - s.min(0))[moving].min() > 0.99 * spread[moving].min()
    # The JAX package's reset of one instance, for the same ranges.
    jobs, jstate = jax.vmap(getattr(jax_classic, name)().reset)(jax.random.split(jax.random.key(0), 256))
    js = np.asarray(jstate.x)
    assert js.shape[1:] == s.shape[1:] and np.asarray(jobs).shape[1:] == (width,)
    assert (js >= np.float32(lo)).all() and (js <= np.float32(hi)).all()
    if name in ("Pendulum", "Acrobot"):
        np.testing.assert_allclose(obs.numpy(), type(env).obs_of(state).numpy())


HORIZONS = {"Pendulum-v1": 200, "MountainCar-v0": 200, "MountainCarContinuous-v0": 999,
            "Acrobot-v1": 500, "seals/MountainCar-v0": 200, "seals/Pendulum-v0": 200,
            "CartPole-v0": 200, "CartPole-v1": 500, "seals/CartPole-v0": 500}


def test_registry_names_and_horizons():
    assert sorted(HORIZONS) == registered_envs()
    for name, horizon in HORIZONS.items():
        venv = make_vec_env(name, num_envs=2, device="cpu")
        jvenv = jax_make_vec_env(name, num_envs=2)
        assert venv.max_episode_steps == jvenv.max_episode_steps == horizon, name
        assert venv.observation_space.shape == jvenv.observation_space.shape, name
        assert venv.action_space.shape == jvenv.action_space.shape, name
        assert venv.action_space.n == jvenv.action_space.n, name
    assert make_vec_env("seals/MountainCar-v0", num_envs=2, device="cpu").env.fixed_horizon
    assert not make_vec_env("MountainCar-v0", num_envs=2, device="cpu").env.fixed_horizon


@pytest.mark.parametrize("env_id,horizon,steps", [
    ("Pendulum-v1", 7, 16), ("seals/Pendulum-v0", 5, 12), ("MountainCar-v0", 6, 14),
    ("seals/MountainCar-v0", 6, 14), ("MountainCarContinuous-v0", 6, 14), ("Acrobot-v1", 3, 7),
])
def test_vector_env_matches_jax_with_injected_resets(monkeypatch, env_id, horizon, steps):
    """Auto-reset, truncation and the monitor through ``VectorEnv``, with the
    port's resets replaced by the states the JAX engine reset to."""
    B = 6
    jvenv = jax_make_vec_env(env_id, num_envs=B, max_episode_steps=horizon)
    jstate = jvenv.reset(jax.random.key(0))
    reset_states = [np.asarray(jstate.env_state.x)]
    space = jvenv.action_space
    rng = np.random.default_rng(1)
    if space.is_discrete:
        acts = rng.integers(0, space.n, (steps, B)).astype(np.int32)
    else:
        acts = rng.uniform(space.low, space.high, (steps, B) + space.shape).astype(np.float32)
    step = jax.jit(jvenv.step)
    jouts = []
    for i in range(steps):
        jstate, out = step(jstate, jnp.asarray(acts[i]))
        jouts.append(jax.device_get(out))
        reset_states.append(np.asarray(jstate.env_state.x))  # where done, the reset state

    venv = make_vec_env(env_id, num_envs=B, max_episode_steps=horizon, device="cpu")
    env = venv.env
    queue = iter(reset_states)
    obs_of = getattr(type(env), "obs_of", lambda x: x)

    def injected_reset(n, generator):
        x = torch.from_numpy(next(queue).copy())
        return obs_of(x), x

    monkeypatch.setattr(env, "reset", injected_reset)
    state = venv.reset(torch.Generator())
    tol = TOL[type(env).__name__]
    n_trunc = 0
    for i in range(steps):
        state, out = venv.step(state, torch.from_numpy(acts[i]))
        want = jouts[i]
        np.testing.assert_array_equal(out.terminated.numpy(), np.asarray(want.terminated))
        np.testing.assert_array_equal(out.truncated.numpy(), np.asarray(want.truncated))
        np.testing.assert_allclose(out.obs.numpy(), np.asarray(want.obs), **tol)
        np.testing.assert_allclose(out.terminal_obs.numpy(), np.asarray(want.terminal_obs), **tol)
        np.testing.assert_allclose(out.reward.numpy(), np.asarray(want.reward), **tol)
        done = out.done.numpy()
        np.testing.assert_allclose(out.episode_return.numpy()[done],
                                   np.asarray(want.episode_return)[done], **tol)
        np.testing.assert_array_equal(out.episode_length.numpy()[done],
                                      np.asarray(want.episode_length)[done])
        if "Pendulum" in env_id or env_id.startswith("seals/"):
            # No early termination: every env truncates at each multiple of the horizon.
            assert out.truncated.all() == ((i + 1) % horizon == 0) and out.truncated.any() == out.truncated.all()
        n_trunc += int(out.truncated.sum())
    assert n_trunc > 0


def test_experts_match_jax_exactly():
    rng = np.random.default_rng(0)
    n = 256
    th = np.concatenate([rng.uniform(-np.pi, np.pi, n - 64), rng.uniform(-0.5, 0.5, 64)])
    obs = np.stack([np.cos(th), np.sin(th), rng.uniform(-8, 8, n)], -1).astype(np.float32)
    want, _ = jax_experts.pendulum_expert_fn(None, jnp.asarray(obs), None)
    got, aux = experts.pendulum_expert_fn(torch.from_numpy(obs))
    assert got.shape == (n, 1) and got.dtype == torch.float32 and aux == {}
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.abs(got.numpy()) < 2.0).any()  # the PD branch near the top is exercised

    obs = np.stack([rng.uniform(-1.2, 0.6, n), rng.uniform(-0.07, 0.07, n)], -1).astype(np.float32)
    obs[0, 1] = 0.0
    want, _ = jax_experts.mountain_car_expert_fn(None, jnp.asarray(obs), None)
    got, _ = experts.mountain_car_expert_fn(torch.from_numpy(obs))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert sorted(experts.EXPERTS) == sorted(jax_experts.EXPERTS)


def test_expert_demonstrations():
    venv = make_vec_env("Pendulum-v1", num_envs=8, device="cpu")
    demos = experts.generate_expert_trajectories("Pendulum-v1", venv, min_episodes=8, seed=0)
    assert all(len(d) == 200 and not d.terminal for d in demos)
    assert demos[0].acts.shape == (200, 1) and demos[0].acts.dtype == np.float32
    assert demos[0].obs.shape == (201, 3)
    assert rollout_stats(demos)["return_mean"] > -400  # random actions score about -1200

    venv = make_vec_env("MountainCar-v0", num_envs=4, device="cpu")
    demos = experts.generate_expert_trajectories("MountainCar-v0", venv, min_episodes=4, seed=0)
    assert all(d.terminal and len(d) < 200 for d in demos)  # the goal, before the horizon
