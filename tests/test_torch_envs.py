"""Device CartPole and VectorEnv in imitation_tpu_torch against the JAX package.

Tolerance on observations: 1e-5 absolute and relative. XLA and PyTorch
evaluate cos and sin with different approximations (a few ulp apart), and
the difference grows slowly over an episode. Flags, rewards and episode
stats must match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imitation_tpu.envs import make_vec_env as jax_make_vec_env
from imitation_tpu.envs.classic import ArrayState
from imitation_tpu.envs.classic import CartPole as JaxCartPole
from imitation_tpu_torch.envs import VectorEnv, make_vec_env
from imitation_tpu_torch.envs.classic import CartPole

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fixed_horizon", [False, True])
def test_cartpole_step_matches_jax(fixed_horizon):
    rng = np.random.default_rng(0)
    B = 512
    scale = np.array([2.6, 2.0, 0.25, 2.5], np.float32)
    x = (rng.uniform(-1, 1, (B, 4)) * scale).astype(np.float32)
    acts = rng.integers(0, 2, B).astype(np.int32)
    jenv = JaxCartPole(fixed_horizon=fixed_horizon)
    keys = jax.random.split(jax.random.key(0), B)
    _, jts = jax.vmap(jenv.step)(ArrayState(x=jnp.asarray(x)), jnp.asarray(acts), keys)
    state, ts = CartPole(fixed_horizon=fixed_horizon).step(torch.from_numpy(x), torch.from_numpy(acts))
    want_obs = np.asarray(jts.obs)
    np.testing.assert_allclose(ts.obs.numpy(), want_obs, **TOL)
    np.testing.assert_array_equal(state.numpy(), ts.obs.numpy())
    np.testing.assert_array_equal(ts.reward.numpy(), np.asarray(jts.reward))
    # Flags: skip rows whose new x or theta lies within float noise of a threshold.
    clear = (np.abs(np.abs(want_obs[:, 0]) - 2.4) > 1e-4) & (
        np.abs(np.abs(want_obs[:, 2]) - jenv.theta_threshold) > 1e-4)
    term = ts.terminated.numpy()
    np.testing.assert_array_equal(term[clear], np.asarray(jts.terminated)[clear])
    assert term.any() != fixed_horizon
    assert not ts.truncated.any()


@pytest.mark.parametrize("env_id,horizon", [("CartPole-v1", 20), ("seals/CartPole-v0", 7)])
def test_vector_env_matches_jax_with_injected_resets(monkeypatch, env_id, horizon):
    B, steps = 6, 60
    jvenv = jax_make_vec_env(env_id, num_envs=B, max_episode_steps=horizon)
    jstate = jvenv.reset(jax.random.key(0))
    reset_obs = [np.asarray(jstate.obs)]
    acts = np.random.default_rng(1).integers(0, 2, (steps, B)).astype(np.int32)
    step = jax.jit(jvenv.step)
    jouts = []
    for i in range(steps):
        jstate, out = step(jstate, jnp.asarray(acts[i]))
        out = jax.device_get(out)
        jouts.append(out)
        reset_obs.append(np.asarray(out.obs))  # where done, the auto-reset obs

    venv = make_vec_env(env_id, num_envs=B, max_episode_steps=horizon, device="cpu")
    queue = iter(reset_obs)

    def injected_reset(n, generator):
        x = torch.from_numpy(next(queue).copy())
        return x, x

    monkeypatch.setattr(venv.env, "reset", injected_reset)
    state = venv.reset(torch.Generator())
    n_term = n_trunc = 0
    for i in range(steps):
        state, out = venv.step(state, torch.from_numpy(acts[i]))
        want = jouts[i]
        np.testing.assert_array_equal(out.terminated.numpy(), np.asarray(want.terminated))
        np.testing.assert_array_equal(out.truncated.numpy(), np.asarray(want.truncated))
        np.testing.assert_allclose(out.obs.numpy(), np.asarray(want.obs), **TOL)
        np.testing.assert_allclose(out.terminal_obs.numpy(), np.asarray(want.terminal_obs), **TOL)
        np.testing.assert_array_equal(out.reward.numpy(), np.asarray(want.reward))
        done = out.done.numpy()
        np.testing.assert_array_equal(out.episode_return.numpy()[done], np.asarray(want.episode_return)[done])
        np.testing.assert_array_equal(out.episode_length.numpy()[done], np.asarray(want.episode_length)[done])
        n_term += int(out.terminated.sum())
        n_trunc += int(out.truncated.sum())
    assert n_trunc > 0
    assert (n_term > 0) == (env_id == "CartPole-v1")


def test_truncation_only_when_not_terminated():
    # Env 0 leaves the track on its first step (terminated), env 1 does not:
    # at a horizon of 1 only env 1 is truncated.
    x = np.array([[2.39, 10.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]], np.float32)
    acts = np.array([1, 1], np.int32)
    jvenv = jax_make_vec_env("CartPole-v1", num_envs=2, max_episode_steps=1)
    jstate = jvenv.reset(jax.random.key(0))
    jstate = jstate.replace(env_state=ArrayState(x=jnp.asarray(x)), obs=jnp.asarray(x))
    _, jout = jvenv.step(jstate, jnp.asarray(acts))

    venv = make_vec_env("CartPole-v1", num_envs=2, max_episode_steps=1, device="cpu")
    state = venv.reset(torch.Generator().manual_seed(0))
    state.env_state = state.obs = torch.from_numpy(x)
    _, out = venv.step(state, torch.from_numpy(acts))
    assert out.terminated.tolist() == [True, False] == np.asarray(jout.terminated).tolist()
    assert out.truncated.tolist() == [False, True] == np.asarray(jout.truncated).tolist()
    assert out.episode_length.tolist() == [1, 1]
    assert not np.allclose(out.obs.numpy(), out.terminal_obs.numpy())  # both reset


def test_reset_range_and_generator():
    venv = make_vec_env("CartPole-v1", num_envs=4096, device="cpu")
    a = venv.reset(torch.Generator().manual_seed(3)).obs
    b = venv.reset(torch.Generator().manual_seed(3)).obs
    assert torch.equal(a, b)
    assert a.abs().max() <= 0.05 and a.abs().max() > 0.049
    assert a.shape == (4096, 4) and a.dtype == torch.float32


def test_registry_and_default_device():
    assert make_vec_env("CartPole-v0", num_envs=2, device="cpu").max_episode_steps == 200
    assert make_vec_env("CartPole-v1", num_envs=2, device="cpu").max_episode_steps == 500
    assert make_vec_env("seals/CartPole-v0", num_envs=2, device="cpu").env.fixed_horizon
    venv = make_vec_env("seals/HalfCheetah-v1", num_envs=2, device="cpu")  # the port's host MuJoCo engine
    assert venv.is_host and venv.device == torch.device("cpu")
    venv.close()
    with pytest.raises(NotImplementedError):
        make_vec_env("seals/Ant-v1", device="cpu")  # not ported yet
    with pytest.raises(KeyError):
        make_vec_env("NoSuchEnv-v0", device="cpu")
    if torch.cuda.is_available():
        assert make_vec_env("CartPole-v1").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_vec_env("CartPole-v1")


def test_vector_env_defaults_to_the_card(monkeypatch):
    # Built directly, without a device, a VectorEnv (and so a PPO or GAIL
    # trainer that takes its device from it) resolves to CUDA, and raises
    # where there is none; the CPU is used only when asked for.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VectorEnv(CartPole(), 4)
    venv = VectorEnv(CartPole(), 4, device="cpu")
    assert venv.device == torch.device("cpu")
    state = venv.reset(torch.Generator().manual_seed(0))
    state, out = venv.step(state, torch.ones(4, dtype=torch.int32))
    assert out.obs.shape == (4, 4) and out.obs.device.type == "cpu"
