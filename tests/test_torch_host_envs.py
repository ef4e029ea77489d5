"""The port's host env engine (``imitation_tpu_torch.native``) against the
JAX package's, against the port's device envs, and its build.

* The two engines (each package builds its own copy of ``envengine.cpp``)
  agree exactly on all seven step outputs and the reset, over 200 steps of
  seeded actions (a 60-step horizon), for every ``ENV_TYPES`` name, on 1
  and 4 threads.
* One engine step against ``envs/classic.py``'s step on the CPU from the
  same state (CartPole and MountainCar: the observation is the state;
  Pendulum: theta = atan2(sin, cos), theta_dot), within 1e-6: the engine
  computes in float32 with libm's ``sinf``/``cosf`` and another grouping of
  CartPole's products, so the two differ by float32 rounding.
* A failed build raises with the compiler's output.

Skipped only where ``g++`` is missing.
"""

import shutil

import numpy as np
import pytest
import torch

from imitation_tpu.native.cpp_env import CppVectorEnv as JaxCppVectorEnv
from imitation_tpu_torch.envs import classic
from imitation_tpu_torch.native import ENV_TYPES, CppVectorEnv, build

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="the engine is built with g++")

FIELDS = ("obs", "terminal_obs", "reward", "terminated", "truncated", "episode_return",
          "episode_length")


def _actions(space, rng, n):
    if space.is_discrete:
        return rng.integers(0, space.n, n)
    low, high = np.broadcast_to(space.low, space.shape), np.broadcast_to(space.high, space.shape)
    # a little beyond the bounds, so the engines' clipping is exercised
    return rng.uniform(1.2 * low, 1.2 * high, (n,) + space.shape).astype(np.float32)


@pytest.mark.parametrize("num_threads", [1, 4])
@pytest.mark.parametrize("env_name", sorted(ENV_TYPES))
def test_engines_agree_exactly(env_name, num_threads):
    B = 8
    # a 60-step horizon, so that truncations and auto-resets occur in every env
    kw = dict(num_envs=B, seed=7, num_threads=num_threads, max_episode_steps=60)
    jenv = JaxCppVectorEnv(env_name, **kw)
    tenv = CppVectorEnv(env_name, device="cpu", **kw)
    assert tenv.is_host and tenv.device == torch.device("cpu")
    for attr in ("observation_space", "action_space"):
        j, t = getattr(jenv, attr), getattr(tenv, attr)
        assert (j.shape, j.n) == (t.shape, t.n)
        if j.n is None:
            np.testing.assert_array_equal(j.low, t.low)
            np.testing.assert_array_equal(j.high, t.high)
    np.testing.assert_array_equal(tenv.reset(), jenv.reset())
    rng = np.random.default_rng(0)
    n_done = 0
    for _ in range(200):
        acts = _actions(tenv.action_space, rng, B)
        jout, tout = jenv.step(acts), tenv.step(acts)
        for k in FIELDS:
            assert tout[k].dtype == jout[k].dtype, k
            np.testing.assert_array_equal(tout[k], jout[k], err_msg=k)
        n_done += int((tout["terminated"] | tout["truncated"]).sum())
    assert n_done >= 3 * B
    jenv.close()
    tenv.close()


def _device_env(env_name):
    env_type, fixed = ENV_TYPES[env_name]
    return [classic.CartPole, classic.Pendulum, classic.MountainCar,
            classic.MountainCarContinuous][env_type](fixed_horizon=fixed)


def _state_of(env_name, obs):
    if ENV_TYPES[env_name][0] == 1:  # Pendulum: (cos, sin, theta_dot) -> (theta, theta_dot)
        return np.stack([np.arctan2(obs[:, 1], obs[:, 0]), obs[:, 2]], axis=-1)
    return obs


@pytest.mark.parametrize("env_name", sorted(ENV_TYPES))
def test_engine_step_matches_device_env(env_name):
    B = 64
    tenv = CppVectorEnv(env_name, num_envs=B, seed=3, num_threads=1, device="cpu")
    env = _device_env(env_name)
    rng = np.random.default_rng(1)
    obs = tenv.reset()
    worst = 0.0
    for _ in range(50):
        acts = _actions(tenv.action_space, rng, B)
        state = torch.from_numpy(_state_of(env_name, obs).astype(np.float32))
        a = torch.from_numpy(acts if acts.dtype == np.float32 else acts.astype(np.int32))
        _, ts = env.step(state, a)
        out = tenv.step(acts)
        np.testing.assert_allclose(ts.obs.numpy(), out["terminal_obs"], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ts.reward.numpy(), out["reward"], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(ts.terminated.numpy(), out["terminated"])
        worst = max(worst, float(np.abs(ts.obs.numpy() - out["terminal_obs"]).max()))
        obs = out["obs"]
    assert worst < 1e-6


def test_unknown_env_and_failed_build(tmp_path, monkeypatch):
    with pytest.raises(KeyError, match="no C\\+\\+ engine"):
        CppVectorEnv("Acrobot-v1", device="cpu")
    bad = tmp_path / "envengine.cpp"
    bad.write_text("int main( { return 0; }\n")
    monkeypatch.setattr(build, "SOURCE", bad)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed with code") as err:
        build.build_library()
    assert "envengine.cpp" in str(err.value) and "error" in str(err.value)
    assert not any((tmp_path / "_build").iterdir())
    assert build.library_path().name.startswith("libitt_envengine_")
