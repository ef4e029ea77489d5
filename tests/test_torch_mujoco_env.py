"""The port's seals/HalfCheetah host env (``envs/mujoco_native.py``) against
the JAX package's ``MujocoLockstepVectorEnv`` (MuJoCo through
``mujoco.rollout``), and the paths on top of it.

* Spaces, reset states and the reset draws' order: equal exactly for the
  same seed (numpy's generator in both); a reseeding ``reset(seed)`` too.
* One env step from the same states: obs within 1e-8 of their scale,
  reward within 1e-6 relative; every output's dtype equal to the JAX
  env's (float64 obs, float32 rewards).
* The fixed-horizon lockstep auto-reset, as tests/envs/test_mujoco_native.py
  checks it for the JAX env.
* ``make_vec_env`` returns the lockstep env on the asked device; the
  queued seals envs and the gym bridge raise.
* ``HostCollector`` over both envs with one deterministic policy: float32
  ``obs``/``next_obs`` in both chunks (the cast happens in the port's
  collector), each field within 1e-5 over 3 steps (random weights) and
  1e-8 over 10 (constant actions); ``CppVectorEnv``'s float32
  observations pass through the cast as the same array.
* The repo's SAC expert, deterministic, 16 envs from reset seed 12345,
  one 1000-step episode each: mean return within 1% of the JAX env's
  (the figure the fixture records, which tests/test_torch_mujoco_model.py
  regenerates).
* The CLI: ``train_adversarial gail with gail_seals_half_cheetah fast``,
  ``train_imitation bc with bc_seals_half_cheetah fast``, ``dagger with
  dagger_seals_half_cheetah fast`` (its checkpoint, which holds the SAC
  expert, rebuilt by ``reconstruct_trainer``) and ``eval_policy`` of the
  expert, on the CPU.
"""

import json

import jax
import numpy as np
import pytest
import torch

from imitation_tpu.data import rollout as jax_rollout
from imitation_tpu.envs.mujoco_native import MujocoLockstepVectorEnv as JaxEnv
from imitation_tpu.models.policies import ActorCriticPolicy as JaxPolicy
from imitation_tpu_torch import convert
from imitation_tpu_torch.algorithms import dagger
from imitation_tpu_torch.data import rollout
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.envs.mujoco_native import MujocoLockstepVectorEnv
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.native import CppVectorEnv
from imitation_tpu_torch.policies import serialize
from imitation_tpu_torch.scripts import eval_policy, train_adversarial, train_imitation
from tests import torch_mujoco_tools as tools
from tests.torch_parity import host

torch.set_num_threads(1)

ENV = "seals/HalfCheetah-v1"
FIELDS = ("obs", "terminal_obs", "reward", "terminated", "truncated", "episode_return", "episode_length")


def _pair(B, **kw):
    return JaxEnv(ENV, num_envs=B, **kw), MujocoLockstepVectorEnv(ENV, num_envs=B, device="cpu", **kw)


def test_spaces_and_reset_states_equal_jax():
    jenv, env = _pair(8, seed=5)
    try:
        for attr in ("observation_space", "action_space"):
            j, t = getattr(jenv, attr), getattr(env, attr)
            assert (j.shape, j.dtype, j.n) == (t.shape, t.dtype, t.n), attr
            np.testing.assert_array_equal(j.low, t.low)
            np.testing.assert_array_equal(j.high, t.high)
        assert env.max_episode_steps == jenv.max_episode_steps == 1000
        for seed in (None, 12345):  # the constructor's seed, then a reseed
            want, got = jenv.reset(seed=seed), env.reset(seed=seed)
            assert got.dtype == want.dtype == np.float64 and got.shape == (8, 18)
            np.testing.assert_array_equal(got, want)
    finally:
        jenv.close()
        env.close()


def test_env_step_equals_jax():
    jenv, env = _pair(16, seed=3)
    try:
        jenv.reset(), env.reset()
        rng = np.random.default_rng(0)
        for t in range(30):
            # the port's env restarts each step from the JAX env's state
            env._qpos[:], env._qvel[:] = jenv._states[:, 1:10], jenv._states[:, 10:]
            acts = rng.uniform(-1.2, 1.2, (16, 6)).astype(np.float32)
            want, got = jenv.step(acts), env.step(acts)
            for k in FIELDS:
                assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            scale = max(1.0, float(np.abs(want["obs"]).max()))
            assert np.abs(got["obs"] - want["obs"]).max() <= 1e-8 * scale
            np.testing.assert_allclose(got["reward"], want["reward"], rtol=1e-6, atol=1e-6)
            assert (got["episode_length"] == want["episode_length"]).all()
    finally:
        jenv.close()
        env.close()


def test_fixed_horizon_autoreset():
    venv = make_vec_env(ENV, num_envs=2, max_episode_steps=7, device="cpu")
    venv.reset(seed=0)
    acts = np.zeros((2,) + venv.action_space.shape, np.float32)
    rets = np.zeros(2)
    for t in range(7):
        out = venv.step(acts)
        rets += out["reward"]
        if t < 6:
            assert not out["truncated"].any()
    assert out["truncated"].all()
    assert not out["terminated"].any()
    np.testing.assert_allclose(out["episode_return"], rets, rtol=1e-5)
    assert (out["episode_length"] == 7).all()
    # terminal_obs is pre-reset, obs is the fresh episode's first obs
    assert not np.allclose(out["obs"], out["terminal_obs"])
    out2 = venv.step(acts)
    assert (out2["episode_length"] == 1).all()
    venv.close()


def test_registry():
    venv = make_vec_env("seals/HalfCheetah-v0", num_envs=3, device="cpu")
    assert isinstance(venv, MujocoLockstepVectorEnv) and venv.is_host
    assert venv.device == torch.device("cpu") and venv.num_envs == 3
    venv.close()
    for name in ("seals/Hopper-v1", "seals/Walker2d-v0", "seals/Swimmer-v1", "seals/Ant-v1"):
        with pytest.raises(NotImplementedError, match="not ported yet.*queue A"):
            make_vec_env(name, num_envs=2, device="cpu")
    with pytest.raises(NotImplementedError, match="gym bridge"):
        make_vec_env(ENV, num_envs=2, device="cpu", lockstep=False)


@pytest.mark.parametrize("policy_kind, T, tol", [("random", 3, 1e-5), ("constant", 10, 1e-8)])
def test_host_collector_casts_to_float32_as_jax_does(policy_kind, T, tol):
    """With random weights the two float32 MLPs' actions differ by rounding
    (4e-8 at the first step), which the contacts grow about threefold a
    step, so 3 steps are compared; with the first layer zeroed the actions
    are equal and 10 steps agree to the physics' rounding."""
    B = 4
    jenv, env = _pair(B, seed=1)
    jpolicy = JaxPolicy(jenv.observation_space, jenv.action_space, hid_sizes=(16, 16))
    variables = jpolicy.init(jax.random.key(0))
    if policy_kind == "constant":
        variables = jax.tree_util.tree_map_with_path(
            lambda path, x: x * 0 if "kernel" in jax.tree_util.keystr(path) and x.shape[0] == 18 else x,
            variables)
    policy = ActorCriticPolicy(env.observation_space, env.action_space, hid_sizes=(16, 16))
    policy.load_state_dict(convert.policy_state_dict(host(variables)))
    try:
        jchunk = jax_rollout.HostCollector(jenv, jpolicy.deterministic_fn(), variables, seed=0).collect(T)
        chunk = rollout.HostCollector(env, policy.deterministic_fn(), seed=0).collect(T, device="cpu")
        for k in rollout.CHUNK_FIELDS:
            got, want = getattr(chunk, k).numpy(), np.asarray(getattr(jchunk, k))
            assert got.dtype == want.dtype and got.shape == want.shape, k
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=k)
        assert chunk.obs.dtype == chunk.next_obs.dtype == torch.float32
        if policy_kind == "constant":
            assert (chunk.acts == chunk.acts[0, 0]).all()
    finally:
        jenv.close()
        env.close()
    cpp = CppVectorEnv("Pendulum-v1", num_envs=2, device="cpu", num_threads=1)
    obs = cpp.reset()
    assert obs.dtype == np.float32 and rollout._f32(obs) is obs
    cpp.close()


def test_expert_return_within_one_percent_of_jax():
    want = np.load(tools.FIXTURE_PATH)["expert_returns"]
    act = serialize.load_policy_from_path(str(tools.EXPERT), device="cpu").deterministic_fn()
    venv = MujocoLockstepVectorEnv(ENV, num_envs=16, device="cpu")
    obs, ret = venv.reset(seed=12345), np.zeros(16)
    for _ in range(venv.max_episode_steps):
        with torch.inference_mode():
            acts = act(torch.from_numpy(obs.astype(np.float32)))[0].numpy()
        out = venv.step(acts)
        ret += out["reward"]
        obs = out["obs"]
    venv.close()
    assert out["truncated"].all() and np.isfinite(ret).all()
    assert abs(ret.mean() - want.mean()) <= 0.01 * abs(want.mean()), (ret.mean(), want.mean())


def _completed(tmp_path, result):
    (run_dir,) = [p for p in (tmp_path / "seals_HalfCheetah-v1").iterdir() if p.is_dir() and not p.is_symlink()]
    run = json.loads((run_dir / "run.json").read_text())
    assert run["status"] == "COMPLETED"
    assert json.loads((run_dir / "config.json").read_text())["env_name"] == ENV
    stats = result.get("imit_stats", result)
    assert np.isfinite(stats["return_mean"])
    return stats


@pytest.mark.parametrize("script, argv", [
    (train_adversarial, ["gail", "with", "gail_seals_half_cheetah", "fast"]),
    (train_imitation, ["bc", "with", "bc_seals_half_cheetah", "fast"]),
    (train_imitation, ["dagger", "with", "dagger_seals_half_cheetah", "fast"]),
    (eval_policy, ["with", "expert.policy_type=saved", f"expert.loader_kwargs.path={tools.EXPERT}",
                   f"env_name={ENV}", "num_envs=4", "eval_n_episodes=4", "max_episode_steps=100"]),
], ids=["gail_seals_half_cheetah", "bc_seals_half_cheetah", "dagger_seals_half_cheetah", "eval_policy_expert"])
def test_cli(script, argv, tmp_path):
    result = script.ex.run_cli(argv + ["device=cpu", f"log_root={tmp_path}", "log_format_strs=['csv']"])
    stats = _completed(tmp_path, result)
    if argv[0] == "dagger":  # the checkpoint holds the SAC expert, as the JAX package's cloudpickle does
        (scratch,) = [p for p in tmp_path.glob("seals_HalfCheetah-v1/*/scratch") if not p.parent.is_symlink()]
        venv = make_vec_env(ENV, num_envs=4, device="cpu")
        trainer = dagger.reconstruct_trainer(scratch, venv)
        expert = serialize.load_policy_from_path(str(tools.EXPERT), device="cpu").sample_fn()
        obs = torch.from_numpy(venv.reset(seed=0).astype(np.float32))
        got = trainer.expert_policy_apply(obs, torch.Generator().manual_seed(0))[0]
        want = expert(obs, torch.Generator().manual_seed(0))[0]
        assert torch.equal(got, want)
        venv.close()
    if script is eval_policy:
        assert stats["n_traj"] >= 4 and stats["len_mean"] == 100
        assert stats["return_mean"] > 300  # the expert runs forward at about 7 m/s
