"""The port's seals MuJoCo host envs (``envs/mujoco_native.py``:
HalfCheetah, Hopper, Walker2d, Swimmer) against the JAX package's
``MujocoLockstepVectorEnv`` (MuJoCo through ``mujoco.rollout``), and the
paths on top of them.

* Spaces, reset states and the reset draws' order (HalfCheetah's normal
  qvel noise, the others' uniform): equal exactly for the same seed
  (numpy's generator in both); a reseeding ``reset(seed)`` too.
* One env step from the same states: obs within 1e-8 of their scale (qvel
  clipped to +-10 for Hopper and Walker2d, the clip reached), reward
  within 1e-6 relative (the healthy reward included); every output's
  dtype equal to the JAX env's (float64 obs, float32 rewards).
* The fixed-horizon lockstep auto-reset, as tests/envs/test_mujoco_native.py
  checks it for the JAX env.
* ``make_vec_env`` returns the lockstep env on the asked device; seals/Ant
  and the gym bridge raise.
* ``HostCollector`` over both envs with one deterministic policy: float32
  ``obs``/``next_obs`` in both chunks (the cast happens in the port's
  collector), each field within 1e-5 over 3 steps (random weights) and
  1e-8 over 10 (constant actions); ``CppVectorEnv``'s float32
  observations pass through the cast as the same array.
* The repo's expert of each env, deterministic, from reset seed 12345
  over the fixture's envs (16 HalfCheetah, 1024 Hopper and Walker2d, 64
  Swimmer: ``tools.EXPERT_ENVS``), one 1000-step episode each: mean return
  within 1% of the JAX env's (the figure the fixture records, which
  tests/test_torch_mujoco_model.py regenerates).
* The first demo episode of each env: its stored rewards against the seals
  reward recomputed from its observations and actions.
* The CLI on the CPU: ``train_adversarial gail`` / ``airl`` and
  ``train_imitation bc`` / ``dagger`` with each env's tuned config and
  ``fast`` (HalfCheetah's DAgger checkpoint, which holds the SAC expert,
  rebuilt by ``reconstruct_trainer``), and ``eval_policy`` of each expert.
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
from imitation_tpu_torch.envs import mujoco_native
from imitation_tpu_torch.envs.mujoco_native import MujocoLockstepVectorEnv
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.native import CppVectorEnv
from imitation_tpu_torch.policies import serialize
from imitation_tpu_torch.scripts import eval_policy, train_adversarial, train_imitation
from tests import torch_mujoco_tools as tools
from tests.torch_parity import host

torch.set_num_threads(1)

ENV = "seals/HalfCheetah-v1"
ENVS = [tools.ENVS[b][1] for b in tools.BASE_IDS]
BASE = {tools.ENVS[b][1]: b for b in tools.BASE_IDS}
FIELDS = ("obs", "terminal_obs", "reward", "terminated", "truncated", "episode_return", "episode_length")


def _pair(B, env_id=ENV, **kw):
    return JaxEnv(env_id, num_envs=B, **kw), MujocoLockstepVectorEnv(env_id, num_envs=B, device="cpu", **kw)


@pytest.mark.parametrize("env_id", ENVS)
def test_spaces_and_reset_states_equal_jax(env_id):
    jenv, env = _pair(8, env_id, seed=5)
    try:
        for attr in ("observation_space", "action_space"):
            j, t = getattr(jenv, attr), getattr(env, attr)
            assert (j.shape, j.dtype, j.n) == (t.shape, t.dtype, t.n), attr
            np.testing.assert_array_equal(j.low, t.low)
            np.testing.assert_array_equal(j.high, t.high)
        assert env.max_episode_steps == jenv.max_episode_steps == 1000
        dim = env.engine.nq + env.engine.nv
        for seed in (None, 12345):  # the constructor's seed, then a reseed
            want, got = jenv.reset(seed=seed), env.reset(seed=seed)
            assert got.dtype == want.dtype == np.float64 and got.shape == (8, dim)
            np.testing.assert_array_equal(got, want)
    finally:
        jenv.close()
        env.close()


@pytest.mark.parametrize("env_id", ENVS)
def test_env_step_equals_jax(env_id):
    jenv, env = _pair(16, env_id, seed=3)
    nq, nv, nu = env.engine.nq, env.engine.nv, env.engine.nu
    clip = env._qvel_clip
    clipped = 0
    try:
        jenv.reset(), env.reset()
        rng = np.random.default_rng(0)
        if clip is not None:  # fast joints at the start, so that the observations reach the clip
            jenv._states[:, 1 + nq:] += rng.uniform(-2 * clip, 2 * clip, (16, nv))
        for t in range(30):
            # the port's env restarts each step from the JAX env's state
            env._qpos[:], env._qvel[:] = jenv._states[:, 1:1 + nq], jenv._states[:, 1 + nq:]
            acts = rng.uniform(-1.2, 1.2, (16, nu)).astype(np.float32)
            want, got = jenv.step(acts), env.step(acts)
            for k in FIELDS:
                assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            scale = max(1.0, float(np.abs(want["obs"]).max()))
            assert np.abs(got["obs"] - want["obs"]).max() <= 1e-8 * scale
            np.testing.assert_allclose(got["reward"], want["reward"], rtol=1e-6, atol=1e-6)
            assert (got["episode_length"] == want["episode_length"]).all()
            if clip is not None:
                assert np.abs(got["obs"][:, nq:]).max() <= clip
                clipped += int((np.abs(want["obs"][:, nq:]) == clip).sum())
    finally:
        jenv.close()
        env.close()
    assert (clipped > 0) == (clip is not None)


@pytest.mark.parametrize("env_id", ENVS)
def test_fixed_horizon_autoreset(env_id):
    venv = make_vec_env(env_id, num_envs=2, max_episode_steps=7, device="cpu")
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
    for family in ("HalfCheetah", "Hopper", "Walker2d", "Swimmer"):
        for version in ("v0", "v1"):
            venv = make_vec_env(f"seals/{family}-{version}", num_envs=3, device="cpu")
            assert isinstance(venv, MujocoLockstepVectorEnv) and venv.is_host
            assert venv.device == torch.device("cpu") and venv.num_envs == 3
            venv.close()
    for name in ("seals/Ant-v0", "seals/Ant-v1"):
        with pytest.raises(NotImplementedError, match="not ported yet.*queue A"):
            make_vec_env(name, num_envs=2, device="cpu")
    with pytest.raises(NotImplementedError, match="gym bridge"):
        make_vec_env(ENV, num_envs=2, device="cpu", lockstep=False)


@pytest.mark.parametrize("env_id", ENVS)
@pytest.mark.parametrize("policy_kind, T, tol", [("random", 3, 1e-5), ("constant", 10, 1e-8)])
def test_host_collector_casts_to_float32_as_jax_does(policy_kind, T, tol, env_id):
    """With random weights the two float32 MLPs' actions differ by rounding
    (4e-8 at the first step), which the contacts grow about threefold a
    step, so 3 steps are compared; with the first layer zeroed the actions
    are equal and 10 steps agree to the physics' rounding."""
    B = 4
    jenv, env = _pair(B, env_id, seed=1)
    obs_dim = env.observation_space.shape[0]
    jpolicy = JaxPolicy(jenv.observation_space, jenv.action_space, hid_sizes=(16, 16))
    variables = jpolicy.init(jax.random.key(0))
    if policy_kind == "constant":
        variables = jax.tree_util.tree_map_with_path(
            lambda path, x: x * 0 if "kernel" in jax.tree_util.keystr(path) and x.shape[0] == obs_dim else x,
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


@pytest.mark.parametrize("env_id", ENVS)
def test_expert_return_within_one_percent_of_jax(env_id):
    base_id = BASE[env_id]
    want = np.load(tools.fixture_path(base_id))["expert_returns"]
    act = serialize.load_policy_from_path(str(tools.expert_path(base_id)), device="cpu").deterministic_fn()
    venv = MujocoLockstepVectorEnv(env_id, num_envs=len(want), device="cpu")
    obs, ret = venv.reset(seed=12345), np.zeros(len(want))
    for _ in range(venv.max_episode_steps):
        with torch.inference_mode():
            acts = act(torch.from_numpy(obs.astype(np.float32)))[0].numpy()
        out = venv.step(acts)
        ret += out["reward"]
        obs = out["obs"]
    venv.close()
    assert out["truncated"].all() and np.isfinite(ret).all()
    assert abs(ret.mean() - want.mean()) <= 0.01 * abs(want.mean()), (ret.mean(), want.mean())


def _completed(tmp_path, result, env_id=ENV):
    env_dir = tmp_path / env_id.replace("/", "_")
    (run_dir,) = [p for p in env_dir.iterdir() if p.is_dir() and not p.is_symlink()]
    run = json.loads((run_dir / "run.json").read_text())
    assert run["status"] == "COMPLETED"
    assert json.loads((run_dir / "config.json").read_text())["env_name"] == env_id
    stats = result.get("imit_stats", result)
    assert np.isfinite(stats["return_mean"])
    return stats


# the tuned configs' names: the seals env's family, as the JAX package names them
_CONFIG = {"seals/HalfCheetah-v1": "seals_half_cheetah", "seals/Hopper-v1": "seals_hopper",
           "seals/Walker2d-v1": "seals_walker", "seals/Swimmer-v1": "seals_swimmer"}


def _eval_argv(env_id):
    return ["with", "expert.policy_type=saved", f"expert.loader_kwargs.path={tools.expert_path(BASE[env_id])}",
            f"env_name={env_id}", "num_envs=4", "eval_n_episodes=4", "max_episode_steps=100"]


_CLI = [(train_adversarial, ["gail", "with", "gail_seals_half_cheetah", "fast"], ENV),
        (train_imitation, ["bc", "with", "bc_seals_half_cheetah", "fast"], ENV),
        (train_imitation, ["dagger", "with", "dagger_seals_half_cheetah", "fast"], ENV),
        (eval_policy, _eval_argv(ENV), ENV)]
_CLI_IDS = ["gail_seals_half_cheetah", "bc_seals_half_cheetah", "dagger_seals_half_cheetah", "eval_policy_expert"]
for _env in ENVS[1:]:
    for _script, _cmd in ((train_adversarial, "gail"), (train_adversarial, "airl"), (train_imitation, "bc"),
                          (train_imitation, "dagger")):
        _CLI.append((_script, [_cmd, "with", f"{_cmd}_{_CONFIG[_env]}", "fast"], _env))
        _CLI_IDS.append(f"{_cmd}_{_CONFIG[_env]}")
    _CLI.append((eval_policy, _eval_argv(_env), _env))
    _CLI_IDS.append(f"eval_policy_{_CONFIG[_env]}")


@pytest.mark.parametrize("script, argv, env_id", _CLI, ids=_CLI_IDS)
def test_cli(script, argv, env_id, tmp_path):
    result = script.ex.run_cli(argv + ["device=cpu", f"log_root={tmp_path}", "log_format_strs=['csv']"])
    stats = _completed(tmp_path, result, env_id)
    if argv[0] == "dagger":  # the checkpoint holds the expert, as the JAX package's cloudpickle does
        env_dir = env_id.replace("/", "_")
        (scratch,) = [p for p in tmp_path.glob(f"{env_dir}/*/scratch") if not p.parent.is_symlink()]
        venv = make_vec_env(env_id, num_envs=4, device="cpu")
        trainer = dagger.reconstruct_trainer(scratch, venv)
        expert = serialize.load_policy_from_path(str(tools.expert_path(BASE[env_id])), device="cpu").sample_fn()
        obs = torch.from_numpy(venv.reset(seed=0).astype(np.float32))
        got = trainer.expert_policy_apply(obs, torch.Generator().manual_seed(0))[0]
        want = expert(obs, torch.Generator().manual_seed(0))[0]
        assert torch.equal(got, want)
        venv.close()
    if script is eval_policy:
        assert stats["n_traj"] >= 4 and stats["len_mean"] == 100
        # the experts run forward: HalfCheetah at about 7 m/s; Hopper and Walker2d
        # collect the healthy reward (1.0 a step) besides
        assert stats["return_mean"] > {ENV: 300, "seals/Hopper-v1": 150, "seals/Walker2d-v1": 150,
                                       "seals/Swimmer-v1": 5}[env_id]


# (healthy reward the env pays, steps of the first demo episode whose stored
# reward is the seals reward less it, the rest equal to the seals reward)
_DEMO_REWARDS = {"seals/HalfCheetah-v1": (0.0, 0), "seals/Hopper-v1": (1.0, 993),
                 "seals/Walker2d-v1": (1.0, 803), "seals/Swimmer-v1": (0.0, 0)}


@pytest.mark.parametrize("env_id", ENVS)
def test_demo_rewards_carry_gymnasium_healthy_reward(env_id):
    """The repo's demos (output/experts/*/rollouts) were recorded under
    gymnasium v5's conditional healthy reward, not the seals one that the
    JAX env and the port pay on every step: on the first episode the stored
    reward is the seals reward, forward velocity less the control cost plus
    the healthy reward, recomputed from the float32 observations and
    actions (within 2e-3), less the healthy reward on most of Hopper's and
    Walker2d's steps and equal to it on the others. This is why their
    demos' mean returns (644.0, 2454.6) sit about 1,000 and 740 below the
    experts' evaluation returns; GAIL and BC never read them."""
    from imitation_tpu_torch.data import serialize as data_serialize

    base_id = BASE[env_id]
    model = mujoco_native.load_model(tools.ENVS[base_id][0])
    env = model["env"]
    dt = model["opt"]["timestep"] * env["frame_skip"]
    healthy, withheld = _DEMO_REWARDS[env_id]
    assert env["healthy_reward"] == healthy
    traj = next(iter(data_serialize.load(str(tools.EXPERTS / tools.ENVS[base_id][2] / "rollouts"))))
    obs, acts = traj.obs.astype(np.float64), traj.acts.astype(np.float64)
    seals = (env["forward_reward_weight"] * (obs[1:, 0] - obs[:-1, 0]) / dt
             - env["ctrl_cost_weight"] * np.sum(np.square(acts), 1) + healthy)
    diff = seals - np.asarray(traj.rews, np.float64)
    less = np.abs(diff - healthy) < 2e-3 if healthy else np.zeros(len(diff), bool)
    assert int(less.sum()) == withheld
    assert (np.abs(diff[~less]) < 2e-3).all()
