"""Writes the port's MuJoCo model files and its chip fixture from MuJoCo itself.

``imitation_tpu_torch/envs/assets/half_cheetah.json`` holds what
``mujoco.MjModel`` holds for gymnasium's ``half_cheetah.xml`` after MuJoCo's
compiler has run (inertias from the geoms scaled to ``settotalmass``,
``invweight0``, the filled-in defaults), plus the gymnasium env's settings
(frame skip, horizon, reward weights, reset noise, spaces). The port's
engine (``imitation_tpu_torch/native/mjtree.cpp``) reads it, so MuJoCo's
compiler is never needed there.

``imitation_tpu_torch/envs/assets/half_cheetah_fixture.npz`` is MuJoCo's
own answer for 64 env steps with contacts (states, actions, next states,
rewards), and the JAX env's deterministic return of the repo's SAC expert
(16 envs from reset seed 12345, one 1000-step episode each), for
``chip_smoke.py``'s check on a machine without MuJoCo.

Run from the repository root (needs ``mujoco``, ``gymnasium`` and, for the
expert figure, the JAX package):

    python -m tests.torch_mujoco_tools

The tests (``tests/test_torch_mujoco_model.py``) regenerate both and hold
them equal to the committed copies.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
ASSETS = ROOT / "imitation_tpu_torch" / "envs" / "assets"
MODEL_PATH = ASSETS / "half_cheetah.json"
FIXTURE_PATH = ASSETS / "half_cheetah_fixture.npz"
EXPERT = ROOT / "output" / "experts" / "seals_half_cheetah" / "policy"

# The compiled model's arrays, by their MjModel names.
MODEL_FIELDS = (
    "body_parentid", "body_rootid", "body_jntadr", "body_jntnum", "body_weldid", "body_pos",
    "body_quat", "body_mass", "body_subtreemass", "body_ipos", "body_iquat", "body_inertia",
    "body_invweight0",
    "jnt_type", "jnt_bodyid", "jnt_qposadr", "jnt_dofadr", "jnt_pos", "jnt_axis", "jnt_stiffness",
    "jnt_range", "jnt_limited", "jnt_solref", "jnt_solimp", "jnt_margin",
    "qpos0", "qpos_spring", "dof_armature", "dof_damping", "dof_invweight0",
    "geom_type", "geom_bodyid", "geom_size", "geom_pos", "geom_quat", "geom_contype",
    "geom_conaffinity", "geom_condim", "geom_friction", "geom_solref", "geom_solimp",
    "geom_solmix", "geom_margin", "geom_gap",
    "actuator_trntype", "actuator_dyntype", "actuator_gaintype", "actuator_biastype", "actuator_trnid",
    "actuator_gainprm", "actuator_gear", "actuator_ctrlrange", "actuator_ctrllimited",
)
OPT_FIELDS = ("timestep", "gravity", "impratio", "integrator", "cone", "solver", "iterations",
              "tolerance", "noslip_iterations", "disableflags", "enableflags")


def _plain(x):
    a = np.asarray(x)
    if a.dtype == bool:
        return a.astype(int).tolist()
    return a.tolist()


def compiled_model(base_id: str = "HalfCheetah-v5") -> dict:
    """The compiled model and the gymnasium env's settings, as JSON values
    (Python's float repr round-trips every float64 exactly)."""
    import gymnasium as gym

    env = gym.make(base_id, exclude_current_positions_from_observation=False).unwrapped
    m = env.model
    obs_space, act_space = env.observation_space, env.action_space
    out = {
        "name": os.path.splitext(os.path.basename(env.fullpath))[0],
        "source": f"gymnasium {gym.__version__} {base_id} ({os.path.basename(env.fullpath)}), "
                  f"compiled by mujoco {__import__('mujoco').__version__}",
        "sizes": {k: int(getattr(m, k)) for k in ("nq", "nv", "nu", "nbody", "njnt", "ngeom")},
        "opt": {k: _plain(getattr(m.opt, k)) for k in OPT_FIELDS},
        "model": {k: _plain(getattr(m, k)) for k in MODEL_FIELDS},
        "env": {
            "frame_skip": int(env.frame_skip),
            "max_episode_steps": int(gym.spec(base_id).max_episode_steps),
            "forward_reward_weight": float(env._forward_reward_weight),
            "ctrl_cost_weight": float(env._ctrl_cost_weight),
            "reset_noise_scale": float(env._reset_noise_scale),
            "qvel_noise": "normal",
            "init_qpos": _plain(env.init_qpos),
            "init_qvel": _plain(env.init_qvel),
            "observation_space": {"shape": list(obs_space.shape), "dtype": str(obs_space.dtype),
                                  "low": _plain(obs_space.low), "high": _plain(obs_space.high)},
            "action_space": {"shape": list(act_space.shape), "dtype": str(act_space.dtype),
                             "low": _plain(act_space.low), "high": _plain(act_space.high)},
        },
    }
    env.close()
    return out


def model_text(base_id: str = "HalfCheetah-v5") -> str:
    return json.dumps(compiled_model(base_id), indent=1, allow_nan=True) + "\n"


def _mujoco_env_step(m, d, qpos, qvel, act, frame_skip):
    """One gymnasium env step from (qpos, qvel): the next state and x."""
    import mujoco

    d.qpos[:], d.qvel[:] = qpos, qvel
    d.ctrl[:] = act
    mujoco.mj_step(m, d, nstep=frame_skip)
    return d.qpos.copy(), d.qvel.copy()


def fixture_arrays(steps: int = 64, seed: int = 0) -> dict:
    """MuJoCo's steps of one random-action run, started from a state in
    contact: ``qpos``/``qvel`` [steps, nq/nv] before each step, ``act``
    [steps, nu] (float32, some beyond the control range), ``next_qpos``,
    ``next_qvel`` and ``reward`` (the seals reward on the unclamped
    action); ``ncon`` the contacts at each start state."""
    import gymnasium as gym
    import mujoco

    env = gym.make("HalfCheetah-v5", exclude_current_positions_from_observation=False).unwrapped
    m, fs, dt = env.model, env.frame_skip, env.dt
    d = mujoco.MjData(m)
    rng = np.random.default_rng(seed)
    qpos = env.init_qpos + rng.uniform(-0.1, 0.1, m.nq)
    qvel = env.init_qvel + 0.1 * rng.standard_normal(m.nv)
    for _ in range(40):  # fall onto the floor first
        qpos, qvel = _mujoco_env_step(m, d, qpos, qvel, rng.uniform(-1, 1, m.nu), fs)
    rec = {k: [] for k in ("qpos", "qvel", "act", "next_qpos", "next_qvel", "reward", "ncon")}
    for _ in range(steps):
        act = rng.uniform(-1.2, 1.2, m.nu).astype(np.float32)
        d.qpos[:], d.qvel[:] = qpos, qvel
        mujoco.mj_forward(m, d)
        rec["ncon"].append(d.ncon)
        nq, nv = _mujoco_env_step(m, d, qpos, qvel, act, fs)
        a64 = act.astype(np.float64)
        rec["reward"].append((nq[0] - qpos[0]) / dt - 0.1 * np.sum(np.square(a64)))
        for k, v in (("qpos", qpos), ("qvel", qvel), ("act", act), ("next_qpos", nq), ("next_qvel", nv)):
            rec[k].append(v)
        qpos, qvel = nq, nv
    env.close()
    out = {k: np.asarray(v) for k, v in rec.items()}
    out["ncon"] = out["ncon"].astype(np.int32)
    return out


def jax_expert_returns(num_envs: int = 16, seed: int = 12345) -> np.ndarray:
    """The repo's SAC expert, deterministic, on the JAX package's lockstep
    env: one 1000-step episode in each of ``num_envs`` envs from reset
    ``seed``, the expert loaded by the port's CPU loader and fed float32
    observations. The per-env returns."""
    import torch

    from imitation_tpu.envs.mujoco_native import MujocoLockstepVectorEnv
    from imitation_tpu_torch.policies import serialize

    act = serialize.load_policy_from_path(str(EXPERT), device="cpu").deterministic_fn()
    venv = MujocoLockstepVectorEnv("seals/HalfCheetah-v1", num_envs=num_envs)
    try:
        obs = venv.reset(seed=seed)
        ret = np.zeros(num_envs)
        for _ in range(venv.max_episode_steps):
            with torch.inference_mode():
                acts = act(torch.from_numpy(obs.astype(np.float32)))[0].numpy()
            out = venv.step(acts)
            ret += out["reward"]
            obs = out["obs"]
        return ret
    finally:
        venv.close()


def fixture(with_expert: bool = True) -> dict:
    out = fixture_arrays()
    if with_expert:
        out["expert_returns"] = jax_expert_returns()
    return out


def main() -> None:
    ASSETS.mkdir(parents=True, exist_ok=True)
    MODEL_PATH.write_text(model_text())
    np.savez_compressed(FIXTURE_PATH, **fixture())
    print(f"wrote {MODEL_PATH.relative_to(ROOT)} and {FIXTURE_PATH.relative_to(ROOT)}")


if __name__ == "__main__":
    main()
