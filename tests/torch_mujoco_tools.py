"""Writes the port's MuJoCo model files and its chip fixtures from MuJoCo itself.

For each seals MuJoCo env the port steps (HalfCheetah, Hopper, Walker2d,
Swimmer), ``imitation_tpu_torch/envs/assets/<name>.json`` holds what
``mujoco.MjModel`` holds for gymnasium's ``<name>.xml`` after MuJoCo's
compiler has run (inertias from the geoms scaled to ``settotalmass``,
``invweight0``, the filled-in defaults), plus the gymnasium env's settings
(frame skip, horizon, reward weights, reset noise, spaces) and the JAX
env's seals settings (``imitation_tpu/envs/mujoco_native.py`` ``_SPECS``:
the qvel clip of the observation, the healthy reward; its reset rule: qvel
noise normal for HalfCheetah, uniform for the others). The port's engine
(``imitation_tpu_torch/native/mjtree.cpp``) reads it, so MuJoCo's compiler
is never needed there.

``imitation_tpu_torch/envs/assets/<name>_fixture.npz`` is MuJoCo's own
answer for 64 env steps from states with contacts (states, actions, next
states, rewards; for Hopper half of them folded, with capsule-capsule
contacts), and the JAX env's deterministic return of the repo's expert
(``EXPERT_ENVS`` envs from reset seed 12345, one 1000-step episode each),
for ``chip_smoke.py``'s check on a machine without MuJoCo.

Run from the repository root (needs ``mujoco``, ``gymnasium`` and, for the
expert figures, the JAX package):

    python -m tests.torch_mujoco_tools

The tests (``tests/test_torch_mujoco_model.py``) regenerate them and hold
them equal to the committed copies.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
ASSETS = ROOT / "imitation_tpu_torch" / "envs" / "assets"
EXPERTS = ROOT / "output" / "experts"

# gymnasium id -> (model file name, the seals env, the repo's expert)
ENVS = {
    "HalfCheetah-v5": ("half_cheetah", "seals/HalfCheetah-v1", "seals_half_cheetah"),
    "Hopper-v5": ("hopper", "seals/Hopper-v1", "seals_hopper"),
    "Walker2d-v5": ("walker2d_v5", "seals/Walker2d-v1", "seals_walker2d"),
    "Swimmer-v5": ("swimmer", "seals/Swimmer-v1", "seals_swimmer"),
}
BASE_IDS = tuple(ENVS)

# Envs of the expert-return figure. Two engines that agree to 1e-15 a step
# still part over a 1000-step episode (the dynamics are chaotic), and on the
# card the expert's float32 actions differ from the CPU's in the last bits,
# so there the episodes are fresh samples: the mean must be over enough
# envs. Hopper's deterministic episodes spread 11-13% of their mean,
# Walker2d's 7%: over 64 envs the card's Hopper mean stood 2.9% from the
# JAX env's; over 1024 the difference of two independent means has a
# standard deviation of 0.5% (Hopper) and 0.3% (Walker2d). HalfCheetah's
# and Swimmer's spread 1%: 16 (HalfCheetah's figure since it was ported)
# and 64 envs.
EXPERT_ENVS = {"HalfCheetah-v5": 16, "Hopper-v5": 1024, "Walker2d-v5": 1024, "Swimmer-v5": 64}


def model_path(base_id: str) -> Path:
    return ASSETS / f"{ENVS[base_id][0]}.json"


def fixture_path(base_id: str) -> Path:
    return ASSETS / f"{ENVS[base_id][0]}_fixture.npz"


def expert_path(base_id: str) -> Path:
    return EXPERTS / ENVS[base_id][2] / "policy"


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
    "geom_solmix", "geom_margin", "geom_gap", "geom_fluid",
    "actuator_trntype", "actuator_dyntype", "actuator_gaintype", "actuator_biastype", "actuator_trnid",
    "actuator_gainprm", "actuator_gear", "actuator_ctrlrange", "actuator_ctrllimited",
)
OPT_FIELDS = ("timestep", "gravity", "impratio", "integrator", "cone", "solver", "iterations",
              "tolerance", "noslip_iterations", "disableflags", "enableflags", "viscosity", "density", "wind")


def _plain(x):
    a = np.asarray(x)
    if a.dtype == bool:
        return a.astype(int).tolist()
    return a.tolist()


def seals_settings(base_id: str) -> dict:
    """The JAX env's seals settings for ``base_id``: its ``_SPECS`` entry
    (qvel clip, healthy reward) and its reset rule's qvel noise
    (``MujocoLockstepVectorEnv.__init__``: normal for HalfCheetah and Ant,
    uniform for the other families)."""
    from imitation_tpu.envs.mujoco_native import _SPECS

    _, qvel_clip, healthy = _SPECS[ENVS[base_id][1]]
    return {"qvel_clip": qvel_clip, "healthy_reward": float(healthy),
            "qvel_noise": "normal" if base_id.startswith(("HalfCheetah", "Ant")) else "uniform"}


def compiled_model(base_id: str = "HalfCheetah-v5") -> dict:
    """The compiled model, the gymnasium env's settings and the JAX env's
    seals settings, as JSON values (Python's float repr round-trips every
    float64 exactly)."""
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
            **seals_settings(base_id),
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


# Hopper's folded start (thigh and leg near their lower limits) and the
# actions that keep it folded: the torso then touches the leg and the foot.
HOPPER_FOLD = ((-2.4, -2.4, 0.5), (-1.0, -1.0, 0.0))


def fixture_arrays(base_id: str = "HalfCheetah-v5", steps: int = 64, seed: int = 0) -> dict:
    """MuJoCo's steps of a random-action run from the env's reset draw
    (HalfCheetah's rule for HalfCheetah, uniform qvel for the others) after
    40 steps to fall onto the floor: ``qpos``/``qvel`` [steps, nq/nv] before
    each step, ``act`` [steps, nu] (float32, some beyond the control range),
    ``next_qpos``, ``next_qvel`` and ``reward`` (the seals reward on the
    unclamped action, the healthy reward included); ``ncon`` the contacts
    at each start state. For Hopper the second half of the steps starts
    folded (``HOPPER_FOLD``, 8 steps in) under actions near the fold's, so
    that the torso's capsule touches the leg's and the foot's."""
    import gymnasium as gym
    import mujoco

    env = gym.make(base_id, exclude_current_positions_from_observation=False).unwrapped
    m, fs, dt = env.model, env.frame_skip, env.dt
    fwd, ctrl, healthy = env._forward_reward_weight, env._ctrl_cost_weight, seals_settings(base_id)["healthy_reward"]
    d = mujoco.MjData(m)
    rng = np.random.default_rng(seed)
    noise = env._reset_noise_scale
    qpos = env.init_qpos + rng.uniform(-noise, noise, m.nq)
    if seals_settings(base_id)["qvel_noise"] == "normal":
        qvel = env.init_qvel + noise * rng.standard_normal(m.nv)
    else:
        qvel = env.init_qvel + rng.uniform(-noise, noise, m.nv)
    for _ in range(40):  # fall onto the floor first
        qpos, qvel = _mujoco_env_step(m, d, qpos, qvel, rng.uniform(-1, 1, m.nu), fs)
    rec = {k: [] for k in ("qpos", "qvel", "act", "next_qpos", "next_qvel", "reward", "ncon")}
    fold = base_id.startswith("Hopper")
    for t in range(steps):
        if fold and t == steps // 2:
            qpos, qvel = env.init_qpos.copy(), env.init_qvel.copy()
            qpos[3:] = HOPPER_FOLD[0]
            for _ in range(8):
                qpos, qvel = _mujoco_env_step(m, d, qpos, qvel, np.asarray(HOPPER_FOLD[1]), fs)
        act = rng.uniform(-1.2, 1.2, m.nu).astype(np.float32)
        if fold and t >= steps // 2:
            act = (np.asarray(HOPPER_FOLD[1]) + rng.uniform(-0.3, 0.3, m.nu)).astype(np.float32)
        d.qpos[:], d.qvel[:] = qpos, qvel
        mujoco.mj_forward(m, d)
        rec["ncon"].append(d.ncon)
        nq, nv = _mujoco_env_step(m, d, qpos, qvel, act, fs)
        a64 = act.astype(np.float64)
        rec["reward"].append(fwd * (nq[0] - qpos[0]) / dt - ctrl * np.sum(np.square(a64)) + healthy)
        for k, v in (("qpos", qpos), ("qvel", qvel), ("act", act), ("next_qpos", nq), ("next_qvel", nv)):
            rec[k].append(v)
        qpos, qvel = nq, nv
    env.close()
    out = {k: np.asarray(v) for k, v in rec.items()}
    out["ncon"] = out["ncon"].astype(np.int32)
    return out


def jax_expert_returns(base_id: str = "HalfCheetah-v5", seed: int = 12345) -> np.ndarray:
    """The repo's expert for ``base_id``, deterministic, on the JAX
    package's lockstep env: one 1000-step episode in each of
    ``EXPERT_ENVS[base_id]`` envs from reset ``seed``, the expert loaded by
    the port's CPU loader and fed float32 observations. The per-env returns."""
    import torch

    num_envs = EXPERT_ENVS[base_id]
    from imitation_tpu.envs.mujoco_native import MujocoLockstepVectorEnv
    from imitation_tpu_torch.policies import serialize

    act = serialize.load_policy_from_path(str(expert_path(base_id)), device="cpu").deterministic_fn()
    venv = MujocoLockstepVectorEnv(ENVS[base_id][1], num_envs=num_envs)
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


def fixture(base_id: str = "HalfCheetah-v5", with_expert: bool = True) -> dict:
    out = fixture_arrays(base_id)
    if with_expert:
        out["expert_returns"] = jax_expert_returns(base_id)
    return out


def main() -> None:
    ASSETS.mkdir(parents=True, exist_ok=True)
    for base_id in BASE_IDS:
        model_path(base_id).write_text(model_text(base_id))
        np.savez_compressed(fixture_path(base_id), **fixture(base_id))
        print(f"wrote {model_path(base_id).relative_to(ROOT)} and {fixture_path(base_id).relative_to(ROOT)}")


if __name__ == "__main__":
    main()
