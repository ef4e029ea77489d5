"""The port's MuJoCo-compatible engine (``native/mjtree.cpp``) against MuJoCo,
stage by stage, on the compiled models of seals/HalfCheetah (Euler),
Hopper, Walker2d and Swimmer (RK4).

* About 500 states a model from a random-action run and an expert run
  (the repo's expert, deterministic; for Hopper also folded runs): every
  stage of ``mj_forward`` within 1e-9 of each quantity's scale (its
  largest magnitude over the states, at least 1): kinematics (body,
  inertial and geom frames, subtree centres of mass), com-frame inertias
  and motion axes, velocities, the full M, ``qfrc_bias``, ``qfrc_passive``
  (Swimmer's inertia-box fluid forces in it), ``qfrc_actuator``,
  ``qacc_smooth``, the contacts (position, frame, distance, geoms), the
  constraint rows (``efc_J``, type, pos, diagApprox, R, D, aref, vel,
  force) and ``qacc``; the contact and row counts exactly. Among the
  states: floor contacts (HalfCheetah 1 to 4 at once), joint limits,
  Hopper's frictionless capsule-capsule contacts (two at once where the
  torso's and the foot's capsules are parallel).
* One substep (``mj_step``: Euler, or RK4's four forward passes) and one
  env step (``frame_skip`` substeps) from every state: qpos and qvel
  within 1e-8 of their scale; the seals reward within 1e-6 relative.
* The committed chip fixture through ``MujocoEngine`` as ``chip_smoke.py``
  steps it, within 1e-8.
* Steps are independent of the thread count, and a bad array raises.
"""

import gymnasium as gym
import mujoco
import numpy as np
import pytest
import torch

from imitation_tpu_torch.envs import mujoco_native
from imitation_tpu_torch.policies import serialize
from tests import torch_mujoco_tools as tools

STAGE_TOL = 1e-9
STEP_TOL = 1e-8


class Sim:
    """One model in MuJoCo and in the port's engine, with the env's settings."""

    def __init__(self, base_id):
        self.base_id = base_id
        self.gym_env = gym.make(base_id, exclude_current_positions_from_observation=False).unwrapped
        self.m = self.gym_env.model
        self.d = mujoco.MjData(self.m)
        self.model = mujoco_native.load_model(tools.ENVS[base_id][0])
        self.engine = mujoco_native.MujocoEngine(self.model)
        env = self.model["env"]
        self.frame_skip = env["frame_skip"]
        self.dt = self.model["opt"]["timestep"] * self.frame_skip
        self.weights = (env["forward_reward_weight"], env["ctrl_cost_weight"], env["healthy_reward"])
        self.qvel_clip = env["qvel_clip"]

    def reward(self, x_before, x_after, ctrl):
        fwd, cost, healthy = self.weights
        return fwd * (x_after - x_before) / self.dt - cost * np.sum(np.square(ctrl), axis=-1) + healthy


@pytest.fixture(scope="module", params=tools.BASE_IDS)
def sim(request):
    s = Sim(request.param)
    yield s
    s.engine.close()
    s.gym_env.close()


@pytest.fixture(scope="module")
def states(sim):
    return _states(sim)


def _states(sim):
    """(qpos, qvel, ctrl) at every env step of a random-action run (ctrl
    beyond the control range too) and of the expert's run, and at every
    substep of the first 20 random steps; for Hopper also every env step
    of folded runs (the torso's capsule against the leg's and the foot's)."""
    m, d, fs = sim.m, sim.d, sim.frame_skip
    init_qpos = sim.gym_env.init_qpos
    out = []
    rng = np.random.default_rng(0)
    mujoco.mj_resetData(m, d)
    d.qpos[:] = init_qpos + rng.uniform(-0.1, 0.1, m.nq)
    d.qvel[:] = 0.1 * rng.standard_normal(m.nv)
    for t in range(300):
        ctrl = rng.uniform(-1.2, 1.2, m.nu)
        for s in range(fs):
            if s == 0 or t < 20:
                out.append((d.qpos.copy(), d.qvel.copy(), ctrl))
            d.ctrl[:] = ctrl
            mujoco.mj_step(m, d)
    act = serialize.load_policy_from_path(str(tools.expert_path(sim.base_id)), device="cpu").deterministic_fn()
    mujoco.mj_resetData(m, d)
    d.qpos[:] = init_qpos + rng.uniform(-0.1, 0.1, m.nq)
    for _ in range(120):
        qvel = d.qvel if sim.qvel_clip is None else np.clip(d.qvel, -sim.qvel_clip, sim.qvel_clip)
        obs = np.concatenate([d.qpos, qvel]).astype(np.float32)[None]
        with torch.inference_mode():
            ctrl = act(torch.from_numpy(obs))[0].numpy()[0].astype(np.float64)
        out.append((d.qpos.copy(), d.qvel.copy(), ctrl))
        d.ctrl[:] = ctrl
        mujoco.mj_step(m, d, nstep=fs)
    if sim.base_id == "Hopper-v5":
        # the torso's and the foot's capsules parallel (thigh + leg + foot =
        # -3 pi / 2): MuJoCo's two-contact branch of the capsule pair
        for thigh, leg in ((-2.3, -1.95), (-2.3, -1.9), (-2.3, -1.85), (-2.2, -2.0), (-2.1, -2.1)):
            qpos = sim.gym_env.init_qpos.copy()
            qpos[3:] = (thigh, leg, -1.5 * np.pi - thigh - leg)
            out.append((qpos, 0.1 * rng.standard_normal(m.nv), rng.uniform(-1, 1, m.nu)))
        for foot in (-0.6, 0.0, 0.6):
            mujoco.mj_resetData(m, d)
            d.qpos[3:] = (-2.4, -2.4, foot)
            for _ in range(40):
                ctrl = np.asarray(tools.HOPPER_FOLD[1]) + rng.uniform(-0.3, 0.3, m.nu)
                out.append((d.qpos.copy(), d.qvel.copy(), ctrl))
                d.ctrl[:] = ctrl
                mujoco.mj_step(m, d, nstep=fs)
    return out


# What the states must cover, by model: the contact counts seen, and the
# least number of states with a row of each type (limit, frictionless,
# pyramidal) and with fluid forces.
COVER = {
    "HalfCheetah-v5": ({1, 2, 3, 4}, 20, 0, 100, 0),
    "Hopper-v5": ({1, 2}, 20, 60, 100, 0),
    "Walker2d-v5": ({1, 2, 3}, 20, 0, 100, 0),
    "Swimmer-v5": ({0}, 20, 0, 0, 400),
}


def _mujoco_stages(m, d, qpos, qvel, ctrl):
    d.qpos[:], d.qvel[:], d.ctrl[:] = qpos, qvel, ctrl
    mujoco.mj_forward(m, d)
    M = np.zeros((m.nv, m.nv))
    mujoco.mj_fullM(m, d, M)
    n, ne = d.ncon, d.nefc
    con = d.contact
    return {
        "ncon": n, "nefc": ne, "xpos": d.xpos.copy(), "xmat": d.xmat.copy(), "xipos": d.xipos.copy(),
        "geom_xpos": d.geom_xpos.copy(), "geom_xmat": d.geom_xmat.copy(),
        "subtree_com": d.subtree_com.copy(), "cinert": d.cinert.copy(), "cdof": d.cdof.copy(),
        "cvel": d.cvel.copy(), "qM": M, "qfrc_bias": d.qfrc_bias.copy(),
        "qfrc_passive": d.qfrc_passive.copy(), "qfrc_actuator": d.qfrc_actuator.copy(),
        "qacc_smooth": d.qacc_smooth.copy(), "contact_pos": con.pos[:n].copy(),
        "contact_frame": con.frame[:n].copy(), "contact_dist": con.dist[:n].copy(),
        "contact_geom": np.stack([con.geom1[:n], con.geom2[:n]], -1).astype(np.int32),
        "efc_type": d.efc_type[:ne].copy(), "efc_J": d.efc_J[:ne * m.nv].reshape(ne, m.nv).copy(),
        "efc_pos": d.efc_pos[:ne].copy(), "efc_margin": d.efc_margin[:ne].copy(),
        "efc_diagApprox": d.efc_diagA[:ne].copy(), "efc_R": d.efc_R[:ne].copy(), "efc_D": d.efc_D[:ne].copy(),
        "efc_aref": d.efc_aref[:ne].copy(), "efc_vel": d.efc_vel[:ne].copy(),
        "efc_force": d.efc_force[:ne].copy(), "qacc": d.qacc.copy(), "qfrc_constraint": d.qfrc_constraint.copy(),
    }


def test_every_stage_matches_mujoco(sim, states):
    m, d, engine = sim.m, sim.d, sim.engine
    assert not mujoco.mj_isSparse(m)
    assert len(states) >= 200
    pairs = [(_mujoco_stages(m, d, *s), engine.inspect(*s)) for s in states]
    ncons = [w["ncon"] for w, _ in pairs]
    want_ncon, limits, frictionless, pyramidal, fluid = COVER[sim.base_id]
    assert want_ncon <= set(ncons), sorted(set(ncons))
    C = mujoco.mjtConstraint
    for typ, least in ((C.mjCNSTR_LIMIT_JOINT, limits), (C.mjCNSTR_CONTACT_FRICTIONLESS, frictionless),
                       (C.mjCNSTR_CONTACT_PYRAMIDAL, pyramidal)):
        assert sum(bool((w["efc_type"] == typ).any()) for w, _ in pairs) >= least, typ
    if sim.base_id == "Hopper-v5":  # two contacts of one capsule pair: its parallel branch
        assert sum(w["contact_geom"].tolist().count([1, 4]) == 2 for w, _ in pairs) >= 3
    # Swimmer's dofs have no springs or dampers: its passive force is the fluid's
    assert sum(bool(np.abs(w["qfrc_passive"]).max() > 1e-3) for w, _ in pairs) >= fluid
    for want, got in pairs:
        assert (got["ncon"], got["nefc"]) == (want["ncon"], want["nefc"])
        np.testing.assert_array_equal(got["contact_geom"], want["contact_geom"])
        np.testing.assert_array_equal(got["efc_type"], want["efc_type"])
    for k in pairs[0][0]:
        if k in ("ncon", "nefc", "contact_geom", "efc_type"):
            continue
        rows = [(g[k], w[k]) for w, g in pairs if w[k].size]
        if not rows:  # Swimmer: no contacts
            continue
        scale = max(1.0, max(float(np.abs(w).max()) for _, w in rows))
        worst = max(float(np.abs(g - w).max()) for g, w in rows)
        assert worst <= STAGE_TOL * scale, (k, worst, scale)


def test_substep_and_env_step_match_mujoco(sim, states):
    m, d, engine = sim.m, sim.d, sim.engine
    states = states[::2]
    worst = {}
    for nstep in (1, sim.frame_skip):
        got_q, got_v, want_q, want_v, rew_got, rew_want = [], [], [], [], [], []
        for qpos, qvel, ctrl in states:
            d.qpos[:], d.qvel[:], d.ctrl[:] = qpos, qvel, ctrl
            mujoco.mj_step(m, d, nstep=nstep)
            q, v = qpos[None].copy(), qvel[None].copy()
            engine.step(q, v, ctrl[None], nstep)
            got_q.append(q[0]), got_v.append(v[0]), want_q.append(d.qpos.copy()), want_v.append(d.qvel.copy())
            rew_got.append(sim.reward(qpos[0], q[0, 0], ctrl))
            rew_want.append(sim.reward(qpos[0], d.qpos[0], ctrl))
        for name, g, w in (("qpos", got_q, want_q), ("qvel", got_v, want_v)):
            g, w = np.asarray(g), np.asarray(w)
            worst[name, nstep] = float(np.abs(g - w).max() / max(1.0, np.abs(w).max()))
            assert worst[name, nstep] <= STEP_TOL, (name, nstep, worst)
        np.testing.assert_allclose(rew_got, rew_want, rtol=1e-6, atol=1e-6)


def test_fixture_steps(sim):
    """The chip fixture as ``chip_smoke.py`` checks it: all 64 steps at once."""
    fx = np.load(tools.fixture_path(sim.base_id))
    q, v = fx["qpos"].copy(), fx["qvel"].copy()
    sim.engine.step(q, v, fx["act"], sim.frame_skip)
    for got, want in ((q, fx["next_qpos"]), (v, fx["next_qvel"])):
        assert np.abs(got - want).max() <= STEP_TOL * max(1.0, np.abs(want).max())
    reward = sim.reward(fx["qpos"][:, 0], q[:, 0], fx["act"].astype(np.float64))
    np.testing.assert_allclose(reward, fx["reward"], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("base_id", tools.BASE_IDS)
def test_threads_and_bad_arrays(base_id):
    model = mujoco_native.load_model(tools.ENVS[base_id][0])
    fx = np.load(tools.fixture_path(base_id))
    outs = []
    for threads in (1, 3):
        engine = mujoco_native.MujocoEngine(model, threads)
        q, v = fx["qpos"].copy(), fx["qvel"].copy()
        engine.step(q, v, fx["act"], 10)
        outs.append((q, v))
        engine.close()
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    engine = mujoco_native.MujocoEngine(model)
    with pytest.raises(ValueError, match="float64"):
        engine.step(fx["qpos"].astype(np.float32), fx["qvel"].copy(), fx["act"], 1)
    with pytest.raises(ValueError, match="C-contiguous"):
        engine.step(np.asfortranarray(fx["qpos"]), fx["qvel"].copy(), fx["act"], 1)
