"""The port's MuJoCo-compatible engine (``native/mjtree.cpp``) against MuJoCo,
stage by stage, on seals/HalfCheetah's compiled model.

* 500 states from a random-action run and an expert run (the repo's SAC
  expert, deterministic), among them states with 1, 2, 3 and 4 contacts
  and states at a joint limit: every stage of ``mj_forward`` within 1e-9
  of each quantity's scale (its largest magnitude over the states, at
  least 1): kinematics (body, inertial and geom frames, subtree centres
  of mass), com-frame inertias and motion axes, velocities, the full M,
  ``qfrc_bias``, ``qfrc_passive``, ``qfrc_actuator``, ``qacc_smooth``,
  the contacts (position, frame, distance, geoms), the constraint rows
  (``efc_J``, type, pos, diagApprox, R, D, aref, vel, force) and
  ``qacc``; the contact and row counts exactly.
* One substep (``mj_step``) and one env step (``frame_skip`` substeps)
  from every state: qpos and qvel within 1e-8 of their scale; the seals
  reward within 1e-6 relative.
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


@pytest.fixture(scope="module")
def sim():
    env = gym.make("HalfCheetah-v5", exclude_current_positions_from_observation=False).unwrapped
    engine = mujoco_native.MujocoEngine(mujoco_native.load_model("half_cheetah"))
    yield env.model, mujoco.MjData(env.model), engine
    engine.close()
    env.close()


@pytest.fixture(scope="module")
def states(sim):
    m, d, _ = sim
    return _states(m, d)


def _states(m, d):
    """(qpos, qvel, ctrl) at every env step of a random-action run (ctrl
    beyond the control range too) and of the expert's run, and at every
    substep of the first 20 random steps."""
    out = []
    rng = np.random.default_rng(0)
    mujoco.mj_resetData(m, d)
    d.qpos[:] = rng.uniform(-0.1, 0.1, m.nq)
    d.qvel[:] = 0.1 * rng.standard_normal(m.nv)
    for t in range(300):
        ctrl = rng.uniform(-1.2, 1.2, m.nu)
        for s in range(5):
            if s == 0 or t < 20:
                out.append((d.qpos.copy(), d.qvel.copy(), ctrl))
            d.ctrl[:] = ctrl
            mujoco.mj_step(m, d)
    act = serialize.load_policy_from_path(str(tools.EXPERT), device="cpu").deterministic_fn()
    mujoco.mj_resetData(m, d)
    d.qpos[:] = rng.uniform(-0.1, 0.1, m.nq)
    for _ in range(120):
        obs = np.concatenate([d.qpos, d.qvel]).astype(np.float32)[None]
        with torch.inference_mode():
            ctrl = act(torch.from_numpy(obs))[0].numpy()[0].astype(np.float64)
        out.append((d.qpos.copy(), d.qvel.copy(), ctrl))
        d.ctrl[:] = ctrl
        mujoco.mj_step(m, d, nstep=5)
    return out


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
    m, d, engine = sim
    assert not mujoco.mj_isSparse(m)
    assert len(states) >= 200
    pairs = [(_mujoco_stages(m, d, *s), engine.inspect(*s)) for s in states]
    ncons = [w["ncon"] for w, _ in pairs]
    assert {1, 2, 3, 4} <= set(ncons), sorted(set(ncons))
    assert sum(bool((w["efc_type"] == mujoco.mjtConstraint.mjCNSTR_LIMIT_JOINT).any()) for w, _ in pairs) >= 20
    assert sum(bool((w["efc_type"] == mujoco.mjtConstraint.mjCNSTR_CONTACT_PYRAMIDAL).any())
               for w, _ in pairs) >= 100
    for want, got in pairs:
        assert (got["ncon"], got["nefc"]) == (want["ncon"], want["nefc"])
        np.testing.assert_array_equal(got["contact_geom"], want["contact_geom"])
        np.testing.assert_array_equal(got["efc_type"], want["efc_type"])
    for k in pairs[0][0]:
        if k in ("ncon", "nefc", "contact_geom", "efc_type"):
            continue
        rows = [(g[k], w[k]) for w, g in pairs if w[k].size]
        scale = max(1.0, max(float(np.abs(w).max()) for _, w in rows))
        worst = max(float(np.abs(g - w).max()) for g, w in rows)
        assert worst <= STAGE_TOL * scale, (k, worst, scale)


def test_substep_and_env_step_match_mujoco(sim, states):
    m, d, engine = sim
    states = states[::2]
    worst = {}
    for nstep in (1, 5):
        got_q, got_v, want_q, want_v, rew_got, rew_want = [], [], [], [], [], []
        for qpos, qvel, ctrl in states:
            d.qpos[:], d.qvel[:], d.ctrl[:] = qpos, qvel, ctrl
            mujoco.mj_step(m, d, nstep=nstep)
            q, v = qpos[None].copy(), qvel[None].copy()
            engine.step(q, v, ctrl[None], nstep)
            got_q.append(q[0]), got_v.append(v[0]), want_q.append(d.qpos.copy()), want_v.append(d.qvel.copy())
            cost = 0.1 * np.sum(np.square(ctrl))
            rew_got.append((q[0, 0] - qpos[0]) / 0.05 - cost)
            rew_want.append((d.qpos[0] - qpos[0]) / 0.05 - cost)
        for name, g, w in (("qpos", got_q, want_q), ("qvel", got_v, want_v)):
            g, w = np.asarray(g), np.asarray(w)
            worst[name, nstep] = float(np.abs(g - w).max() / max(1.0, np.abs(w).max()))
            assert worst[name, nstep] <= STEP_TOL, (name, nstep, worst)
        np.testing.assert_allclose(rew_got, rew_want, rtol=1e-6, atol=1e-6)


def test_fixture_steps(sim):
    """The chip fixture as ``chip_smoke.py`` checks it: all 64 steps at once."""
    _, _, engine = sim
    fx = np.load(tools.FIXTURE_PATH)
    q, v = fx["qpos"].copy(), fx["qvel"].copy()
    engine.step(q, v, fx["act"], 5)
    for got, want in ((q, fx["next_qpos"]), (v, fx["next_qvel"])):
        assert np.abs(got - want).max() <= STEP_TOL * max(1.0, np.abs(want).max())
    reward = (q[:, 0] - fx["qpos"][:, 0]) / 0.05 - 0.1 * np.sum(np.square(fx["act"].astype(np.float64)), 1)
    np.testing.assert_allclose(reward, fx["reward"], rtol=1e-6, atol=1e-6)


def test_threads_and_bad_arrays():
    model = mujoco_native.load_model("half_cheetah")
    fx = np.load(tools.FIXTURE_PATH)
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
