"""The port's compiled MuJoCo model file and chip fixture against MuJoCo.

* ``imitation_tpu_torch/envs/assets/half_cheetah.json`` equals
  ``mujoco.MjModel`` of gymnasium's ``half_cheetah.xml`` in every field it
  holds, exactly, and the gymnasium env's settings; the file is what
  ``tests/torch_mujoco_tools.py`` writes today.
* ``half_cheetah_fixture.npz`` (MuJoCo's steps and the JAX env's expert
  returns, which ``chip_smoke.py`` reads) is what the tool writes today.
* The collision pairs the port derives are MuJoCo's, and the packer
  refuses what the engine does not model.
"""

import json

import gymnasium as gym
import mujoco
import numpy as np
import pytest

from imitation_tpu_torch.envs import mujoco_native
from tests import torch_mujoco_tools as tools


@pytest.fixture(scope="module")
def gym_env():
    env = gym.make("HalfCheetah-v5", exclude_current_positions_from_observation=False).unwrapped
    yield env
    env.close()


def test_model_file_equals_mjmodel(gym_env):
    model = mujoco_native.load_model("half_cheetah")
    m = gym_env.model
    assert model["sizes"] == {k: getattr(m, k) for k in ("nq", "nv", "nu", "nbody", "njnt", "ngeom")}
    assert set(model["model"]) == set(tools.MODEL_FIELDS)
    for k in tools.MODEL_FIELDS:
        want = np.asarray(getattr(m, k))
        got = np.asarray(model["model"][k], want.dtype)
        np.testing.assert_array_equal(got.reshape(want.shape), want, err_msg=k)
    for k in tools.OPT_FIELDS:
        np.testing.assert_array_equal(model["opt"][k], getattr(m.opt, k), err_msg=k)
    env = model["env"]
    assert (env["frame_skip"], env["max_episode_steps"]) == (gym_env.frame_skip, 1000)
    assert (env["forward_reward_weight"], env["ctrl_cost_weight"], env["reset_noise_scale"]) == (1.0, 0.1, 0.1)
    np.testing.assert_array_equal(env["init_qpos"], gym_env.init_qpos)
    np.testing.assert_array_equal(env["init_qvel"], gym_env.init_qvel)
    obs, act = env["observation_space"], env["action_space"]
    assert (obs["shape"], obs["dtype"], act["shape"], act["dtype"]) == ([18], "float64", [6], "float32")
    np.testing.assert_array_equal(act["low"], gym_env.action_space.low)
    np.testing.assert_array_equal(act["high"], gym_env.action_space.high)
    # the whole file is the tool's output today
    assert tools.MODEL_PATH.read_text() == tools.model_text()
    assert json.loads(tools.model_text()) == model


def test_fixture_is_current():
    committed = np.load(tools.FIXTURE_PATH)
    fresh = tools.fixture()
    assert sorted(committed.files) == sorted(fresh)
    for k in fresh:
        assert committed[k].dtype == fresh[k].dtype, k
        np.testing.assert_array_equal(committed[k], fresh[k], err_msg=k)
    assert committed["ncon"].max() >= 1 and committed["qpos"].shape == (64, 9)
    assert committed["expert_returns"].shape == (16,)


def test_collision_pairs_are_mujocos(gym_env):
    """MuJoCo's contacts over a random-action run come only from the port's
    pairs, and in the port's pair order."""
    model = mujoco_native.load_model("half_cheetah")
    pairs = [tuple(p) for p in mujoco_native.collision_pairs(model)]
    assert pairs == [(0, g) for g in range(1, 9)]  # the floor with each body geom
    m = gym_env.model
    d = mujoco.MjData(m)
    rng = np.random.default_rng(1)
    seen = set()
    for _ in range(300):
        d.ctrl[:] = rng.uniform(-1, 1, m.nu)
        mujoco.mj_step(m, d, nstep=5)
        got = [(int(c.geom1), int(c.geom2)) for c in d.contact[:d.ncon]] if d.ncon else []
        order = [pairs.index(p) for p in got]
        assert order == sorted(order)
        seen.update(got)
    assert len(seen) >= 3


def test_pack_refuses_what_the_engine_lacks():
    model = mujoco_native.load_model("half_cheetah")
    ints, doubles = mujoco_native.pack_model(model)
    assert ints.dtype == np.int32 and doubles.dtype == np.float64
    rk4 = json.loads(json.dumps(model))
    rk4["opt"]["integrator"] = 1
    with pytest.raises(NotImplementedError, match="Euler"):
        mujoco_native.pack_model(rk4)
    boxes = json.loads(json.dumps(model))
    boxes["model"]["geom_type"][3] = 6  # a box on a body
    with pytest.raises(NotImplementedError, match="spheres and capsules"):
        mujoco_native.collision_pairs(boxes)
    frictionless = json.loads(json.dumps(model))
    frictionless["model"]["geom_condim"] = [1] * len(model["model"]["geom_condim"])
    with pytest.raises(NotImplementedError, match="condim 3"):
        mujoco_native.collision_pairs(frictionless)
