"""The port's compiled MuJoCo model files and chip fixtures against MuJoCo,
for each seals env the port steps (HalfCheetah, Hopper, Walker2d, Swimmer).

* ``imitation_tpu_torch/envs/assets/<name>.json`` equals ``mujoco.MjModel``
  of gymnasium's ``<name>.xml`` in every field it holds, exactly, the
  gymnasium env's settings, and the JAX env's seals settings (qvel clip,
  healthy reward, qvel reset noise); the file is what
  ``tests/torch_mujoco_tools.py`` writes today.
* ``<name>_fixture.npz`` (MuJoCo's steps and the JAX env's expert
  returns, which ``chip_smoke.py`` reads) is what the tool writes today.
* The collision pairs the port derives are MuJoCo's (Hopper's three
  capsule-capsule pairs included), and the packer refuses what the engine
  does not model.
"""

import json

import gymnasium as gym
import mujoco
import numpy as np
import pytest

from imitation_tpu_torch.envs import mujoco_native
from tests import torch_mujoco_tools as tools


# the pairs MuJoCo tests: the floor with each body geom that it may touch,
# and Hopper's non-adjacent body capsules (torso-leg, torso-foot, thigh-foot)
PAIRS = {
    "HalfCheetah-v5": [(0, g) for g in range(1, 9)],
    "Hopper-v5": [(0, 1), (0, 2), (0, 3), (0, 4), (1, 3), (1, 4), (2, 4)],
    "Walker2d-v5": [(0, g) for g in range(1, 8)],
    "Swimmer-v5": [],
}


@pytest.fixture(scope="module", params=tools.BASE_IDS)
def gym_env(request):
    env = gym.make(request.param, exclude_current_positions_from_observation=False).unwrapped
    env.base_id = request.param
    yield env
    env.close()


def test_model_file_equals_mjmodel(gym_env):
    base_id = gym_env.base_id
    name = tools.ENVS[base_id][0]
    model = mujoco_native.load_model(name)
    assert model["name"] == name
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
    assert (env["forward_reward_weight"], env["ctrl_cost_weight"], env["reset_noise_scale"]) == (
        gym_env._forward_reward_weight, gym_env._ctrl_cost_weight, gym_env._reset_noise_scale)
    # the JAX env's seals settings (imitation_tpu/envs/mujoco_native.py _SPECS and reset rule)
    want = {"HalfCheetah-v5": (None, 0.0, "normal"), "Hopper-v5": (10.0, 1.0, "uniform"),
            "Walker2d-v5": (10.0, 1.0, "uniform"), "Swimmer-v5": (None, 0.0, "uniform")}[base_id]
    assert (env["qvel_clip"], env["healthy_reward"], env["qvel_noise"]) == want
    np.testing.assert_array_equal(env["init_qpos"], gym_env.init_qpos)
    np.testing.assert_array_equal(env["init_qvel"], gym_env.init_qvel)
    obs, act = env["observation_space"], env["action_space"]
    assert (obs["shape"], obs["dtype"], act["shape"], act["dtype"]) == (
        [m.nq + m.nv], "float64", [m.nu], "float32")
    np.testing.assert_array_equal(act["low"], gym_env.action_space.low)
    np.testing.assert_array_equal(act["high"], gym_env.action_space.high)
    # the whole file is the tool's output today
    assert tools.model_path(base_id).read_text() == tools.model_text(base_id)
    assert json.loads(tools.model_text(base_id)) == model


@pytest.mark.parametrize("base_id", tools.BASE_IDS)
def test_fixture_is_current(base_id):
    committed = np.load(tools.fixture_path(base_id))
    fresh = tools.fixture(base_id)
    assert sorted(committed.files) == sorted(fresh)
    for k in fresh:
        assert committed[k].dtype == fresh[k].dtype, k
        np.testing.assert_array_equal(committed[k], fresh[k], err_msg=k)
    nq = mujoco_native.load_model(tools.ENVS[base_id][0])["sizes"]["nq"]
    assert committed["qpos"].shape == (64, nq)
    # every state in contact but Swimmer's (it has no pairs)
    assert (committed["ncon"].max() == 0) == (base_id == "Swimmer-v5")
    assert committed["expert_returns"].shape == (tools.EXPERT_ENVS[base_id],)


def test_collision_pairs_are_mujocos(gym_env):
    """MuJoCo's contacts over a random-action run (and, for Hopper, folded
    runs whose torso touches its leg and foot) come only from the port's
    pairs, and in the port's pair order."""
    base_id = gym_env.base_id
    model = mujoco_native.load_model(tools.ENVS[base_id][0])
    pairs = [tuple(p) for p in mujoco_native.collision_pairs(model)]
    assert pairs == PAIRS[base_id]
    m = gym_env.model
    d = mujoco.MjData(m)
    rng = np.random.default_rng(1)
    seen = set()

    def run(steps, act_fn):
        for _ in range(steps):
            d.ctrl[:] = act_fn()
            mujoco.mj_step(m, d, nstep=gym_env.frame_skip)
            got = [(int(c.geom1), int(c.geom2)) for c in d.contact[:d.ncon]] if d.ncon else []
            order = [pairs.index(p) for p in got]
            assert order == sorted(order)
            seen.update(got)

    run(300, lambda: rng.uniform(-1, 1, m.nu))
    if base_id == "Hopper-v5":
        for foot in (-0.6, 0.0, 0.6):
            mujoco.mj_resetData(m, d)
            d.qpos[3:] = (-2.4, -2.4, foot)
            run(40, lambda: np.asarray(tools.HOPPER_FOLD[1]) + rng.uniform(-0.3, 0.3, m.nu))
        assert {(1, 3), (1, 4)} <= seen  # the torso against the leg and the foot
    assert len(seen) >= min(3, len(pairs))


def test_pack_refuses_what_the_engine_lacks():
    """The packer takes the four models (Euler and RK4, condim 1 and 3,
    capsule-capsule pairs, the inertia-box fluid model) and refuses a free
    joint, a box geom, condim 4 or 6, elliptic cones, the ellipsoid fluid
    model and the implicit integrators."""
    for base_id in tools.BASE_IDS:
        ints, doubles = mujoco_native.pack_model(mujoco_native.load_model(tools.ENVS[base_id][0]))
        assert ints.dtype == np.int32 and doubles.dtype == np.float64
    hopper = mujoco_native.load_model("hopper")

    def changed(edit):
        model = json.loads(json.dumps(hopper))
        edit(model)
        return model

    for integrator in (2, 3):  # implicit, implicitfast
        with pytest.raises(NotImplementedError, match="Euler and RK4"):
            mujoco_native.pack_model(changed(lambda m: m["opt"].update(integrator=integrator)))
    with pytest.raises(NotImplementedError, match="pyramidal cones"):
        mujoco_native.pack_model(changed(lambda m: m["opt"].update(cone=1)))
    with pytest.raises(NotImplementedError, match="hinge and slide"):
        mujoco_native.pack_model(changed(lambda m: m["model"]["jnt_type"].__setitem__(0, 0)))  # free
    with pytest.raises(NotImplementedError, match="ellipsoid"):
        mujoco_native.pack_model(changed(lambda m: m["model"]["geom_fluid"][2].__setitem__(0, 1.0)))
    boxes = changed(lambda m: m["model"]["geom_type"].__setitem__(3, 6))  # a box on a body
    with pytest.raises(NotImplementedError, match="spheres and capsules"):
        mujoco_native.collision_pairs(boxes)
    for condim in (4, 6):
        with pytest.raises(NotImplementedError, match=f"need condim {condim}"):
            mujoco_native.collision_pairs(changed(lambda m: m["model"]["geom_condim"].__setitem__(2, condim)))
