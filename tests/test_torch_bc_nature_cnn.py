"""BC with a NatureCNN policy on uint8 frames, and saved ``nature_cnn``
policies, in imitation_tpu_torch against the JAX package.

BC: both trainers start from the JAX trainer's initial weights (carried
across with ``convert``) on the same seeded uint8 frames (kept uint8 in the
demo store) and labels; the JAX package's epoch permutations are fed to the
port through ``base._permutation`` (as in tests/test_torch_bc.py). Every
batch's metrics within 1e-5; the parameters within 1e-5 of the largest
update, raised where needed to 4x the case's own float32 floor
(``tests.torch_parity.update_floors``). A saved policy: the JAX package's
``policy_config.json`` for a ``nature_cnn`` policy builds the same policy
in the port, which gives the JAX outputs within 1e-5 with its weights; the
port's own save writes the same config and loads back exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imitation_tpu.algorithms.bc import BC as JaxBC
from imitation_tpu.data import types as jax_types
from imitation_tpu.envs.base import Space as JaxSpace
from imitation_tpu.models.policies import ActorCriticPolicy as JaxPolicy
from imitation_tpu.policies import serialize as jax_policy_serialize
from imitation_tpu.util.logger import configure as jax_configure
from imitation_tpu_torch import convert
from imitation_tpu_torch.algorithms.bc import BC, METRIC_NAMES
from imitation_tpu_torch.data import types
from imitation_tpu_torch.envs.base import Space
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.policies import serialize
from imitation_tpu_torch.util.logger import configure
from tests.test_torch_bc import _capture, _feed_perms, jax_bc_perms
from tests.torch_parity import assert_params_close, host, nudge_, param_tolerance, snapshot, update_floors

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPE = (36, 36, 3)


def _frames(n_traj, length, seed):
    """uint8 frames whose Discrete(5) label is the brightest of five
    vertical bands, as (JAX, port) trajectories."""
    rng = np.random.default_rng(seed)
    jtrajs, ttrajs = [], []
    for _ in range(n_traj):
        obs = rng.integers(0, 200, (length + 1,) + SHAPE).astype(np.uint8)
        band = rng.integers(0, 5, length + 1)
        for i, b in enumerate(band):
            obs[i, :, b * 7:(b + 1) * 7] += 55
        kw = dict(obs=obs, acts=band[:-1].astype(np.int64), rews=np.zeros(length), infos=None,
                  terminal=False)
        jtrajs.append(jax_types.TrajectoryWithRew(**kw))
        ttrajs.append(types.TrajectoryWithRew(**kw))
    return jtrajs, ttrajs


def test_bc_nature_cnn_matches_jax(tmp_path, monkeypatch):
    jobs, jact = JaxSpace.box(0, 255, SHAPE, np.uint8), JaxSpace.discrete(5)
    tobs, tact = Space.box(0, 255, SHAPE, np.uint8), Space.discrete(5)
    jdemos, tdemos = _frames(4, 20, seed=0)
    n_rows, n_batches = 80, 6
    common = dict(batch_size=16, ent_weight=1e-3, l2_weight=0.0, optimizer_kwargs=dict(learning_rate=1e-3))
    jlogger = jax_configure(str(tmp_path), format_strs=[])
    jrows = _capture(jlogger)
    jbc = JaxBC(observation_space=jobs, action_space=jact, demonstrations=jdemos,
                policy=JaxPolicy(jobs, jact, features="nature_cnn"), rng=1, custom_logger=jlogger,
                **common)
    jinit = host(jbc.state.variables)
    jbc.train(n_batches=n_batches, log_interval=1)

    def port(rel):
        logger = configure(format_strs=())
        rows = _capture(logger)
        bc = BC(observation_space=tobs, action_space=tact, demonstrations=tdemos,
                policy=ActorCriticPolicy(tobs, tact, features="nature_cnn"), rng=1, custom_logger=logger,
                device="cpu", **common)
        assert bc._demo_store.batch.obs.dtype == torch.uint8  # frames stay uint8
        bc.policy.load_state_dict(convert.policy_state_dict(jinit))
        nudge_([bc.policy], rel)
        queue = _feed_perms(monkeypatch, jax_bc_perms(1, 2, n_rows))
        init = snapshot(bc.policy)
        bc.train(n_batches=n_batches, log_interval=1)
        assert len(queue) == 0 and bc.num_batches == n_batches
        return bc, rows, init

    bc, rows, _ = port(0.0)
    assert len(rows) == len(jrows) == n_batches
    for row, jrow in zip(rows, jrows):
        for name in METRIC_NAMES:
            np.testing.assert_allclose(row[f"mean/bc/{name}"], jrow[f"mean/bc/{name}"], **TOL, err_msg=name)

    def port_updates(rel):
        nudged, _, init = port(rel)
        return {"policy": (init, snapshot(nudged.policy))}

    floor = update_floors(port_updates)["policy"]
    assert_params_close(bc.policy, jbc.state.variables["params"], jinit["params"], "net.",
                        param_tolerance(floor))


@pytest.mark.parametrize("normalize", [False, True])
def test_jax_saved_nature_cnn_policy_loads(tmp_path, normalize):
    jobs, jact = JaxSpace.box(0, 255, SHAPE, np.uint8), JaxSpace.discrete(5)
    jpol = JaxPolicy(jobs, jact, features="nature_cnn", normalize_features=normalize, hid_sizes=(8,))
    variables = jpol.init(jax.random.key(0))
    jax_policy_serialize.save_policy(str(tmp_path / "jax"), jpol, variables)
    with open(tmp_path / "jax" / serialize.POLICY_CONFIG) as f:
        config = json.load(f)
    assert config["features"] == "nature_cnn"
    policy = serialize.policy_from_config(config)
    assert policy.features == "nature_cnn" and policy.net.cnn_fc.out_features == 512
    policy.load_state_dict(convert.policy_state_dict(host(variables)))
    obs = np.random.default_rng(1).integers(0, 256, (4,) + SHAPE).astype(np.uint8)
    jdist, jvalue = jpol.dist_and_value(variables, jnp.asarray(obs))
    dist, value = policy.dist_and_value(torch.from_numpy(obs))
    np.testing.assert_allclose(dist.logits.detach().numpy(), np.asarray(jdist.logits), **TOL)
    np.testing.assert_allclose(value.detach().numpy(), np.asarray(jvalue), **TOL)

    serialize.save_policy(str(tmp_path / "port"), policy)
    with open(tmp_path / "port" / serialize.POLICY_CONFIG) as f:
        assert json.load(f) == config
    loaded = serialize.load_policy_from_path(str(tmp_path / "port"), device="cpu")
    assert loaded.features == "nature_cnn"
    assert all(torch.equal(v, policy.state_dict()[k]) for k, v in loaded.state_dict().items())
