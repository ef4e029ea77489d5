"""BC of imitation_tpu_torch on the repo's seals demos and on dict
observations, against the JAX package.

* seals/HalfCheetah-v1: each package's loader reads the first 2 expert
  episodes of ``output/experts/seals_half_cheetah/rollouts`` (the port's
  loader gives a lazily decoded ``TrajectoryDatasetSequence``) and feeds its
  own BC at
  ``benchmarking/run_parity.py``'s HalfCheetah settings (FeedForward32 with
  ``normalize_features``, batch 64, l2 5.73e-3, lr 8.06e-3; 2 epochs here,
  not 20), the spaces from the expert's ``policy_config.json``.
* Dict observations: tests/algorithms/test_bc_dictobs.py's demos and
  settings (64 transitions of ``{"pos", "vel"}``, batch 16, 20 epochs),
  with ``DictObs`` transitions and as dict-observation trajectories.

Both trainers start from the JAX trainer's initial weights and the JAX
package's epoch permutations are fed through ``algorithms/base.py``
``_permutation`` (tests/test_torch_bc.py). Every batch's metrics match
within tests/test_torch_bc.py's 1e-5; the feature statistics within 1e-5.
"""

import json
import os

import numpy as np
import pytest
import torch

from imitation_tpu.algorithms.bc import BC as JaxBC
from imitation_tpu.data import serialize as jax_serialize
from imitation_tpu.data import types as jax_types
from imitation_tpu.envs import base as jax_envs
from imitation_tpu.models.policies import ActorCriticPolicy as JaxPolicy
from imitation_tpu.policies import serialize as jax_policy_serialize
from imitation_tpu.util.logger import configure as jax_configure
from imitation_tpu_torch import convert
from imitation_tpu_torch.algorithms.bc import BC, METRIC_NAMES
from imitation_tpu_torch.data import huggingface_utils, serialize, types
from imitation_tpu_torch.envs import base as envs
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.policies import serialize as policy_serialize
from imitation_tpu_torch.util.logger import configure
from tests.test_torch_bc import METRIC_TOL, _capture, _feed_perms, jax_bc_perms
from tests.torch_parity import host

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHEETAH = os.path.join(REPO, "output", "experts", "seals_half_cheetah")
# benchmarking/run_parity.py BC_HPS["seals_half_cheetah"]: (batch, l2, lr, epochs)
BATCH, L2, LR = 64, 5.73e-3, 8.06e-3


def _run_both(tmp_path, monkeypatch, jspaces, tspaces, jdemos, tdemos, n_rows, n_epochs, seed, **kw):
    """Trains each package's BC on its demos from the same initial weights
    and epoch permutations; returns (port BC, JAX BC, port rows, JAX rows)."""
    jlogger = jax_configure(str(tmp_path), format_strs=[])
    jrows = _capture(jlogger)
    jbc = JaxBC(observation_space=jspaces[0], action_space=jspaces[1], demonstrations=jdemos,
                policy=JaxPolicy(*jspaces, **kw.get("policy", {})), rng=seed, custom_logger=jlogger,
                **kw["bc"])
    jinit = host(jbc.state.variables)
    jbc.train(n_epochs=n_epochs, log_interval=1)

    logger = configure(format_strs=())
    rows = _capture(logger)
    bc = BC(observation_space=tspaces[0], action_space=tspaces[1], demonstrations=tdemos,
            policy=ActorCriticPolicy(*tspaces, **kw.get("policy", {})), rng=seed, custom_logger=logger,
            device="cpu", **kw["bc"])
    bc.policy.load_state_dict(convert.policy_state_dict(jinit))
    queue = _feed_perms(monkeypatch, jax_bc_perms(seed, n_epochs, n_rows))
    bc.train(n_epochs=n_epochs, log_interval=1)
    assert queue == [] and bc.host_reads == n_epochs
    assert len(rows) == len(jrows) == n_epochs * (n_rows // kw["bc"]["batch_size"])
    for row, jrow in zip(rows, jrows):
        for name in METRIC_NAMES:
            np.testing.assert_allclose(row[f"mean/bc/{name}"], jrow[f"mean/bc/{name}"], **METRIC_TOL,
                                       err_msg=f"batch {row['mean/bc/batch']}: {name}")
    return bc, jbc, rows, jrows


def _cheetah_spaces():
    with open(os.path.join(CHEETAH, "policy", "policy_config.json")) as f:
        config = json.load(f)
    return tuple(jax_policy_serialize._space_from_json(config[k]) for k in ("observation_space", "action_space")), \
        tuple(policy_serialize._space_from_json(config[k]) for k in ("observation_space", "action_space"))


def test_bc_on_half_cheetah_demos_matches_jax(tmp_path, monkeypatch):
    path = os.path.join(CHEETAH, "rollouts")
    seq = serialize.load(path)
    assert isinstance(seq, huggingface_utils.TrajectoryDatasetSequence) and len(seq) == 48
    tdemos = seq[:2]
    jdemos = list(jax_serialize.load(path))[:2]
    n_rows = sum(len(t) for t in tdemos)
    assert n_rows == 2000 and tdemos[0].obs.dtype == np.float32
    jspaces, tspaces = _cheetah_spaces()
    assert tspaces[0].dtype == np.float64  # the expert's space; the demos are float32
    bc, jbc, rows, _ = _run_both(
        tmp_path, monkeypatch, jspaces, tspaces, jdemos, tdemos, n_rows, 2, seed=0,
        policy=dict(hid_sizes=(32, 32), normalize_features=True),
        bc=dict(batch_size=BATCH, l2_weight=L2, optimizer_kwargs=dict(learning_rate=LR)))
    stats = host(jbc.state.variables["stats"])["feat_norm"]
    for name in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(bc.policy.net.feat_norm, name).numpy(), stats[name], **METRIC_TOL)
    assert int(bc.policy.net.feat_norm.count) == int(stats["count"]) == n_rows  # folded once per train call
    assert rows[-1]["mean/bc/loss"] < rows[0]["mean/bc/loss"]


def _dict_demos(mod, n=64):
    """tests/algorithms/test_bc_dictobs.py ``make_dict_demos``."""
    rng = np.random.default_rng(0)
    obs = {"pos": rng.normal(size=(n, 3)).astype(np.float32), "vel": rng.normal(size=(n, 2)).astype(np.float32)}
    acts = (obs["pos"][:, 0] > 0).astype(np.int64)
    return mod.TransitionsMinimal(obs=mod.DictObs(obs), acts=acts, infos=np.array([{}] * n)), obs, acts


def _dict_spaces():
    box = lambda mod, shape: mod.Space.box(-10, 10, shape)
    return ((jax_envs.DictSpace(spaces={"pos": box(jax_envs, (3,)), "vel": box(jax_envs, (2,))}),
             jax_envs.Space.discrete(2)),
            (envs.DictSpace(spaces={"pos": box(envs, (3,)), "vel": box(envs, (2,))}), envs.Space.discrete(2)))


@pytest.mark.parametrize("form", ["transitions", "trajectories"])
def test_bc_on_dict_obs_matches_jax(tmp_path, monkeypatch, form):
    jspaces, tspaces = _dict_spaces()
    jdemos, obs, acts = _dict_demos(jax_types)
    tdemos, _, _ = _dict_demos(types)
    if form == "trajectories":  # 4 episodes of 16 steps: dict obs through flatten_trajectories
        def trajs(mod):
            return [mod.Trajectory(obs=mod.DictObs({k: np.concatenate([v[i:i + 16], v[i + 15:i + 16]])
                                                    for k, v in obs.items()}),
                                   acts=acts[i:i + 16], infos=None, terminal=True) for i in range(0, 64, 16)]
        jdemos, tdemos = trajs(jax_types), trajs(types)
    bc, _, _, _ = _run_both(tmp_path, monkeypatch, jspaces, tspaces, jdemos, tdemos, 64, 20, seed=0,
                            bc=dict(batch_size=16))
    with torch.no_grad():
        preds = bc.policy.distribution({k: torch.from_numpy(v) for k, v in obs.items()}).mode().numpy()
    assert (preds == acts).mean() > 0.9
