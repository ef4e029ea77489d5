"""BC in imitation_tpu_torch against the JAX package.

Both trainers start from the same weights (the JAX trainer's initial
policy, carried across with ``convert``) and train on the same seeded demos.
The epoch shuffles are the JAX package's own: its BC draws
``k_init, key = split(key(seed))`` and then ``key, k_epoch = split(key)``
and ``permutation(k_epoch, n)`` per epoch (imitation_tpu/algorithms/bc.py
``_init_state`` and ``train``, ``base.DemonstrationStore.epoch_indices``);
they are recomputed and fed to the port through ``base._permutation``.
Both log every batch (``log_interval=1``), so the logged rows hold each
batch's metrics.

Tolerances:
* per-batch metrics: 1e-5 (relative and absolute), the same float32 loss;
* feature-normalizer statistics: 1e-5;
* parameters after training: 1e-5 of the largest parameter update
  (``PARAM_REL``), raised where needed to 4x the case's own float32 floor,
  measured by ``tests.torch_parity.update_floors`` as in
  tests/test_torch_ppo.py.
"""

import jax
import numpy as np
import pytest
import torch

import imitation_tpu_torch.algorithms.base as torch_base
from imitation_tpu.algorithms import base as jax_base
from imitation_tpu.algorithms.bc import BC as JaxBC
from imitation_tpu.data import types as jax_types
from imitation_tpu.models.policies import ActorCriticPolicy as JaxPolicy
from imitation_tpu.util.logger import configure as jax_configure
from imitation_tpu_torch import convert
from imitation_tpu_torch.algorithms.bc import BC, METRIC_NAMES, reconstruct_policy
from imitation_tpu_torch.data import rollout, types
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.testing import experts
from imitation_tpu_torch.testing.reward_improvement import is_significant_reward_improvement
from imitation_tpu_torch.util.logger import configure
from tests.torch_parity import (
    assert_params_close, host, nudge_, param_tolerance, snapshot, spaces, update_floors,
)

torch.set_num_threads(1)

METRIC_TOL = dict(rtol=1e-5, atol=1e-5)


def _demos(kind, n_traj=8, length=25, seed=0):
    """(JAX, port) trajectories with the same arrays: CartPole-shaped or a
    [3]-obs, [2]-action box, observations on a wide scale."""
    rng = np.random.default_rng(seed)
    dim = 4 if kind == "discrete" else 3
    jtrajs, ttrajs = [], []
    for _ in range(n_traj):
        obs = rng.normal(loc=1.5, scale=4.0, size=(length + 1, dim)).astype(np.float32)
        if kind == "discrete":
            acts = (obs[:-1, 2] + 0.3 * obs[:-1, 3] > 1.5).astype(np.int64)
        else:
            acts = np.tanh(obs[:-1, :2] * 0.3 + rng.normal(scale=0.1, size=(length, 2))).astype(np.float32)
        kw = dict(obs=obs, acts=acts, rews=np.ones(length), infos=None, terminal=bool(rng.random() < 0.5))
        jtrajs.append(jax_types.TrajectoryWithRew(**kw))
        ttrajs.append(types.TrajectoryWithRew(**kw))
    return jtrajs, ttrajs


def _capture(logger):
    rows = []
    logger.default_logger.output_formats.append(type("Capture", (), {
        "write": lambda self, kvs, step: rows.append(dict(kvs)), "close": lambda self: None})())
    return rows


def jax_bc_perms(seed, n_epochs, n):
    """The epoch permutations ``imitation_tpu`` BC draws with ``rng=seed``."""
    _, key = jax.random.split(jax.random.key(seed))
    perms = []
    for _ in range(n_epochs):
        key, k_epoch = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(k_epoch, n)))
    return perms


def _feed_perms(monkeypatch, perms):
    queue = list(perms)
    monkeypatch.setattr(torch_base, "_permutation",
                        lambda n, generator: torch.from_numpy(queue.pop(0).astype(np.int64)))
    return queue


CASES = {
    "discrete": dict(kind="discrete"),
    "discrete-normalize-l2": dict(kind="discrete", normalize=True, l2=1e-2),
    "continuous": dict(kind="continuous"),
    "continuous-normalize-l2": dict(kind="continuous", normalize=True, l2=1e-2),
    "discrete-batch32-minibatch8": dict(kind="discrete", minibatch=8, l2=1e-3),
    "continuous-batch32-minibatch8": dict(kind="continuous", minibatch=8, normalize=True),
    "n_batches-cuts-an-epoch": dict(kind="discrete", n_batches=9, normalize=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bc_matches_jax(tmp_path, monkeypatch, case):
    c = {**dict(normalize=False, l2=0.0, minibatch=None, n_batches=None), **CASES[case]}
    jobs, jact, tobs, tact = spaces(c["kind"])
    jdemos, tdemos = _demos(c["kind"])
    n_rows = sum(len(t) for t in tdemos)
    budget = dict(n_batches=c["n_batches"]) if c["n_batches"] else dict(n_epochs=2)
    n_epochs = 2
    common = dict(batch_size=32, minibatch_size=c["minibatch"], ent_weight=1e-2,
                  l2_weight=c["l2"], optimizer_kwargs=dict(learning_rate=3e-3))

    jlogger = jax_configure(str(tmp_path), format_strs=[])
    jrows = _capture(jlogger)
    jbc = JaxBC(observation_space=jobs, action_space=jact, demonstrations=jdemos,
                policy=JaxPolicy(jobs, jact, normalize_features=c["normalize"]), rng=4,
                custom_logger=jlogger, **common)
    jinit = host(jbc.state.variables)
    jbc.train(log_interval=1, **budget)
    n_batches = int(jbc.state.num_batches)
    assert n_batches == (c["n_batches"] or n_epochs * (n_rows // 32))

    def port(rel):
        logger = configure(format_strs=())
        rows = _capture(logger)
        bc = BC(observation_space=tobs, action_space=tact, demonstrations=tdemos,
                policy=ActorCriticPolicy(tobs, tact, normalize_features=c["normalize"]), rng=4,
                custom_logger=logger, device="cpu", **common)
        bc.policy.load_state_dict(convert.policy_state_dict(jinit))
        nudge_([bc.policy], rel)
        queue = _feed_perms(monkeypatch, jax_bc_perms(4, n_epochs, n_rows))
        init = snapshot(bc.policy)
        bc.train(log_interval=1, **budget)
        assert queue == [] and bc.num_batches == n_batches
        assert bc.host_reads == n_epochs  # one read of the metrics per epoch
        return bc, rows, init

    bc, rows, _ = port(0.0)
    assert len(rows) == len(jrows) == n_batches
    for row, jrow in zip(rows, jrows):
        assert row.keys() == jrow.keys()
        for name in METRIC_NAMES:
            np.testing.assert_allclose(row[f"mean/bc/{name}"], jrow[f"mean/bc/{name}"],
                                       **METRIC_TOL, err_msg=name)
        for name in ("samples_so_far", "batch"):
            assert row[f"mean/bc/{name}"] == jrow[f"mean/bc/{name}"]
    if c["l2"] == 0:
        assert all(row["mean/bc/l2_loss"] == 0 for row in rows)
    if c["normalize"]:
        stats = host(jbc.state.variables["stats"])["feat_norm"]
        np.testing.assert_allclose(bc.policy.net.feat_norm.running_mean.numpy(), stats["running_mean"],
                                   **METRIC_TOL)
        np.testing.assert_allclose(bc.policy.net.feat_norm.running_var.numpy(), stats["running_var"],
                                   **METRIC_TOL)
        assert int(bc.policy.net.feat_norm.count) == int(stats["count"]) == n_rows

    def port_updates(rel):
        nudged, _, init = port(rel)
        return {"policy": (init, snapshot(nudged.policy))}

    floor = update_floors(port_updates)["policy"]
    assert_params_close(bc.policy, jbc.state.variables["params"], jinit["params"], "net.",
                        param_tolerance(floor))


@pytest.mark.parametrize("drop_last", [True, False])
def test_epoch_indices_match_jax(monkeypatch, drop_last):
    """The index matrix from one permutation: rows of the batch size, the
    ragged tail dropped or padded by wrapping around."""
    n, batch = 50, 16
    _, tdemos = _demos("discrete", n_traj=2, length=25)
    jdemos, _ = _demos("discrete", n_traj=2, length=25)
    jstore = jax_base.DemonstrationStore.from_demonstrations(jdemos)
    store = torch_base.DemonstrationStore.from_demonstrations(tdemos, torch.device("cpu"))
    assert store.num_samples == jstore.num_samples == n
    key = jax.random.key(3)
    want = np.asarray(jstore.epoch_indices(key, batch, drop_last=drop_last))
    _feed_perms(monkeypatch, [np.asarray(jax.random.permutation(key, n))])
    got = store.epoch_indices(torch.Generator(), batch, drop_last=drop_last)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == ((3, 16) if drop_last else (4, 16))
    with pytest.raises(ValueError, match="larger than dataset"):
        store.epoch_indices(torch.Generator(), n + 1)


def test_demo_store_sample_and_real_permutation():
    _, tdemos = _demos("continuous", n_traj=3, length=10)
    store = torch_base.DemonstrationStore.from_demonstrations(tdemos, torch.device("cpu"))
    g = torch.Generator().manual_seed(0)
    idx = store.epoch_indices(g, 7)
    assert idx.shape == (4, 7) and len(set(idx.flatten().tolist())) == 28
    mb = store.sample(g, 64)
    assert mb.obs.shape == (64, 3) and mb.acts.shape == (64, 2) and mb.obs.dtype == torch.float32
    rows = {tuple(r) for r in store.batch.obs.numpy().tolist()}
    assert all(tuple(r) in rows for r in mb.obs.numpy().tolist())


@pytest.fixture(scope="module")
def cartpole_demos():
    venv = make_vec_env("CartPole-v1", num_envs=8, max_episode_steps=100, device="cpu")
    return experts.generate_expert_trajectories("CartPole-v1", venv, min_episodes=10)


def make_bc(demos, **kwargs):
    venv = make_vec_env("CartPole-v1", num_envs=4, device="cpu")
    defaults = dict(observation_space=venv.observation_space, action_space=venv.action_space,
                    demonstrations=demos, rng=0, batch_size=32, device="cpu",
                    custom_logger=configure(format_strs=()))
    defaults.update(kwargs)
    return BC(**defaults)


def test_bc_requires_exactly_one_budget(cartpole_demos):
    bc = make_bc(cartpole_demos)
    with pytest.raises(ValueError, match="exactly one"):
        bc.train()
    with pytest.raises(ValueError, match="exactly one"):
        bc.train(n_epochs=1, n_batches=1)


def test_bc_no_demos_raises():
    venv = make_vec_env("CartPole-v1", num_envs=2, device="cpu")
    bc = BC(observation_space=venv.observation_space, action_space=venv.action_space, rng=0,
            device="cpu", custom_logger=configure(format_strs=()))
    with pytest.raises(ValueError, match="No demonstrations"):
        bc.train(n_epochs=1)


def test_bc_invalid_minibatch_raises(cartpole_demos):
    with pytest.raises(ValueError, match="multiple"):
        make_bc(cartpole_demos, batch_size=32, minibatch_size=5)


def test_bc_too_few_demos_raises(cartpole_demos):
    with pytest.raises(ValueError, match="Not enough demonstrations"):
        make_bc(cartpole_demos[:1], batch_size=10**6).train(n_epochs=1)


def test_bc_defaults_to_cuda():
    venv = make_vec_env("CartPole-v1", num_envs=2, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BC(observation_space=venv.observation_space, action_space=venv.action_space)


def test_epoch_end_callbacks(cartpole_demos):
    counts = {"epoch": 0, "batch": 0}
    bc = make_bc(cartpole_demos)
    bc.train(
        n_epochs=2,
        on_epoch_end=lambda: counts.__setitem__("epoch", counts["epoch"] + 1),
        on_batch_end=lambda: counts.__setitem__("batch", counts["batch"] + 1),
    )
    assert counts["epoch"] == 2 and bc.host_reads == 2
    assert counts["batch"] == bc.num_batches == 2 * (bc._demo_store.num_samples // 32)


def test_log_rollouts_and_policy_round_trip(cartpole_demos, tmp_path):
    logger = configure(format_strs=())
    rows = []
    logger.default_logger.output_formats.append(type("Capture", (), {
        "write": lambda self, kvs, step: rows.append(dict(kvs)), "close": lambda self: None})())
    bc = make_bc(cartpole_demos, custom_logger=logger)
    venv = make_vec_env("CartPole-v1", num_envs=4, max_episode_steps=50, device="cpu")
    bc.train(n_batches=20, log_interval=10, log_rollouts_venv=venv, log_rollouts_n_episodes=3)
    assert [row["mean/bc/batch"] for row in rows] == [10, 20]
    assert all(0 < row["mean/bc/rollout/return_mean"] <= 50 for row in rows)
    bc.save_policy(str(tmp_path / "policy"))
    loaded = reconstruct_policy(str(tmp_path / "policy"), device="cpu")
    for (k, v), (k2, v2) in zip(bc.policy.state_dict().items(), loaded.state_dict().items()):
        assert k == k2 and torch.equal(v, v2)


def test_set_demonstrations_replaces_data(cartpole_demos):
    """Training after ``set_demonstrations`` sees only the new demos."""
    bc = make_bc(cartpole_demos)
    bc.train(n_batches=4)
    flipped = [type(t)(obs=t.obs, acts=np.zeros_like(t.acts), rews=t.rews, infos=t.infos,
                       terminal=t.terminal) for t in cartpole_demos]
    bc.set_demonstrations(flipped)
    bc.train(n_epochs=3)
    preds = bc.policy.distribution(torch.zeros((8, 4))).mode()
    assert (preds == 0).all(), "policy should imitate the replaced demos"


def test_bc_improves_rewards(cartpole_demos):
    """Statistical learning gate, as the JAX package's test_bc_improves_rewards."""
    venv = make_vec_env("CartPole-v1", num_envs=8, device="cpu")
    bc = make_bc(cartpole_demos, batch_size=64)
    novice = rollout.generate_trajectories(bc.policy.sample_fn(), venv,
                                           rollout.make_min_episodes(10), rng=0)
    novice_returns = [t.rews.sum() for t in novice]
    bc.train(n_epochs=12)
    trained = rollout.generate_trajectories(bc.policy.sample_fn(), venv,
                                            rollout.make_min_episodes(10), rng=1)
    trained_returns = [t.rews.sum() for t in trained]
    assert is_significant_reward_improvement(novice_returns, trained_returns)
    assert np.mean(trained_returns) > 3 * np.mean(novice_returns)
