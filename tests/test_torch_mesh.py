"""The mesh helpers of imitation_tpu_torch.parallel in one process: their
errors against imitation_tpu/parallel/mesh.py's, the rows a rank owns, and
that W rank views of the envs, of the host collector and of the replay ring
together are the one-process ones.

A rank's view needs no process group where no collective runs: its draws
come from the replicated generator, and a ``Mesh(dp, rank=r)`` made by hand
plays each rank in turn. One case joins a gloo group of one process through
a ``FileStore`` (the world-size-1 path the card's NCCL run takes).
"""

import datetime
import os

import numpy as np
import pytest
import torch

from imitation_tpu.parallel import mesh as jax_mesh
from imitation_tpu_torch import make_generator
from imitation_tpu_torch.algorithms import preference_comparisons as pc
from imitation_tpu_torch.data import buffer as buffer_mod
from imitation_tpu_torch.data import rollout as rollout_mod
from imitation_tpu_torch.data.types import TransitionBatch
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.envs.tabular import random_mdp
from imitation_tpu_torch.envs.vector import VectorEnv
from imitation_tpu_torch.models.distributions import Categorical, DiagGaussian
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.parallel import distributed
from imitation_tpu_torch.parallel import mesh as mesh_mod
from imitation_tpu_torch.parallel.mesh import Mesh
from imitation_tpu_torch.rewards.reward_nets import BasicRewardNet
from imitation_tpu_torch.rl.ppo import PPO, PPOConfig
from imitation_tpu_torch.rl.sac import SAC, SACConfig
from imitation_tpu_torch.util.logger import configure

torch.set_num_threads(1)


def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type and message are the result
        return type(e), str(e)
    return None


def test_make_mesh_errors_match_jax():
    m = mesh_mod.make_mesh(device="cpu")
    assert (m.shape, m.rank, m.distributed) == ({"dp": 1, "tp": 1}, 0, False)
    assert mesh_mod.make_mesh(dp=1, tp=1, device="cpu").shape == {"dp": 1, "tp": 1}
    one_device = [__import__("jax").devices()[0]]
    for kwargs in (dict(dp=3, tp=2), dict(tp=2), dict(dp=2)):
        jax_err = _raises(lambda: jax_mesh.make_mesh(devices=one_device, **kwargs))
        port_err = _raises(lambda: mesh_mod.make_mesh(device="cpu", **kwargs))
        assert jax_err[0] is port_err[0] is ValueError, kwargs
        assert port_err[1].startswith(jax_err[1].split(" devices")[0]), (port_err, jax_err)
    # tp > 1 at a world that fits it: the ROADMAP item, not a silent replication.
    err = _raises(lambda: mesh_mod.shard_params_tp(torch.nn.Linear(2, 2), Mesh(dp=1, tp=2)))
    assert err[0] is NotImplementedError and "ROADMAP A11" in err[1]
    assert distributed.local_env_count(8) == 8 and not distributed.is_multiprocess()


def test_shard_batch_tree_and_rows():
    m = Mesh(dp=4, rank=1)
    tree = {"a": torch.arange(48.0).reshape(16, 3), "b": torch.zeros(()), "c": torch.arange(6)}
    placed = mesh_mod.shard_batch_tree(tree, m)
    np.testing.assert_array_equal(placed["a"].numpy(), tree["a"][4:8].numpy())
    assert placed["b"] is tree["b"] and placed["c"] is tree["c"]  # scalar, indivisible: whole
    assert m.rows(8) == slice(2, 4)
    assert _raises(lambda: m.rows(6))[0] is ValueError
    assert mesh_mod.batch_sharding(m, 1).axis == 1


def test_shard_helpers_raise_what_jax_raises():
    m = Mesh(dp=4, rank=0)
    venv = make_vec_env("Pendulum-v1", num_envs=6, device="cpu")
    ppo = PPO(venv, ActorCriticPolicy(venv.observation_space, venv.action_space, hid_sizes=(4,)),
              PPOConfig(n_steps=4, n_minibatches=2), seed=0)
    err = _raises(lambda: mesh_mod.shard_rl_state(ppo.init_state(), m))
    assert err == (ValueError, "num_envs=6 not divisible by dp=4")

    # The ring's capacity divides by dp in JAX; here also by the env count.
    for num_envs, capacity, match in ((4, 30, "divisible by dp=4"), (8, 36, "divisible by num_envs=8")):
        venv = make_vec_env("Pendulum-v1", num_envs=num_envs, device="cpu")
        sac = SAC(venv, SACConfig(buffer_size=capacity, actor_hid_sizes=(4,), critic_hid_sizes=(4,)), seed=0)
        err = _raises(lambda: mesh_mod.shard_sac_state(sac.init_state(), m))
        assert err[0] is ValueError and match in err[1], err

    net = BasicRewardNet(venv.observation_space, venv.action_space)
    trainer = pc.BasicRewardTrainer(pc.PreferenceModel(net), batch_size=8,
                                    custom_logger=configure(format_strs=()))
    run = type("Run", (), {"reward_trainer": trainer, "trajectory_generator": None})()
    err = _raises(lambda: mesh_mod.shard_preference_comparisons(run, Mesh(dp=3)))
    assert err == (ValueError, "reward trainer batch_size=8 must be divisible by dp=3 to shard fragment batches")


def _rank_views(venv, W):
    return [venv.rows(Mesh(dp=W, rank=r)) for r in range(W)]


@pytest.mark.parametrize("env", ["CartPole-v1", "Pendulum-v1", "tabular"])
def test_rank_views_step_the_one_process_envs(env):
    """W = 2 rank views, each collecting from its own copy of the replicated
    generator, together step the one-process envs: resets, a stochastic
    env's steps and the policy's Categorical / Gaussian draws are each the
    rank's block of the whole batch's."""
    T, B, W = 24, 8, 2
    if env == "tabular":
        venv = VectorEnv(random_mdp(6, 3, horizon=5, obs_dim=4, seed=0), B, device="cpu")
    else:
        venv = make_vec_env(env, num_envs=B, max_episode_steps=10, device="cpu")
    policy = ActorCriticPolicy(venv.observation_space, venv.action_space, hid_sizes=(8,))
    policy.init(torch.Generator().manual_seed(1))

    def run(view, mesh):
        g = make_generator(0, "cpu")
        state = venv.reset(g)
        if mesh is not None:
            state = mesh_mod.shard_batch_tree(state, mesh)
        return rollout_mod.collect(view, policy.sample_fn(), state, T, g)[1]

    whole = run(venv, None)
    parts = [run(view, view.mesh) for view in _rank_views(venv, W)]
    for name in rollout_mod.CHUNK_FIELDS:
        got = torch.cat([getattr(p, name) for p in parts], dim=1).numpy()
        np.testing.assert_allclose(got, getattr(whole, name).numpy(), rtol=1e-6, atol=1e-6, err_msg=name)
    assert whole.dones.any()  # auto-resets happened inside the window


def test_draw_rows_blocks_of_the_whole_draw():
    logits = torch.randn(6, 3, generator=torch.Generator().manual_seed(0))
    whole = Categorical(logits).sample(torch.Generator().manual_seed(5))
    gauss = DiagGaussian(torch.zeros(6, 2), torch.zeros(2)).sample(torch.Generator().manual_seed(5))
    for r in range(3):
        rows = slice(2 * r, 2 * r + 2)
        with distributed.local_rows(Mesh(dp=3, rank=r)):
            part = Categorical(logits[rows]).sample(torch.Generator().manual_seed(5))
            g = DiagGaussian(torch.zeros(2, 2), torch.zeros(2)).sample(torch.Generator().manual_seed(5))
        np.testing.assert_array_equal(part.numpy(), whole[rows].numpy())
        np.testing.assert_array_equal(g.numpy(), gauss[rows].numpy())
    # Outside the context a draw is the plain one.
    np.testing.assert_array_equal(Categorical(logits).sample(torch.Generator().manual_seed(5)).numpy(),
                                  whole.numpy())


def test_host_collector_blocks_of_one_process():
    """Two ``CppVectorEnv`` blocks (``first_env``) under collectors marked
    with their rank step exactly the one-process host env's columns."""
    from imitation_tpu_torch.native import CppVectorEnv

    B, W, T = 8, 2, 40
    env_kw = dict(max_episode_steps=25, seed=3, num_threads=1, device="cpu")
    whole_env = CppVectorEnv("CartPole-v1", num_envs=B, **env_kw)
    policy = ActorCriticPolicy(whole_env.observation_space, whole_env.action_space, hid_sizes=(8,))
    policy.init(torch.Generator().manual_seed(1))
    whole = rollout_mod.HostCollector(whole_env, policy.sample_fn(), seed=7).collect(T, device="cpu")
    parts = []
    for r in range(W):
        env = CppVectorEnv("CartPole-v1", num_envs=B // W,
                           first_env=r * B // W, **env_kw)
        collector = rollout_mod.HostCollector(env, policy.sample_fn(), seed=7)
        collector.mesh = Mesh(dp=W, rank=r)
        parts.append(collector.collect(T, device="cpu"))
    for name in rollout_mod.CHUNK_FIELDS:
        got = torch.cat([getattr(p, name) for p in parts], dim=1).numpy()
        np.testing.assert_array_equal(got, getattr(whole, name).numpy(), err_msg=name)
    assert whole.dones.any()


def test_split_ring_keeps_each_env_column_on_its_rank():
    """Each rank's local ring, storing its own env columns, holds exactly the
    one-process ring's rows that ``RingShard.owner_and_row`` gives it,
    through a wrap and a store larger than the ring."""
    E, W, capacity = 4, 2, 12
    rng = np.random.default_rng(0)

    def batch(steps, cols=slice(None)):
        a = rng.normal(size=(steps, E, 3)).astype(np.float32)
        t = torch.from_numpy(a[:, cols].copy())
        n = t.shape[0] * t.shape[1]
        return TransitionBatch(obs=t.reshape(n, 3), acts=t[..., :1].reshape(n, 1), next_obs=t.reshape(n, 3),
                               dones=t[..., 0].reshape(n), rews=t[..., 1].reshape(n)), a

    ring = buffer_mod.ReplayBuffer(capacity)
    example = batch(1)[0]
    whole = ring.init_state(example)
    meshes = [Mesh(dp=W, rank=r) for r in range(W)]
    locals_ = [buffer_mod.shard_ring(ring.init_state(example), m, E) for m in meshes]
    for steps in (2, 2, 5):  # 8, 8 (wraps), 20 rows (more than the ring)
        b, a = batch(steps)
        whole = ring.store(whole, b)
        for r, m in enumerate(meshes):
            cols = m.rows(E)
            t = torch.from_numpy(a[:, cols].copy())
            n = t.shape[0] * t.shape[1]
            local_b = TransitionBatch(obs=t.reshape(n, 3), acts=t[..., :1].reshape(n, 1),
                                      next_obs=t.reshape(n, 3), dones=t[..., 0].reshape(n),
                                      rews=t[..., 1].reshape(n))
            locals_[r] = ring.store(locals_[r], local_b)
        assert all(s.global_size == whole.size for s in locals_)
    g = torch.arange(capacity)
    owner, row = locals_[0].shard.owner_and_row(g)
    for gi, o, ri in zip(g.tolist(), owner.tolist(), row.tolist()):
        np.testing.assert_array_equal(locals_[o].data.obs[ri].numpy(), whole.data.obs[gi].numpy())
    assert sorted(owner.tolist()) == [0] * 6 + [1] * 6


def test_ppo_minibatch_must_split_over_ranks():
    venv = make_vec_env("Pendulum-v1", num_envs=4, device="cpu")
    ppo = PPO(venv, ActorCriticPolicy(venv.observation_space, venv.action_space, hid_sizes=(4,)),
              PPOConfig(n_steps=4, n_minibatches=4), seed=0)
    state = ppo.init_state().replace(mesh=Mesh(dp=3))
    chunk = rollout_mod.collect(venv, ppo.policy.sample_fn(), ppo.init_state().env_state, 4,
                                make_generator(0, "cpu"))[1]
    assert _raises(lambda: ppo.process_chunk(state, None, chunk, state.generator)) == (
        ValueError, "minibatch size 4 not divisible by dp=3")


def test_initialize_world_of_one(tmp_path, monkeypatch):
    """No variables: a no-op. With a FileStore and world size 1 the group
    starts, the collectives are the identity and ``shutdown`` leaves it."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is None
    assert _raises(lambda: distributed.initialize(rank=0, world_size=1, init_method="file:///x"))[0] is ValueError
    dev = distributed.initialize("gloo", rank=0, world_size=1, device="cpu",
                                 init_method="file://" + os.path.join(tmp_path, "store"),
                                 timeout=datetime.timedelta(seconds=60))
    try:
        assert dev == torch.device("cpu")
        m = mesh_mod.make_mesh()
        assert m.distributed and m.dp == 1 and m.device == torch.device("cpu")
        x = torch.arange(6.0).reshape(3, 2)
        np.testing.assert_array_equal(distributed.process_allgather(x, m).numpy(), x.numpy())
        t = [x.clone()]
        distributed.all_reduce_(t, m, average=True)
        np.testing.assert_array_equal(t[0].numpy(), x.numpy())
        distributed.barrier(m)
    finally:
        distributed.shutdown()
    assert not distributed.is_multiprocess() and not torch.distributed.is_initialized()
