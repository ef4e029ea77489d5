"""The rank processes of tests/test_torch_distributed.py, and the cases they run.

Launched as ``python -m tests.torch_dist_worker <dir> <case>,<case>,...`` with
``RANK`` and ``WORLD_SIZE`` set (``launch``): each rank joins a gloo group
through a ``FileStore`` in ``<dir>``, runs the cases over
``parallel.mesh.make_mesh()`` on the CPU and writes ``<dir>/<case>_<rank>.pt``.
The parent test runs the same case functions with ``mesh=None`` for the
one-process run. This module imports the port only, not JAX: the JAX
package's draws and weights come in ``<dir>/inputs.pt``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import subprocess
import sys
import types as pytypes
from typing import Any, Dict, Optional

import numpy as np
import torch

from imitation_tpu_torch.algorithms import preference_comparisons as pc
from imitation_tpu_torch.algorithms.adversarial.gail import GAIL
from imitation_tpu_torch.data import buffer as buffer_mod
from imitation_tpu_torch.data import types
from imitation_tpu_torch.data.rollout import RolloutChunk
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.envs.base import Space
from imitation_tpu_torch.models import networks
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.parallel import distributed
from imitation_tpu_torch.parallel import mesh as mesh_mod
from imitation_tpu_torch.rewards import reward_nets
from imitation_tpu_torch.rewards.reward_nets import BasicRewardNet
from imitation_tpu_torch.rl.ppo import PPO, PPOConfig
from imitation_tpu_torch.rl.sac import SAC, SACConfig
from imitation_tpu_torch.testing import experts
from imitation_tpu_torch.util.checkpoint import save_state
from imitation_tpu_torch.util.logger import configure

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT = 240  # seconds a launch of ranks may take in all
GROUP_TIMEOUT = datetime.timedelta(seconds=120)  # any one collective


def launch(out_dir: str, world_size: int, cases: str) -> None:
    """Runs ``world_size`` ranks of this module on ``cases`` and waits for
    them, killing every rank when any fails or the launch outlasts
    ``LAUNCH_TIMEOUT``."""
    procs = []
    for rank in range(world_size):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                   OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        env.pop("MASTER_ADDR", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.torch_dist_worker", out_dir, cases], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=LAUNCH_TIMEOUT)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{out}"


def load(out_dir: str, case: str, world_size: int):
    return [torch.load(os.path.join(out_dir, f"{case}_{r}.pt"), weights_only=False)
            for r in range(world_size)]


def params(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    return {k: v.detach().clone().numpy() for k, v in module.named_parameters()}


def nudge_(modules, rel: float) -> None:
    with torch.no_grad():
        for m in modules:
            for p in m.parameters():
                p.mul_(1 + rel)


def feed(values):
    """A stand-in for a sampling helper that returns ``values`` in order."""
    queue = list(values)

    def take(*args, **kwargs):
        item = queue.pop(0)
        if isinstance(item, tuple):
            return tuple(torch.from_numpy(np.array(x)) for x in item)
        return torch.from_numpy(np.array(item)).long()

    take.remaining = queue
    return take


def columns(chunk: RolloutChunk, mesh) -> RolloutChunk:
    """A rank's env columns of a ``[T, B]`` chunk (the whole one without a mesh)."""
    if mesh is None:
        return chunk
    rows = mesh.rows(chunk.acts.shape[1])
    return RolloutChunk(aux={k: v[:, rows] for k, v in chunk.aux.items()},
                        **{f.name: getattr(chunk, f.name)[:, rows]
                           for f in dataclasses.fields(chunk) if f.name != "aux"})


# -- (b) collectives ------------------------------------------------------------


def collectives_case(mesh) -> Dict[str, Any]:
    """The counterpart of tests/parallel/test_distributed.py's psum step: each
    rank holds a different half of the batch; one SGD step on the global
    mean of (x @ w)^2, the global mean, the gathered batch; and the errors."""
    W, r = mesh.dp, mesh.rank
    x = torch.arange(16, dtype=torch.float32).reshape(4, 4) + 100.0 * r
    w = torch.ones(4, requires_grad=True)
    ((x @ w) ** 2).mean().backward()
    distributed.all_reduce_grads_([w], mesh)
    out = {"w": (w.detach() - 0.01 * w.grad).numpy()}
    out["full"] = distributed.process_allgather({"x": x}, mesh)["x"].numpy()
    flat = x.reshape(-1)
    n, mean, m2 = distributed.merge_moments(torch.tensor(16.0), flat.mean(), flat.var(unbiased=False) * 16,
                                            mesh)
    out.update(count=float(n), batch_mean=float(mean), batch_var=float(m2 / n))
    with distributed.local_rows(mesh):
        cnt, col_mean, col_var = distributed.row_moments(x)
        out.update(col_count=float(torch.as_tensor(cnt).reshape(-1)[0]), col_mean=col_mean.numpy(),
                   col_var=col_var.numpy(), col_mean_ema=distributed.row_mean(x).numpy(),
                   draw=distributed.draw_rows(lambda s: torch.arange(s[0] * s[1]).reshape(s), (2, 3)).numpy())
    out["replicated"] = distributed.replicate_global(torch.full((3,), float(r + 1)), mesh).numpy()
    out["local_envs"] = distributed.local_env_count(8)
    errors = {}
    for name, fn in (("env_count", lambda: distributed.local_env_count(4 * W + 1)),
                     ("tp", lambda: mesh_mod.make_mesh(dp=1, tp=W, device="cpu")),
                     ("dp_tp", lambda: mesh_mod.make_mesh(dp=W + 1, device="cpu"))):
        try:
            fn()
            errors[name] = None
        except Exception as e:  # noqa: BLE001 - the type is the result
            errors[name] = (type(e).__name__, str(e))
    out["errors"] = errors
    distributed.barrier(mesh)
    return out


# -- (c, h) PPO process_chunk and the checkpoint ----------------------------------

PPO_T, PPO_B = 8, 8


def ppo_chunk(policy: ActorCriticPolicy, seed: int) -> RolloutChunk:
    """A Pendulum-shaped ``[T, B]`` chunk from ``seed``, its log-probs and
    values the policy's own (every rank computes the whole chunk's)."""
    rng = np.random.default_rng(seed)
    T, B = PPO_T, PPO_B
    terminated = rng.random((T, B)) < 0.05
    arrays = dict(
        obs=rng.normal(size=(T, B, 3)).astype(np.float32),
        acts=rng.normal(size=(T, B, 1)).astype(np.float32),
        rews=rng.normal(size=(T, B)).astype(np.float32),
        next_obs=rng.normal(size=(T, B, 3)).astype(np.float32),
        terminated=terminated,
        truncated=(rng.random((T, B)) < 0.1) & ~terminated,
        episode_return=rng.normal(size=(T, B)).astype(np.float32),
        episode_length=rng.integers(1, 50, (T, B)).astype(np.int32),
    )
    tensors = {k: torch.from_numpy(v) for k, v in arrays.items()}
    with torch.no_grad():
        dist, value = policy.dist_and_value(tensors["obs"].reshape(T * B, 3))
        aux = {"log_prob": dist.log_prob(tensors["acts"].reshape(T * B, 1)).reshape(T, B),
               "value": value.reshape(T, B)}
    return RolloutChunk(aux=aux, **tensors)


def build_ppo(target_kl: Optional[float] = None) -> PPO:
    venv = make_vec_env("Pendulum-v1", num_envs=PPO_B, device="cpu")
    policy = ActorCriticPolicy(venv.observation_space, venv.action_space, hid_sizes=(16, 16),
                               normalize_features=True)
    cfg = PPOConfig(n_steps=PPO_T, n_minibatches=4, n_epochs=2, learning_rate=3e-3,
                    normalize_rewards=True, target_kl=target_kl)
    return PPO(venv, policy, cfg, seed=0)


def ppo_record(ppo: PPO, state, metrics) -> Dict[str, Any]:
    norm = ppo.policy.net.feat_norm
    rn = state.reward_norm
    return dict(params=params(ppo.policy), metrics={k: float(v) for k, v in metrics.items()},
                feat_mean=norm.running_mean.numpy().copy(), feat_var=norm.running_var.numpy().copy(),
                rew_stats=np.array([float(rn.mean), float(rn.var), float(rn.count)]),
                timesteps=state.timesteps)


def ppo_case(mesh, rel: float = 0.0, ckpt_dir: Optional[str] = None) -> Dict[str, Any]:
    """Two ``process_chunk`` calls (feature and reward normalization on),
    plain and with a ``target_kl`` that stops the second epoch; with
    ``ckpt_dir`` the plain state is saved and one more chunk processed."""
    out = {}
    for label, target_kl in (("plain", None), ("kl", 2e-3)):
        ppo = build_ppo(target_kl)
        state = ppo.init_state()
        nudge_([ppo.policy], rel)
        if mesh is not None:
            state = mesh_mod.shard_rl_state(state, mesh)
        init = params(ppo.policy)
        for seed in (1, 2):
            chunk = columns(ppo_chunk(ppo.policy, seed), mesh)
            state, metrics = ppo.process_chunk(state, state.env_state, chunk, state.generator)
        out[label] = dict(init=init, **ppo_record(ppo, state, metrics))
        if label == "plain" and ckpt_dir is not None:
            save_state(os.path.join(ckpt_dir, "ppo.ckpt"), state)
            chunk = columns(ppo_chunk(ppo.policy, 3), mesh)
            state, metrics = ppo.process_chunk(state, state.env_state, chunk, state.generator)
            out["resumed"] = ppo_record(ppo, state, metrics)
            out["local_ret"] = state.reward_norm.ret.numpy().copy()
    return out


# -- (d) GAIL train_fused with the JAX package's draws ------------------------------


def build_gail_fixed(inputs: Dict[str, Any]) -> GAIL:
    """GAIL at tests/test_torch_gail.py's widths (CartPole, 8 envs x 16 steps)
    with the JAX trainer's weights."""
    demo = types.TransitionBatch(**{k: torch.from_numpy(v) for k, v in inputs["demos"].items()})
    venv = make_vec_env("CartPole-v1", num_envs=inputs["B"], device="cpu")
    tr = GAIL(demonstrations=demo, venv=venv,
              gen_config=PPOConfig(n_steps=inputs["T"], n_minibatches=4, n_epochs=2, learning_rate=1e-3),
              reward_net=BasicRewardNet(venv.observation_space, venv.action_space, normalize_input=False),
              demo_batch_size=64, n_disc_updates_per_round=2, allow_variable_horizon=True, seed=0,
              custom_logger=configure(format_strs=()))
    tr.reward_net.load_state_dict(inputs["reward_sd"])
    tr.gen_state = tr.gen_algo.init_state()
    tr.policy.load_state_dict(inputs["policy_sd"])
    return tr


def gail_fixed_case(mesh, inputs: Dict[str, Any], rel: float = 0.0) -> Dict[str, Any]:
    """``train_fused`` over 2 rounds with the fixed rollout chunk (this rank's
    columns), the JAX epoch permutations and disc-step indices fed in."""
    import imitation_tpu_torch.algorithms.adversarial.common as adv_common
    import imitation_tpu_torch.rl.ppo as ppo_mod

    T, B, rounds = inputs["T"], inputs["B"], inputs["rounds"]
    tr = build_gail_fixed(inputs)
    nudge_([tr.policy, tr.reward_net], rel)
    if mesh is not None:
        mesh_mod.shard_adversarial_trainer(tr, mesh)
    chunk = columns(RolloutChunk(aux={k: torch.from_numpy(v) for k, v in inputs["aux"].items()},
                                 **{k: torch.from_numpy(v) for k, v in inputs["chunk"].items()}), mesh)
    perms, indices = feed(inputs["perms"]), feed(inputs["disc_indices"])
    saved = (ppo_mod.rollout_mod.collect, ppo_mod._epoch_permutation, adv_common._disc_indices)
    ppo_mod.rollout_mod.collect = lambda venv, fn, state, n, generator: (state, chunk)
    ppo_mod._epoch_permutation, adv_common._disc_indices = perms, indices
    init = {"policy": params(tr.policy), "disc": params(tr.reward_net)}
    try:
        tr.train_fused(rounds * T * B, rounds_per_sync=rounds)
    finally:
        ppo_mod.rollout_mod.collect, ppo_mod._epoch_permutation, adv_common._disc_indices = saved
    assert perms.remaining == [] and indices.remaining == []
    return dict(init=init, policy=params(tr.policy), disc=params(tr.reward_net),
                ring=tr._gen_buffer_state.data.obs.numpy().copy(), ring_size=tr._gen_buffer_state.size,
                timesteps=tr.gen_state.timesteps, disc_step=tr.disc_state.step)


# -- (e) GAIL train_fused on the envs ----------------------------------------------


def gail_envs_case(mesh, rel: float = 0.0) -> Dict[str, Any]:
    """``train_fused`` over 2 rounds on 8 CartPole envs stepped for real: each
    rank steps its block of them, every draw its block of the one-process
    draw."""
    demo_venv = make_vec_env("CartPole-v1", num_envs=4, max_episode_steps=32, device="cpu")
    demos = experts.generate_expert_trajectories("CartPole-v1", demo_venv, min_episodes=4, seed=0)
    venv = make_vec_env("CartPole-v1", num_envs=8, max_episode_steps=32, device="cpu")
    tr = GAIL(demonstrations=demos, demo_batch_size=32, venv=venv,
              gen_config=PPOConfig(n_steps=8, n_minibatches=2, n_epochs=2),
              n_disc_updates_per_round=2, allow_variable_horizon=True, seed=0,
              custom_logger=configure(format_strs=()))
    tr.gen_state = tr.gen_algo.init_state()
    nudge_([tr.policy, tr.reward_net], rel)
    if mesh is not None:
        mesh_mod.shard_adversarial_trainer(tr, mesh)
    init = {"policy": params(tr.policy), "disc": params(tr.reward_net)}
    tr.train_fused(2 * tr.gen_train_timesteps, rounds_per_sync=2)
    return dict(init=init, policy=params(tr.policy), disc=params(tr.reward_net),
                ring=tr._gen_buffer_state.data.obs.numpy().copy(), timesteps=tr.gen_state.timesteps,
                n_updates=tr.gen_state.n_updates, disc_step=tr.disc_state.step,
                local_envs=tr.gen_state.env_state.obs.shape[0])


# -- (f) SAC with the split ring ----------------------------------------------------


def sac_case(mesh) -> Dict[str, Any]:
    venv = make_vec_env("Pendulum-v1", num_envs=4, device="cpu")
    sac = SAC(venv, SACConfig(train_freq=2, gradient_steps=2, learning_starts=8, buffer_size=32,
                              batch_size=16, actor_hid_sizes=(16,), critic_hid_sizes=(16,)), seed=0)
    state = sac.init_state()
    if mesh is not None:
        state = mesh_mod.shard_sac_state(state, mesh)
    local_rows = state.buffer_state.data.batch_size
    for _ in range(6):  # 48 transitions: the 32-row ring wraps
        state, metrics = sac.train_step(state)
    ring = state.buffer_state
    whole = buffer_mod.unshard_ring(ring) if ring.shard is not None else ring
    return dict(actor=params(sac.actor), critic=params(sac.critic), log_alpha=float(sac.log_alpha.detach()),
                local_rows=local_rows, local_size=ring.size, ring_obs=whole.data.obs.numpy().copy(),
                ring_acts=whole.data.acts.numpy().copy(), timesteps=state.timesteps,
                metrics={k: float(v) for k, v in metrics.items()})


# -- (g) the reward trainers --------------------------------------------------------

FRAG_LEN = 6


def preference_dataset(n_pairs: int = 22, seed: int = 0) -> pc.PreferenceDataset:
    rng = np.random.default_rng(seed)
    trajs = []
    for i in range(8):
        steps = int(rng.integers(FRAG_LEN, 4 * FRAG_LEN))
        trajs.append(types.TrajectoryWithRew(
            obs=rng.normal(size=(steps + 1, 3)).astype(np.float32),
            acts=rng.normal(size=(steps, 2)).astype(np.float32),
            rews=rng.normal(size=steps), infos=None, terminal=bool(i % 3 == 0)))
    logger = configure(format_strs=())
    fragments = pc.RandomFragmenter(rng=seed, warning_threshold=0, custom_logger=logger)(
        trajs, FRAG_LEN, n_pairs)
    ds = pc.PreferenceDataset()
    ds.push(fragments, pc.SyntheticGatherer(rng=seed, custom_logger=logger)(fragments))
    return ds


def reward_case(mesh, kind: str, rel: float = 0.0) -> Dict[str, Any]:
    """``train`` of a ``BasicRewardTrainer`` or an ``EnsembleTrainer`` on 22
    pairs in batches of 8 and slices of 4: a trailing batch of 6 whose second
    slice (2 pairs) is all on rank 0."""
    box3, box2 = Space.box(-2.0, 2.0, (3,)), Space.box(-2.0, 2.0, (2,))
    if kind == "basic":
        net = reward_nets.BasicRewardNet(box3, box2, normalize_input=True)
        trainer_cls = pc.BasicRewardTrainer
    else:
        net = reward_nets.RewardEnsemble(box3, box2, num_members=3, member_normalize_cls=networks.RunningNorm)
        trainer_cls = pc.EnsembleTrainer
    net.init(torch.Generator().manual_seed(0))
    nudge_([net], rel)
    trainer = trainer_cls(pc.PreferenceModel(net), rng=0, batch_size=8, minibatch_size=4, epochs=3,
                          lr=1e-3, custom_logger=configure(format_strs=()))
    init = params(net)
    if mesh is not None:
        mesh_mod.shard_preference_comparisons(
            pytypes.SimpleNamespace(reward_trainer=trainer, trajectory_generator=None), mesh)
    metrics = trainer.train(preference_dataset())
    return dict(init=init, params=params(net), metrics=dict(metrics))


# -- RLHF: the agent and the reward trainer split ---------------------------------


def rlhf_case(mesh, rel: float = 0.0) -> Dict[str, Any]:
    """Two ``PreferenceComparisons`` iterations (PPO agent on 8 Pendulum envs
    with an exploration share, ``BasicRewardTrainer`` batch 16) placed by
    ``shard_preference_comparisons``: sampling, fragments and preferences
    replicated, the agent's envs and the reward batches split."""
    venv = make_vec_env("Pendulum-v1", num_envs=8, device="cpu")
    ppo = PPO(venv, ActorCriticPolicy(venv.observation_space, venv.action_space, hid_sizes=(16,)),
              PPOConfig(n_steps=16, n_minibatches=2, n_epochs=2), seed=0)
    net = BasicRewardNet(venv.observation_space, venv.action_space)
    logger = configure(format_strs=())
    agent = pc.AgentTrainer(ppo, net, venv, rng=0, exploration_frac=0.25, custom_logger=logger)
    trainer = pc.PreferenceComparisons(
        agent, net, num_iterations=2,
        reward_trainer=pc.BasicRewardTrainer(pc.PreferenceModel(net), rng=0, batch_size=16, epochs=2, lr=2e-3),
        fragmenter=pc.RandomFragmenter(rng=0, warning_threshold=0),
        preference_gatherer=pc.SyntheticGatherer(rng=np.random.default_rng(0), sample=False),
        fragment_length=16, transition_oversampling=1.5, initial_comparison_frac=0.25,
        initial_epoch_multiplier=2.0, allow_variable_horizon=True, rng=0, seed=0, custom_logger=logger)
    nudge_([ppo.policy, net], rel)
    if mesh is not None:
        mesh_mod.shard_preference_comparisons(trainer, mesh)
    init = {"policy": params(ppo.policy), "net": params(net)}
    result = trainer.train(total_timesteps=512, total_comparisons=32)
    return dict(init=init, policy=params(ppo.policy), net=params(net), timesteps=agent.state.timesteps,
                dataset=len(trainer.dataset), accuracy=float(result["reward_accuracy"]))


# -- tutorial 11 --------------------------------------------------------------------


def tutorial_case(mesh, out_dir: str) -> Dict[str, Any]:
    """The ported tutorial 11: 4 sharded rounds, then rank 0 resumes alone."""
    from imitation_tpu_torch.examples.tutorials import t11_multichip

    trainer, resumed = t11_multichip.run(mesh, out_dir, "cpu", n_rounds=4)
    out = dict(policy=params(trainer.policy), n_updates=trainer.gen_state.n_updates,
               timesteps=trainer.gen_state.timesteps)
    if resumed is not None:
        out.update(resumed_n_updates=resumed.gen_state.n_updates, resumed_timesteps=resumed.gen_state.timesteps)
    return out


# -- the rank process ---------------------------------------------------------------


def main(out_dir: str, cases: str) -> None:
    torch.set_num_threads(1)
    distributed.initialize("gloo", init_method="file://" + os.path.join(out_dir, "store"), device="cpu",
                           timeout=GROUP_TIMEOUT)
    mesh = mesh_mod.make_mesh(device="cpu")
    inputs_path = os.path.join(out_dir, "inputs.pt")
    inputs = torch.load(inputs_path, weights_only=False) if os.path.exists(inputs_path) else {}
    runners = {
        "collectives": lambda: collectives_case(mesh),
        "ppo": lambda: ppo_case(mesh, ckpt_dir=out_dir),
        "gail_fixed": lambda: gail_fixed_case(mesh, inputs["gail"]),
        "gail_envs": lambda: gail_envs_case(mesh),
        "sac": lambda: sac_case(mesh),
        "reward_basic": lambda: reward_case(mesh, "basic"),
        "reward_ensemble": lambda: reward_case(mesh, "ensemble"),
        "tutorial": lambda: tutorial_case(mesh, out_dir),
        "rlhf": lambda: rlhf_case(mesh),
    }
    for case in cases.split(","):
        result = runners[case]()
        torch.save(result, os.path.join(out_dir, f"{case}_{mesh.rank}.pt"))
    distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
