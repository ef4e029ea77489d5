"""Rollout collection: the on-device step loop and the host trajectory API.

Port of the device-env half of ``imitation_tpu/data/rollout.py``:

* ``collect``: steps a ``VectorEnv`` with a policy for T steps and returns a
  ``RolloutChunk`` of ``[T, B]`` tensors on the env's device. Where the JAX
  package scans one traced step, this is a Python loop of eager launches.
* ``generate_trajectories``: collects complete episodes until a
  ``sample_until`` condition holds, cuts them on the host into
  ``TrajectoryWithRew`` objects and shuffles them, as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Sequence, Tuple, Union

import numpy as np
import torch

from imitation_tpu_torch import make_generator
from imitation_tpu_torch.data import types
from imitation_tpu_torch.envs.vector import VecEnvState, VectorEnv

# A rollout policy: (obs[B, ...], generator) -> (acts[B, ...], aux dict).
PolicyApply = Callable[[torch.Tensor, torch.Generator], Tuple[torch.Tensor, Any]]

GenTrajTerminationFn = Callable[[Sequence[types.TrajectoryWithRew]], bool]


@dataclasses.dataclass
class RolloutChunk:
    """[T, B]-shaped result of a rollout (device-resident)."""

    obs: torch.Tensor  # [T, B, ...] obs the action was computed from
    acts: torch.Tensor  # [T, B, ...]
    rews: torch.Tensor  # [T, B]
    next_obs: torch.Tensor  # [T, B, ...] true next obs (terminal obs at episode ends)
    terminated: torch.Tensor  # [T, B] bool
    truncated: torch.Tensor  # [T, B] bool
    episode_return: torch.Tensor  # [T, B] valid where done
    episode_length: torch.Tensor  # [T, B] valid where done
    aux: Dict[str, torch.Tensor]  # [T, B, ...] policy aux (log_prob, value, ...)

    @property
    def dones(self) -> torch.Tensor:
        return self.terminated | self.truncated

    @property
    def num_steps(self) -> int:
        return self.acts.shape[0]

    @property
    def num_envs(self) -> int:
        return self.acts.shape[1]

    def replace(self, **changes) -> "RolloutChunk":
        return dataclasses.replace(self, **changes)


def collect(
    venv: VectorEnv,
    policy_apply: PolicyApply,
    state: VecEnvState,
    num_steps: int,
    generator: torch.Generator,
) -> Tuple[VecEnvState, RolloutChunk]:
    """Steps ``num_steps`` of policy+env interaction on the env's device.

    ``next_obs`` at done steps is the *terminal* observation, so reward
    relabelling over the chunk sees the true (s, a, s', done) tuples.
    """
    names = ("obs", "acts", "rews", "next_obs", "terminated", "truncated",
             "episode_return", "episode_length")
    recs: Dict[str, List[torch.Tensor]] = {k: [] for k in names}
    aux_recs: List[Any] = []
    for _ in range(num_steps):
        obs = state.obs
        acts, aux = policy_apply(obs, generator)
        state, out = venv.step(state, acts)
        for k, v in (("obs", obs), ("acts", acts), ("rews", out.reward),
                     ("next_obs", out.terminal_obs), ("terminated", out.terminated),
                     ("truncated", out.truncated), ("episode_return", out.episode_return),
                     ("episode_length", out.episode_length)):
            recs[k].append(v)
        aux_recs.append(aux)
    stacked = {k: torch.stack(v) for k, v in recs.items()}
    aux_stacked = (
        {k: torch.stack([a[k] for a in aux_recs]) for k in aux_recs[0]}
        if aux_recs and aux_recs[0] else {}
    )
    return state, RolloutChunk(aux=aux_stacked, **stacked)


def chunk_to_transitions(chunk: RolloutChunk) -> types.TransitionBatch:
    """Flattens a [T, B] rollout chunk into a [T*B] TransitionBatch (device)."""
    T, B = chunk.acts.shape[0], chunk.acts.shape[1]

    def flat(x):
        return x.reshape((T * B,) + tuple(x.shape[2:]))

    return types.TransitionBatch(
        obs=flat(chunk.obs),
        acts=flat(chunk.acts),
        next_obs=flat(chunk.next_obs),
        dones=flat(chunk.dones.float()),
        rews=flat(chunk.rews),
    )


# ---------------------------------------------------------------------------
# Termination conditions (host-side)
# ---------------------------------------------------------------------------


def make_min_episodes(n: int) -> GenTrajTerminationFn:
    """Terminate after collecting n episodes."""
    if n < 1:
        raise ValueError(f"n must be positive, got {n}")
    return lambda trajectories: len(trajectories) >= n


# ---------------------------------------------------------------------------
# Host-side conversion: chunks -> trajectories
# ---------------------------------------------------------------------------


class TrajectoryAccumulator:
    """Cuts [T, B] chunks into variable-length episodes, per env column.

    Partial episodes carry over between chunks. Episodes come out in the
    order they finish (by step, then env), as in the JAX package.
    """

    def __init__(self, num_envs: int):
        self.partial: List[List[Dict[str, np.ndarray]]] = [[] for _ in range(num_envs)]

    def add_chunk(self, chunk: RolloutChunk) -> List[types.TrajectoryWithRew]:
        obs = chunk.obs.cpu().numpy()
        acts = chunk.acts.cpu().numpy()
        rews = chunk.rews.cpu().numpy()
        next_obs = chunk.next_obs.cpu().numpy()
        terminated = chunk.terminated.cpu().numpy()
        done = terminated | chunk.truncated.cpu().numpy()
        finished: List[Tuple[int, int, types.TrajectoryWithRew]] = []
        T = acts.shape[0]
        for b in range(acts.shape[1]):
            start = 0
            for t in np.flatnonzero(done[:, b]):
                segs = self.partial[b] + [
                    dict(obs=obs[start:t + 1, b], acts=acts[start:t + 1, b],
                         rews=rews[start:t + 1, b])
                ]
                self.partial[b] = []
                traj = types.TrajectoryWithRew(
                    obs=np.concatenate([s["obs"] for s in segs] + [next_obs[t, b][None]]),
                    acts=np.concatenate([s["acts"] for s in segs]),
                    rews=np.concatenate([s["rews"] for s in segs]).astype(np.float64),
                    infos=None,
                    terminal=bool(terminated[t, b]),
                )
                finished.append((int(t), b, traj))
                start = t + 1
            if start < T:
                self.partial[b].append(
                    dict(obs=obs[start:, b], acts=acts[start:, b], rews=rews[start:, b])
                )
        finished.sort(key=lambda x: (x[0], x[1]))
        return [traj for _, _, traj in finished]


def generate_trajectories(
    policy_apply: PolicyApply,
    venv: VectorEnv,
    sample_until: GenTrajTerminationFn,
    rng: Union[int, np.random.Generator],
    *,
    chunk_size: int = 256,
) -> Sequence[types.TrajectoryWithRew]:
    """Collects complete episodes until ``sample_until`` is satisfied.

    Rollouts run on the env's device in fixed-size chunks; episodes are cut
    on the host between chunks, then shuffled so that truncation by the
    caller does not favour short episodes.
    """
    if isinstance(rng, np.random.Generator):
        seed = int(rng.integers(0, 2**31 - 1))
    else:
        seed = int(rng)
        rng = np.random.default_rng(seed)
    generator = make_generator(seed, venv.device)
    state = venv.reset(generator)
    accum = TrajectoryAccumulator(venv.num_envs)
    trajectories: List[types.TrajectoryWithRew] = []
    while not sample_until(trajectories):
        state, chunk = collect(venv, policy_apply, state, chunk_size, generator)
        trajectories.extend(accum.add_chunk(chunk))

    perm = rng.permutation(len(trajectories))
    trajectories = [trajectories[i] for i in perm]

    obs_shape = tuple(venv.observation_space.shape)
    for trajectory in trajectories:
        n_steps = len(trajectory.acts)
        if trajectory.obs.shape != (n_steps + 1,) + obs_shape:
            raise ValueError(f"bad obs shape {trajectory.obs.shape} for {n_steps} steps")
        if trajectory.rews.shape != (n_steps,):
            raise ValueError(f"bad rews shape {trajectory.rews.shape} for {n_steps} steps")
    return trajectories


def flatten_trajectories(trajectories: Sequence[types.Trajectory]) -> types.TransitionBatch:
    """Flattens trajectories into a TransitionBatch on the CPU.

    ``dones`` marks the last step of each terminal trajectory; ``rews`` is
    zeros, as in the JAX package's ``TransitionBatch.from_host`` of plain
    ``Transitions``. Arrays become 32-bit, as JAX's ``asarray`` makes them.
    """
    obs = np.concatenate([t.obs[:-1] for t in trajectories]).astype(np.float32)
    next_obs = np.concatenate([t.obs[1:] for t in trajectories]).astype(np.float32)
    acts = np.concatenate([t.acts for t in trajectories])
    acts = acts.astype(np.int32 if np.issubdtype(acts.dtype, np.integer) else np.float32)
    dones = np.concatenate([
        np.arange(len(t)) == len(t) - 1 if t.terminal else np.zeros(len(t), bool)
        for t in trajectories
    ])
    return types.TransitionBatch(
        obs=torch.from_numpy(np.ascontiguousarray(obs)),
        acts=torch.from_numpy(np.ascontiguousarray(acts)),
        next_obs=torch.from_numpy(np.ascontiguousarray(next_obs)),
        dones=torch.from_numpy(dones.astype(np.float32)),
        rews=torch.zeros(len(acts), dtype=torch.float32),
    )


def rollout_stats(trajectories: Sequence[types.TrajectoryWithRew]) -> Mapping[str, float]:
    """Summary stats: return/len min/mean/std/max (+ monitor_return)."""
    if not trajectories:
        raise ValueError("no trajectories")
    out_stats: Dict[str, float] = {"n_traj": len(trajectories)}
    returns = np.asarray([np.sum(t.rews) for t in trajectories])
    traj_descriptors = {
        "return": returns,
        "len": np.asarray([len(t.rews) for t in trajectories]),
        # Chunks record the true env reward, so the monitor return is the
        # plain return.
        "monitor_return": returns,
    }
    for desc_name, desc_vals in traj_descriptors.items():
        for stat_name in ("min", "mean", "std", "max"):
            out_stats[f"{desc_name}_{stat_name}"] = float(getattr(np, stat_name)(desc_vals))
    return out_stats
