"""Rollout collection: the on-device step loop, host-env collection and the
host trajectory API.

Port of ``imitation_tpu/data/rollout.py``:

* ``collect``: steps a ``VectorEnv`` with a policy for T steps and returns a
  ``RolloutChunk`` of ``[T, B]`` tensors on the env's device. Where the JAX
  package scans one traced step, this is a Python loop of eager launches.
* ``HostCollector``: the same chunk from a host vector env (``is_host``,
  e.g. ``native.CppVectorEnv``): the env steps on the host and the policy's
  forward runs on a CPU snapshot of its module, refreshed explicitly; the
  finished chunk moves to ``venv.device`` once per field.
* ``generate_trajectories``: collects complete episodes until a
  ``sample_until`` condition holds, cuts them on the host into
  ``TrajectoryWithRew`` objects and shuffles them, as the reference does
  (through ``generate_trajectories_host`` on a host env); ``rollout`` and
  ``generate_transitions`` build on it.
* Host helpers: the ``sample_until`` conditions, ``flatten_trajectories``
  (``_with_rew``), ``rollout_stats`` and ``discounted_sum``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from imitation_tpu_torch import make_generator
from imitation_tpu_torch.data import types
from imitation_tpu_torch.envs.vector import VecEnvState, VectorEnv
from imitation_tpu_torch.parallel import distributed
from imitation_tpu_torch.parallel import mesh as mesh_mod

# A rollout policy: (obs[B, ...], generator) -> (acts[B, ...], aux dict).
PolicyApply = Callable[[torch.Tensor, torch.Generator], Tuple[torch.Tensor, Any]]

GenTrajTerminationFn = Callable[[Sequence[types.TrajectoryWithRew]], bool]

CHUNK_FIELDS = ("obs", "acts", "rews", "next_obs", "terminated", "truncated",
                "episode_return", "episode_length")


def module_fn(module: torch.nn.Module, make: Callable[[torch.nn.Module], PolicyApply]) -> PolicyApply:
    """``make(module)``: a rollout policy that reads ``module``'s weights,
    marked with ``module`` and ``rebind = make`` so that a ``HostCollector``
    can build the same policy over a CPU copy of the module."""
    fn = make(module)
    fn.module, fn.rebind = module, make
    return fn


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
    relabelling over the chunk sees the true (s, a, s', done) tuples. Over a
    data-parallel rank's view (``VectorEnv.rows``) the policy's draws are
    that rank's block of the whole batch's.
    """
    recs: Dict[str, List[torch.Tensor]] = {k: [] for k in CHUNK_FIELDS}
    aux_recs: List[Any] = []
    mesh = getattr(venv, "mesh", None)  # a data-parallel rank's view (VectorEnv.rows)
    for _ in range(num_steps):
        obs = state.obs
        with distributed.local_rows(mesh):
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


class HostCollector:
    """Rollout collection for a host vector env (``venv.is_host``).

    The env steps on the host; the policy's forward runs on the CPU, one
    call per env step for all B envs, under ``torch.inference_mode``. A
    policy made by ``module_fn`` (every policy module's ``sample_fn``) runs
    over a CPU snapshot of its module, which ``refresh`` (or
    ``set_policy``) overwrites with the module's ``state_dict``, buffers
    included, by a synchronous copy; a tp-split module's split weights are
    gathered whole first, so the snapshot is the unsplit module. The learners update their module in
    place on ``venv.device`` meanwhile, so a collection running on another
    thread reads only the snapshot. Other policies (scripted experts,
    ``host_stateful`` ones) are host functions and are called as they are.
    Draws come from the collector's own CPU generator, seeded with ``seed``;
    with ``mesh`` set (a data-parallel rank whose host env is its block of
    the envs, ``parallel.distributed.local_env_count``) they are that
    block of the whole batch's draws.
    ``collect`` stacks each field in numpy and copies it to ``venv.device``
    (or ``device``) once.
    """

    def __init__(self, venv, policy_apply: PolicyApply, seed: int = 0):
        self.venv = venv
        self._source: Optional[torch.nn.Module] = None
        self._snapshot: Optional[torch.nn.Module] = None
        self.mesh = None
        self.set_policy(policy_apply)
        self.reseed(seed)

    def reseed(self, seed: int) -> None:
        """Resets the env and the generator for a fresh collection pass."""
        self.generator = torch.Generator().manual_seed(int(seed))
        self.obs = self.venv.reset(seed=seed)

    def set_policy(self, policy_apply: PolicyApply) -> None:
        """Collects with ``policy_apply`` from now on, over a refreshed
        snapshot where it reads a module."""
        module = getattr(policy_apply, "module", None)
        if module is None:
            self._source, self._apply = None, policy_apply
            return
        if module is not self._source:
            self._snapshot = mesh_mod.unsplit_copy(module).cpu()
            self._source = module
        self._apply = policy_apply.rebind(self._snapshot)
        self.refresh()

    def refresh(self) -> None:
        """Copies the module's current weights and buffers into the snapshot
        (tp-split weights gathered whole: a collective over the tp ranks)."""
        if self._source is not None:
            with torch.no_grad():
                self._snapshot.load_state_dict(mesh_mod.full_state_dict(self._source))

    def collect(self, num_steps: int, device=None) -> RolloutChunk:
        recs: Dict[str, List[np.ndarray]] = {k: [] for k in CHUNK_FIELDS}
        aux_recs: List[Dict[str, np.ndarray]] = []
        for _ in range(num_steps):
            with torch.inference_mode(), distributed.local_rows(self.mesh):
                acts, aux = self._apply(torch.from_numpy(self.obs), self.generator)
                acts = acts.numpy() if isinstance(acts, torch.Tensor) else np.asarray(acts)
                aux = {k: v.numpy() for k, v in aux.items()}
            out = self.venv.step(acts)
            for k, v in (("obs", self.obs), ("acts", acts), ("rews", out["reward"]),
                         ("next_obs", out["terminal_obs"]), ("terminated", out["terminated"]),
                         ("truncated", out["truncated"]), ("episode_return", out["episode_return"]),
                         ("episode_length", out["episode_length"])):
                recs[k].append(v)
            aux_recs.append(aux)
            self.obs = out["obs"]
        dev = self.venv.device if device is None else device

        def put(arrays):
            return torch.from_numpy(np.stack(arrays)).to(dev)

        aux = {k: put([a[k] for a in aux_recs]) for k in aux_recs[0]} if aux_recs else {}
        return RolloutChunk(aux=aux, **{k: put(v) for k, v in recs.items()})


def generate_trajectories_host(
    policy_apply: PolicyApply,
    venv,
    sample_until: GenTrajTerminationFn,
    rng: Union[int, np.random.Generator],
    *,
    chunk_size: int = 128,
) -> Sequence[types.TrajectoryWithRew]:
    """``generate_trajectories`` over a host vector env. One collector is
    kept on the venv and reused with each call's policy; chunks stay on the
    host."""
    seed = int(rng.integers(0, 2**31 - 1)) if isinstance(rng, np.random.Generator) else int(rng)
    collector = getattr(venv, "_gen_traj_collector", None)
    if collector is None:
        collector = HostCollector(venv, policy_apply, seed=seed)
        venv._gen_traj_collector = collector
    else:
        collector.set_policy(policy_apply)
        collector.reseed(seed)
    accum = TrajectoryAccumulator(venv.num_envs)
    trajectories: List[types.TrajectoryWithRew] = []
    while not sample_until(trajectories):
        trajectories.extend(accum.add_chunk(collector.collect(chunk_size, device="cpu")))
    perm = np.random.default_rng(seed).permutation(len(trajectories))
    return [trajectories[i] for i in perm]


# ---------------------------------------------------------------------------
# Termination conditions (host-side)
# ---------------------------------------------------------------------------


def make_min_episodes(n: int) -> GenTrajTerminationFn:
    """Terminate after collecting n episodes."""
    if n < 1:
        raise ValueError(f"n must be positive, got {n}")
    return lambda trajectories: len(trajectories) >= n


def make_min_timesteps(n: int) -> GenTrajTerminationFn:
    """Terminate after collecting at least n timesteps."""
    if n < 1:
        raise ValueError(f"n must be positive, got {n}")
    return lambda trajectories: sum(len(t) for t in trajectories) >= n


def make_sample_until(
    min_timesteps: Optional[int] = None,
    min_episodes: Optional[int] = None,
) -> GenTrajTerminationFn:
    """Terminate once every given condition holds."""
    if min_timesteps is None and min_episodes is None:
        raise ValueError("At least one of min_timesteps and min_episodes must be provided")
    conditions = []
    if min_timesteps is not None:
        if min_timesteps < 1:
            raise ValueError(f"min_timesteps={min_timesteps} if provided must be positive")
        conditions.append(make_min_timesteps(min_timesteps))
    if min_episodes is not None:
        if min_episodes < 1:
            raise ValueError(f"min_episodes={min_episodes} if provided must be positive")
        conditions.append(make_min_episodes(min_episodes))
    return lambda trajectories: all(cond(trajectories) for cond in conditions)


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
    caller does not favour short episodes. A host vector env goes to
    ``generate_trajectories_host``.
    """
    if getattr(venv, "is_host", False):
        return generate_trajectories_host(policy_apply, venv, sample_until, rng, chunk_size=chunk_size)
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


def rollout(
    policy_apply: PolicyApply,
    venv: VectorEnv,
    sample_until: GenTrajTerminationFn,
    rng: Union[int, np.random.Generator],
    *,
    verbose: bool = False,
    **kwargs,
) -> Sequence[types.TrajectoryWithRew]:
    """``generate_trajectories``, printing ``rollout_stats`` if ``verbose``."""
    trajs = generate_trajectories(policy_apply, venv, sample_until, rng, **kwargs)
    if verbose:
        print(f"Rollout stats: {rollout_stats(trajs)}")
    return trajs


def generate_transitions(
    policy_apply: PolicyApply,
    venv: VectorEnv,
    n_timesteps: int,
    rng: Union[int, np.random.Generator],
    *,
    truncate: bool = True,
    **kwargs,
) -> types.TransitionsWithRew:
    """At least ``n_timesteps`` transitions from whole episodes, cut to
    exactly ``n_timesteps`` if ``truncate``."""
    trajs = generate_trajectories(policy_apply, venv, make_min_timesteps(n_timesteps), rng, **kwargs)
    transitions = flatten_trajectories_with_rew(trajs)
    if truncate:
        fields = {f.name: getattr(transitions, f.name) for f in dataclasses.fields(transitions)}
        transitions = types.TransitionsWithRew(**{k: v[:n_timesteps] for k, v in fields.items()})
    return transitions


def flatten_trajectories(trajectories: Sequence[types.Trajectory]) -> types.Transitions:
    """Flattens trajectories into host transitions.

    ``dones`` marks the last step of each terminal trajectory; ``infos`` are
    empty dicts where a trajectory has none; ``DictObs`` observations are
    concatenated per key.
    """
    parts: Dict[str, List[Any]] = {k: [] for k in ("obs", "next_obs", "acts", "dones", "infos")}
    for traj in trajectories:
        parts["obs"].append(traj.obs[:-1])
        parts["next_obs"].append(traj.obs[1:])
        parts["acts"].append(traj.acts)
        dones = np.zeros(len(traj.acts), dtype=bool)
        dones[-1] = traj.terminal
        parts["dones"].append(dones)
        parts["infos"].append(np.array([{}] * len(traj)) if traj.infos is None else traj.infos)
    cat = {k: types.concatenate_maybe_dictobs(v) if k in ("obs", "next_obs") else np.concatenate(v)
           for k, v in parts.items()}
    return types.Transitions(**{k: types.maybe_unwrap_dictobs(v) for k, v in cat.items()})


def flatten_trajectories_with_rew(
    trajectories: Sequence[types.TrajectoryWithRew],
) -> types.TransitionsWithRew:
    transitions = flatten_trajectories(trajectories)
    return types.TransitionsWithRew(
        **types.dataclass_quick_asdict(transitions),
        rews=np.concatenate([traj.rews for traj in trajectories]),
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


def discounted_sum(arr: np.ndarray, gamma: float) -> Union[np.ndarray, float]:
    """Discounted sum of ``arr`` along its first axis."""
    if arr.ndim == 0:
        raise ValueError("arr must have at least one dimension")
    if gamma == 1.0:
        return arr.sum(axis=0)
    discounts = gamma ** np.arange(arr.shape[0])
    if arr.ndim == 1:
        return float(discounts @ arr)
    return np.tensordot(discounts, arr, axes=(0, 0))


def discounted_sum_torch(arr: torch.Tensor, gamma: float, axis: int = 0) -> torch.Tensor:
    """Discounted sum of ``arr`` along ``axis`` on its own device (the JAX
    package's ``discounted_sum_jax``): the discounts ``gamma ** t`` are
    powers in ``arr``'s dtype."""
    n = arr.shape[axis]
    discounts = torch.pow(torch.tensor(gamma, dtype=arr.dtype, device=arr.device),
                          torch.arange(n, dtype=arr.dtype, device=arr.device))
    shape = [1] * arr.dim()
    shape[axis] = n
    return (arr * discounts.reshape(shape)).sum(dim=axis)
