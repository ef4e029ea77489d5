"""Preference comparisons (DRLHP-style RLHF): learn a reward from
preferences between trajectory fragments, and train an agent on it.

Port of ``imitation_tpu/algorithms/preference_comparisons.py`` for device
envs and array observations:

* Trajectory sources: ``TrajectoryDataset`` (static trajectories),
  ``AgentTrainer`` (a PPO generator trained on the learned reward, whose
  true-reward rollout chunks are cut into episodes and buffered for queries,
  topped up, with an exploration share from ``ExplorationWrapper``) and
  ``SACAgentTrainer`` (PEBBLE: a SAC generator whose replay batches are
  relabelled by the live reward).
* ``FragmentBatch``: fragment pairs as ``[N, 2, L(+1)]`` tensors, so a
  fragment-reward evaluation is one reward-net forward over every step of
  every pair; ``PreferenceModel``: Boltzmann preference probabilities from
  (discounted) return differences, clipped at ``threshold``, mixed with
  ``noise_prob``; an ensemble's per-member rewards in one batched forward.
* ``RandomFragmenter``, ``ActiveSelectionFragmenter`` (the pairs of highest
  ensemble variance on logit, probability or label), ``SyntheticGatherer``
  (ground-truth preferences, sampled or soft), ``PreferenceDataset`` (FIFO).
* ``CrossEntropyRewardLoss``, ``BasicRewardTrainer`` (AdamW epochs,
  gradient accumulation over minibatches, a regularizer with a train/val
  split) and ``EnsembleTrainer`` (each member bags its own resample).
* ``PreferenceComparisons``: the loop of sample, fragment, gather, train
  the reward, train the agent, each stage in a ``record_function`` range
  (``pc.sample``, ``pc.fragment``, ``pc.gather``, ``pc.reward_train``,
  ``pc.agent_train``).

One reward-net module is shared by every part: the reward trainer's
optimizer updates its parameters, and the generators relabel with it (under
``no_grad``, statistics frozen) and fold their relabelled batches into its
output normalizer after each step, as the JAX package does. Every host-side
draw (fragments, preferences, permutations, bagging, rollout seeds) comes
from a numpy ``Generator`` in the JAX package's order, so with the same seed
the port picks the same fragments and preferences.
"""

from __future__ import annotations

import abc
import dataclasses
import math
import pickle
from collections import deque
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from imitation_tpu_torch import Device, default_device, make_generator
from imitation_tpu_torch.algorithms import base
from imitation_tpu_torch.data import rollout as rollout_mod
from imitation_tpu_torch.data import types
from imitation_tpu_torch.envs.vector import VectorEnv
from imitation_tpu_torch.parallel import distributed
from imitation_tpu_torch.policies.exploration_wrapper import ExplorationWrapper
from imitation_tpu_torch.rewards.reward_nets import NormalizedRewardNet, RewardEnsemble, RewardNet
from imitation_tpu_torch.rl import common as rl_common
from imitation_tpu_torch.rl.ppo import PPO
from imitation_tpu_torch.rl.sac import SAC
from imitation_tpu_torch.util import util
from imitation_tpu_torch.util.logger import HierarchicalLogger, configure

TrajectoryWithRewPair = Tuple[types.TrajectoryWithRew, types.TrajectoryWithRew]

# Chunk length of the exploration rollouts.
_EXPLORE_CHUNK = 128


def _as_rng(rng: Union[int, np.random.Generator]) -> np.random.Generator:
    return rng if isinstance(rng, np.random.Generator) else np.random.default_rng(rng)


def _module_device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


# ---------------------------------------------------------------------------
# Trajectory generation
# ---------------------------------------------------------------------------


class TrajectoryGenerator(abc.ABC):
    """A source of trajectories, with optional training logic."""

    def __init__(self, custom_logger: Optional[HierarchicalLogger] = None):
        self._logger = custom_logger or configure()

    @abc.abstractmethod
    def sample(self, steps: int) -> Sequence[types.TrajectoryWithRew]:
        """At least ``steps`` transitions of trajectories."""

    def train(self, steps: int, **kwargs: Any) -> None:
        """Trains the agent, where the generator has one (default no-op)."""

    @property
    def logger(self) -> HierarchicalLogger:
        return self._logger

    @logger.setter
    def logger(self, value: HierarchicalLogger) -> None:
        self._logger = value


class TrajectoryDataset(TrajectoryGenerator):
    """A static set of trajectories, served shuffled."""

    def __init__(
        self,
        trajectories: Sequence[types.TrajectoryWithRew],
        rng: Union[int, np.random.Generator] = 0,
        custom_logger: Optional[HierarchicalLogger] = None,
    ):
        super().__init__(custom_logger=custom_logger)
        self._trajectories = list(trajectories)
        self.rng = _as_rng(rng)

    def sample(self, steps: int) -> Sequence[types.TrajectoryWithRew]:
        trajectories = list(self._trajectories)
        self.rng.shuffle(trajectories)  # type: ignore[arg-type]
        return _get_trajectories(trajectories, steps)


def _get_trajectories(
    trajectories: Sequence[types.TrajectoryWithRew], steps: int
) -> Sequence[types.TrajectoryWithRew]:
    """The shortest prefix of ``trajectories`` that covers ``steps`` transitions."""
    if steps == 0:
        return []
    available_steps = sum(len(traj) for traj in trajectories)
    if available_steps < steps:
        raise RuntimeError(f"Asked for {steps} transitions but only {available_steps} available")
    steps_cumsum = np.cumsum([len(traj) for traj in trajectories])
    idx = int((steps_cumsum >= steps).argmax())
    return trajectories[: idx + 1]


def _make_relabel_fn(reward_net: RewardNet, relabel_alpha: Optional[float]) -> rl_common.RelabelRewardFn:
    """``(reward net, s, a, s', d) -> rewards``: the generator's training
    reward, ``predict_processed`` with statistics frozen, or with
    ``relabel_alpha`` an ensemble's mean + alpha * std (risk-sensitive
    RLHF). The generators fold statistics after their step."""
    if relabel_alpha is not None:
        if not hasattr(reward_net, "predict_reward_moments"):
            raise TypeError("relabel_alpha requires an ensemble reward net (predict_reward_moments)")

        def relabel_fn(net, obs, acts, next_obs, dones):
            mean, var = net.predict_reward_moments(obs, acts, next_obs, dones)
            return mean + relabel_alpha * torch.sqrt(var)

        return relabel_fn

    def relabel_fn(net, obs, acts, next_obs, dones):
        return net.predict_processed(obs, acts, next_obs, dones, update_stats=False)

    return relabel_fn


def _has_output_norm(reward_net: RewardNet) -> bool:
    """Whether relabelling should fold statistics into ``reward_net``."""
    return isinstance(reward_net, NormalizedRewardNet) or (
        isinstance(reward_net, RewardEnsemble) and reward_net.member_normalize_cls is not None
    )


def _explore(explorer: ExplorationWrapper, venv: VectorEnv, steps: int, seed: int) -> List[types.TrajectoryWithRew]:
    """Complete episodes of the exploration mixture covering ``steps``
    transitions, from fresh envs and a generator seeded with ``seed``. On a
    host env the mixture runs as ``host_policy_fn`` through the host
    rollout path."""
    if getattr(venv, "is_host", False):
        return list(rollout_mod.generate_trajectories(
            explorer.host_policy_fn(), venv, rollout_mod.make_min_timesteps(steps), rng=seed))
    generator = make_generator(seed, venv.device)
    env_state = venv.reset(generator)
    mode = explorer.initial_mode(generator)
    accum = rollout_mod.TrajectoryAccumulator(venv.num_envs)
    collected: List[types.TrajectoryWithRew] = []
    while sum(len(t) for t in collected) < steps:
        env_state, mode, chunk = explorer.collect(env_state, mode, _EXPLORE_CHUNK, generator)
        collected.extend(accum.add_chunk(chunk))
    return collected


class AgentTrainer(TrajectoryGenerator):
    """A PPO generator trained on the learned reward.

    ``train(steps)`` runs PPO iterations whose chunks are relabelled by the
    reward net; each iteration's true-reward chunk is cut into episodes and
    buffered, and its relabelled rows are folded into an output normalizer
    afterwards. ``sample`` serves buffered episodes, tops them up with fresh
    rollouts as needed, and adds an ``exploration_frac`` share from the
    policy/random mixture.
    """

    def __init__(
        self,
        algorithm: PPO,
        reward_net: RewardNet,
        venv: VectorEnv,
        rng: Union[int, np.random.Generator] = 0,
        exploration_frac: float = 0.0,
        switch_prob: float = 0.5,
        random_prob: float = 0.5,
        relabel_alpha: Optional[float] = None,
        custom_logger: Optional[HierarchicalLogger] = None,
    ):
        super().__init__(custom_logger=custom_logger)
        self.algorithm = algorithm
        self.venv = venv
        self.device = venv.device
        self.reward_net = reward_net.to(self.device)
        self.exploration_frac = exploration_frac
        self.rng = _as_rng(rng)
        algorithm.reward_fn = _make_relabel_fn(reward_net, relabel_alpha)
        algorithm.return_transitions = True
        self.state = algorithm.init_state()
        self._accum = rollout_mod.TrajectoryAccumulator(venv.num_envs)
        self._buffered: List[types.TrajectoryWithRew] = []
        self._explorer = ExplorationWrapper(
            algorithm.policy.sample_fn(), venv, random_prob=random_prob, switch_prob=switch_prob
        )

    def train(self, steps: int, **kwargs: Any) -> None:
        """``ceil(steps / (n_steps * num_envs))`` PPO iterations (at least one)
        on the current reward; the last one's metrics are logged."""
        steps_per_iter = self.algorithm.config.n_steps * self.venv.num_envs
        for _ in range(max(1, int(math.ceil(steps / steps_per_iter)))):
            self.state, metrics, chunk = self.algorithm.train_step(self.state, self.reward_net)
            self._fold_reward_stats(chunk)
            self._buffered.extend(self._accum.add_chunk(chunk))
        for k, v in rl_common.metrics_to_host(metrics).items():
            self.logger.record(k, float(v))

    @torch.no_grad()
    def _fold_reward_stats(self, chunk: rollout_mod.RolloutChunk) -> None:
        """Folds the chunk's T * B relabelled rows into the output normalizer."""
        if not _has_output_norm(self.reward_net):
            return
        T, B = chunk.acts.shape[0], chunk.acts.shape[1]

        def flat(x):
            return x.reshape((T * B,) + tuple(x.shape[2:]))

        self.reward_net.predict_processed(
            flat(chunk.obs), flat(chunk.acts), flat(chunk.next_obs), flat(chunk.dones.float()),
            update_stats=True,
        )

    def sample(self, steps: int) -> Sequence[types.TrajectoryWithRew]:
        avail = sum(len(t) for t in self._buffered)
        agent_steps = int(steps * (1 - self.exploration_frac))
        exploration_steps = steps - agent_steps
        while avail < agent_steps:
            extra = rollout_mod.generate_trajectories(
                self.algorithm.policy.sample_fn(),
                self.venv,
                rollout_mod.make_min_timesteps(agent_steps - avail),
                rng=int(self.rng.integers(0, 2**31 - 1)),
            )
            self._buffered.extend(extra)
            avail = sum(len(t) for t in self._buffered)
        self.rng.shuffle(self._buffered)  # type: ignore[arg-type]
        out = list(_get_trajectories(self._buffered, agent_steps)) if agent_steps else []
        self._buffered = self._buffered[len(out):]
        if exploration_steps > 0:
            out.extend(_explore(self._explorer, self.venv, exploration_steps,
                                int(self.rng.integers(0, 2**31 - 1))))
        return out

    @property
    def policy(self):
        return self.algorithm.policy


class SACAgentTrainer(TrajectoryGenerator):
    """A SAC generator (PEBBLE): every replay batch it samples is relabelled
    by the current reward net, so old transitions follow the reward as it
    trains. After ``train`` one replay sample of ``batch_size`` rows is
    folded into an output normalizer, once the buffer holds that many."""

    def __init__(
        self,
        algorithm: SAC,
        reward_net: RewardNet,
        venv: VectorEnv,
        rng: Union[int, np.random.Generator] = 0,
        exploration_frac: float = 0.0,
        relabel_alpha: Optional[float] = None,
        custom_logger: Optional[HierarchicalLogger] = None,
    ):
        super().__init__(custom_logger=custom_logger)
        self.algorithm = algorithm
        self.venv = venv
        self.device = venv.device
        self.reward_net = reward_net.to(self.device)
        self.exploration_frac = exploration_frac
        self.rng = _as_rng(rng)
        point_fn = _make_relabel_fn(reward_net, relabel_alpha)

        def relabel_fn(net, batch: types.TransitionBatch) -> types.TransitionBatch:
            return dataclasses.replace(batch, rews=point_fn(net, batch.obs, batch.acts, batch.next_obs, batch.dones))

        algorithm.relabel_fn = relabel_fn
        self.state = algorithm.init_state()
        self._explorer = ExplorationWrapper(algorithm.policy.sample_fn(), venv)

    def train(self, steps: int, **kwargs: Any) -> None:
        self.state = self.algorithm.learn(self.state, steps, reward_params=self.reward_net)
        self._fold_reward_stats()

    @torch.no_grad()
    def _fold_reward_stats(self) -> None:
        """Folds one replay sample of the learner's batch size into the
        output normalizer; skipped until the buffer holds that many rows (a
        with-replacement sample of a near-empty buffer would overweight its
        few rows). It reads ``self.state``'s buffer, the newest: the port's
        ring is written in place, so an older state would see newer rows."""
        if not _has_output_norm(self.reward_net):
            return
        n_fold = int(self.algorithm.config.batch_size)
        if self.state.buffer_state.size < n_fold:
            return
        generator = make_generator(int(self.rng.integers(0, 2**31 - 1)), self.device)
        batch = self.algorithm.replay.sample(self.state.buffer_state, n_fold, generator)
        self.reward_net.predict_processed(batch.obs, batch.acts, batch.next_obs, batch.dones, update_stats=True)

    def sample(self, steps: int) -> Sequence[types.TrajectoryWithRew]:
        agent_steps = int(steps * (1 - self.exploration_frac))
        out: List[types.TrajectoryWithRew] = []
        if agent_steps > 0:
            out.extend(rollout_mod.generate_trajectories(
                self.algorithm.policy.sample_fn(),
                self.venv,
                rollout_mod.make_min_timesteps(agent_steps),
                rng=int(self.rng.integers(0, 2**31 - 1)),
            ))
        exploration_steps = steps - agent_steps
        if exploration_steps > 0:
            out.extend(_explore(self._explorer, self.venv, exploration_steps,
                                int(self.rng.integers(0, 2**31 - 1))))
        return out

    @property
    def policy(self):
        return self.algorithm.policy


# ---------------------------------------------------------------------------
# Fragment batches and the preference model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FragmentBatch:
    """Fragment pairs on one device: ``obs[n, j, t]`` for pair n, side j in
    {0, 1} and step t in [0, L]; actions, ground-truth rewards and done
    flags over t in [0, L); ``prefs[n]`` is the probability that the first
    fragment is preferred. A member-bagged batch has a leading member axis
    on every field."""

    obs: torch.Tensor  # [N, 2, L+1, ...]
    acts: torch.Tensor  # [N, 2, L, ...]
    rews_gt: torch.Tensor  # [N, 2, L]
    dones: torch.Tensor  # [N, 2, L]
    prefs: torch.Tensor  # [N]

    @property
    def num_pairs(self) -> int:
        return self.prefs.shape[-1]

    @property
    def fragment_length(self) -> int:
        return self.rews_gt.shape[-1]

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "FragmentBatch":
        return FragmentBatch(**{f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)})

    @classmethod
    def from_pairs(cls, pairs: Sequence[TrajectoryWithRewPair], prefs: np.ndarray, device: Device) -> "FragmentBatch":
        """Stacks the pairs on the host, then copies each field to ``device``
        once."""
        L = len(pairs[0][0])
        for f1, f2 in pairs:
            if len(f1) != L or len(f2) != L:
                raise ValueError("all fragments must have equal length")
        dones = np.zeros((len(pairs), 2, L), np.float32)
        for n, pair in enumerate(pairs):
            for j, f in enumerate(pair):
                if f.terminal:
                    dones[n, j, -1] = 1.0
        host = dict(
            obs=np.stack([[np.asarray(f.obs) for f in pair] for pair in pairs]),
            acts=np.stack([[np.asarray(f.acts) for f in pair] for pair in pairs]),
            rews_gt=np.stack([[np.asarray(f.rews) for f in pair] for pair in pairs]).astype(np.float32),
            dones=dones,
            prefs=np.asarray(prefs, np.float32),
        )
        return cls(**{k: torch.from_numpy(v).to(device) for k, v in host.items()})


def _flat_steps(batch: FragmentBatch, lead: int):
    """``(obs, acts, next_obs, dones)`` of every step of the pairs, each
    flattened to ``[*lead_axes, N*2*L, ...]``, where ``lead`` axes (the
    member axis of a bagged batch) come first; and L."""
    ax = lead + 2  # the step axis
    L = batch.acts.shape[ax]
    head = tuple(batch.obs.shape[:lead]) + (-1,)

    def flat(x):
        return x.reshape(head + tuple(x.shape[ax + 1:]))

    obs = batch.obs
    return (flat(obs.narrow(ax, 0, L)), flat(batch.acts), flat(obs.narrow(ax, 1, L)),
            batch.dones.reshape(head)), L


@dataclasses.dataclass
class PreferenceModel:
    """Boltzmann preference probabilities from a reward net."""

    model: RewardNet
    noise_prob: float = 0.0
    discount_factor: float = 1.0
    threshold: float = 50.0

    def __post_init__(self):
        self.is_ensemble = isinstance(self.model, RewardEnsemble)

    def fragment_rewards(self, batch: FragmentBatch) -> torch.Tensor:
        """The training forward's reward for every step: ``[(M,) N, 2, L]``."""
        N = batch.num_pairs
        args, L = _flat_steps(batch, 0)
        rews = self.model(*args)
        return rews.reshape(rews.shape[:-1] + (N, 2, L))

    def member_fragment_rewards(self, batch: FragmentBatch) -> torch.Tensor:
        """Member m's rewards on member m's pairs of a bagged batch (a
        leading member axis on every field), in one batched forward over the
        members: ``[M, N, 2, L]``."""
        if not self.is_ensemble:
            raise TypeError("member_fragment_rewards requires a RewardEnsemble.")
        M, N = batch.prefs.shape
        args, L = _flat_steps(batch, 1)
        return self.model(*args).reshape(M, N, 2, L)

    def probability_from_rewards(self, rews: torch.Tensor) -> torch.Tensor:
        """``[(M,) N]`` probability that the first fragment is preferred."""
        L = rews.shape[-1]
        if self.discount_factor == 1.0:
            returns = rews.sum(dim=-1)
        else:
            discounts = torch.pow(
                torch.tensor(self.discount_factor, dtype=rews.dtype, device=rews.device),
                torch.arange(L, dtype=rews.dtype, device=rews.device),
            )
            returns = (rews * discounts).sum(dim=-1)
        returns_diff = torch.clamp(returns[..., 1] - returns[..., 0], -self.threshold, self.threshold)
        model_probability = 1.0 / (1.0 + torch.exp(returns_diff))
        return self.noise_prob * 0.5 + (1 - self.noise_prob) * model_probability

    def __call__(self, batch: FragmentBatch) -> torch.Tensor:
        return self.probability_from_rewards(self.fragment_rewards(batch))


# ---------------------------------------------------------------------------
# Fragmenters
# ---------------------------------------------------------------------------


class Fragmenter(abc.ABC):
    """Makes fragment pairs from trajectories."""

    def __init__(self, custom_logger: Optional[HierarchicalLogger] = None):
        self.logger = custom_logger or configure()

    @abc.abstractmethod
    def __call__(
        self, trajectories: Sequence[types.TrajectoryWithRew], fragment_length: int, num_pairs: int
    ) -> Sequence[TrajectoryWithRewPair]:
        ...


class RandomFragmenter(Fragmenter):
    """Uniform random fragments: a trajectory chosen with probability
    proportional to its length, a uniform start, with replacement; the
    fragments are paired in order."""

    def __init__(
        self,
        rng: Union[int, np.random.Generator] = 0,
        warning_threshold: int = 10,
        custom_logger: Optional[HierarchicalLogger] = None,
    ):
        super().__init__(custom_logger)
        self.rng = _as_rng(rng)
        self.warning_threshold = warning_threshold

    def __call__(self, trajectories, fragment_length, num_pairs):
        fragments: List[types.TrajectoryWithRew] = []
        prev_num_trajectories = len(trajectories)
        trajectories = [t for t in trajectories if len(t) >= fragment_length]
        if len(trajectories) == 0:
            raise ValueError(
                "No trajectories are long enough for the desired fragment length "
                f"of {fragment_length}.",
            )
        num_discarded = prev_num_trajectories - len(trajectories)
        if num_discarded:
            self.logger.info(
                f"Discarded {num_discarded} out of {prev_num_trajectories} "
                "trajectories because they are shorter than the desired length "
                f"of {fragment_length}.",
            )
        weights = [len(t) for t in trajectories]
        num_transitions = 2 * num_pairs * fragment_length
        if sum(weights) < num_transitions:
            self.logger.warn(
                "Fewer transitions available than needed for desired number "
                "of fragment pairs. Some transitions will appear multiple times.",
            )
        elif self.warning_threshold and sum(weights) < self.warning_threshold * num_transitions:
            self.logger.warn(
                f"Samples will contain {num_transitions} transitions in total "
                f"and only {sum(weights)} are available. "
                f"Because we sample with replacement, a significant number "
                "of transitions are likely to appear multiple times.",
            )
        for _ in range(2 * num_pairs):
            traj_idx = self.rng.choice(len(trajectories), p=np.array(weights) / sum(weights))
            traj = trajectories[traj_idx]
            n = len(traj)
            start = self.rng.integers(0, n - fragment_length, endpoint=True)
            end = start + fragment_length
            fragments.append(types.TrajectoryWithRew(
                obs=traj.obs[start:end + 1],
                acts=traj.acts[start:end],
                infos=traj.infos[start:end] if traj.infos is not None else None,
                rews=traj.rews[start:end],
                terminal=bool((end == n) and traj.terminal),
            ))
        iterator = iter(fragments)
        return list(zip(iterator, iterator))


class ActiveSelectionFragmenter(Fragmenter):
    """Oversamples ``fragment_sample_factor`` times the pairs from a base
    fragmenter and keeps those whose preference the ensemble's members
    disagree on most: by the variance over members of the return difference
    (``logit``), of the probability, or of the predicted label."""

    def __init__(
        self,
        preference_model: PreferenceModel,
        base_fragmenter: Fragmenter,
        fragment_sample_factor: float,
        uncertainty_on: str = "logit",
        custom_logger: Optional[HierarchicalLogger] = None,
    ):
        super().__init__(custom_logger)
        if not preference_model.is_ensemble:
            raise ValueError("PreferenceModel not wrapped over an ensemble of networks.")
        self.preference_model = preference_model
        self.base_fragmenter = base_fragmenter
        self.fragment_sample_factor = fragment_sample_factor
        self._uncertainty_on = uncertainty_on
        if uncertainty_on not in ("logit", "probability", "label"):
            self.raise_uncertainty_on_not_supported()

    @property
    def uncertainty_on(self) -> str:
        return self._uncertainty_on

    def raise_uncertainty_on_not_supported(self):
        raise ValueError(
            f"""{self.uncertainty_on} not supported.
            `uncertainty_on` should be from `logit`, `probability`, or `label`""",
        )

    @torch.no_grad()
    def __call__(self, trajectories, fragment_length, num_pairs):
        fragment_pairs = self.base_fragmenter(
            trajectories=trajectories,
            fragment_length=fragment_length,
            num_pairs=int(self.fragment_sample_factor * num_pairs),
        )
        batch = FragmentBatch.from_pairs(
            fragment_pairs, np.zeros(len(fragment_pairs)), _module_device(self.preference_model.model)
        )
        rews = self.preference_model.fragment_rewards(batch)  # [M, N, 2, L]
        if self.uncertainty_on == "logit":
            returns = rews.sum(dim=-1).cpu().numpy()  # [M, N, 2]
            var_estimates = (returns[..., 0] - returns[..., 1]).var(axis=0)
        else:
            probs = self.preference_model.probability_from_rewards(rews).cpu().numpy()  # [M, N]
            if self.uncertainty_on == "probability":
                var_estimates = probs.var(axis=0)
            else:
                prob_estimate = (probs > 0.5).astype(np.float32).mean(axis=0)
                var_estimates = prob_estimate * (1 - prob_estimate)
        fragment_idxs = np.argsort(var_estimates)[::-1]
        return [fragment_pairs[i] for i in fragment_idxs[:num_pairs]]


# ---------------------------------------------------------------------------
# Preference gathering
# ---------------------------------------------------------------------------


class PreferenceGatherer(abc.ABC):
    """Gathers preferences for fragment pairs."""

    def __init__(self, rng: Optional[np.random.Generator] = None,
                 custom_logger: Optional[HierarchicalLogger] = None):
        self.logger = custom_logger or configure()
        self.rng = rng

    @abc.abstractmethod
    def __call__(self, fragment_pairs: Sequence[TrajectoryWithRewPair]) -> np.ndarray:
        ...


def _xlogx(x: np.ndarray) -> np.ndarray:
    """x * log(x), 0 where x is 0 (``scipy.special.xlogy(x, x)``)."""
    positive = x > 0
    return np.where(positive, x * np.log(np.where(positive, x, 1)), 0).astype(x.dtype)


class SyntheticGatherer(PreferenceGatherer):
    """Preferences from the ground-truth returns: Bernoulli draws of the
    Boltzmann probability at ``temperature`` (``sample``), or the
    probabilities themselves; the label entropy is logged."""

    def __init__(
        self,
        temperature: float = 1.0,
        discount_factor: float = 1.0,
        sample: bool = True,
        rng: Optional[Union[int, np.random.Generator]] = None,
        threshold: float = 50.0,
        custom_logger: Optional[HierarchicalLogger] = None,
    ):
        if isinstance(rng, int):
            rng = np.random.default_rng(rng)
        super().__init__(rng=rng, custom_logger=custom_logger)
        self.temperature = temperature
        self.discount_factor = discount_factor
        self.sample = sample
        self.threshold = threshold
        if self.sample and self.rng is None:
            raise ValueError("If `sample` is True, then `rng` must be provided.")

    def __call__(self, fragment_pairs: Sequence[TrajectoryWithRewPair]) -> np.ndarray:
        returns1, returns2 = self._reward_sums(fragment_pairs)
        if self.temperature == 0:
            return (np.sign(returns1 - returns2) + 1) / 2
        returns1 = returns1 / self.temperature
        returns2 = returns2 / self.temperature
        returns_diff = np.clip(returns2 - returns1, -self.threshold, self.threshold)
        model_probs = 1 / (1 + np.exp(returns_diff))
        entropy = -(_xlogx(model_probs) + _xlogx(1 - model_probs)).mean()
        self.logger.record("entropy", float(entropy))
        if self.sample:
            return self.rng.binomial(n=1, p=model_probs).astype(np.float32)
        return model_probs

    def _reward_sums(self, fragment_pairs) -> Tuple[np.ndarray, np.ndarray]:
        rews1, rews2 = zip(*[
            (rollout_mod.discounted_sum(f1.rews, self.discount_factor),
             rollout_mod.discounted_sum(f2.rews, self.discount_factor))
            for f1, f2 in fragment_pairs
        ])
        return np.array(rews1, dtype=np.float32), np.array(rews2, dtype=np.float32)


# ---------------------------------------------------------------------------
# Preference dataset
# ---------------------------------------------------------------------------


class PreferenceDataset:
    """FIFO dataset of (fragment pair, preference), at most ``max_size``."""

    def __init__(self, max_size: Optional[int] = None):
        self.fragments1: deque = deque(maxlen=max_size)
        self.fragments2: deque = deque(maxlen=max_size)
        self.max_size = max_size
        self.preferences: np.ndarray = np.array([])

    def push(self, fragments: Sequence[TrajectoryWithRewPair], preferences: np.ndarray) -> None:
        fragments1, fragments2 = zip(*fragments)
        if preferences.shape != (len(fragments),):
            raise ValueError(
                f"Unexpected preferences shape {preferences.shape}, expected {(len(fragments),)}",
            )
        if preferences.dtype != np.float32:
            raise ValueError("preferences should have dtype float32")
        self.fragments1.extend(fragments1)
        self.fragments2.extend(fragments2)
        self.preferences = np.concatenate((self.preferences, preferences))
        if self.max_size is not None and len(self.preferences) > self.max_size:
            self.preferences = self.preferences[-self.max_size:]
        assert len(self.preferences) == len(self.fragments1)

    def __getitem__(self, key):
        return (self.fragments1[key], self.fragments2[key]), self.preferences[key]

    def __len__(self) -> int:
        assert len(self.fragments1) == len(self.fragments2) == len(self.preferences)
        return len(self.fragments1)

    def save(self, path) -> None:
        with open(path, "wb") as file:
            pickle.dump(self, file)

    @staticmethod
    def load(path) -> "PreferenceDataset":
        """Loads a dataset ``save`` wrote (a pickle: load only files this
        program wrote)."""
        with open(path, "rb") as file:
            return pickle.load(file)

    def as_batch(self, device: Device) -> FragmentBatch:
        return FragmentBatch.from_pairs(list(zip(self.fragments1, self.fragments2)), self.preferences, device)


# ---------------------------------------------------------------------------
# Reward loss and trainers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LossAndMetrics:
    loss: torch.Tensor
    metrics: Dict[str, torch.Tensor]


class RewardLoss(abc.ABC):
    """A loss over a preference batch."""

    @abc.abstractmethod
    def __call__(self, preference_model: PreferenceModel, batch: FragmentBatch) -> LossAndMetrics:
        ...


def _bce(probs: torch.Tensor, prefs: torch.Tensor) -> torch.Tensor:
    probs_c = torch.clamp(probs, 1e-7, 1 - 1e-7)
    return -(prefs * torch.log(probs_c) + (1 - prefs) * torch.log(1 - probs_c))


class CrossEntropyRewardLoss(RewardLoss):
    """BCE between predicted and target preferences (the mean over pairs,
    then over an ensemble's members), with the accuracy and the BCE of the
    ground-truth rewards' preferences (``gt_reward_loss``, the loss floor)."""

    def __call__(self, preference_model: PreferenceModel, batch: FragmentBatch) -> LossAndMetrics:
        probs = preference_model(batch)  # [(M,) N]
        prefs = batch.prefs
        n = prefs.shape[0]

        def mean(x):
            return (x.sum(dim=-1) / n).mean()

        loss = mean(_bce(probs, prefs))
        accuracy = mean(((probs > 0.5) == (prefs > 0.5)).float())
        gt_loss = _bce(preference_model.probability_from_rewards(batch.rews_gt), prefs).sum() / n
        return LossAndMetrics(loss=loss, metrics={"accuracy": accuracy, "gt_reward_loss": gt_loss})


class RewardTrainer(abc.ABC):
    """Trains a reward model on a preference dataset."""

    def __init__(self, preference_model: PreferenceModel, custom_logger: Optional[HierarchicalLogger] = None):
        self.preference_model = preference_model
        self._logger = custom_logger or configure()

    @property
    def logger(self) -> HierarchicalLogger:
        return self._logger

    @logger.setter
    def logger(self, value: HierarchicalLogger) -> None:
        self._logger = value

    def train(self, dataset: PreferenceDataset, epoch_multiplier: float = 1.0) -> Dict[str, float]:
        """Trains; returns the last epoch's metrics (loss, accuracy, ...)."""
        with self.logger.accumulate_means("reward"):
            return self._train(dataset, epoch_multiplier) or {}

    @abc.abstractmethod
    def _train(self, dataset: PreferenceDataset, epoch_multiplier: float) -> Dict[str, float]:
        ...


class BasicRewardTrainer(RewardTrainer):
    """Epochs of AdamW over shuffled batches of ``batch_size`` pairs.

    A batch's gradient is ``(1 / batch_size) * sum_i grad(bce_i)`` over its
    pairs, accumulated over slices of ``minibatch_size`` pairs, so a short
    trailing batch takes a proportionally smaller step; the metrics are
    means over the batch's pairs. A regularizer adds ``lambda_ *
    loss_penalty`` over the reward net's parameters; with a ``val_split``
    its lambda follows the train/val loss ratio after each ``train``.
    """

    def __init__(
        self,
        preference_model: PreferenceModel,
        loss: Optional[RewardLoss] = None,
        rng: Union[int, np.random.Generator] = 0,
        batch_size: int = 32,
        minibatch_size: Optional[int] = None,
        epochs: int = 1,
        lr: float = 1e-3,
        weight_decay: float = 0.0,
        regularizer_factory: Optional[Callable[..., Any]] = None,
        custom_logger: Optional[HierarchicalLogger] = None,
    ):
        super().__init__(preference_model, custom_logger)
        self.loss = loss or CrossEntropyRewardLoss()
        self.batch_size = batch_size
        self.minibatch_size = minibatch_size or batch_size
        if self.batch_size % self.minibatch_size != 0:
            raise ValueError("batch_size must be a multiple of minibatch_size.")
        self.epochs = epochs
        self.optimizer = rl_common.Adam(preference_model.model.parameters(), lr, weight_decay=weight_decay)
        self.rng = _as_rng(rng)
        self.regularizer = (
            regularizer_factory(optimizer=self.optimizer, logger=self.logger)
            if regularizer_factory is not None else None
        )
        # parallel.mesh.shard_preference_comparisons sets this: each update's
        # pairs are split over the data-parallel ranks on their sample axis.
        self.batch_sharding = None

    @property
    def device(self) -> torch.device:
        return _module_device(self.preference_model.model)

    def _lambda(self) -> float:
        return self.regularizer.lambda_ if self.regularizer is not None else 0.0

    def _share(self, sl: FragmentBatch, axis: int) -> Tuple[FragmentBatch, int]:
        """This rank's block of a slice of at most ``minibatch_size`` pairs
        and its pair count. The slice is split as if padded to
        ``minibatch_size`` pairs; a rank whose block is all padding gets one
        real pair with weight 0 (count 0), as the JAX trainer's zero-weight
        padding rows."""
        mesh = self.batch_sharding.mesh
        c = self.minibatch_size // mesh.dp
        k = sl.prefs.shape[-1]
        lo, hi = min(mesh.rank * c, k), min((mesh.rank + 1) * c, k)
        if lo == hi:
            return sl.map(lambda x: x.narrow(axis, 0, 1)), 0
        return sl.map(lambda x: x.narrow(axis, lo, hi - lo)), hi - lo

    def _reduce(self, params: List[torch.Tensor], extra: torch.Tensor) -> None:
        """Sums the gradients and ``extra`` (in place) over the data-parallel ranks."""
        distributed.all_reduce_grads_(params, self.batch_sharding.mesh, [extra], average=False)

    def _update(self, batch: FragmentBatch, lam: float) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` (at most ``batch_size`` pairs);
        on a data-parallel rank the loss of its share, with the gradients
        and metric sums added over the ranks."""
        params = list(self.preference_model.model.parameters())
        self.optimizer.zero_grad()
        n = batch.num_pairs
        sums: Dict[str, torch.Tensor] = {}
        for start in range(0, n, self.minibatch_size):
            sl = batch.map(lambda x: x[start:start + self.minibatch_size])
            k = sl.num_pairs
            if self.batch_sharding is not None:
                sl, k = self._share(sl, 0)
            out = self.loss(self.preference_model, sl)
            (out.loss * k / self.batch_size).backward()
            for name, v in {**out.metrics, "loss": out.loss}.items():
                sums[name] = sums.get(name, 0.0) + v.detach() * k
        if self.batch_sharding is not None:
            names = list(sums)
            stacked = torch.stack([sums[k] for k in names])
            self._reduce(params, stacked)
            sums = dict(zip(names, stacked.unbind(0)))
        if self.regularizer is not None:
            (lam * self.regularizer.loss_penalty(params)).backward()
        self.optimizer.step()
        return {name: v / n for name, v in sums.items()}

    @torch.no_grad()
    def _eval_loss(self, batch: FragmentBatch) -> float:
        return float(self.loss(self.preference_model, batch).loss)

    def _split_dataset(self, dataset: PreferenceDataset) -> Tuple[FragmentBatch, Optional[FragmentBatch]]:
        """The training pairs and, with a regularizer's ``val_split``, the
        validation pairs, as device batches."""
        if self.regularizer is not None and self.regularizer.val_split is not None:
            val_length = int(len(dataset) * self.regularizer.val_split)
            train_length = len(dataset) - val_length
            if val_length < 1 or train_length < 1:
                raise ValueError(
                    "Not enough data samples to split into training and "
                    "validation, or the validation split is too large/small. "
                    "Make sure you've generated enough initial preference data. "
                    "You can adjust this through initial_comparison_frac in "
                    "PreferenceComparisons.",
                )
            perm = self.rng.permutation(len(dataset))
            train_idx, val_idx = perm[:train_length], perm[train_length:]
        else:
            train_idx, val_idx = np.arange(len(dataset)), None
        full = dataset.as_batch(self.device)

        def take(idx):
            index = torch.from_numpy(idx).to(self.device)
            return full.map(lambda x: x[index])

        return take(train_idx), (take(val_idx) if val_idx is not None else None)

    def _finish(self, train_batch: FragmentBatch, val_batch: Optional[FragmentBatch],
                last_metrics: Dict[str, float]) -> Dict[str, float]:
        """The regularizer's lambda update from the train/val losses, and the
        final metrics under ``final/train/``."""
        if self.regularizer is not None and val_batch is not None:
            train_loss = self._eval_loss(train_batch)
            val_loss = self._eval_loss(val_batch)
            self.logger.record("val_loss", val_loss)
            self.regularizer.update_params(train_loss, val_loss)
        for k, v in last_metrics.items():
            self.logger.record(f"final/train/{k}", v)
        return last_metrics

    def _record(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
        host = {k: float(v) for k, v in rl_common.metrics_to_host(metrics).items()}
        for k, v in host.items():
            self.logger.record(k, v)
        return host

    def _train(self, dataset: PreferenceDataset, epoch_multiplier: float = 1.0) -> Dict[str, float]:
        train_batch, val_batch = self._split_dataset(dataset)
        epochs = max(1, int(round(self.epochs * epoch_multiplier)))
        n = train_batch.num_pairs
        bs = min(self.batch_size, n)
        lam = self._lambda()
        last_metrics: Dict[str, float] = {}
        for _ in range(epochs):
            perm = torch.from_numpy(self.rng.permutation(n)).to(self.device)
            for i in range(0, n, bs):
                sel = perm[i:i + bs]
                metrics = self._update(train_batch.map(lambda x: x[sel]), lam)
            last_metrics = self._record(metrics)
        return self._finish(train_batch, val_batch, last_metrics)


class EnsembleTrainer(BasicRewardTrainer):
    """Trains a ``RewardEnsemble``: on each ``train`` call every member
    draws its own with-replacement resample of the training pairs (bagging)
    and runs its epochs on it; all members step together, each on its own
    pairs, through one batched forward. ``lambda_ * sum theta^2`` of a
    regularizer is added inside each slice's loss by its share of the batch;
    the metrics add ``accuracy_std`` and ``loss_std`` over members."""

    def __init__(self, preference_model: PreferenceModel, **kwargs):
        if not preference_model.is_ensemble:
            raise TypeError("PreferenceModel of a RewardEnsemble expected by EnsembleTrainer.")
        super().__init__(preference_model, **kwargs)
        self.num_members = preference_model.model.num_members

    def _update(self, batch: FragmentBatch, lam: float) -> Dict[str, torch.Tensor]:
        """One step on a bagged batch (fields ``[M, b, ...]``); on a
        data-parallel rank the loss of its share of each slice's pairs, with
        the gradients and each slice's per-member sums added over the
        ranks."""
        params = list(self.preference_model.model.parameters())
        self.optimizer.zero_grad()
        b = batch.num_pairs
        sums: Dict[str, torch.Tensor] = {}
        slices = []  # (pairs, per-member BCE sums, per-member correct counts)
        for start in range(0, b, self.minibatch_size):
            sl = batch.map(lambda x: x[:, start:start + self.minibatch_size])
            k = k_all = sl.num_pairs
            if self.batch_sharding is not None:
                sl, k = self._share(sl, 1)
            probs = self.preference_model.probability_from_rewards(
                self.preference_model.member_fragment_rewards(sl))  # [M, k]
            per_member = _bce(probs, sl.prefs).sum(dim=1) / max(k, 1)
            acc_m = ((probs > 0.5) == (sl.prefs > 0.5)).float().sum(dim=1) / max(k, 1)
            total = per_member.mean() * k / self.batch_size
            if lam:
                l2 = sum(torch.sum(torch.square(p)) for p in params)
                total = total + lam * l2 * float(np.float32(k) / np.float32(b))
            total.backward()
            with torch.no_grad():
                if self.batch_sharding is not None:
                    slices.append((k_all, per_member * k, acc_m * k))
                    continue
                metrics = {
                    "accuracy": acc_m.mean(),
                    "accuracy_std": acc_m.std(unbiased=False),
                    "loss": per_member.mean(),
                    "loss_std": per_member.std(unbiased=False),
                }
            for name, v in metrics.items():
                sums[name] = sums.get(name, 0.0) + v * k
        if self.batch_sharding is not None:
            stacked = torch.stack([torch.stack(sl[1:]) for sl in slices])  # [S, 2, M]
            self._reduce(params, stacked)
            with torch.no_grad():
                for (k, _, _), (bce_sum, correct) in zip(slices, stacked.unbind(0)):
                    per_member, acc_m = bce_sum / k, correct / k
                    for name, v in (("accuracy", acc_m.mean()),
                                    ("accuracy_std", acc_m.std(unbiased=False)),
                                    ("loss", per_member.mean()),
                                    ("loss_std", per_member.std(unbiased=False))):
                        sums[name] = sums.get(name, 0.0) + v * k
        self.optimizer.step()
        return {name: v / b for name, v in sums.items()}

    def _train(self, dataset: PreferenceDataset, epoch_multiplier: float = 1.0) -> Dict[str, float]:
        train_batch, val_batch = self._split_dataset(dataset)
        n = train_batch.num_pairs
        M = self.num_members
        bag = self.rng.integers(0, n, size=(M, n))
        epochs = max(1, int(round(self.epochs * epoch_multiplier)))
        bs = min(self.batch_size, n)
        lam = self._lambda()
        rows = np.arange(M)[:, None]
        last_metrics: Dict[str, float] = {}
        for _ in range(epochs):
            perms = np.stack([self.rng.permutation(n) for _ in range(M)])
            order = torch.from_numpy(bag[rows, perms]).to(self.device)  # [M, n]
            for i in range(0, n, bs):
                sel = order[:, i:i + bs]
                metrics = self._update(train_batch.map(lambda x: x[sel]), lam)
            last_metrics = self._record(metrics)
        return self._finish(train_batch, val_batch, last_metrics)


def get_base_model(reward_model: RewardNet) -> RewardNet:
    """The innermost net under wrappers that keep theirs in ``base``."""
    base_model = reward_model
    while getattr(base_model, "base", None) is not None:
        base_model = base_model.base
    return base_model


def _make_reward_trainer(
    preference_model: PreferenceModel,
    loss: Optional[RewardLoss] = None,
    rng: Union[int, np.random.Generator] = 0,
    reward_trainer_kwargs: Optional[Mapping[str, Any]] = None,
) -> RewardTrainer:
    """An ``EnsembleTrainer`` for an ensemble, else a ``BasicRewardTrainer``."""
    kwargs = dict(reward_trainer_kwargs or {})
    if preference_model.is_ensemble:
        return EnsembleTrainer(preference_model, loss=loss, rng=rng, **kwargs)
    return BasicRewardTrainer(preference_model, loss=loss, rng=rng, **kwargs)


QUERY_SCHEDULES: Dict[str, Callable[[float], float]] = {
    "constant": lambda t: 1.0,
    "hyperbolic": lambda t: 1.0 / (1.0 + t),
    "inverse_quadratic": lambda t: 1.0 / (1.0 + t**2),
}


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------


class PreferenceComparisons(base.BaseImitationAlgorithm):
    """The RLHF loop: a reward learned from preferences, an agent trained
    on it.

    The reward model is moved to ``device`` (by default the trajectory
    generator's, else CUDA) and initialised from ``seed``, or loaded from
    the state dict ``reward_variables``.
    """

    def __init__(
        self,
        trajectory_generator: TrajectoryGenerator,
        reward_model: RewardNet,
        num_iterations: int,
        fragmenter: Optional[Fragmenter] = None,
        preference_gatherer: Optional[PreferenceGatherer] = None,
        reward_trainer: Optional[RewardTrainer] = None,
        comparison_queue_size: Optional[int] = None,
        fragment_length: int = 100,
        transition_oversampling: float = 1.0,
        initial_comparison_frac: float = 0.1,
        initial_epoch_multiplier: float = 200.0,
        custom_logger: Optional[HierarchicalLogger] = None,
        allow_variable_horizon: bool = False,
        rng: Union[int, np.random.Generator] = 0,
        query_schedule: Union[str, Callable[[float], float]] = "hyperbolic",
        reward_variables: Optional[Mapping[str, torch.Tensor]] = None,
        seed: int = 0,
        device: Optional[Device] = None,
    ):
        super().__init__(custom_logger=custom_logger, allow_variable_horizon=allow_variable_horizon)
        rng = _as_rng(rng)
        self.rng = rng
        if device is None:
            device = getattr(trajectory_generator, "device", None)
        self.device = default_device(device)
        self.model = reward_model.to(self.device)
        if reward_variables is not None:
            self.model.load_state_dict(reward_variables)
        else:
            self.model.init(make_generator(seed, self.device))
        self.trajectory_generator = trajectory_generator
        self.trajectory_generator.logger = self.logger
        self.fragmenter = fragmenter or RandomFragmenter(rng=rng)
        self.fragmenter.logger = self.logger
        self.preference_gatherer = preference_gatherer or SyntheticGatherer(rng=rng)
        self.preference_gatherer.logger = self.logger
        self.reward_trainer = reward_trainer or _make_reward_trainer(PreferenceModel(reward_model), rng=rng)
        self.reward_trainer.logger = self.logger
        self.num_iterations = num_iterations
        self.fragment_length = fragment_length
        self.transition_oversampling = transition_oversampling
        if not (0 <= initial_comparison_frac <= 1):
            raise ValueError("initial_comparison_frac must lie in [0, 1]")
        self.initial_comparison_frac = initial_comparison_frac
        self.initial_epoch_multiplier = initial_epoch_multiplier
        self.dataset = PreferenceDataset(max_size=comparison_queue_size)
        self._iteration = 0
        if callable(query_schedule):
            self.query_schedule = query_schedule
        elif query_schedule in QUERY_SCHEDULES:
            self.query_schedule = QUERY_SCHEDULES[query_schedule]
        else:
            raise ValueError(f"Unknown query schedule: {query_schedule}")

    def train(
        self,
        total_timesteps: int,
        total_comparisons: int,
        callback: Optional[Callable[[int], None]] = None,
    ) -> Mapping[str, Any]:
        """An initial share of the comparisons, then ``num_iterations``
        iterations by the query schedule; each gathers its comparisons,
        trains the reward (``initial_epoch_multiplier`` times longer on the
        first) and trains the agent for its share of ``total_timesteps``."""
        initial_comparisons = int(total_comparisons * self.initial_comparison_frac)
        total_comparisons -= initial_comparisons
        vec_schedule = np.vectorize(self.query_schedule)
        unnormalized_probs = vec_schedule(np.linspace(0, 1, self.num_iterations))
        probs = unnormalized_probs / np.sum(unnormalized_probs)
        shares = util.oric(probs * total_comparisons)
        schedule = [initial_comparisons] + shares.tolist()
        self.logger.info(f"Query schedule: {schedule}")

        timesteps_per_iteration, extra_timesteps = divmod(total_timesteps, self.num_iterations)
        reward_loss = None
        reward_accuracy = None

        for i, num_pairs in enumerate(schedule):
            num_steps = math.ceil(self.transition_oversampling * 2 * num_pairs * self.fragment_length)
            self.logger.info(f"Collecting {2 * num_pairs} fragments ({num_steps} transitions)")
            with record_function("pc.sample"):
                trajectories = self.trajectory_generator.sample(num_steps)
            self._check_fixed_horizon(len(traj) for traj in trajectories if traj.terminal)
            with record_function("pc.fragment"):
                fragments = self.fragmenter(trajectories, self.fragment_length, num_pairs)
            with record_function("pc.gather"), self.logger.accumulate_means("preferences"):
                preferences = self.preference_gatherer(fragments)
            self.dataset.push(fragments, preferences)
            self.logger.info(f"Dataset now contains {len(self.dataset)} comparisons")

            epoch_multiplier = self.initial_epoch_multiplier if i == 0 else 1.0
            with record_function("pc.reward_train"):
                train_metrics = self.reward_trainer.train(self.dataset, epoch_multiplier=epoch_multiplier)
            reward_loss = train_metrics.get("loss")
            reward_accuracy = train_metrics.get("accuracy")

            num_steps = timesteps_per_iteration
            if i == self.num_iterations - 1:
                num_steps += extra_timesteps
            with record_function("pc.agent_train"), self.logger.accumulate_means("agent"):
                self.logger.info(f"Training agent for {num_steps} timesteps")
                self.trajectory_generator.train(steps=num_steps)

            self.logger.dump(self._iteration)
            if callback:
                callback(self._iteration)
            self._iteration += 1

        return {"reward_loss": reward_loss, "reward_accuracy": reward_accuracy}
