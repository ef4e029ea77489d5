"""Behavioral Cloning: supervised policy learning on (obs, act) pairs.

Port of ``imitation_tpu/algorithms/bc.py``. The loss is

    L = -E[log pi(a|s)] - ent_weight * H(pi(.|s)) + l2_weight * ||theta||

where ``||theta||`` is the norm (not its square) of every parameter of the
policy (``log_std`` included, the feature normalizer's buffers not).
Demonstrations (trajectories, a ``TrajectoryDatasetSequence`` of the
HuggingFace format, transitions; array or ``DictObs`` observations) live on
the device as one ``TransitionBatch``; an epoch's
shuffled index matrix is drawn there too, and each minibatch is a gather of
its rows. Where the JAX package scans an epoch inside one program, the port
runs one eager step per minibatch, keeps each step's metrics on the device
and reads the epoch's stacked metrics to the host once. With
``minibatch_size < batch_size`` the microbatch gradients are summed, then
divided by their number before the optimizer step (optax Adam, no
clipping), and the metrics are averaged the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from imitation_tpu_torch import Device, default_device, make_generator
from imitation_tpu_torch.algorithms import base
from imitation_tpu_torch.data import rollout as rollout_mod
from imitation_tpu_torch.data import types
from imitation_tpu_torch.envs.base import Space
from imitation_tpu_torch.envs.vector import VectorEnv
from imitation_tpu_torch.models.policies import ActorCriticPolicy, FeedForward32Policy
from imitation_tpu_torch.policies import serialize as policy_serialize
from imitation_tpu_torch.rl import common as rl_common
from imitation_tpu_torch.util.logger import HierarchicalLogger


@dataclasses.dataclass
class BCTrainingMetrics:
    """BC's per-batch metrics (tensors, or numpy arrays once on the host)."""

    neglogp: Any
    entropy: Any
    ent_loss: Any
    prob_true_act: Any
    l2_norm: Any
    l2_loss: Any
    loss: Any


METRIC_NAMES = tuple(f.name for f in dataclasses.fields(BCTrainingMetrics))


def loss_calculator(
    policy: ActorCriticPolicy,
    ent_weight: float,
    l2_weight: float,
) -> Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """The BC loss: ``(obs, acts) -> (loss, metrics)``, where ``metrics`` is
    the ``[7]`` stack of the ``BCTrainingMetrics`` fields, detached."""

    def loss_fn(obs: types.ObsTensor, acts: torch.Tensor):
        dist = policy.distribution(obs)
        if not policy.action_space.is_discrete:
            acts = acts.reshape(acts.shape[0], -1)
        log_prob = dist.log_prob(acts)
        prob_true_act = torch.exp(log_prob).mean()
        neglogp = -log_prob.mean()
        ent = dist.entropy().mean()
        ent_loss = -ent_weight * ent
        # One norm over all parameters flattened together: two launches, not
        # two per parameter. With l2_weight 0 it is only a metric, so no
        # graph is built.
        with torch.set_grad_enabled(l2_weight != 0 and torch.is_grad_enabled()):
            l2_norm = torch.linalg.vector_norm(torch.cat([p.reshape(-1) for p in policy.parameters()]))
        l2_loss = l2_weight * l2_norm
        loss = neglogp + ent_loss + l2_loss
        with torch.no_grad():
            metrics = torch.stack([neglogp, ent, ent_loss, prob_true_act, l2_norm, l2_loss, loss])
        return loss, metrics

    return loss_fn


class BC(base.DemonstrationAlgorithm):
    """Behavioral cloning on the device (CUDA unless ``device="cpu"``)."""

    def __init__(
        self,
        *,
        observation_space: Space,
        action_space: Space,
        rng: Optional[Union[int, np.random.Generator]] = None,
        demonstrations: Optional[base.AnyDemonstrations] = None,
        policy: Optional[ActorCriticPolicy] = None,
        batch_size: int = 32,
        minibatch_size: Optional[int] = None,
        optimizer_kwargs: Optional[Mapping[str, Any]] = None,
        ent_weight: float = 1e-3,
        l2_weight: float = 0.0,
        custom_logger: Optional[HierarchicalLogger] = None,
        allow_variable_horizon: bool = False,
        device: Optional[Device] = None,
    ):
        self.device = default_device(device)
        self.observation_space = observation_space
        self.action_space = action_space
        self.batch_size = batch_size
        self.minibatch_size = minibatch_size or batch_size
        if self.batch_size % self.minibatch_size != 0:
            raise ValueError("batch_size must be a multiple of minibatch_size.")
        self._demo_store: Optional[base.DemonstrationStore] = None
        super().__init__(
            demonstrations=demonstrations,
            custom_logger=custom_logger,
            allow_variable_horizon=allow_variable_horizon,
        )
        self._policy = (policy or FeedForward32Policy(observation_space, action_space)).to(self.device)
        optimizer_kwargs = dict(optimizer_kwargs or {})
        lr = optimizer_kwargs.pop("lr", optimizer_kwargs.pop("learning_rate", 1e-3))
        self._optimizer_kwargs = dict(optimizer_kwargs, lr=lr)
        self.ent_weight = ent_weight
        self.l2_weight = l2_weight
        self.loss_fn = loss_calculator(self._policy, ent_weight, l2_weight)

        seed = 0 if rng is None else (
            int(rng.integers(0, 2**31 - 1)) if isinstance(rng, np.random.Generator) else int(rng)
        )
        # One generator draws the initial weights and every epoch's shuffle.
        self._generator = make_generator(seed, self.device)
        self._policy.init(self._generator)
        self.optimizer = rl_common.make_optimizer(self._policy.parameters(), lr, **optimizer_kwargs)
        self.num_samples_so_far = 0
        self.num_batches = 0
        self.host_reads = 0  # reads of training metrics to the host, one per epoch

    # -- demonstrations ----------------------------------------------------
    def set_demonstrations(self, demonstrations: base.AnyDemonstrations) -> None:
        self._demo_store = base.DemonstrationStore.from_demonstrations(demonstrations, self.device)

    @property
    def policy(self) -> ActorCriticPolicy:
        return self._policy

    # -- training ----------------------------------------------------------
    def _run_batches(self, idx: torch.Tensor) -> BCTrainingMetrics:
        """One optimizer step per row of ``idx`` (``[n, batch_size]`` demo
        rows); returns the ``n`` steps' metrics, read to the host once."""
        batch = self._demo_store.batch
        n_micro = self.batch_size // self.minibatch_size
        params = list(self._policy.parameters())
        rows = []
        for row in idx:
            self.optimizer.zero_grad()
            if n_micro == 1:
                loss, metrics = self.loss_fn(types.map_obs(lambda x: x[row], batch.obs), batch.acts[row])
                loss.backward()
            else:
                summed = []
                for micro in row.split(self.minibatch_size):
                    loss, m = self.loss_fn(types.map_obs(lambda x: x[micro], batch.obs), batch.acts[micro])
                    loss.backward()  # gradients add up in .grad
                    summed.append(m)
                with torch.no_grad():
                    torch._foreach_div_([p.grad for p in params if p.grad is not None], n_micro)
                    metrics = torch.stack(summed).sum(dim=0) / n_micro
            self.optimizer.step()
            rows.append(metrics)
        host = torch.stack(rows).cpu().numpy()  # [n, 7]: the epoch's one host read
        self.host_reads += 1
        return BCTrainingMetrics(*host.T)

    def train(
        self,
        *,
        n_epochs: Optional[int] = None,
        n_batches: Optional[int] = None,
        on_epoch_end: Optional[Callable[[], None]] = None,
        on_batch_end: Optional[Callable[[], None]] = None,
        log_interval: int = 500,
        log_rollouts_venv: Optional[VectorEnv] = None,
        log_rollouts_n_episodes: int = 5,
        progress_bar: bool = False,
        reset_tensorboard: bool = False,
    ) -> None:
        """Trains for exactly one of ``n_epochs`` or ``n_batches``; a batch
        budget cuts the last epoch short.

        Every ``log_interval`` batches the metrics of the window's last batch
        are logged under ``bc/``, with the mean return of
        ``log_rollouts_n_episodes`` episodes on ``log_rollouts_venv`` if it
        is given. ``progress_bar`` and ``reset_tensorboard`` are accepted
        and ignored, as in the JAX package.
        """
        if self._demo_store is None:
            raise ValueError("No demonstrations provided.")
        if (n_epochs is not None) == (n_batches is not None):
            raise ValueError("Must provide exactly one of `n_epochs` and `n_batches`.")
        if self._policy.normalize_features:
            # Fold the whole demo set into the feature normalizer once per
            # call, so a tanh torso does not saturate on wide-range obs.
            self._policy.net.update_feature_stats(self._demo_store.batch.obs)
        if self._demo_store.num_samples // self.batch_size == 0:
            raise ValueError("Not enough demonstrations for one batch.")
        batches_left, epochs_left = n_batches, n_epochs
        logged_batches = 0

        while (epochs_left is None or epochs_left > 0) and (
            batches_left is None or batches_left > 0
        ):
            idx = self._demo_store.epoch_indices(self._generator, self.batch_size)
            if batches_left is not None and idx.shape[0] > batches_left:
                idx = idx[:batches_left]
            n_call = int(idx.shape[0])
            metrics = self._run_batches(idx)
            self.num_batches += n_call
            self.num_samples_so_far += n_call * self.batch_size
            total_batches = self.num_batches
            # Log per log_interval batches: the last batch in the window.
            while logged_batches + log_interval <= total_batches:
                logged_batches += log_interval
                i = max(0, min(logged_batches - (total_batches - n_call) - 1, n_call - 1))
                with self.logger.accumulate_means("bc"):
                    for name in METRIC_NAMES:
                        self.logger.record(name, float(getattr(metrics, name)[i]))
                    self.logger.record("samples_so_far", self.num_samples_so_far)
                    self.logger.record("batch", logged_batches)
                if log_rollouts_venv is not None and log_rollouts_n_episodes > 0:
                    trajs = rollout_mod.generate_trajectories(
                        self._policy.sample_fn(),
                        log_rollouts_venv,
                        rollout_mod.make_min_episodes(log_rollouts_n_episodes),
                        rng=logged_batches,
                    )
                    stats = rollout_mod.rollout_stats(trajs)
                    with self.logger.accumulate_means("bc"):
                        self.logger.record("rollout/return_mean", stats["return_mean"])
                self.logger.dump(step=total_batches)
            if on_batch_end is not None:
                for _ in range(n_call):
                    on_batch_end()
            if epochs_left is not None:
                epochs_left -= 1
            if batches_left is not None:
                batches_left -= n_call
            if on_epoch_end is not None:
                on_epoch_end()

    # -- persistence -------------------------------------------------------
    def save_policy(self, path: str) -> None:
        policy_serialize.save_policy(path, self._policy)

    def state_dict(self) -> Dict[str, Any]:
        """Everything needed to continue training identically: the config,
        the policy's architecture and weights, the optimizer's moments and
        count, the generator's state and the counters."""
        return {
            "config": dict(
                batch_size=self.batch_size,
                minibatch_size=self.minibatch_size,
                optimizer_kwargs=dict(self._optimizer_kwargs),
                ent_weight=self.ent_weight,
                l2_weight=self.l2_weight,
                allow_variable_horizon=self.allow_variable_horizon,
            ),
            "policy_config": policy_serialize.policy_config(self._policy),
            "policy": {k: v.detach().cpu() for k, v in self._policy.state_dict().items()},
            "optimizer": self.optimizer.state_dict(),
            "generator": self._generator.get_state(),
            "num_batches": self.num_batches,
            "num_samples_so_far": self.num_samples_so_far,
        }

    @classmethod
    def from_state_dict(
        cls,
        state: Mapping[str, Any],
        device: Optional[Device] = None,
        custom_logger: Optional[HierarchicalLogger] = None,
    ) -> "BC":
        """A BC trainer, without demonstrations, in the state ``state_dict``
        gave."""
        policy = policy_serialize.policy_from_config(state["policy_config"])
        bc = cls(
            observation_space=policy.observation_space,
            action_space=policy.action_space,
            policy=policy,
            custom_logger=custom_logger,
            device=device,
            **state["config"],
        )
        bc._policy.load_state_dict(state["policy"])
        bc.optimizer.load_state_dict(state["optimizer"])
        bc._generator.set_state(state["generator"])
        bc.num_batches = state["num_batches"]
        bc.num_samples_so_far = state["num_samples_so_far"]
        return bc


def reconstruct_policy(policy_path: str, device: Optional[Device] = None) -> ActorCriticPolicy:
    """A policy ``BC.save_policy`` saved, on ``device``."""
    return policy_serialize.load_policy_from_path(policy_path, device=device)
