"""Adversarial imitation learning core (the GAIL/AIRL common loop).

Port of ``imitation_tpu/algorithms/adversarial/common.py`` for a PPO or
SAC generator on a device env or a host vector env (``venv.is_host``: the
generator collects on the host, and everything else runs on
``venv.device``). The training loop alternates:

    for each round (total_timesteps // gen_train_timesteps):
        train_gen:  the generator trains on rewards relabelled by the
                    CURRENT reward net; the fresh rollout transitions replace
                    the generator replay buffer's rows
        train_disc x n_disc_updates_per_round:
                    a binary-cross-entropy discriminator step on an equal
                    mix of expert and generator rows

A PPO generator relabels its rollout chunk before GAE. A SAC generator
relabels each batch it samples from its own replay ring (``relabel_fn``), so
old rows always carry the current reward, and returns its fresh transitions
for the trainer's ring; AIRL's log pi(a|s) then comes from
``SAC.log_prob_fn``.

Each discriminator step builds its ``[expert; gen]`` batch with the
hand-written CUDA kernel B2 (``ops.disc_assembly.assemble_fields``), one
launch for all four fields, gathering straight from the demo store and the
replay ring. Parameters are updated in place; metrics stay on the device until
``train`` reads them once per round, or ``train_fused`` once per
``rounds_per_sync`` rounds (device envs only). When the generator has a
``phase_timer``, each round's disc steps are timed as ``disc_update``,
waiting for the device at their end.

Subclass contract (GAIL, AIRL): ``logits_expert_is_high`` maps reward-net
outputs (and, where ``needs_policy_log_prob``, log pi(a|s)) to discriminator
logits where high means "expert"; ``reward_train_fn`` gives the reward the
generator trains on and ``reward_test_fn`` the reward for transfer
evaluation.

The ``record_function`` ranges of a round are named for the algorithm:
``gail.disc_step``, ``airl.disc_step`` and so on.
"""

from __future__ import annotations

import abc
import contextlib
import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from imitation_tpu_torch import make_generator
from imitation_tpu_torch.algorithms import base
from imitation_tpu_torch.data import types
from imitation_tpu_torch.data.buffer import BufferState, ReplayBuffer
from imitation_tpu_torch.data.rollout import chunk_to_transitions
from imitation_tpu_torch.envs.vector import VectorEnv
from imitation_tpu_torch.models.networks import NormLayer
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.ops.disc_assembly import assemble_fields
from imitation_tpu_torch.rewards.reward_nets import RewardNet
from imitation_tpu_torch.rl import common as rl_common
from imitation_tpu_torch.rl.ppo import PPO, PPOConfig
from imitation_tpu_torch.rl.sac import SAC, SACPolicy
from imitation_tpu_torch.util.logger import HierarchicalLogger


def compute_train_stats(
    disc_logits_expert_is_high: torch.Tensor,
    labels_expert_is_one: torch.Tensor,
    disc_loss: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """Discriminator diagnostics (reference common.py:27-92)."""
    bin_is_generated_pred = disc_logits_expert_is_high < 0
    bin_is_generated_true = labels_expert_is_one == 0
    bin_is_expert_true = labels_expert_is_one == 1
    int_is_generated_pred = bin_is_generated_pred.float()
    int_is_generated_true = bin_is_generated_true.float()
    n_labels = labels_expert_is_one.shape[0]
    n_generated = int_is_generated_true.sum()
    n_expert = n_labels - n_generated
    pct_expert = n_expert / n_labels
    correct = (bin_is_generated_pred == bin_is_generated_true).float()
    acc = correct.mean()
    nan = torch.full_like(acc, float("nan"))
    expert_acc = torch.where(
        n_expert > 0,
        (correct * bin_is_expert_true).sum() / torch.clamp(n_expert, min=1),
        nan,
    )
    generated_acc = torch.where(
        n_generated > 0,
        (correct * bin_is_generated_true).sum() / torch.clamp(n_generated, min=1),
        nan,
    )
    pct_expert_pred = 1.0 - int_is_generated_pred.mean()
    # entropy of the Bernoulli implied by each logit
    p = torch.sigmoid(disc_logits_expert_is_high)
    entropy = -(
        p * torch.log(torch.clamp(p, min=1e-12))
        + (1 - p) * torch.log(torch.clamp(1 - p, min=1e-12))
    ).mean()
    return {
        "disc_loss": disc_loss,
        "disc_acc": acc,
        "disc_acc_expert": expert_acc,
        "disc_acc_gen": generated_acc,
        "disc_entropy": entropy,
        "disc_proportion_expert_true": pct_expert,
        "disc_proportion_expert_pred": pct_expert_pred,
    }


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Element-wise BCE on logits, written as ``optax`` writes it."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def _disc_indices(
    n_demo: int, buffer: ReplayBuffer, buffer_state: BufferState, batch_size: int,
    generator: torch.Generator,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert and generator row indices ``[B]`` int32 of one disc step
    (tests substitute the JAX package's)."""
    e_idx = torch.randint(
        0, n_demo, (batch_size,), generator=generator, device=generator.device, dtype=torch.int32
    )
    return e_idx, buffer.sample_indices(buffer_state, batch_size, generator)


@dataclasses.dataclass
class DiscState:
    optimizer: rl_common.Adam  # updates the reward net in place
    generator: torch.Generator  # drives the batch sampling
    step: int = 0


class AdversarialTrainer(base.DemonstrationAlgorithm):
    """Base class for adversarial imitation with a PPO or SAC generator
    (``gen_algo``; a PPO of ``policy`` and ``gen_config`` when it is None)."""

    def __init__(
        self,
        *,
        demonstrations: base.AnyDemonstrations,
        demo_batch_size: int,
        venv: VectorEnv,
        gen_algo: Optional[Union[PPO, SAC]] = None,
        reward_net: RewardNet = None,
        policy: Optional[ActorCriticPolicy] = None,
        gen_config: Optional[PPOConfig] = None,
        demo_minibatch_size: Optional[int] = None,
        n_disc_updates_per_round: int = 2,
        disc_opt_kwargs: Optional[Mapping[str, Any]] = None,
        gen_train_timesteps: Optional[int] = None,
        gen_replay_buffer_capacity: Optional[int] = None,
        custom_logger: Optional[HierarchicalLogger] = None,
        allow_variable_horizon: bool = False,
        seed: int = 0,
    ):
        self.demo_batch_size = demo_batch_size
        self.demo_minibatch_size = demo_minibatch_size or demo_batch_size
        if self.demo_batch_size % self.demo_minibatch_size != 0:
            raise ValueError("demo_batch_size must be divisible by demo_minibatch_size.")
        self.venv = venv
        self.device = venv.device
        self.reward_net = reward_net.to(self.device)
        self.n_disc_updates_per_round = n_disc_updates_per_round
        self._demo_store: Optional[base.DemonstrationStore] = None
        super().__init__(
            demonstrations=demonstrations,
            custom_logger=custom_logger,
            allow_variable_horizon=allow_variable_horizon,
        )

        # Generator: PPO relabels its chunk with the learned reward; an
        # off-policy SAC relabels every batch it samples from its replay.
        if gen_algo is None:
            policy = policy or ActorCriticPolicy(venv.observation_space, venv.action_space)
            gen_algo = PPO(
                venv,
                policy,
                gen_config or PPOConfig(),
                reward_fn=self._reward_train_relabel_fn,
                return_transitions=True,
                seed=seed,
            )
        elif isinstance(gen_algo, SAC):
            def _relabel_batch(reward_params, batch: types.TransitionBatch) -> types.TransitionBatch:
                rews = self._reward_train_relabel_fn(
                    reward_params, batch.obs, batch.acts, batch.next_obs, batch.dones
                )
                return dataclasses.replace(batch, rews=rews)

            gen_algo.relabel_fn = _relabel_batch
            gen_algo.return_transitions = True
        else:
            gen_algo.reward_fn = self._reward_train_relabel_fn
            gen_algo.return_transitions = True
        self.gen_algo = gen_algo

        # One generator round produces n_steps (PPO) or train_freq (SAC)
        # steps of every env.
        cfg = gen_algo.config
        self._gen_steps_per_iter = (getattr(cfg, "n_steps", None) or cfg.train_freq) * venv.num_envs
        if gen_train_timesteps is None:
            gen_train_timesteps = self._gen_steps_per_iter
        self.gen_train_timesteps = gen_train_timesteps
        if gen_replay_buffer_capacity is None:
            gen_replay_buffer_capacity = self.gen_train_timesteps
        self._gen_replay_buffer = ReplayBuffer(gen_replay_buffer_capacity)
        self._gen_buffer_state: Optional[BufferState] = None

        # Discriminator optimizer: Adam, lr 1e-3 by default.
        disc_opt_kwargs = dict(disc_opt_kwargs or {})
        lr = disc_opt_kwargs.pop("lr", disc_opt_kwargs.pop("learning_rate", 1e-3))
        generator = make_generator(seed ^ 0x5EED, self.device)
        self.reward_net.init(generator)
        self.disc_state = DiscState(
            optimizer=rl_common.make_optimizer(self.reward_net.parameters(), lr, **disc_opt_kwargs),
            generator=generator,
        )
        self.gen_state: Optional[rl_common.RLState] = None
        self._global_step = 0
        self._range = type(self).__name__.lower()  # "gail", "airl": profiler range prefix

    # -- demonstration handling -------------------------------------------
    def set_demonstrations(self, demonstrations: base.AnyDemonstrations) -> None:
        if isinstance(demonstrations, (list, tuple)) and demonstrations and isinstance(
            demonstrations[0], types.Trajectory
        ):
            self._check_fixed_horizon(len(t) for t in demonstrations)
        self._demo_store = base.DemonstrationStore.from_demonstrations(demonstrations, self.device)
        if self._demo_store.num_samples < self.demo_batch_size:
            raise ValueError(
                f"demo_batch_size={self.demo_batch_size} exceeds demonstration "
                f"size {self._demo_store.num_samples}"
            )

    @property
    def policy(self) -> Union[ActorCriticPolicy, SACPolicy]:
        return self.gen_algo.policy

    # -- subclass contract -------------------------------------------------
    @abc.abstractmethod
    def logits_expert_is_high(
        self, reward_net: RewardNet, obs, acts, next_obs, dones,
        log_policy_act_prob: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Discriminator logits; high = classified expert."""

    @abc.abstractmethod
    def reward_train_fn(self) -> rl_common.RelabelRewardFn:
        """Reward used to train the generator."""

    def reward_test_fn(self) -> rl_common.RelabelRewardFn:
        """Reward for transfer evaluation; defaults to the train reward."""
        return self.reward_train_fn()

    @property
    def needs_policy_log_prob(self) -> bool:
        """AIRL needs log pi(a|s) inside the disc logit; GAIL does not."""
        return False

    def _reward_train_relabel_fn(self, reward_params, obs, acts, next_obs, dones):
        return self.reward_train_fn()(reward_params, obs, acts, next_obs, dones)

    # -- discriminator step ------------------------------------------------
    def _disc_step(
        self,
        disc_state: DiscState,
        gen_buffer_state: BufferState,
        policy: Union[ActorCriticPolicy, SACPolicy],
        demo_batch: types.TransitionBatch,
    ) -> Tuple[DiscState, Dict[str, torch.Tensor]]:
        """One BCE discriminator update on expert+gen half-batches.

        When ``demo_minibatch_size < demo_batch_size``, gradients accumulate
        over ``[expert_mb; gen_mb]`` slices with the loss scaled by
        ``mb / demo_batch_size``, and one optimizer step is taken at the end.
        Where ``needs_policy_log_prob`` (AIRL), log pi(a|s) under ``policy``
        (a SAC generator's: ``SAC.log_prob_fn``, the rescale's Jacobian
        included) is computed once on the whole ``[2B]`` batch, with no
        gradient and without folding the policy's normalizer stats, and
        split into minibatches like the other fields.
        """
        B = self.demo_batch_size
        mb = self.demo_minibatch_size
        k = B // mb
        e_idx, g_idx = _disc_indices(
            demo_batch.batch_size, self._gen_replay_buffer, gen_buffer_state, B,
            disc_state.generator,
        )
        gen = gen_buffer_state.data
        obs, acts, next_obs, dones = assemble_fields(
            [(getattr(demo_batch, f), getattr(gen, f)) for f in ("obs", "acts", "next_obs", "dones")],
            e_idx, g_idx,
        )

        log_prob = None
        if self.needs_policy_log_prob:
            with torch.no_grad():
                if isinstance(self.gen_algo, SAC):
                    log_prob = self.gen_algo.log_prob_fn()(obs, acts)
                else:
                    dist, _ = policy.dist_and_value(obs)
                    log_prob = dist.log_prob(acts if policy.action_space.is_discrete
                                             else acts.reshape(acts.shape[0], -1))

        def to_mb(x):
            # [2B, ...] with expert rows first -> [k, 2*mb, ...]
            if x is None:
                return [None] * k
            if k == 1:
                return x[None]
            e = x[:B].reshape((k, mb) + tuple(x.shape[1:]))
            g = x[B:].reshape((k, mb) + tuple(x.shape[1:]))
            return torch.cat([e, g], dim=1)

        dev = self.device
        labels_mb = torch.cat([torch.ones(mb, device=dev), torch.zeros(mb, device=dev)])
        labels = torch.cat([torch.ones(B, device=dev), torch.zeros(B, device=dev)])
        net = self.reward_net
        optimizer = disc_state.optimizer
        optimizer.zero_grad()
        losses, logits_k = [], []
        for o, a, no, d, lp in zip(
            to_mb(obs), to_mb(acts), to_mb(next_obs), to_mb(dones), to_mb(log_prob)
        ):
            logits = self.logits_expert_is_high(net, o, a, no, d, lp)
            # Scaled so the k accumulated grads sum to the full-batch mean.
            loss = sigmoid_binary_cross_entropy(logits, labels_mb).mean() * (mb / B)
            loss.backward()
            losses.append(loss.detach())
            logits_k.append(logits.detach())
        loss = torch.stack(losses).sum()  # == full-batch mean BCE
        logits_k = torch.stack(logits_k)  # [k, 2mb] -> [all expert; all gen]
        logits = torch.cat([logits_k[:, :mb].reshape(B), logits_k[:, mb:].reshape(B)])
        optimizer.step()
        stats = compute_train_stats(logits, labels, loss)
        if any(isinstance(m, NormLayer) for m in net.modules()):
            # Fold this batch into the input normalizers' statistics, of any
            # kind (a shaped net's normalizer sits in its base), as JAX folds
            # the whole "stats" collection.
            with torch.no_grad():
                net(obs, acts, next_obs, dones, update_stats=True)
        return dataclasses.replace(disc_state, step=disc_state.step + 1), stats

    def train_disc(self, sync: bool = True) -> Mapping[str, Any]:
        """One discriminator update using the current buffers."""
        if self._gen_buffer_state is None:
            raise RuntimeError("No generator samples for training. Call `train_gen()` first.")
        with record_function(f"{self._range}.disc_step"):
            self.disc_state, stats = self._disc_step(
                self.disc_state, self._gen_buffer_state, self._current_policy(),
                self._demo_store.batch,
            )
        if not sync:
            return stats
        return {k: float(v) for k, v in rl_common.metrics_to_host(stats).items()}

    def train_disc_rounds(self, n: Optional[int] = None, sync: bool = True):
        """Runs ``n`` (default ``n_disc_updates_per_round``) disc updates;
        returns per-update stats stacked on axis 0."""
        if self._gen_buffer_state is None:
            raise RuntimeError("No generator samples for training. Call `train_gen()` first.")
        n = n or self.n_disc_updates_per_round
        policy = self._current_policy()
        all_stats = []
        timer = getattr(self.gen_algo, "phase_timer", None)
        with timer.phase("disc_update", block_on=list(self.reward_net.parameters())) \
                if timer is not None else contextlib.nullcontext():
            for _ in range(n):
                with record_function(f"{self._range}.disc_step"):
                    self.disc_state, stats = self._disc_step(
                        self.disc_state, self._gen_buffer_state, policy, self._demo_store.batch
                    )
                all_stats.append(stats)
        stacked = {k: torch.stack([s[k] for s in all_stats]) for k in all_stats[0]}
        return stacked if not sync else rl_common.metrics_to_host(stacked)

    def _current_policy(self) -> Union[ActorCriticPolicy, SACPolicy]:
        if self.gen_state is None:
            self.gen_state = self.gen_algo.init_state()
        return self.policy

    # -- generator warm start ----------------------------------------------
    def warm_start_generator(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """Loads pre-trained policy weights into the generator before
        training: a policy ``state_dict`` (e.g. ``convert.policy_state_dict``)
        for PPO, an actor's (``convert.sac_actor_state_dict``) for SAC, whose
        critics are kept. The optimizers' moments are kept, as the JAX
        package keeps its ``opt_state``."""
        if self.gen_state is None:
            self.gen_state = self.gen_algo.init_state()
        if isinstance(self.gen_algo, SAC):
            self.gen_algo.actor.load_state_dict(state_dict)
        else:
            self.policy.load_state_dict(state_dict)
        # A background collection (overlap_collection) ran under the
        # replaced weights: drop it.
        self.gen_algo.discard_pending_collection()

    # -- generator step ----------------------------------------------------
    def train_gen(self, total_timesteps: Optional[int] = None, sync: bool = True) -> Mapping[str, Any]:
        """Trains the generator on relabelled rewards; refills the gen buffer."""
        if total_timesteps is None:
            total_timesteps = self.gen_train_timesteps
        if self.gen_state is None:
            self.gen_state = self.gen_algo.init_state()
        n_iters = max(1, -(-total_timesteps // self._gen_steps_per_iter))
        metrics = {}
        for _ in range(n_iters):
            self.gen_state, metrics, chunk = self.gen_algo.train_step(
                self.gen_state, self.reward_net
            )
            with record_function(f"{self._range}.buffer_store"):
                if isinstance(chunk, types.TransitionBatch):
                    transitions = chunk  # an off-policy generator returns these directly
                else:
                    transitions = chunk_to_transitions(chunk)
                if self._gen_buffer_state is None:
                    self._gen_buffer_state = self._gen_replay_buffer.init_state(transitions)
                self._gen_buffer_state = self._gen_replay_buffer.store(
                    self._gen_buffer_state, transitions
                )
        if not sync:
            return metrics
        return {k: float(v) for k, v in rl_common.metrics_to_host(metrics).items()}

    # -- multi-round loop --------------------------------------------------
    def _example_transitions(self) -> types.TransitionBatch:
        """One all-zero row shaped like the env's transitions (sizes the ring)."""
        obs_space, act_space = self.venv.observation_space, self.venv.action_space
        dev = self.device
        obs = torch.zeros((1,) + tuple(obs_space.shape), device=dev)
        if act_space.is_discrete:
            acts = torch.zeros((1,), dtype=torch.int32, device=dev)
        else:
            acts = torch.zeros((1,) + tuple(act_space.shape), device=dev)
        zero = torch.zeros((1,), device=dev)
        return types.TransitionBatch(obs=obs, acts=acts, next_obs=obs, dones=zero, rews=zero)

    def _round_step(self) -> Dict[str, torch.Tensor]:
        """One adversarial round: ONE generator train step (whatever
        ``gen_train_timesteps`` is, as in the JAX package's fused round), the
        replay store and ``n_disc_updates_per_round`` disc steps. Returns the
        round's metrics on the device: ``gen/*``, and ``disc/*`` averaged over
        the disc steps."""
        gen_metrics = self.train_gen(self._gen_steps_per_iter, sync=False)
        disc_stats = self.train_disc_rounds(sync=False)
        metrics = {f"gen/{k}": v for k, v in gen_metrics.items()}
        metrics.update({f"disc/{k}": v.mean() for k, v in disc_stats.items()})
        return metrics

    def train_fused(self, total_timesteps: int, rounds_per_sync: int = 8) -> None:
        """Runs ``rounds_per_sync`` rounds between host reads of the metrics.

        The JAX package runs those rounds as one traced ``lax.scan``; here
        they run eagerly, with no host read until the last of them. The
        metrics of each sync are averaged over its rounds and logged as
        ``mean/gen/*`` and ``mean/disc/*``. The replay ring is sized from
        ``_example_transitions`` before the first round. ``ReplayBuffer.store``
        writes the ring in place, which is harmless here: only the newest
        buffer state is kept. A host-env generator is refused, as in the
        JAX package.
        """
        if getattr(self.gen_algo, "is_host_env", False):
            raise ValueError("train_fused requires a device env")
        n_rounds = total_timesteps // self.gen_train_timesteps
        if n_rounds < 1:
            raise ValueError(
                f"No updates (need at least {self.gen_train_timesteps} timesteps, "
                f"have only total_timesteps={total_timesteps})!"
            )
        if self.gen_state is None:
            self.gen_state = self.gen_algo.init_state()
        if self._gen_buffer_state is None:
            self._gen_buffer_state = self._gen_replay_buffer.init_state(self._example_transitions())
        done_rounds = 0
        while done_rounds < n_rounds:
            k = min(rounds_per_sync, n_rounds - done_rounds)
            rounds = [self._round_step() for _ in range(k)]
            with record_function(f"{self._range}.metrics_to_host"):  # the sync's one read
                host = rl_common.metrics_to_host(
                    {key: torch.stack([m[key] for m in rounds]).mean() for key in rounds[0]}
                )
            for key, v in host.items():
                self.logger.record(f"mean/{key}", float(v))
            done_rounds += k
            self._global_step += k
            self.logger.dump(self._global_step)

    # -- outer loop --------------------------------------------------------
    def train(self, total_timesteps: int, callback: Optional[Callable[[int], None]] = None) -> None:
        """Alternating adversarial training, one host read of metrics per round."""
        n_rounds = total_timesteps // self.gen_train_timesteps
        if n_rounds < 1:
            raise ValueError(
                f"No updates (need at least {self.gen_train_timesteps} timesteps, "
                f"have only total_timesteps={total_timesteps})!"
            )
        for r in range(n_rounds):
            gen_metrics = self.train_gen(self.gen_train_timesteps, sync=False)
            disc_stats = self.train_disc_rounds(sync=False)
            with record_function(f"{self._range}.metrics_to_host"):  # the round's one sync
                gen_metrics = rl_common.metrics_to_host(gen_metrics)
                disc_stats = rl_common.metrics_to_host(disc_stats)
            with self.logger.accumulate_means("gen"):
                for k, v in gen_metrics.items():
                    self.logger.record(k, float(v))
            for i in range(self.n_disc_updates_per_round):
                with self.logger.accumulate_means("disc"):
                    for k, v in disc_stats.items():
                        self.logger.record(k, float(v[i]))
            self._global_step += 1
            if callback:
                callback(r)
            self.logger.dump(self._global_step)
        # A live background collection would race the caller's next use of
        # the venv (an evaluation, say): host envs are not thread-safe.
        self.gen_algo.discard_pending_collection()
