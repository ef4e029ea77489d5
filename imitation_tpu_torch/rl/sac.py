"""SAC: Soft Actor-Critic with automatic temperature tuning.

Port of ``imitation_tpu/rl/sac.py``. ``train_step`` runs, on the env's
device:

1. a collect of ``train_freq`` lockstep env steps under the squashed-Gaussian
   actor (``data.rollout.collect``), its actions scaled to the env's bounds;
2. a store of the ``train_freq * num_envs`` transitions, with those
   env-scaled actions, in the replay ring;
3. ``gradient_steps`` updates, each on a batch from the ring (or from
   ``sample_hook``: SQIL's 50/50 mix), relabelled by ``relabel_fn`` where it
   is set (an adversarial trainer's learned reward). An update computes the
   critic target (from the target critic and the alpha before this step),
   the critic's gradients, the actor's gradients through the critic as it
   stood before this step, and the temperature's gradient, and only then
   applies the critic, actor and temperature Adam steps and the Polyak
   step: the JAX package's order.

Until ``learning_starts`` rows are stored the JAX package runs the updates
with every gradient masked to zero. Here such an update computes its losses
for the metrics without gradients and applies nothing, but each optimizer's
count advances as optax's does (``Adam.step_masked``), so the bias
corrections of the first real update agree. Parameters are updated in
place; metrics stay on the device until the caller reads them.

Over a host vector env (``venv.is_host``) step 1 is
``data.rollout.HostCollector`` on a CPU snapshot of the actor, refreshed
before each collection, and steps 2-3 run on ``venv.device``; with
``overlap_collection`` the next ``train_freq`` steps are collected on a
background thread while this round's updates run.

On data-parallel ranks (``parallel.mesh.shard_sac_state``) each rank steps
its block of the envs and keeps their rows of the replay ring; an update's
batch is drawn with global indices from the replicated generator and
gathered from the rows' owners, and every rank then computes the whole
update, so the result is the one-process one and needs no gradient
reduction.
"""

from __future__ import annotations

import concurrent.futures
import copy
import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from imitation_tpu_torch import make_generator
from imitation_tpu_torch.data import rollout as rollout_mod
from imitation_tpu_torch.data.buffer import BufferState, ReplayBuffer
from imitation_tpu_torch.data.types import TransitionBatch
from imitation_tpu_torch.envs.base import Space
from imitation_tpu_torch.envs.vector import VecEnvState, VectorEnv
from imitation_tpu_torch.models import networks
from imitation_tpu_torch.models.distributions import SquashedGaussian
from imitation_tpu_torch.parallel import distributed
from imitation_tpu_torch.rl import common

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


class SACActor(nn.Module):
    """Squashed-Gaussian actor: a relu torso ``dense{i}`` and the heads
    ``mean`` and ``log_std`` (clipped to [-20, 2]), the flax module's names."""

    def __init__(self, obs_dim: int, act_dim: int, hid_sizes: Sequence[int] = (256, 256)):
        super().__init__()
        self.hid_sizes = tuple(hid_sizes)
        size = obs_dim
        for i, h in enumerate(self.hid_sizes):
            self.add_module(f"dense{i}", networks.dense(size, h))
            size = h
        self.mean = networks.dense(size, act_dim)
        self.log_std = networks.dense(size, act_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for layer in self.children():
            networks.init_dense_(layer, generator)

    def forward(self, obs: torch.Tensor) -> SquashedGaussian:
        x = obs.reshape(obs.shape[0], -1).float()
        for i in range(len(self.hid_sizes)):
            x = torch.relu(getattr(self, f"dense{i}")(x))
        log_std = torch.clamp(self.log_std(x), LOG_STD_MIN, LOG_STD_MAX)
        return SquashedGaussian(mean=self.mean(x), log_std=log_std)


class SACCritic(nn.Module):
    """Twin Q networks in one module, ``q{q}_dense{i}`` and ``q{q}_out``
    (the flax names); ``forward(obs, acts)`` returns ``[2, B]``."""

    def __init__(self, obs_dim: int, act_dim: int, hid_sizes: Sequence[int] = (256, 256)):
        super().__init__()
        self.hid_sizes = tuple(hid_sizes)
        for q in range(2):
            size = obs_dim + act_dim
            for i, h in enumerate(self.hid_sizes):
                self.add_module(f"q{q}_dense{i}", networks.dense(size, h))
                size = h
            self.add_module(f"q{q}_out", networks.dense(size, 1))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for layer in self.children():
            networks.init_dense_(layer, generator)

    def forward(self, obs: torch.Tensor, acts: torch.Tensor) -> torch.Tensor:
        x0 = torch.cat([obs.reshape(obs.shape[0], -1), acts.reshape(acts.shape[0], -1)], dim=-1).float()
        qs = []
        for q in range(2):
            x = x0
            for i in range(len(self.hid_sizes)):
                x = torch.relu(getattr(self, f"q{q}_dense{i}")(x))
            qs.append(getattr(self, f"q{q}_out")(x)[:, 0])
        return torch.stack(qs)


@dataclasses.dataclass
class SACConfig:
    learning_rate: float = 3e-4
    buffer_size: int = 1_000_000
    learning_starts: int = 100
    batch_size: int = 256
    tau: float = 0.005
    gamma: float = 0.99
    train_freq: int = 1
    gradient_steps: int = 1
    ent_coef: str = "auto"  # "auto" or a float string
    target_entropy: Optional[float] = None  # default -act_dim
    actor_hid_sizes: Tuple[int, ...] = (256, 256)
    critic_hid_sizes: Tuple[int, ...] = (256, 256)
    # Host envs only: collect the next train_freq steps on a background
    # thread, with the pre-update actor, while the device updates. Refused
    # over a device env.
    overlap_collection: bool = False


@dataclasses.dataclass
class SACState:
    """Carried state of SAC: the modules it updates in place, their
    optimizers and the host-side counters."""

    actor: SACActor
    critic: SACCritic
    target_critic: SACCritic
    log_alpha: nn.Parameter  # scalar
    actor_opt: common.Adam
    critic_opt: common.Adam
    alpha_opt: common.Adam
    env_state: Optional[VecEnvState]
    buffer_state: BufferState
    generator: torch.Generator
    timesteps: int = 0
    n_updates: int = 0
    # The data-parallel mesh (parallel.mesh.shard_sac_state): env_state and
    # the replay ring then hold this rank's env rows.
    mesh: Optional[Any] = None

    @property
    def variables(self) -> SACActor:
        """The module holding the policy's weights (the JAX state's
        ``variables`` alias), so generic code can treat a SACState like an
        ``RLState``."""
        return self.actor


# relabel hook: (reward_params, batch) -> batch with replaced rews
RelabelBatchFn = Callable[[Any, TransitionBatch], TransitionBatch]

# sample hook: (replay, buffer_state, generator, batch_size) -> TransitionBatch
# (the JAX package's contract with a generator for the key; SQIL's 50/50
# expert mix plugs in here, as in rl/dqn.py)
SampleHook = Callable[[ReplayBuffer, BufferState, torch.Generator, int], TransitionBatch]


class SACPolicy(nn.Module):
    """A SAC actor as a policy over env-scaled actions: the rollout
    closures ``sample_fn`` and ``deterministic_fn`` (``(obs, generator) ->
    (acts, aux)``) and ``log_prob``. Saved and loaded by
    ``policies.serialize`` as the ``sac_actor`` type."""

    def __init__(self, observation_space: Space, action_space: Space,
                 hid_sizes: Sequence[int] = (256, 256)):
        super().__init__()
        self.observation_space = observation_space
        self.action_space = action_space
        self.hid_sizes = tuple(hid_sizes)
        self.actor = SACActor(observation_space.flat_dim, action_space.flat_dim, self.hid_sizes)
        low = np.broadcast_to(np.asarray(action_space.low, np.float32), action_space.shape)
        high = np.broadcast_to(np.asarray(action_space.high, np.float32), action_space.shape)
        scale = (high - low) / 2.0
        self.register_buffer("act_scale", torch.from_numpy(np.array(scale)), persistent=False)
        self.register_buffer("act_center", torch.from_numpy(np.array((high + low) / 2.0)),
                             persistent=False)
        # The log-scale Jacobian of the affine rescale, in float32 as JAX sums it.
        self._log_scale_sum = float(np.sum(np.log(scale)))

    def scale(self, squashed: torch.Tensor) -> torch.Tensor:
        """Squashed actions in (-1, 1) -> env-scaled actions."""
        return squashed.reshape((-1,) + tuple(self.action_space.shape)) * self.act_scale + self.act_center

    def _sample_closure(self):
        @torch.no_grad()
        def f(obs: torch.Tensor, generator: torch.Generator):
            squashed, lp = self.actor(obs).sample_and_log_prob(generator)
            return self.scale(squashed), {"log_prob": lp}

        return f

    def _mode_closure(self):
        @torch.no_grad()
        def f(obs: torch.Tensor, generator: Optional[torch.Generator] = None):
            return self.scale(self.actor(obs).mode()), {}

        return f

    def sample_fn(self):
        """(obs, generator) -> (env-scaled acts, {log_prob}) for rollouts."""
        return rollout_mod.module_fn(self, SACPolicy._sample_closure)

    def deterministic_fn(self):
        """As ``sample_fn``, with the distribution's mode and no aux."""
        return rollout_mod.module_fn(self, SACPolicy._mode_closure)

    def log_prob(self, obs: torch.Tensor, acts_env: torch.Tensor) -> torch.Tensor:
        """log pi(a|s) of env-scaled actions, the rescale's Jacobian
        included: AIRL's disc logit term for an off-policy generator."""
        flat = acts_env.reshape(acts_env.shape[0], -1)
        a = (flat - self.act_center.reshape(-1)) / self.act_scale.reshape(-1)
        a = torch.clamp(a, -1.0 + 1e-6, 1.0 - 1e-6)
        return self.actor(obs).log_prob(a) - self._log_scale_sum


class SAC:
    """Soft Actor-Critic over a device ``VectorEnv`` (continuous actions).

    Actions are squashed to (-1, 1) and rescaled to the env's bounds at step
    time; the replay ring and the critic see them rescaled.
    """

    def __init__(
        self,
        venv: VectorEnv,
        config: SACConfig = SACConfig(),
        *,
        relabel_fn: Optional[RelabelBatchFn] = None,
        sample_hook: Optional[SampleHook] = None,
        seed: int = 0,
    ):
        if venv.action_space.is_discrete:
            raise ValueError("SAC requires a continuous action space")
        # Host envs: a HostCollector steps the env, everything after the
        # collect runs on the device. Adversarial ``train_fused`` reads
        # ``is_host_env`` for its own refusal.
        self.is_host_env = bool(getattr(venv, "is_host", False))
        if config.overlap_collection and not self.is_host_env:
            # Refused rather than ignored: a device env has no host collection to overlap.
            raise NotImplementedError(
                "overlap_collection pipelines host-env collection; a device env has none"
            )
        self._host_collector: Optional[rollout_mod.HostCollector] = None
        self._pending_chunk: Optional[concurrent.futures.Future] = None
        self._collect_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self.venv = venv
        self.device = venv.device
        self.config = config
        self.act_dim = venv.action_space.flat_dim
        self._policy = SACPolicy(
            venv.observation_space, venv.action_space, config.actor_hid_sizes
        ).to(self.device)
        self.actor = self._policy.actor
        self.critic = SACCritic(
            venv.observation_space.flat_dim, self.act_dim, config.critic_hid_sizes
        ).to(self.device)
        self.target_critic = copy.deepcopy(self.critic).requires_grad_(False)
        self.log_alpha = nn.Parameter(torch.zeros((), device=self.device))
        self.replay = ReplayBuffer(config.buffer_size)
        self.relabel_fn = relabel_fn
        self.sample_hook = sample_hook
        # When True, train_step also returns the freshly collected
        # TransitionBatch (adversarial trainers store it for disc batches).
        self.return_transitions = False
        self._seed = seed
        self.target_entropy = (
            config.target_entropy if config.target_entropy is not None else -float(self.act_dim)
        )
        self._auto_alpha = config.ent_coef == "auto"
        self._fixed_alpha = None if self._auto_alpha else float(config.ent_coef)

    def rebind(self) -> None:
        """Kept for callers of the JAX package's API, which re-jits after a
        hook changes; the port reads its hooks at every step."""

    # -- state -------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None) -> SACState:
        """Re-initialises the actor, the critics and the temperature from
        the seed, resets the envs and allocates the replay ring."""
        generator = generator if generator is not None else make_generator(self._seed, self.device)
        self.actor.reset_parameters(generator)
        self.critic.reset_parameters(generator)
        self.target_critic.load_state_dict(self.critic.state_dict())
        with torch.no_grad():
            self.log_alpha.zero_()
        lr = self.config.learning_rate
        dev = self.device
        obs = torch.zeros((1,) + tuple(self.venv.observation_space.shape), device=dev)
        zero = torch.zeros((1,), device=dev)
        example = TransitionBatch(
            obs=obs, acts=torch.zeros((1,) + tuple(self.venv.action_space.shape), device=dev),
            next_obs=obs, dones=zero, rews=zero,
        )
        if self.is_host_env:
            self.discard_pending_collection()
            env_state = None
            self._host_collector = rollout_mod.HostCollector(
                self.venv, self._policy.sample_fn(), seed=self._seed
            )
        else:
            env_state = self.venv.reset(generator)
        return SACState(
            actor=self.actor,
            critic=self.critic,
            target_critic=self.target_critic,
            log_alpha=self.log_alpha,
            actor_opt=common.make_optimizer(self.actor.parameters(), lr),
            critic_opt=common.make_optimizer(self.critic.parameters(), lr),
            alpha_opt=common.make_optimizer([self.log_alpha], lr),
            env_state=env_state,
            buffer_state=self.replay.init_state(example),
            generator=generator,
        )

    def log_prob_fn(self):
        """(obs, env-scaled acts) -> log pi(a|s), the Jacobian included."""
        return self._policy.log_prob

    @property
    def policy(self) -> SACPolicy:
        """The actor as a policy (shares this SAC's actor module)."""
        return self._policy

    # -- train step --------------------------------------------------------
    def train_step(self, state: SACState, reward_params: Any = None):
        """Collect ``train_freq`` steps, store them, run the updates."""
        if self.is_host_env:
            if self.config.overlap_collection:
                return self.train_step_host_overlapped(state, reward_params)
            return self.train_step_host(state, reward_params)
        venv = self.venv if state.mesh is None else self.venv.rows(state.mesh)
        with record_function("sac.collect"):
            env_state, chunk = rollout_mod.collect(
                venv, self._policy.sample_fn(), state.env_state, self.config.train_freq,
                state.generator,
            )
        return self._process_chunk(state, env_state, chunk, reward_params)

    def _host_collect(self, state) -> rollout_mod.RolloutChunk:
        if self._host_collector is None:
            raise RuntimeError("call init_state() first")
        self._host_collector.mesh = state.mesh
        self._host_collector.refresh()
        return self._host_collector.collect(self.config.train_freq)

    def train_step_host(self, state: SACState, reward_params: Any = None):
        """Host-env path: ``train_freq`` env steps through the host
        collector, then the same store and updates on the device."""
        with record_function("sac.host_collect"):
            chunk = self._host_collect(state)
        return self._process_chunk(state, None, chunk, reward_params)

    def train_step_host_overlapped(self, state: SACState, reward_params: Any = None):
        """Pipelined host-env path (``SACConfig.overlap_collection``): joins
        the chunk collected during the previous round's updates, snapshots
        the current (pre-update) actor synchronously, starts the next
        collection from that snapshot on the collector's thread, then runs
        this round's store and updates."""
        if self._collect_pool is None:
            self._collect_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="sac-host-collect"
            )
        if self._pending_chunk is None:
            chunk = self._host_collect(state)
        else:
            with record_function("sac.collect_join"):
                chunk = self._pending_chunk.result()
            self._host_collector.refresh()
        self._pending_chunk = self._collect_pool.submit(
            self._host_collector.collect, self.config.train_freq
        )
        return self._process_chunk(state, None, chunk, reward_params)

    def discard_pending_collection(self) -> None:
        """Joins and drops any background collection (call after replacing
        the actor's weights from outside, e.g. a warm start)."""
        if self._pending_chunk is not None:
            try:
                self._pending_chunk.result()
            finally:
                self._pending_chunk = None

    def _process_chunk(self, state: SACState, env_state: Optional[VecEnvState],
                       chunk: rollout_mod.RolloutChunk, reward_params: Any):
        """``_process`` over a ``[T, B]`` chunk's transitions. On a
        data-parallel rank the chunk is its env columns: the ring stores
        them where they are, and the episode statistics (and the transitions
        returned to an adversarial trainer) are gathered over the ranks, in
        the one-process order."""

        def transitions_of(c: rollout_mod.RolloutChunk) -> TransitionBatch:
            def flat(x):
                return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))

            return TransitionBatch(
                obs=flat(c.obs),
                acts=flat(c.acts),
                next_obs=flat(c.next_obs),
                # the TD target bootstraps through time limits, not true terminals
                dones=flat(c.terminated.float()),
                rews=flat(c.rews),
            )

        done, ep_return, whole = chunk.dones, chunk.episode_return, None
        if state.mesh is not None:
            names = ["dones", "episode_return"]
            names += ["obs", "acts", "next_obs", "terminated", "rews"] if self.return_transitions else []
            tensors = [done, ep_return] + [getattr(chunk, n) for n in names[2:]]
            gathered = dict(zip(names, distributed.all_gather_many(tensors, state.mesh, dim=1)))
            done, ep_return = gathered.pop("dones"), gathered.pop("episode_return")
            if self.return_transitions:
                whole = transitions_of(chunk.replace(**gathered))
        return self._process(state, env_state, transitions_of(chunk), done, ep_return,
                             reward_params, whole)

    def _alpha(self) -> torch.Tensor:
        if self._auto_alpha:
            return torch.exp(self.log_alpha.detach())
        return torch.full((), self._fixed_alpha, device=self.device)

    def _update(self, state: SACState, buffer_state: BufferState, reward_params: Any,
                learn: bool) -> Dict[str, torch.Tensor]:
        """One gradient step, in the JAX package's order (module docstring);
        where not ``learn``, its losses only and the masked optimizer steps."""
        cfg = self.config
        generator = state.generator
        if self.sample_hook is not None:
            batch = self.sample_hook(self.replay, buffer_state, generator, cfg.batch_size)
        else:
            batch = self.replay.sample(buffer_state, cfg.batch_size, generator)
        scale = self._policy.scale
        with torch.no_grad():
            if self.relabel_fn is not None:
                batch = self.relabel_fn(reward_params, batch)
            alpha = self._alpha()
            next_sq, next_lp = self.actor(batch.next_obs).sample_and_log_prob(generator)
            q_next = self.target_critic(batch.next_obs, scale(next_sq)).min(dim=0).values
            target = batch.rews + cfg.gamma * (1.0 - batch.dones) * (q_next - alpha * next_lp)

        with torch.set_grad_enabled(learn):
            qs = self.critic(batch.obs, batch.acts)
            c_loss = ((qs - target[None]) ** 2).mean()
            # The actor's loss through the critic as it stands before this step.
            sq, lp = self.actor(batch.obs).sample_and_log_prob(generator)
            q = self.critic(batch.obs, scale(sq)).min(dim=0).values
            a_loss = (alpha * lp - q).mean()
        lp_mean = lp.detach().mean()
        opts = (state.critic_opt, state.actor_opt) + ((state.alpha_opt,) if self._auto_alpha else ())
        if not learn:
            for opt in opts:
                opt.step_masked()
        else:
            # Each loss's gradients reach its own module's .grad only.
            for loss, module in ((c_loss, self.critic), (a_loss, self.actor)):
                params = list(module.parameters())
                for p, g in zip(params, torch.autograd.grad(loss, params)):
                    p.grad = g
            if self._auto_alpha:
                # d/d log_alpha of -(exp(log_alpha) * stop_gradient(lp_mean + target_entropy))
                self.log_alpha.grad = -(torch.exp(self.log_alpha.detach()) * (lp_mean + self.target_entropy))
            for opt in opts:
                opt.step()
            with torch.no_grad():
                target_params = list(self.target_critic.parameters())
                torch._foreach_mul_(target_params, 1.0 - cfg.tau)
                torch._foreach_add_(target_params, torch._foreach_mul(list(self.critic.parameters()), cfg.tau))
        return {
            "critic_loss": c_loss.detach(),
            "actor_loss": a_loss.detach(),
            "alpha": alpha,
            "q_mean": qs.detach().mean(),
            "entropy": -lp_mean,
        }

    def _process(
        self,
        state: SACState,
        env_state: Optional[VecEnvState],
        transitions: TransitionBatch,
        done: torch.Tensor,
        ep_return: torch.Tensor,
        reward_params: Any = None,
        whole: Optional[TransitionBatch] = None,
    ):
        """Store ``transitions``, run ``gradient_steps`` updates (masked
        before ``learning_starts``) and gather the metrics on the device.
        ``whole`` is every rank's transitions on a data-parallel rank."""
        cfg = self.config
        with record_function("sac.buffer_store"):
            buffer_state = self.replay.store(state.buffer_state, transitions)
        can_learn = buffer_state.global_size >= min(cfg.learning_starts, self.replay.capacity)
        auxs = []
        for _ in range(cfg.gradient_steps):
            with record_function("sac.update"):
                auxs.append(self._update(state, buffer_state, reward_params, can_learn))

        dev = self.device
        with torch.no_grad():
            nan = torch.full((), float("nan"), device=dev)
            metrics = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
            done_f = done.float()
            n_done = done_f.sum()
            metrics["ep_return_mean"] = torch.where(
                n_done > 0, (ep_return * done_f).sum() / torch.clamp(n_done, min=1), nan
            )
            metrics["buffer_size"] = torch.full((), float(buffer_state.global_size), device=dev)
        whole = whole if whole is not None else transitions
        new_state = dataclasses.replace(
            state,
            env_state=env_state,
            buffer_state=buffer_state,
            timesteps=state.timesteps + transitions.batch_size * (1 if state.mesh is None else state.mesh.dp),
            n_updates=state.n_updates + cfg.gradient_steps,
        )
        if self.return_transitions:
            return new_state, metrics, whole
        return new_state, metrics

    # -- host loop ---------------------------------------------------------
    def learn(
        self,
        state: SACState,
        total_timesteps: int,
        reward_params: Any = None,
        callback: Optional[Callable[[SACState, Dict[str, torch.Tensor]], None]] = None,
        logger=None,
        log_every: int = 100,
    ) -> SACState:
        """Runs ``ceil(total_timesteps / (train_freq * num_envs))`` train
        steps (at least one). Metrics are read to the host only for the
        ``logger``, every ``log_every`` steps (``sac/*``, dumped at the step
        count); ``callback(state, metrics)`` gets them on the device."""
        steps_per_iter = self.config.train_freq * self.venv.num_envs
        if state.mesh is not None and self.is_host_env:
            steps_per_iter *= state.mesh.dp  # each rank's host env is its block
        for i in range(max(1, math.ceil(total_timesteps / steps_per_iter))):
            state, metrics = self.train_step(state, reward_params)[:2]
            if logger is not None and (i + 1) % log_every == 0:
                for k, v in common.metrics_to_host(metrics).items():
                    logger.record(f"sac/{k}", float(v))
                logger.dump(step=state.timesteps)
            if callback is not None:
                callback(state, metrics)
        self.discard_pending_collection()
        return state
