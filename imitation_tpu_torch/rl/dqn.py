"""DQN: off-policy Q-learning with a replay ring and a target network.

Port of ``imitation_tpu/rl/dqn.py``. ``train_step`` runs, on the env's
device:

1. a collect of ``train_freq`` lockstep env steps with epsilon-greedy
   actions (``data.rollout.collect``), epsilon read from the state's
   timesteps before the collect;
2. a store of the transitions in the replay ring;
3. ``gradient_steps`` Huber TD updates on sampled batches (or on
   ``sample_hook``'s: SQIL's 50/50 mix), each clipped to a global norm of
   ``max_grad_norm`` and stepped by Adam (``rl_common.make_optimizer``);
4. the target network's hard or Polyak copy when the collected steps cross
   a multiple of ``target_update_interval``.

Until ``learning_starts`` rows are stored the JAX package runs the updates
with masked gradients; here such an update computes its loss for the
metrics without gradients and applies nothing, but the optimizer's count
advances as optax's does (``Adam.step_masked``). The target copy is not
masked.

Over a host vector env (``venv.is_host``) step 1 is
``data.rollout.HostCollector`` with epsilon-greedy actions from a CPU
snapshot of the Q-network, refreshed before each collection; with
``overlap_collection`` the next collection runs on a background thread
while this round's updates run.
"""

from __future__ import annotations

import concurrent.futures
import copy
import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from imitation_tpu_torch import make_generator
from imitation_tpu_torch.data import rollout as rollout_mod
from imitation_tpu_torch.data.buffer import BufferState, ReplayBuffer
from imitation_tpu_torch.data.types import TransitionBatch
from imitation_tpu_torch.envs.vector import VecEnvState, VectorEnv
from imitation_tpu_torch.models import networks
from imitation_tpu_torch.rl import common


class QNetwork(nn.Module):
    """relu MLP ``dense{i}`` -> ``q_out`` of one Q-value per action (the
    flax names)."""

    def __init__(self, obs_dim: int, n_actions: int, hid_sizes: Sequence[int] = (64, 64)):
        super().__init__()
        self.hid_sizes = tuple(hid_sizes)
        size = obs_dim
        for i, h in enumerate(self.hid_sizes):
            self.add_module(f"dense{i}", networks.dense(size, h))
            size = h
        self.q_out = networks.dense(size, n_actions)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for layer in self.children():
            networks.init_dense_(layer, generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs.reshape(obs.shape[0], -1).float()
        for i in range(len(self.hid_sizes)):
            x = torch.relu(getattr(self, f"dense{i}")(x))
        return self.q_out(x)


@dataclasses.dataclass
class DQNConfig:
    learning_rate: float = 1e-4
    buffer_size: int = 100_000
    learning_starts: int = 1000
    batch_size: int = 32
    tau: float = 1.0  # target Polyak factor (1.0 = hard copy at target_update)
    gamma: float = 0.99
    train_freq: int = 4  # env steps (per env) per train_step collect
    gradient_steps: int = 1
    # In collected env steps, across all parallel envs.
    target_update_interval: int = 10_000
    exploration_fraction: float = 0.1
    exploration_initial_eps: float = 1.0
    exploration_final_eps: float = 0.05
    max_grad_norm: float = 10.0
    hid_sizes: Tuple[int, ...] = (64, 64)
    # Host envs only: collect the next train_freq steps on a background
    # thread, with the pre-update Q-net and epsilon, while the device
    # updates. Refused over a device env.
    overlap_collection: bool = False


@dataclasses.dataclass
class DQNState:
    """Carried state of DQN: the Q-network and its target (updated in
    place), the optimizer and the host-side counters."""

    q_net: QNetwork
    target_q_net: QNetwork
    optimizer: common.Adam
    env_state: Optional[VecEnvState]
    buffer_state: BufferState
    generator: torch.Generator
    timesteps: int = 0
    n_updates: int = 0

    @property
    def variables(self) -> QNetwork:
        """The module holding the policy's weights (the JAX state's
        ``variables``)."""
        return self.q_net


# Sample hook: (buffer, buffer_state, generator, batch_size) -> TransitionBatch.
SampleHook = Callable[[ReplayBuffer, BufferState, torch.Generator, int], TransitionBatch]


def _explore_draws(n: int, n_actions: int, generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """The draws of one epsilon-greedy step: ``[n]`` float32 uniforms for
    the epsilon test and ``[n]`` int32 random actions (tests substitute the
    JAX package's)."""
    dev = generator.device
    u = torch.rand((n,), generator=generator, device=dev)
    acts = torch.randint(0, n_actions, (n,), generator=generator, device=dev, dtype=torch.int32)
    return u, acts


class DQN:
    """Deep Q-Network learner over a device ``VectorEnv``."""

    def __init__(
        self,
        venv: VectorEnv,
        config: DQNConfig = DQNConfig(),
        *,
        total_timesteps_hint: int = 100_000,
        sample_hook: Optional[SampleHook] = None,
        seed: int = 0,
    ):
        if not venv.action_space.is_discrete:
            raise ValueError("DQN requires a discrete action space")
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
        self.q_net = QNetwork(
            venv.observation_space.flat_dim, venv.action_space.n, config.hid_sizes
        ).to(self.device)
        self.target_q_net = copy.deepcopy(self.q_net).requires_grad_(False)
        self.replay = ReplayBuffer(config.buffer_size)
        self.sample_hook = sample_hook
        self._seed = seed
        # linear epsilon schedule over exploration_fraction * hint
        self._eps_decay_steps = max(1, int(config.exploration_fraction * total_timesteps_hint))

    def init_state(self, generator: Optional[torch.Generator] = None) -> DQNState:
        """Re-initialises the Q-network (and copies it to the target) from
        the seed, resets the envs and allocates the replay ring."""
        generator = generator if generator is not None else make_generator(self._seed, self.device)
        self.q_net.reset_parameters(generator)
        self.target_q_net.load_state_dict(self.q_net.state_dict())
        dev = self.device
        obs = torch.zeros((1,) + tuple(self.venv.observation_space.shape), device=dev)
        zero = torch.zeros((1,), device=dev)
        example = TransitionBatch(obs=obs, acts=torch.zeros((1,), dtype=torch.int32, device=dev),
                                  next_obs=obs, dones=zero, rews=zero)
        if self.is_host_env:
            self.discard_pending_collection()
            env_state = None
            self._host_collector = rollout_mod.HostCollector(
                self.venv, self._explore_fn(self.config.exploration_initial_eps), seed=self._seed
            )
        else:
            env_state = self.venv.reset(generator)
        return DQNState(
            q_net=self.q_net,
            target_q_net=self.target_q_net,
            optimizer=common.make_optimizer(
                self.q_net.parameters(), self.config.learning_rate, self.config.max_grad_norm
            ),
            env_state=env_state,
            buffer_state=self.replay.init_state(example),
            generator=generator,
        )

    def epsilon(self, timesteps: int) -> float:
        """The linear exploration schedule at ``timesteps``, in float32 as
        the JAX package computes it."""
        cfg = self.config
        f32 = np.float32
        frac = np.clip(f32(timesteps) / f32(self._eps_decay_steps), f32(0), f32(1))
        return float(f32(cfg.exploration_initial_eps)
                     + frac * f32(cfg.exploration_final_eps - cfg.exploration_initial_eps))

    def greedy_fn(self):
        """Deterministic argmax-Q rollout policy ``(obs, generator) -> (acts, {})``."""

        def make(q_net: QNetwork):
            @torch.no_grad()
            def f(obs: torch.Tensor, generator: Optional[torch.Generator] = None):
                return torch.argmax(q_net(obs), dim=-1).to(torch.int32), {}

            return f

        return rollout_mod.module_fn(self.q_net, make)

    def _explore_fn(self, eps: float):
        n_actions = self.venv.action_space.n

        def make(q_net: QNetwork):
            @torch.no_grad()
            def f(obs: torch.Tensor, generator: torch.Generator):
                greedy = torch.argmax(q_net(obs), dim=-1).to(torch.int32)
                u, random_acts = _explore_draws(obs.shape[0], n_actions, generator)
                return torch.where(u < eps, random_acts, greedy), {}

            return f

        return rollout_mod.module_fn(self.q_net, make)

    # -- train step --------------------------------------------------------
    def train_step(self, state: DQNState):
        """Collect ``train_freq`` epsilon-greedy steps, store, update."""
        if self.is_host_env:
            if self.config.overlap_collection:
                return self.train_step_host_overlapped(state)
            return self.train_step_host(state)
        with record_function("dqn.collect"):
            env_state, chunk = rollout_mod.collect(
                self.venv, self._explore_fn(self.epsilon(state.timesteps)), state.env_state,
                self.config.train_freq, state.generator,
            )
        return self._process_chunk(state, env_state, chunk)

    def _point_collector(self, state: DQNState) -> None:
        """Points the collector at a fresh snapshot of the Q-net and at the
        epsilon of ``state``."""
        if self._host_collector is None:
            raise RuntimeError("call init_state() first")
        self._host_collector.set_policy(self._explore_fn(self.epsilon(state.timesteps)))

    def train_step_host(self, state: DQNState):
        """Host-env path: ``train_freq`` epsilon-greedy steps through the
        host collector, then the same store and TD updates on the device."""
        with record_function("dqn.host_collect"):
            self._point_collector(state)
            chunk = self._host_collector.collect(self.config.train_freq)
        return self._process_chunk(state, None, chunk)

    def train_step_host_overlapped(self, state: DQNState):
        """Pipelined host-env path (``DQNConfig.overlap_collection``): joins
        the chunk collected during the previous round's updates, snapshots
        the current (pre-update) Q-net with this state's epsilon, starts the
        next collection on the collector's thread, then runs this round's
        store and updates."""
        if self._collect_pool is None:
            self._collect_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="dqn-host-collect"
            )
        if self._pending_chunk is None:
            self._point_collector(state)
            chunk = self._host_collector.collect(self.config.train_freq)
        else:
            # The snapshot is touched only once the thread that reads it is joined.
            with record_function("dqn.collect_join"):
                chunk = self._pending_chunk.result()
            self._point_collector(state)
        self._pending_chunk = self._collect_pool.submit(self._host_collector.collect, self.config.train_freq)
        return self._process_chunk(state, None, chunk)

    def discard_pending_collection(self) -> None:
        """Joins and drops any background collection."""
        if self._pending_chunk is not None:
            try:
                self._pending_chunk.result()
            finally:
                self._pending_chunk = None

    def _process_chunk(self, state: DQNState, env_state: Optional[VecEnvState],
                       chunk: rollout_mod.RolloutChunk):
        """``_process`` over a ``[T, B]`` chunk's transitions."""
        T, B = chunk.acts.shape[0], chunk.acts.shape[1]

        def flat(x):
            return x.reshape((T * B,) + tuple(x.shape[2:]))

        transitions = TransitionBatch(
            obs=flat(chunk.obs),
            acts=flat(chunk.acts).to(torch.int32),
            next_obs=flat(chunk.next_obs),
            # the TD target bootstraps through time limits, not true terminals
            dones=flat(chunk.terminated.float()),
            rews=flat(chunk.rews),
        )
        return self._process(state, env_state, transitions, chunk.dones, chunk.episode_return)

    def _td_update(self, state: DQNState, buffer_state: BufferState, learn: bool) -> Dict[str, torch.Tensor]:
        """One Huber TD step; where not ``learn``, its loss only and the
        masked optimizer step."""
        cfg = self.config
        if self.sample_hook is not None:
            batch = self.sample_hook(self.replay, buffer_state, state.generator, cfg.batch_size)
        else:
            batch = self.replay.sample(buffer_state, cfg.batch_size, state.generator)
        with torch.no_grad():
            q_next = self.target_q_net(batch.next_obs).max(dim=-1).values
            target = batch.rews + cfg.gamma * (1.0 - batch.dones) * q_next
        with torch.set_grad_enabled(learn):
            q_sel = self.q_net(batch.obs).gather(1, batch.acts.long().reshape(-1, 1))[:, 0]
            err = q_sel - target
            # Huber loss (SB3's smooth_l1)
            loss = torch.where(err.abs() < 1.0, 0.5 * err * err, err.abs() - 0.5).mean()
        if learn:
            state.optimizer.zero_grad()
            loss.backward()
            state.optimizer.step()
        else:
            state.optimizer.step_masked()
        return {"loss": loss.detach(), "q_mean": q_sel.detach().mean()}

    def _process(
        self,
        state: DQNState,
        env_state: Optional[VecEnvState],
        transitions: TransitionBatch,
        done: torch.Tensor,
        ep_return: torch.Tensor,
    ):
        """Store ``transitions``, run the TD updates (masked before
        ``learning_starts``), copy to the target where an interval is
        crossed, and gather the metrics on the device."""
        cfg = self.config
        eps = self.epsilon(state.timesteps)
        with record_function("dqn.buffer_store"):
            buffer_state = self.replay.store(state.buffer_state, transitions)
        new_timesteps = state.timesteps + transitions.batch_size
        can_learn = buffer_state.size >= min(cfg.learning_starts, self.replay.capacity)
        auxs = []
        for _ in range(cfg.gradient_steps):
            with record_function("dqn.update"):
                auxs.append(self._td_update(state, buffer_state, can_learn))

        interval = cfg.target_update_interval
        if new_timesteps // interval > state.timesteps // interval:
            with torch.no_grad():
                target_params = list(self.target_q_net.parameters())
                torch._foreach_mul_(target_params, 1.0 - cfg.tau)
                torch._foreach_add_(target_params, torch._foreach_mul(list(self.q_net.parameters()), cfg.tau))

        dev = self.device
        with torch.no_grad():
            nan = torch.full((), float("nan"), device=dev)
            metrics = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
            done_f = done.float()
            n_done = done_f.sum()
            metrics["epsilon"] = torch.full((), eps, device=dev)
            metrics["buffer_size"] = torch.full((), float(buffer_state.size), device=dev)
            metrics["ep_return_mean"] = torch.where(
                n_done > 0, (ep_return * done_f).sum() / torch.clamp(n_done, min=1), nan
            )
            metrics["n_episodes"] = n_done
        new_state = dataclasses.replace(
            state,
            env_state=env_state,
            buffer_state=buffer_state,
            timesteps=new_timesteps,
            n_updates=state.n_updates + cfg.gradient_steps,
        )
        return new_state, metrics

    # -- host loop ---------------------------------------------------------
    def learn(
        self,
        state: DQNState,
        total_timesteps: int,
        callback: Optional[Callable[[DQNState, Dict[str, torch.Tensor]], None]] = None,
        log_every: int = 50,
        logger=None,
    ) -> DQNState:
        """Runs ``ceil(total_timesteps / (train_freq * num_envs))`` train
        steps (at least one). Metrics are read to the host only for the
        ``logger``, every ``log_every`` steps (``dqn/*``);
        ``callback(state, metrics)`` gets them on the device."""
        steps_per_iter = self.config.train_freq * self.venv.num_envs
        for i in range(max(1, math.ceil(total_timesteps / steps_per_iter))):
            state, metrics = self.train_step(state)
            if logger is not None and (i + 1) % log_every == 0:
                for k, v in common.metrics_to_host(metrics).items():
                    logger.record(f"dqn/{k}", float(v))
                logger.dump(step=state.timesteps)
            if callback is not None:
                callback(state, metrics)
        self.discard_pending_collection()
        return state
