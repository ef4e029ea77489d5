"""PPO: clipped-surrogate on-policy learner.

Port of ``imitation_tpu/rl/ppo.py``. ``train_step`` runs, on the env's
device:

1. a rollout of ``n_steps`` lockstep env steps (``data.rollout.collect``);
2. optional learned-reward relabelling of the whole ``[T, B]`` chunk in one
   batched reward-net forward;
3. GAE with the hand-written CUDA kernel B1 (``ops.gae``);
4. ``n_epochs`` x ``n_minibatches`` clipped PPO updates over shuffled
   minibatches.

The JAX package traces all of this into one XLA program; here it runs as
eager launches, and the policy's parameters are updated in place. Metrics
stay on the device until the caller reads them. ``learn`` is the host loop
of train steps with logging. The learning rate is constant or falls
linearly to 0 over ``total_updates_hint`` train steps (``lr_schedule``).

Over a host vector env (``venv.is_host``, e.g. ``native.CppVectorEnv``)
step 1 is ``data.rollout.HostCollector``: the env steps on the host and the
policy's forward runs on a CPU snapshot of the policy, refreshed from the
card's weights before each collection; steps 2-4 run on ``venv.device`` as
above. With ``overlap_collection`` the next chunk is collected on a
background thread, from the pre-update snapshot, while this iteration's
update runs (``train_step_host_overlapped``). ``phase_timer`` (a
``util.profiling.PhaseTimer``) splits the host paths into ``host_collect``,
``device_update`` and ``collect_join``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch
from torch.profiler import record_function

from imitation_tpu_torch import make_generator
from imitation_tpu_torch.data import rollout as rollout_mod
from imitation_tpu_torch.envs.vector import VectorEnv
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.ops.gae import gae
from imitation_tpu_torch.parallel import distributed
from imitation_tpu_torch.rl import common


@dataclasses.dataclass
class PPOConfig:
    n_steps: int = 2048  # rollout length per env per iteration
    learning_rate: float = 3e-4
    lr_schedule: str = "constant"  # "constant" | "linear" (decay to 0)
    total_updates_hint: int = 1000  # schedule horizon in train_step calls
    n_epochs: int = 10
    n_minibatches: int = 32
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_range: float = 0.2
    clip_range_vf: Optional[float] = None
    ent_coef: float = 0.0
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    normalize_advantage: bool = True
    normalize_rewards: bool = False  # VecNormalize(norm_reward) equivalent
    reward_clip: float = 10.0
    # SB3 semantics: once a minibatch's approx_kl exceeds 1.5*target_kl, that
    # and every later update of the iteration is skipped (costs one device
    # sync per minibatch while set).
    target_kl: Optional[float] = None
    # Host envs only: collect the next chunk on a background thread, with
    # the pre-update policy (one update stale; the chunk's behaviour
    # log-probs keep the importance ratios right), while the device runs
    # this iteration's update. Off: SB3's exact on-policy order. Refused
    # over a device env.
    overlap_collection: bool = False


def _epoch_permutation(n: int, generator: torch.Generator) -> torch.Tensor:
    """The shuffle of one PPO epoch (tests substitute the JAX package's)."""
    return torch.randperm(n, generator=generator, device=generator.device)


class PPO:
    """On-policy PPO over a device ``VectorEnv`` or a host vector env.

    Pass ``reward_fn`` to relabel rewards with a learned reward (GAIL);
    ``return_transitions=True`` makes ``train_step`` also return the raw
    rollout chunk.
    """

    def __init__(
        self,
        venv: VectorEnv,
        policy: ActorCriticPolicy,
        config: PPOConfig = PPOConfig(),
        *,
        reward_fn: Optional[common.RelabelRewardFn] = None,
        return_transitions: bool = False,
        seed: int = 0,
    ):
        self.venv = venv
        self.device = venv.device
        self.policy = policy.to(self.device)
        self.config = config
        self.reward_fn = reward_fn
        self.return_transitions = return_transitions
        self._seed = seed
        self.is_host_env = bool(getattr(venv, "is_host", False))
        if config.overlap_collection and not self.is_host_env:
            # Refused rather than ignored: a device env has no host collection to overlap.
            raise NotImplementedError(
                "overlap_collection pipelines host-env collection; a device env has none"
            )
        self._host_collector: Optional[rollout_mod.HostCollector] = None
        self._pending_chunk: Optional[concurrent.futures.Future] = None
        self._collect_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        # Optional util.profiling.PhaseTimer for the host-env paths; the
        # serialized path then waits for the device at the end of each
        # update, so that ``device_update`` covers its execution.
        self.phase_timer = None
        if config.lr_schedule == "linear":
            updates_per_call = config.n_epochs * config.n_minibatches
            self._lr = common.linear_schedule(
                config.learning_rate, 0.0, config.total_updates_hint * updates_per_call
            )
        elif config.lr_schedule == "constant":
            self._lr = config.learning_rate
        else:
            raise ValueError(f"unknown lr_schedule {config.lr_schedule!r}")
        batch = config.n_steps * venv.num_envs
        if batch % config.n_minibatches != 0:
            raise ValueError(
                f"n_steps*n_envs={batch} not divisible by "
                f"n_minibatches={config.n_minibatches}"
            )

    # -- state -------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None) -> common.RLState:
        """Re-initialises the policy from the seed and resets the envs."""
        generator = generator if generator is not None else make_generator(self._seed, self.device)
        self.policy.init(generator)
        optimizer = common.make_optimizer(
            self.policy.parameters(), self._lr, self.config.max_grad_norm
        )
        if self.is_host_env:
            self.discard_pending_collection()
            env_state = None
            self._host_collector = rollout_mod.HostCollector(
                self.venv, self.policy.sample_fn(), seed=self._seed
            )
        else:
            env_state = self.venv.reset(generator)
        reward_norm = None
        if self.config.normalize_rewards:
            dev = self.device
            reward_norm = common.RewNormState(
                ret=torch.zeros((self.venv.num_envs,), device=dev),
                var=torch.ones((), device=dev),
                mean=torch.zeros((), device=dev),
                count=torch.zeros((), device=dev),
            )
        return common.RLState(
            policy=self.policy,
            optimizer=optimizer,
            env_state=env_state,
            generator=generator,
            reward_norm=reward_norm,
        )

    # -- train step --------------------------------------------------------
    def train_step(self, state: common.RLState, reward_params: Any = None):
        """Rollout + update on the device (host collection over a host env)."""
        if self.is_host_env:
            if self.config.overlap_collection:
                return self.train_step_host_overlapped(state, reward_params)
            return self.train_step_host(state, reward_params)
        venv = self.venv if state.mesh is None else self.venv.rows(state.mesh)
        with record_function("ppo.collect"):
            env_state, chunk = rollout_mod.collect(
                venv, self.policy.sample_fn(), state.env_state,
                self.config.n_steps, state.generator,
            )
        with record_function("ppo.process_chunk"):
            return self.process_chunk(state, env_state, chunk, state.generator, reward_params)

    def _phase(self, name: str, block_on=None):
        if self.phase_timer is None:
            return contextlib.nullcontext()
        return self.phase_timer.phase(name, block_on=block_on)

    def _host_collect(self, state) -> rollout_mod.RolloutChunk:
        """Refreshes the collector's snapshot and collects one chunk (its
        draws a data-parallel rank's block where ``state.mesh`` is set)."""
        if self._host_collector is None:
            raise RuntimeError("call init_state() first")
        self._host_collector.mesh = state.mesh
        self._host_collector.refresh()
        return self._host_collector.collect(self.config.n_steps)

    def train_step_host(self, state: common.RLState, reward_params: Any = None):
        """Host-env path: collect on the host, then the update on the device."""
        with self._phase("host_collect"), record_function("ppo.host_collect"):
            chunk = self._host_collect(state)
        block_on = list(self.policy.parameters()) if self.phase_timer is not None else None
        with self._phase("device_update", block_on=block_on), record_function("ppo.process_chunk"):
            return self.process_chunk(state, None, chunk, state.generator, reward_params)

    def train_step_host_overlapped(self, state: common.RLState, reward_params: Any = None):
        """Pipelined host-env path (``PPOConfig.overlap_collection``).

        Joins the chunk collected in the background during the previous
        iteration's update, snapshots the current (pre-update) weights,
        starts collecting the next chunk from that snapshot on the
        collector's thread, and runs this iteration's update. The snapshot
        is complete before the update is launched (a synchronous copy), and
        the thread reads nothing else of the policy, so the in-place update
        cannot race it.
        """
        if self._collect_pool is None:
            self._collect_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ppo-host-collect"
            )
        if self._pending_chunk is None:
            chunk = self._host_collect(state)
        else:
            # Only the host-blocked wait is timed: a device barrier here
            # would serialize the pipeline this path exists for.
            with self._phase("collect_join"), record_function("ppo.collect_join"):
                chunk = self._pending_chunk.result()
            self._host_collector.refresh()
        self._pending_chunk = self._collect_pool.submit(
            self._host_collector.collect, self.config.n_steps
        )
        with record_function("ppo.process_chunk"):
            return self.process_chunk(state, None, chunk, state.generator, reward_params)

    def discard_pending_collection(self) -> None:
        """Joins and drops any background collection (call after replacing
        the policy's weights from outside, e.g. a warm start, so that the
        next chunk is not one collected under the replaced policy)."""
        if self._pending_chunk is not None:
            try:
                self._pending_chunk.result()
            finally:
                self._pending_chunk = None

    def _normalize_rewards(self, reward_norm: common.RewNormState, rews, dones, mesh=None):
        """VecNormalize-style scaling by the running std of discounted
        returns; each step's return moments are the global env batch's."""
        cfg = self.config
        ret, rets = reward_norm.ret, []
        for r_t, done_t in zip(rews, dones):
            ret = ret * cfg.gamma + r_t
            rets.append(ret)
            ret = ret * (1.0 - done_t.float())
        rets_t = torch.stack(rets)  # [T, B]
        b_count = torch.full((rets_t.shape[0],), float(rets_t.shape[1]), device=rets_t.device)
        b_mean = rets_t.mean(dim=1)
        b_var = rets_t.var(dim=1, unbiased=False)
        if mesh is not None:
            b_count, b_mean, m2 = distributed.merge_moments(b_count, b_mean, b_var * b_count, mesh)
            b_var = m2 / b_count
        out = []
        count, mean, var = reward_norm.count, reward_norm.mean, reward_norm.var
        for t, r_t in enumerate(rews):
            n = b_count[t]
            total = count + n
            delta = b_mean[t] - mean
            new_mean = mean + delta * n / total
            m2 = var * count + b_var[t] * n + delta * delta * count * n / total
            new_var = m2 / total
            out.append(torch.clamp(r_t * torch.rsqrt(new_var + 1e-8), -cfg.reward_clip, cfg.reward_clip))
            count, mean, var = total, new_mean, new_var
        rn = common.RewNormState(ret=ret, var=var, mean=mean, count=count)
        return rn, torch.stack(out)

    def _loss(self, mb: Dict[str, torch.Tensor], adv_stats=None):
        """The clipped loss over ``mb``'s rows; ``adv_stats`` (mean, std) are
        the whole minibatch's where ``mb`` is a rank's share of it."""
        cfg = self.config
        lp, ent, value = self.policy.evaluate_actions(mb["obs"], mb["acts"])
        adv = mb["advantages"]
        if cfg.normalize_advantage:
            mean, std = adv_stats if adv_stats is not None else (adv.mean(), adv.std(unbiased=False))
            adv = (adv - mean) / (std + 1e-8)
        ratio = torch.exp(lp - mb["old_log_prob"])
        pg1 = adv * ratio
        pg2 = adv * torch.clamp(ratio, 1.0 - cfg.clip_range, 1.0 + cfg.clip_range)
        pg_loss = -torch.minimum(pg1, pg2).mean()
        if cfg.clip_range_vf is not None:
            v_clipped = mb["old_value"] + torch.clamp(
                value - mb["old_value"], -cfg.clip_range_vf, cfg.clip_range_vf
            )
            v_loss = torch.maximum(
                (value - mb["returns"]) ** 2, (v_clipped - mb["returns"]) ** 2
            ).mean()
        else:
            v_loss = ((value - mb["returns"]) ** 2).mean()
        ent_loss = -ent.mean()
        total = pg_loss + cfg.ent_coef * ent_loss + cfg.vf_coef * v_loss
        with torch.no_grad():
            aux = {
                "policy_loss": pg_loss.detach(),
                "value_loss": v_loss.detach(),
                "entropy": ent.mean().detach(),
                "clip_fraction": ((ratio - 1.0).abs() > cfg.clip_range).float().mean(),
                "approx_kl": ((ratio - 1.0) - torch.log(ratio)).mean(),
            }
        return total, aux

    def process_chunk(
        self,
        state: common.RLState,
        env_state: Any,
        chunk: rollout_mod.RolloutChunk,
        generator: torch.Generator,
        reward_params: Any = None,
    ):
        """Relabel, GAE and the clipped epochs over one ``[T, B]`` chunk.

        On a data-parallel rank (``state.mesh``) the chunk is the rank's env
        columns ``[T, B/W]``: the feature and reward-normalization moments
        are merged over the ranks, relabel and GAE (B1) run on the rank's
        columns, and the rollout is then gathered once, so that every rank
        holds each global minibatch of the one-process epoch permutation.
        A rank computes the loss of its fixed share of the minibatch's rows,
        normalizing advantages by the whole minibatch's moments, and the
        gradients (with the metrics, ``approx_kl`` included) are averaged
        over the ranks before ``Adam.step``. The chunk returned is the
        gathered one.
        """
        cfg = self.config
        policy = self.policy
        mesh = state.mesh
        T, B = chunk.acts.shape[0], chunk.acts.shape[1]

        def flat(x):
            return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))

        with torch.no_grad():
            # Fold this chunk's observations into the feature normalizer
            # once per iteration (the rollout used the previous stats).
            if policy.normalize_features:
                with distributed.local_rows(mesh):
                    policy.net.update_feature_stats(flat(chunk.obs))

            true_rews = chunk.rews
            dones_f = chunk.dones.float()
            if self.reward_fn is not None:
                rews = self.reward_fn(
                    reward_params, flat(chunk.obs), flat(chunk.acts),
                    flat(chunk.next_obs), flat(dones_f),
                ).reshape(T, B)
            else:
                rews = true_rews

            reward_norm = state.reward_norm
            if cfg.normalize_rewards:
                reward_norm, rews = self._normalize_rewards(reward_norm, rews, chunk.dones, mesh)

            if "value" in chunk.aux:
                values, log_probs = chunk.aux["value"], chunk.aux["log_prob"]
            else:
                dist, values_flat = policy.dist_and_value(flat(chunk.obs))
                log_probs = dist.log_prob(flat(chunk.acts)).reshape(T, B)
                values = values_flat.reshape(T, B)
            next_values = policy.value(flat(chunk.next_obs)).reshape(T, B)
            advantages, returns = gae(
                rews.contiguous(), values.contiguous(), next_values.contiguous(),
                chunk.terminated.float(), dones_f, cfg.gamma, cfg.gae_lambda,
            )

        if mesh is not None:
            # One gather of the rank's env columns into the [T, B*W] rollout.
            fields = [getattr(chunk, f) for f in rollout_mod.CHUNK_FIELDS]
            fields += [rews, log_probs, values, advantages, returns]
            gathered = distributed.all_gather_many(fields, mesh, dim=1)
            n_chunk = len(rollout_mod.CHUNK_FIELDS)
            chunk = rollout_mod.RolloutChunk(aux={}, **dict(zip(rollout_mod.CHUNK_FIELDS, gathered)))
            rews, log_probs, values, advantages, returns = gathered[n_chunk:]
            true_rews, dones_f = chunk.rews, chunk.dones.float()
            B = chunk.acts.shape[1]

        batch = {
            "obs": flat(chunk.obs),
            "acts": flat(chunk.acts),
            "old_log_prob": flat(log_probs),
            "old_value": flat(values),
            "advantages": flat(advantages),
            "returns": flat(returns),
        }
        n_mb = cfg.n_minibatches
        mb_size = (T * B) // n_mb
        share = slice(None)
        if mesh is not None:
            if mb_size % mesh.dp != 0:
                raise ValueError(f"minibatch size {mb_size} not divisible by dp={mesh.dp}")
            share = mesh.rows(mb_size)
        optimizer = state.optimizer
        params = list(policy.parameters())
        auxs = []
        cont = True
        for _ in range(cfg.n_epochs):
            perm = _epoch_permutation(T * B, generator)
            for i in range(n_mb):
                idx = perm[i * mb_size:(i + 1) * mb_size]
                adv_stats = None
                if mesh is not None and cfg.normalize_advantage:
                    adv_mb = batch["advantages"][idx]
                    adv_stats = (adv_mb.mean(), adv_mb.std(unbiased=False))
                mb = {k: v[idx[share]] for k, v in batch.items()}
                optimizer.zero_grad()
                loss, aux = self._loss(mb, adv_stats)
                loss.backward()
                loss = loss.detach()
                if mesh is not None:  # the mean of the ranks' gradients and metrics
                    names = list(aux)
                    stacked = torch.stack([aux[k] for k in names] + [loss])
                    distributed.all_reduce_grads_(params, mesh, [stacked])
                    *values, loss = stacked.unbind(0)
                    aux = dict(zip(names, values))
                if cfg.target_kl is not None:
                    # SB3 early stop: the minibatch whose approx_kl exceeds
                    # 1.5*target_kl is not applied, nor anything after it.
                    cont = cont and not bool(aux["approx_kl"] > 1.5 * cfg.target_kl)
                if cont:
                    aux["grad_norm"] = optimizer.step()
                else:
                    with torch.no_grad():
                        aux["grad_norm"] = common.global_norm(p.grad for p in params)
                aux["loss"] = loss
                auxs.append(aux)

        with torch.no_grad():
            metrics = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
            if cfg.target_kl is not None:
                metrics["early_stop"] = torch.tensor(0.0 if cont else 1.0, device=self.device)
            metrics["explained_variance"] = common.explained_variance(
                batch["old_value"], batch["returns"]
            )
            n_done = dones_f.sum()
            nan = torch.tensor(float("nan"), device=self.device)
            denom = torch.clamp(n_done, min=1)
            metrics["ep_return_mean"] = torch.where(
                n_done > 0, (chunk.episode_return * dones_f).sum() / denom, nan
            )
            metrics["ep_len_mean"] = torch.where(
                n_done > 0, (chunk.episode_length.float() * dones_f).sum() / denom, nan
            )
            metrics["n_episodes"] = n_done
            if self.reward_fn is not None:
                metrics["relabeled_rew_mean"] = rews.mean()
                metrics["true_rew_mean"] = true_rews.mean()

        new_state = state.replace(
            env_state=env_state,
            generator=generator,
            timesteps=state.timesteps + T * B,
            n_updates=state.n_updates + 1,
            reward_norm=reward_norm,
        )
        if self.return_transitions:
            return new_state, metrics, chunk.replace(rews=true_rews, aux={})
        return new_state, metrics

    # -- host loop ---------------------------------------------------------
    def learn(
        self,
        state: common.RLState,
        total_timesteps: int,
        reward_params: Any = None,
        callback: Optional[Callable[[common.RLState, Dict[str, float]], None]] = None,
        logger=None,
        log_prefix: str = "rollout",
    ) -> common.RLState:
        """Runs ``ceil(total_timesteps / (n_steps * num_envs))`` train steps
        (at least one). Metrics are read to the host only for a ``logger``
        (recorded under ``log_prefix`` and dumped at the step count) or a
        ``callback(state, metrics)``."""
        steps_per_iter = self.config.n_steps * self.venv.num_envs
        if state.mesh is not None and self.is_host_env:
            steps_per_iter *= state.mesh.dp  # each rank's host env is its block
        for _ in range(max(1, math.ceil(total_timesteps / steps_per_iter))):
            state, metrics = self.train_step(state, reward_params)[:2]
            if callback is not None or logger is not None:
                host_metrics = {k: float(v) for k, v in common.metrics_to_host(metrics).items()}
                if logger is not None:
                    for k, v in host_metrics.items():
                        logger.record(f"{log_prefix}/{k}", v)
                    logger.dump(step=state.timesteps)
                if callback is not None:
                    callback(state, host_metrics)
        # A live background collection would race the caller's next use of
        # the venv (an evaluation, say): host envs are not thread-safe.
        self.discard_pending_collection()
        return state
