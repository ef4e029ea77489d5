"""PPO: clipped-surrogate on-policy learner.

Port of ``imitation_tpu/rl/ppo.py`` for device envs. ``train_step`` runs, on
the env's device:

1. a rollout of ``n_steps`` lockstep env steps (``data.rollout.collect``);
2. optional learned-reward relabelling of the whole ``[T, B]`` chunk in one
   batched reward-net forward;
3. GAE with the hand-written CUDA kernel B1 (``ops.gae``);
4. ``n_epochs`` x ``n_minibatches`` clipped PPO updates over shuffled
   minibatches.

The JAX package traces all of this into one XLA program; here it runs as
eager launches, and the policy's parameters are updated in place. Metrics
stay on the device until the caller reads them. The learning rate is
constant (the ``linear`` schedule, host envs and overlapped collection are
not ported yet).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch.profiler import record_function

from imitation_tpu_torch import make_generator
from imitation_tpu_torch.data import rollout as rollout_mod
from imitation_tpu_torch.envs.vector import VectorEnv
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.ops.gae import gae
from imitation_tpu_torch.rl import common


@dataclasses.dataclass
class PPOConfig:
    n_steps: int = 2048  # rollout length per env per iteration
    learning_rate: float = 3e-4
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


def _epoch_permutation(n: int, generator: torch.Generator) -> torch.Tensor:
    """The shuffle of one PPO epoch (tests substitute the JAX package's)."""
    return torch.randperm(n, generator=generator, device=generator.device)


class PPO:
    """On-policy PPO over a device ``VectorEnv``.

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
            self.policy.parameters(), self.config.learning_rate, self.config.max_grad_norm
        )
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
        """Rollout + update on the device."""
        with record_function("ppo.collect"):
            env_state, chunk = rollout_mod.collect(
                self.venv, self.policy.sample_fn(), state.env_state,
                self.config.n_steps, state.generator,
            )
        with record_function("ppo.process_chunk"):
            return self.process_chunk(state, env_state, chunk, state.generator, reward_params)

    def _normalize_rewards(self, reward_norm: common.RewNormState, rews, dones):
        """VecNormalize-style scaling by the running std of discounted returns."""
        cfg = self.config
        out = []
        rn = reward_norm
        for r_t, done_t in zip(rews, dones):
            ret = rn.ret * cfg.gamma + r_t
            b_count = ret.shape[0]
            b_mean = ret.mean()
            b_var = ret.var(unbiased=False)
            total = rn.count + b_count
            delta = b_mean - rn.mean
            new_mean = rn.mean + delta * b_count / total
            m2 = rn.var * rn.count + b_var * b_count + delta * delta * rn.count * b_count / total
            new_var = m2 / total
            out.append(torch.clamp(r_t * torch.rsqrt(new_var + 1e-8), -cfg.reward_clip, cfg.reward_clip))
            rn = common.RewNormState(
                ret=ret * (1.0 - done_t.float()), var=new_var, mean=new_mean, count=total
            )
        return rn, torch.stack(out)

    def _loss(self, mb: Dict[str, torch.Tensor]):
        cfg = self.config
        lp, ent, value = self.policy.evaluate_actions(mb["obs"], mb["acts"])
        adv = mb["advantages"]
        if cfg.normalize_advantage:
            adv = (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-8)
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
        """Relabel, GAE and the clipped epochs over one ``[T, B]`` chunk."""
        cfg = self.config
        policy = self.policy
        T, B = chunk.acts.shape[0], chunk.acts.shape[1]

        def flat(x):
            return x.reshape((T * B,) + tuple(x.shape[2:]))

        with torch.no_grad():
            # Fold this chunk's observations into the feature normalizer
            # once per iteration (the rollout used the previous stats).
            if policy.normalize_features:
                policy.net.feat_norm.update(flat(chunk.obs).float())

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
                reward_norm, rews = self._normalize_rewards(reward_norm, rews, chunk.dones)

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
        optimizer = state.optimizer
        auxs = []
        cont = True
        for _ in range(cfg.n_epochs):
            perm = _epoch_permutation(T * B, generator)
            for i in range(n_mb):
                idx = perm[i * mb_size:(i + 1) * mb_size]
                mb = {k: v[idx] for k, v in batch.items()}
                optimizer.zero_grad()
                loss, aux = self._loss(mb)
                loss.backward()
                if cfg.target_kl is not None:
                    # SB3 early stop: the minibatch whose approx_kl exceeds
                    # 1.5*target_kl is not applied, nor anything after it.
                    cont = cont and not bool(aux["approx_kl"] > 1.5 * cfg.target_kl)
                if cont:
                    aux["grad_norm"] = optimizer.step()
                else:
                    with torch.no_grad():
                        aux["grad_norm"] = common.global_norm(p.grad for p in policy.parameters())
                aux["loss"] = loss.detach()
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
