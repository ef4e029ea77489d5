"""Exploration: a Markov-switching mixture of a policy and uniform random
actions.

Port of the device half of ``imitation_tpu/policies/exploration_wrapper.py``.
Each env holds a mode (policy or random); after every step, with probability
``switch_prob``, the mode is drawn anew (random with probability
``random_prob``). ``collect`` is ``data.rollout.collect`` with the per-env
mode carried from step to step. Every draw of the mixture goes through
``_mode_uniform`` and ``_explore_draws`` (tests substitute the JAX
package's). The host-env policy (``host_policy_fn``) waits for the port's
host envs.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from imitation_tpu_torch.data.rollout import PolicyApply, RolloutChunk
from imitation_tpu_torch.envs.base import Space
from imitation_tpu_torch.envs.vector import VecEnvState, VectorEnv


def _mode_uniform(n: int, generator: torch.Generator) -> torch.Tensor:
    """``[n]`` uniforms in [0, 1) on the generator's device: the initial mode."""
    return torch.rand(n, generator=generator, device=generator.device)


def _explore_draws(space: Space, n: int, generator: torch.Generator):
    """One exploring step's draws: ``n`` uniform random actions, then the
    ``[n]`` uniforms of the switch test and of the new mode."""
    return space.sample(n, generator), _mode_uniform(n, generator), _mode_uniform(n, generator)


class ExplorationWrapper:
    """Markov-switching policy/random mixture over a device ``VectorEnv``."""

    def __init__(self, policy_apply: PolicyApply, venv: VectorEnv, random_prob: float = 0.5,
                 switch_prob: float = 0.5):
        if not (0 <= random_prob <= 1) or not (0 <= switch_prob <= 1):
            raise ValueError("probabilities must lie in [0, 1]")
        self.policy_apply = policy_apply
        self.venv = venv
        self.random_prob = random_prob
        self.switch_prob = switch_prob

    def initial_mode(self, generator: torch.Generator) -> torch.Tensor:
        """``[B]`` bool: True where the env starts in random mode."""
        return _mode_uniform(self.venv.num_envs, generator) < self.random_prob

    @torch.no_grad()
    def collect(
        self, env_state: VecEnvState, mode_random: torch.Tensor, num_steps: int, generator: torch.Generator
    ) -> Tuple[VecEnvState, torch.Tensor, RolloutChunk]:
        """``num_steps`` steps of the mixture; returns the env state, the mode
        and the ``[T, B]`` chunk (no policy aux: the log-probs would not
        describe the random actions)."""
        venv = self.venv
        B = venv.num_envs
        names = ("obs", "acts", "rews", "next_obs", "terminated", "truncated",
                 "episode_return", "episode_length")
        recs: Dict[str, List[torch.Tensor]] = {k: [] for k in names}
        for _ in range(num_steps):
            obs = env_state.obs
            pol_acts, _ = self.policy_apply(obs, generator)
            rand_acts, u_switch, u_new = _explore_draws(venv.action_space, B, generator)
            m = mode_random.reshape((B,) + (1,) * (pol_acts.dim() - 1))
            acts = torch.where(m, rand_acts.to(pol_acts.dtype), pol_acts)
            env_state, out = venv.step(env_state, acts)
            mode_random = torch.where(u_switch < self.switch_prob, u_new < self.random_prob, mode_random)
            for k, v in (("obs", obs), ("acts", acts), ("rews", out.reward),
                         ("next_obs", out.terminal_obs), ("terminated", out.terminated),
                         ("truncated", out.truncated), ("episode_return", out.episode_return),
                         ("episode_length", out.episode_length)):
                recs[k].append(v)
        chunk = RolloutChunk(aux={}, **{k: torch.stack(v) for k, v in recs.items()})
        return env_state, mode_random, chunk
