"""Exploration: a Markov-switching mixture of a policy and uniform random
actions.

Port of the device half of ``imitation_tpu/policies/exploration_wrapper.py``.
Each env holds a mode (policy or random); after every step, with probability
``switch_prob``, the mode is drawn anew (random with probability
``random_prob``). ``collect`` is ``data.rollout.collect`` with the per-env
mode carried from step to step. Every draw of the mixture goes through
``_mode_uniform`` and ``_explore_draws`` (tests substitute the JAX
package's). ``host_policy_fn`` is the same mixture as a per-step policy for
host envs, its mode held on the host.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from imitation_tpu_torch.data.rollout import PolicyApply, RolloutChunk, module_fn
from imitation_tpu_torch.envs.base import Space
from imitation_tpu_torch.envs.vector import VecEnvState, VectorEnv


def _mode_uniform(n: int, generator: torch.Generator) -> torch.Tensor:
    """``[n]`` uniforms in [0, 1) on the generator's device: the initial mode."""
    return torch.rand(n, generator=generator, device=generator.device)


def _explore_draws(space: Space, n: int, generator: torch.Generator):
    """One exploring step's draws: ``n`` uniform random actions, then the
    ``[n]`` uniforms of the switch test and of the new mode."""
    return space.sample(n, generator), _mode_uniform(n, generator), _mode_uniform(n, generator)


def _random_actions(space: Space, n: int, generator: torch.Generator) -> torch.Tensor:
    """``n`` uniform random actions of a host step (tests substitute the
    JAX package's)."""
    return space.sample(n, generator)


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

    def host_policy_fn(self, seed: int = 0) -> PolicyApply:
        """The mixture as a rollout policy ``(obs, generator) -> (acts, {})``
        for host envs (``rollout.generate_trajectories`` on an ``is_host``
        venv), marked ``host_stateful``.

        The per-env mode is host state, drawn from ``numpy``'s generator
        seeded with ``seed`` (first on the first call, then the switch and
        new-mode uniforms after each step); the policy's actions and the
        random ones come from the caller's generator. The function is
        cached on the wrapper, so the mode persists across rollout passes.
        It returns no aux: the policy's log-probs would not describe the
        random actions. Where the policy reads a module, a host collector
        runs it over its CPU snapshot, the mode shared.
        """
        cached = getattr(self, "_host_fn_cache", None)
        if cached is not None:
            return cached
        space, B = self.venv.action_space, self.venv.num_envs
        host_rng = np.random.default_rng(seed)
        mode = {"random": None}

        def make(policy_apply: PolicyApply) -> PolicyApply:
            def f(obs: torch.Tensor, generator: torch.Generator):
                pol_acts, _ = policy_apply(obs, generator)
                rand_acts = _random_actions(space, B, generator).to(pol_acts.dtype)
                pol_acts, rand_acts = pol_acts.cpu().numpy(), rand_acts.cpu().numpy()
                if mode["random"] is None:
                    mode["random"] = host_rng.random(B) < self.random_prob
                m = mode["random"].reshape((B,) + (1,) * (pol_acts.ndim - 1))
                acts = np.where(m, rand_acts, pol_acts)
                switch = host_rng.random(B) < self.switch_prob
                new_mode = host_rng.random(B) < self.random_prob
                mode["random"] = np.where(switch, new_mode, mode["random"])
                return torch.from_numpy(acts).to(obs.device), {}

            f.host_stateful = True
            return f

        module = getattr(self.policy_apply, "module", None)
        if module is None:
            f = make(self.policy_apply)
        else:
            f = module_fn(module, lambda m: make(self.policy_apply.rebind(m)))
            f.host_stateful = True
        self._host_fn_cache = f
        return f
