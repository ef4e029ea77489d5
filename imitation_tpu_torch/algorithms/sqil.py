"""SQIL: Soft Q Imitation Learning (Reddy et al. 2019).

Port of ``imitation_tpu/algorithms/sqil.py``: off-policy RL (DQN for
discrete actions, SAC for continuous ones) where every sampled batch is
half fresh environment transitions labelled reward 0 and half expert
transitions labelled reward 1. The expert demonstrations sit on the env's
device as one ``TransitionBatch``; the 50/50 relabelled sample is a
``sample_hook`` of the inner learner, so a SQIL step is the learner's own
collect, store and update.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from imitation_tpu_torch.algorithms import base
from imitation_tpu_torch.data.buffer import BufferState, ReplayBuffer
from imitation_tpu_torch.data.types import TransitionBatch
from imitation_tpu_torch.envs.vector import VectorEnv
from imitation_tpu_torch.rl.dqn import DQN, DQNConfig
from imitation_tpu_torch.rl.sac import SAC, SACConfig
from imitation_tpu_torch.util.logger import HierarchicalLogger


def _expert_indices(n_expert: int, n: int, generator: torch.Generator) -> torch.Tensor:
    """``n`` uniform expert-row indices, ``[n]`` int32 on the generator's
    device (tests substitute the JAX package's)."""
    return torch.randint(0, n_expert, (n,), generator=generator, device=generator.device,
                         dtype=torch.int32)


class _GreedyPolicy:
    """A DQN's argmax-Q rollout closures, for ``SQIL.policy``."""

    def __init__(self, rl: DQN):
        self._rl = rl

    def sample_fn(self):
        return self._rl.greedy_fn()

    deterministic_fn = sample_fn


class SQIL(base.DemonstrationAlgorithm):
    """SQIL trainer: ``rl_algo="dqn"`` (discrete), ``"sac"`` (continuous)
    or ``"auto"`` (by the action space)."""

    def __init__(
        self,
        *,
        venv: VectorEnv,
        demonstrations: base.AnyDemonstrations,
        rl_algo: str = "auto",
        dqn_config: DQNConfig = DQNConfig(),
        sac_config: SACConfig = SACConfig(),
        custom_logger: Optional[HierarchicalLogger] = None,
        allow_variable_horizon: bool = False,
        seed: int = 0,
    ):
        self.venv = venv
        self._expert_batch: Optional[TransitionBatch] = None
        super().__init__(
            demonstrations=demonstrations,
            custom_logger=custom_logger,
            allow_variable_horizon=allow_variable_horizon,
        )
        if rl_algo == "auto":
            rl_algo = "dqn" if venv.action_space.is_discrete else "sac"
        if rl_algo not in ("dqn", "sac"):
            raise ValueError(f"rl_algo must be 'dqn' or 'sac', got {rl_algo!r}")
        self.rl_algo_name = rl_algo
        if rl_algo == "dqn":
            self.rl = DQN(venv, dqn_config, sample_hook=self.sample_hook, seed=seed)
        else:
            self.rl = SAC(venv, sac_config, sample_hook=self.sample_hook, seed=seed)
        self.state = self.rl.init_state()

    def sample_hook(
        self, replay: ReplayBuffer, buffer_state: BufferState, generator: torch.Generator,
        batch_size: int,
    ) -> TransitionBatch:
        """``batch_size // 2`` fresh rows relabelled 0, then the rest expert
        rows relabelled 1, concatenated in that order."""
        half = batch_size // 2
        new = replay.sample(buffer_state, half, generator)
        expert = self._expert_batch
        exp = expert.take(_expert_indices(expert.batch_size, batch_size - half, generator))
        new = dataclasses.replace(new, rews=torch.zeros_like(new.rews))
        exp = dataclasses.replace(exp, rews=torch.ones_like(exp.rews))
        return TransitionBatch(**{k: torch.cat([v, getattr(exp, k)]) for k, v in new.fields().items()})

    def set_demonstrations(self, demonstrations: base.AnyDemonstrations) -> None:
        store = base.DemonstrationStore.from_demonstrations(demonstrations, self.venv.device)
        self._expert_batch = store.batch

    @property
    def policy(self):
        """The greedy DQN policy, or SAC's actor (``sample_fn`` /
        ``deterministic_fn``)."""
        if self.rl_algo_name == "dqn":
            return _GreedyPolicy(self.rl)
        return self.rl.policy

    @property
    def policy_variables(self):
        return self.state.variables

    def train(self, *, total_timesteps: int) -> None:
        """Runs the inner learner for ``total_timesteps`` env steps."""
        with self.logger.accumulate_means("sqil"):
            self.state = self.rl.learn(self.state, total_timesteps, logger=None)
        self.logger.dump(self.state.timesteps)
