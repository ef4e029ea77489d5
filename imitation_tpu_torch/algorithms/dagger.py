"""DAgger: Dataset Aggregation (Ross et al. 2011).

Port of ``imitation_tpu/algorithms/dagger.py``. Round-based:
collect demonstrations with a beta-mixture of expert and robot actions, then
run BC on all demonstrations gathered so far.

* ``LinearBetaSchedule`` / ``ExponentialBetaSchedule``: beta per round.
* ``InteractiveTrajectoryCollector``: one uniform draw per env per step from
  the collector's generator picks the stepped action, the expert's where it
  is below beta and the robot's otherwise; the saved demonstration always
  records the expert's action (carried in the rollout's ``aux``).
* Each round's demos go to ``{scratch_dir}/demos/round-XXX`` in the ``.npz``
  format, and BC retrains on all rounds so far, ``DEFAULT_N_EPOCHS = 4``
  epochs by default.
* ``save_trainer`` writes ``checkpoint-XXX.pt`` and ``checkpoint-latest.pt``,
  a ``torch.save`` of the trainer's state (not of the object), and the
  policy to ``policy-XXX`` and ``policy-latest``; ``reconstruct_trainer``
  rebuilds a trainer that continues as the saved one would have.

On a host vector env (``venv.is_host``) the collector steps the env through
``data.rollout.HostCollector``, the mixture running on CPU copies of the
modules it reads; the expert's policy must then run on host tensors, as the
scripted experts do.
"""

from __future__ import annotations

import abc
import os
import pathlib
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from imitation_tpu_torch import make_generator
from imitation_tpu_torch.algorithms import base
from imitation_tpu_torch.algorithms.bc import BC
from imitation_tpu_torch.data import rollout as rollout_mod
from imitation_tpu_torch.data import serialize, types
from imitation_tpu_torch.envs.vector import VectorEnv
from imitation_tpu_torch.util.logger import HierarchicalLogger

DEFAULT_N_EPOCHS: int = 4


class BetaSchedule(abc.ABC):
    """Computes beta, the probability of stepping the expert's action, per round."""

    @abc.abstractmethod
    def __call__(self, round_num: int) -> float:
        ...


class LinearBetaSchedule(BetaSchedule):
    """beta falling linearly from 1 to 0 over ``rampdown_rounds`` rounds."""

    def __init__(self, rampdown_rounds: int = 15):
        self.rampdown_rounds = rampdown_rounds

    def __call__(self, round_num: int) -> float:
        assert round_num >= 0
        return min(1.0, max(0.0, (self.rampdown_rounds - round_num) / self.rampdown_rounds))


class ExponentialBetaSchedule(BetaSchedule):
    """beta = decay_probability ** round."""

    def __init__(self, decay_probability: float):
        if not (0 <= decay_probability <= 1):
            raise ValueError("decay_probability lies outside the range [0, 1].")
        self.decay_probability = decay_probability

    def __call__(self, round_num: int) -> float:
        assert round_num >= 0
        return self.decay_probability**round_num


def _save_dagger_demo(
    trajectory: types.TrajectoryWithRew,
    trajectory_index: int,
    save_dir: str,
    prefix: str = "",
) -> None:
    """Saves one demo trajectory as ``save_dir/[prefix-]dagger-demo-i``."""
    save_dir = pathlib.Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    actual_prefix = f"{prefix}-" if prefix else ""
    serialize.save(str(save_dir / f"{actual_prefix}dagger-demo-{trajectory_index}"), [trajectory])


class NeedsDemosException(Exception):
    """Demos need to be collected before training."""


def _mixture_mask(n: int, beta: float, generator: torch.Generator) -> torch.Tensor:
    """``[n]`` bool, True where the expert's action is stepped (tests
    substitute the JAX package's draws)."""
    return torch.rand((n,), generator=generator, device=generator.device) < beta


class InteractiveTrajectoryCollector:
    """Collects beta-mixture rollouts on a device or host env, recording the
    expert's actions, and saves the finished episodes to ``save_dir``."""

    def __init__(
        self,
        venv: VectorEnv,
        robot_policy_apply: rollout_mod.PolicyApply,
        beta: float,
        save_dir: str,
        rng: np.random.Generator,
    ):
        self.venv = venv
        self.robot_policy_apply = robot_policy_apply
        self.beta = beta
        self.save_dir = save_dir
        self.rng = rng
        self.traj_index = 0

    def _mixture_policy_apply(self, expert_apply: rollout_mod.PolicyApply) -> rollout_mod.PolicyApply:
        beta = self.beta

        def make(expert_apply: rollout_mod.PolicyApply, robot_apply: rollout_mod.PolicyApply):
            def apply(obs: torch.Tensor, generator: torch.Generator):
                expert_acts, _ = expert_apply(obs, generator)
                robot_acts, _ = robot_apply(obs, generator)
                use_expert = _mixture_mask(obs.shape[0], beta, generator)
                mask = use_expert.reshape((-1,) + (1,) * (expert_acts.dim() - 1))
                acts = torch.where(mask, expert_acts, robot_acts)
                return acts, {"expert_acts": expert_acts}

            return apply

        fns = (expert_apply, self.robot_policy_apply)
        modules = [getattr(fn, "module", None) for fn in fns]
        if all(m is None for m in modules):
            return make(*fns)

        # Marked for a host collector, which rebuilds the mixture over CPU
        # copies of the modules that the two policies read.
        def rebind(held: nn.ModuleList) -> rollout_mod.PolicyApply:
            copies = iter(held)
            return make(*(fn if m is None else fn.rebind(next(copies)) for fn, m in zip(fns, modules)))

        return rollout_mod.module_fn(nn.ModuleList([m for m in modules if m is not None]), rebind)

    def collect_trajectories(
        self,
        expert_apply: rollout_mod.PolicyApply,
        sample_until: rollout_mod.GenTrajTerminationFn,
        *,
        chunk_size: int = 128,
        seed: int = 0,
    ) -> Sequence[types.TrajectoryWithRew]:
        """Rolls out the mixture until ``sample_until`` holds; returns and
        saves the episodes, each labelled with the expert's actions."""
        mixture = self._mixture_policy_apply(expert_apply)
        accum = rollout_mod.TrajectoryAccumulator(self.venv.num_envs)
        collected: List[types.TrajectoryWithRew] = []
        if getattr(self.venv, "is_host", False):
            collector = rollout_mod.HostCollector(self.venv, mixture, seed=seed)
            while not sample_until(collected):
                chunk = collector.collect(chunk_size, device="cpu")
                collected.extend(accum.add_chunk(chunk.replace(acts=chunk.aux["expert_acts"])))
        else:
            generator = make_generator(seed, self.venv.device)
            state = self.venv.reset(generator)
            while not sample_until(collected):
                state, chunk = rollout_mod.collect(self.venv, mixture, state, chunk_size, generator)
                # Demonstrations record the EXPERT action, not the stepped one.
                collected.extend(accum.add_chunk(chunk.replace(acts=chunk.aux["expert_acts"])))
        for traj in collected:
            _save_dagger_demo(traj, self.traj_index, self.save_dir)
            self.traj_index += 1
        return collected


class DAggerTrainer(base.BaseImitationAlgorithm):
    """The round-based DAgger API: collect with ``create_trajectory_collector``,
    then ``extend_and_update``."""

    DEFAULT_N_EPOCHS: int = DEFAULT_N_EPOCHS

    def __init__(
        self,
        *,
        venv: VectorEnv,
        scratch_dir: Union[str, os.PathLike],
        rng: Union[int, np.random.Generator] = 0,
        beta_schedule: Optional[BetaSchedule] = None,
        bc_trainer: Optional[BC] = None,
        custom_logger: Optional[HierarchicalLogger] = None,
    ):
        super().__init__(custom_logger=custom_logger)
        if beta_schedule is None:
            beta_schedule = LinearBetaSchedule(15)
        self.beta_schedule = beta_schedule
        self.scratch_dir = pathlib.Path(scratch_dir)
        self.venv = venv
        self.round_num = 0
        self._last_loaded_round = -1
        self._all_demos: List[types.Trajectory] = []
        self.rng = rng if isinstance(rng, np.random.Generator) else np.random.default_rng(rng)
        if bc_trainer is None:
            bc_trainer = BC(
                observation_space=venv.observation_space,
                action_space=venv.action_space,
                rng=int(self.rng.integers(0, 2**31 - 1)),
                device=venv.device,
            )
        self.bc_trainer = bc_trainer
        self.bc_trainer.logger = self.logger

    @property
    def policy(self):
        return self.bc_trainer.policy

    @property
    def batch_size(self) -> int:
        return self.bc_trainer.batch_size

    def _demo_dir_path_for_round(self, round_num: Optional[int] = None) -> pathlib.Path:
        if round_num is None:
            round_num = self.round_num
        return self.scratch_dir / "demos" / f"round-{round_num:03d}"

    def _try_load_demos(self) -> None:
        """Loads the demos of every round not yet loaded, up to this one."""
        demo_dir = self._demo_dir_path_for_round()
        demo_paths = sorted(p for p in demo_dir.iterdir() if p.is_dir()) if demo_dir.is_dir() else []
        if len(demo_paths) == 0:
            raise NeedsDemosException(
                f"No demos found for round {self.round_num} in dir '{demo_dir}'. "
                f"Maybe you need to collect some demos? See "
                f".create_trajectory_collector()",
            )
        if self._last_loaded_round < self.round_num:
            for r in range(self._last_loaded_round + 1, self.round_num + 1):
                rdir = self._demo_dir_path_for_round(r)
                if not rdir.is_dir():
                    continue
                for p in sorted(q for q in rdir.iterdir() if q.is_dir()):
                    self._all_demos.extend(serialize.load(str(p)))
            self._last_loaded_round = self.round_num
        self._check_fixed_horizon(len(t) for t in self._all_demos)
        self.bc_trainer.set_demonstrations(self._all_demos)

    def extend_and_update(self, bc_train_kwargs: Optional[dict] = None) -> int:
        """Loads the new rounds' demos, trains BC on all of them (by default
        ``DEFAULT_N_EPOCHS`` epochs, evaluated on ``venv``) and returns the
        new round number."""
        bc_train_kwargs = dict(bc_train_kwargs or {})
        bc_train_kwargs.setdefault("log_rollouts_venv", self.venv)
        if "n_epochs" not in bc_train_kwargs and "n_batches" not in bc_train_kwargs:
            bc_train_kwargs["n_epochs"] = self.DEFAULT_N_EPOCHS
        self.logger.info("Loading demonstrations")
        self._try_load_demos()
        self.logger.info(f"Training at round {self.round_num}")
        self.bc_trainer.train(**bc_train_kwargs)
        self.round_num += 1
        self.logger.info(f"New round number is {self.round_num}")
        return self.round_num

    def create_trajectory_collector(self) -> InteractiveTrajectoryCollector:
        """A collector for this round's beta, saving into this round's dir."""
        return InteractiveTrajectoryCollector(
            venv=self.venv,
            robot_policy_apply=self.bc_trainer.policy.sample_fn(),
            beta=self.beta_schedule(self.round_num),
            save_dir=str(self._demo_dir_path_for_round()),
            rng=self.rng,
        )

    def _checkpoint_state(self) -> dict:
        return {
            "round_num": self.round_num,
            "last_loaded_round": self._last_loaded_round,
            "all_demos": self._all_demos,
            "beta_schedule": self.beta_schedule,
            "scratch_dir": str(self.scratch_dir),
            "allow_variable_horizon": self.allow_variable_horizon,
            "rng": self.rng.bit_generator.state,
            "bc": self.bc_trainer.state_dict(),
            "expert_policy_apply": None,
        }

    def save_trainer(self) -> Tuple[pathlib.Path, pathlib.Path]:
        """Checkpoints the trainer and saves its policy; returns the paths of
        the latest checkpoint and policy. The beta schedule and the expert
        are pickled by reference, so they must be importable (no lambdas)."""
        self.scratch_dir.mkdir(parents=True, exist_ok=True)
        state = self._checkpoint_state()
        checkpoint_paths = [
            self.scratch_dir / f"checkpoint-{self.round_num:03d}.pt",
            self.scratch_dir / "checkpoint-latest.pt",
        ]
        for path in checkpoint_paths:
            torch.save(state, path)
        policy_paths = [
            self.scratch_dir / f"policy-{self.round_num:03d}",
            self.scratch_dir / "policy-latest",
        ]
        for path in policy_paths:
            self.bc_trainer.save_policy(str(path))
        return checkpoint_paths[1], policy_paths[1]


def reconstruct_trainer(
    scratch_dir: Union[str, os.PathLike],
    venv: VectorEnv,
    custom_logger: Optional[HierarchicalLogger] = None,
) -> DAggerTrainer:
    """Rebuilds the trainer ``save_trainer`` last saved in ``scratch_dir``,
    on ``venv`` and its device."""
    path = pathlib.Path(scratch_dir, "checkpoint-latest.pt")
    # The checkpoint holds numpy arrays, trajectories and the schedule this
    # program pickled, so it is not a weights-only file.
    state = torch.load(path, map_location="cpu", weights_only=False)
    bc = BC.from_state_dict(state["bc"], device=venv.device, custom_logger=custom_logger)
    kwargs = dict(venv=venv, scratch_dir=state["scratch_dir"], beta_schedule=state["beta_schedule"],
                  bc_trainer=bc, custom_logger=custom_logger)
    if state["expert_policy_apply"] is not None:
        trainer = SimpleDAggerTrainer(expert_policy_apply=state["expert_policy_apply"], **kwargs)
    else:
        trainer = DAggerTrainer(**kwargs)
    trainer.allow_variable_horizon = state["allow_variable_horizon"]
    trainer.round_num = state["round_num"]
    trainer._last_loaded_round = state["last_loaded_round"]
    trainer._all_demos = list(state["all_demos"])
    trainer.rng.bit_generator.state = state["rng"]
    return trainer


class SimpleDAggerTrainer(DAggerTrainer):
    """The DAgger loop with an expert policy closure to query."""

    def __init__(
        self,
        *,
        venv: VectorEnv,
        scratch_dir: Union[str, os.PathLike],
        expert_policy_apply: rollout_mod.PolicyApply,
        rng: Union[int, np.random.Generator] = 0,
        expert_trajs: Optional[Sequence[types.Trajectory]] = None,
        **dagger_trainer_kwargs,
    ):
        super().__init__(venv=venv, scratch_dir=scratch_dir, rng=rng, **dagger_trainer_kwargs)
        self.expert_policy_apply = expert_policy_apply
        if expert_trajs is not None:
            # Pre-existing demos go into round 0.
            for traj_index, traj in enumerate(expert_trajs):
                _save_dagger_demo(traj, traj_index, str(self._demo_dir_path_for_round()),
                                  prefix="initial_data")

    def _checkpoint_state(self) -> dict:
        return dict(super()._checkpoint_state(), expert_policy_apply=self.expert_policy_apply)

    def train(
        self,
        total_timesteps: int,
        *,
        rollout_round_min_episodes: int = 3,
        rollout_round_min_timesteps: int = 500,
        bc_train_kwargs: Optional[dict] = None,
        on_round_end: Optional[Callable[[int, int], None]] = None,
    ) -> None:
        """Alternates collection and BC until ``total_timesteps`` env steps
        have been collected in this call. ``on_round_end(round_num,
        total_timestep_count)``, if given, runs after each round's BC update."""
        total_timestep_count = 0
        round_num = 0
        while total_timestep_count < total_timesteps:
            collector = self.create_trajectory_collector()
            sample_until = rollout_mod.make_sample_until(
                min_timesteps=max(rollout_round_min_timesteps, self.batch_size),
                min_episodes=rollout_round_min_episodes,
            )
            trajectories = collector.collect_trajectories(
                self.expert_policy_apply,
                sample_until,
                seed=int(self.rng.integers(0, 2**31 - 1)),
            )
            round_timestep_count = 0
            for traj in trajectories:
                self._logger.record_mean("dagger/mean_episode_reward", float(np.sum(traj.rews)))
                round_timestep_count += len(traj)
            total_timestep_count += round_timestep_count
            self._logger.record("dagger/total_timesteps", total_timestep_count)
            self._logger.record("dagger/round_num", round_num)
            self._logger.record("dagger/round_episode_count", len(trajectories))
            self._logger.record("dagger/round_timestep_count", round_timestep_count)
            self.extend_and_update(bc_train_kwargs)
            round_num += 1
            if on_round_end is not None:
                on_round_end(round_num, total_timestep_count)
