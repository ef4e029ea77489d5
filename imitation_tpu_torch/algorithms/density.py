"""Density-based reward modeling via kernel density estimation.

Port of ``imitation_tpu/algorithms/density.py``: fit a Gaussian KDE on
flattened demonstration (s) / (s, a) / (s, s') vectors, use its
log-density as the reward, and train PPO on the relabelled environment.

The KDE is the closed form

    log p(x) = logsumexp_i(-||x - d_i||^2 / (2 h^2)) - log N - (d/2) log(2 pi h^2)

with the squared distances expanded as ``x.x - 2 x.d + d.d``, so the
``[B, N]`` cross term is one ``torch.matmul``, as in the JAX package (which
computes it outside any Pallas kernel). The expansion cancels in float32
and can give slightly negative distances; it is kept as the JAX package
computes it, unclamped, so both agree. It needs full float32 products,
PyTorch's default: with TF32 matmuls the cancellation loses the distances.

Two properties of the JAX package are kept exactly:

* non-stationary density (``is_stationary=False``) scores a transition
  under the mixture of every timestep's KDE, not under its own timestep's
  (upstream imitation uses the transition's own timestep);
* the per-timestep datasets are padded to a common size by tiling their
  rows and truncating, so a timestep whose count does not divide the
  largest repeats some rows more often than others.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional

import numpy as np
import torch

from imitation_tpu_torch.algorithms import base
from imitation_tpu_torch.data import rollout as rollout_mod
from imitation_tpu_torch.data import types
from imitation_tpu_torch.envs.vector import VectorEnv
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.rl.ppo import PPO, PPOConfig
from imitation_tpu_torch.util.logger import HierarchicalLogger


class DensityType(enum.Enum):
    """What the density model conditions on."""

    STATE_DENSITY = enum.auto()
    STATE_ACTION_DENSITY = enum.auto()
    STATE_STATE_DENSITY = enum.auto()


def _f32_log(x: float) -> float:
    """``log`` in float32, as the JAX package takes it of a float32 value."""
    return float(np.log(np.float32(x)))


def gaussian_kde_logpdf(
    x: torch.Tensor,  # [B, d]
    data: torch.Tensor,  # [N, d], or [..., N, d] for a stack of datasets
    bandwidth: float,
) -> torch.Tensor:
    """Batched Gaussian KDE log-density of each row of ``x``: ``[B]``, or
    ``[..., B]`` under a stack of datasets (one KDE each, as ``vmap`` over
    the datasets gives). Matches sklearn's
    ``KernelDensity(kernel="gaussian").score_samples``."""
    d = x.shape[-1]
    x_sq = torch.sum(x * x, dim=-1, keepdim=True)  # [B, 1]
    d_sq = torch.sum(data * data, dim=-1)  # [..., N]
    cross = torch.matmul(x, data.transpose(-1, -2))  # [..., B, N]
    sq_dists = x_sq - 2.0 * cross + d_sq[..., None, :]
    log_kernel = -sq_dists / (2.0 * bandwidth**2)
    n = data.shape[-2]
    log_norm = float(np.float32(_f32_log(n))
                     + np.float32(0.5 * d) * np.float32(_f32_log(2.0 * np.pi * bandwidth**2)))
    return torch.logsumexp(log_kernel, dim=-1) - log_norm


@dataclasses.dataclass
class _Scaler:
    mean: np.ndarray
    std: np.ndarray

    @classmethod
    def fit(cls, data: np.ndarray) -> "_Scaler":
        return cls(mean=data.mean(axis=0), std=data.std(axis=0) + 1e-8)

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        mean, std = (torch.as_tensor(v, device=x.device) for v in (self.mean, self.std))
        return (x - mean) / std


class DensityAlgorithm(base.DemonstrationAlgorithm):
    """KDE reward + PPO training on ``venv``'s device.

    The reward is ``_reward_relabel_fn``, PPO's relabelling hook; the
    fitted model reaches it as the ``reward_params`` of each train step
    (``_reward_params``), so a refit takes effect in the next iteration.
    """

    def __init__(
        self,
        *,
        demonstrations: Optional[base.AnyDemonstrations],
        venv: VectorEnv,
        density_type: DensityType = DensityType.STATE_ACTION_DENSITY,
        kernel: str = "gaussian",
        kernel_bandwidth: float = 0.5,
        rl_algo: Optional[PPO] = None,
        rl_config: Optional[PPOConfig] = None,
        is_stationary: bool = True,
        standardise_inputs: bool = True,
        custom_logger: Optional[HierarchicalLogger] = None,
        allow_variable_horizon: bool = False,
        seed: int = 0,
    ):
        if kernel != "gaussian":
            raise ValueError(f"Unsupported kernel {kernel!r} (gaussian only)")
        self.density_type = density_type
        self.is_stationary = is_stationary
        self.kernel_bandwidth = kernel_bandwidth
        self.standardise = standardise_inputs
        self.venv = venv
        self.device = venv.device
        self._scaler: Optional[_Scaler] = None
        # per-timestep data: {t: [N_t, d]}; stationary uses key None
        self._density_data: Optional[Dict[Optional[int], torch.Tensor]] = None
        self.transitions: Dict[Optional[int], np.ndarray] = {}
        super().__init__(
            demonstrations=demonstrations,
            custom_logger=custom_logger,
            allow_variable_horizon=allow_variable_horizon,
        )
        if rl_algo is None:
            policy = ActorCriticPolicy(
                observation_space=venv.observation_space,
                action_space=venv.action_space,
            )
            rl_algo = PPO(
                venv,
                policy,
                rl_config or PPOConfig(),
                reward_fn=self._reward_relabel_fn,
                seed=seed,
            )
        else:
            # PPO reads its hook at every train step: nothing to re-trace,
            # where the JAX package calls ``rl_algo.rebind()`` here.
            rl_algo.reward_fn = self._reward_relabel_fn
        self.rl_algo = rl_algo
        self.rl_state = None

    # -- demonstration ingestion --------------------------------------------
    def set_demonstrations(self, demonstrations: base.AnyDemonstrations) -> None:
        self.transitions = {}
        if isinstance(demonstrations, (types.TransitionsMinimal, types.TransitionBatch)):
            if not self.is_stationary:
                raise ValueError(
                    "Non-stationary density requires trajectories "
                    "(timestep information).",
                )
            batch = base.demonstrations_to_batch(demonstrations, torch.device("cpu"))
            self.transitions[None] = self._flatten(
                *(x.cpu().numpy() for x in (batch.obs, batch.acts, batch.next_obs)))
            return
        items = list(demonstrations)
        if items and isinstance(items[0], types.Trajectory):
            self._check_fixed_horizon(len(t) for t in items)
            per_key: Dict[Optional[int], List[np.ndarray]] = {}
            for traj in items:
                obs = np.asarray(traj.obs)
                for t in range(len(traj)):
                    key = None if self.is_stationary else t
                    vec = self._flatten(obs[t:t + 1], traj.acts[t:t + 1], obs[t + 1:t + 2])
                    per_key.setdefault(key, []).append(vec[0])
            self.transitions = {k: np.stack(v) for k, v in per_key.items()}
        else:
            batch = base.demonstrations_to_batch(items, torch.device("cpu"))
            self.transitions[None] = self._flatten(
                *(x.cpu().numpy() for x in (batch.obs, batch.acts, batch.next_obs)))

    def _flatten(self, obs, acts, next_obs):
        """Flattened density feature per transition, numpy or torch."""
        obs = obs.reshape(obs.shape[0], -1)
        next_obs = next_obs.reshape(next_obs.shape[0], -1)
        if self.density_type == DensityType.STATE_DENSITY:
            return obs
        if self.density_type == DensityType.STATE_ACTION_DENSITY:
            acts2 = acts.reshape(acts.shape[0], -1)
            if isinstance(obs, torch.Tensor):
                return torch.cat([obs, acts2.to(torch.float32)], dim=1)
            return np.concatenate([obs, np.asarray(acts2).astype(np.float32)], axis=1)
        if self.density_type == DensityType.STATE_STATE_DENSITY:
            if isinstance(obs, torch.Tensor):
                return torch.cat([obs, next_obs], dim=1)
            return np.concatenate([obs, next_obs], axis=1)
        raise ValueError(f"Unknown density type {self.density_type}")

    def train(self) -> None:
        """Fits the density model: the scaler, then each dataset scaled, on
        the venv's device."""
        if not self.transitions:
            raise ValueError("No demonstrations set.")
        all_data = np.concatenate(list(self.transitions.values()))
        if self.standardise:
            self._scaler = _Scaler.fit(all_data)
        self._density_data = {}
        for k, v in self.transitions.items():
            data = torch.as_tensor(np.asarray(v, np.float32), device=self.device)
            if self._scaler is not None:
                data = self._scaler.transform(data)
            self._density_data[k] = data

    # -- RewardFn ------------------------------------------------------------
    def __call__(self, state, action, next_state, done) -> np.ndarray:
        """Host RewardFn: numpy in, numpy out, scored on the device."""
        def dev(x):
            return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)

        with torch.no_grad():
            out = self._reward_relabel_fn(None, dev(state), dev(action), dev(next_state), dev(done))
        return out.cpu().numpy()

    def _reward_relabel_fn(self, params, obs, acts, next_obs, dones) -> torch.Tensor:
        # ``params`` carries the fitted density data and scaler statistics,
        # passed per train step, so a refit takes effect at the next one.
        if params is None:
            params = self._reward_params()
        x = self._flatten(obs, acts, next_obs).to(torch.float32)
        x = (x - params["scale_mean"]) / params["scale_std"]
        data = params["data"]  # [M, N, d] stacked per-timestep (M=1 stationary)
        logs = gaussian_kde_logpdf(x, data, self.kernel_bandwidth)  # [M, B]
        if data.shape[0] == 1:
            return logs[0]
        return torch.logsumexp(logs, dim=0) - _f32_log(data.shape[0])

    def _reward_params(self) -> Dict[str, torch.Tensor]:
        """The fitted density model: ``data`` ``[M, N, d]`` (the datasets,
        each padded to the largest by tiling its rows and truncating) and
        the scaler's ``scale_mean`` and ``scale_std``."""
        if self._density_data is None:
            raise RuntimeError("Call .train() before computing rewards.")
        vals = list(self._density_data.values())
        max_n = max(v.shape[0] for v in vals)
        padded = []
        for v in vals:
            if v.shape[0] < max_n:
                reps = -(-max_n // v.shape[0])
                v = v.repeat(reps, 1)[:max_n]
            padded.append(v)
        data = torch.stack(padded)
        if self._scaler is not None:
            mean, std = (torch.as_tensor(a, device=self.device)
                         for a in (self._scaler.mean, self._scaler.std))
        else:
            d = data.shape[-1]
            mean = torch.zeros((d,), device=self.device)
            std = torch.ones((d,), device=self.device)
        # the data is stored already scaled; the queries are scaled in the reward
        return {"data": data, "scale_mean": mean, "scale_std": std}

    # -- RL on the learned reward ---------------------------------------------
    def train_policy(self, n_timesteps: int = 1_000_000) -> None:
        """``PPO.learn`` for ``n_timesteps`` on the density reward (from a
        fresh ``init_state`` the first time)."""
        if self.rl_state is None:
            self.rl_state = self.rl_algo.init_state()
        self.rl_state = self.rl_algo.learn(
            self.rl_state, n_timesteps, reward_params=self._reward_params()
        )

    def test_policy(self, *, n_trajectories: int = 10, true_reward: bool = True):
        """Rollout stats (true reward) of the trained policy."""
        if self.rl_state is None:
            raise RuntimeError("train_policy first")
        trajs = rollout_mod.generate_trajectories(
            self.policy.sample_fn(),
            self.venv,
            rollout_mod.make_min_episodes(n_trajectories),
            rng=0,
        )
        return rollout_mod.rollout_stats(trajs)

    @property
    def policy(self) -> ActorCriticPolicy:
        return self.rl_algo.policy

    @property
    def policy_variables(self):
        assert self.rl_state is not None
        return self.rl_state.policy
