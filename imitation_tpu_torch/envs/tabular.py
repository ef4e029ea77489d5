"""Tabular model-based MDPs for MCE IRL.

Port of ``imitation_tpu/envs/tabular.py``: a finite MDP given by dense
transition ``T[S, A, S]``, reward ``R[S]``, initial-state and observation
matrices and a fixed horizon, so value iteration and occupancy measures are
matrix programs (``algorithms/mce_irl.py``).

It is also a batched ``Env``: the state is ``[B, 2]`` int64 (state index,
step count), the observation is the observation-matrix row of the state,
and episodes never terminate (the vector engine truncates them at the
horizon). Each draw is a categorical by inversion of one uniform, as
``jax.random.choice(..., p=...)`` draws it: the first index whose
cumulative probability reaches ``cdf[-1] * (1 - u)``. Every uniform comes
from ``_tabular_uniforms``, so tests can feed the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from imitation_tpu_torch.envs.base import Env, Space, TimeStep
from imitation_tpu_torch.parallel import distributed


def _tabular_uniforms(n: int, generator: torch.Generator) -> torch.Tensor:
    """``[n]`` float32 uniforms in ``[0, 1)`` on the generator's device: one
    per categorical draw of a reset or step (tests substitute the JAX
    package's)."""
    return torch.rand((n,), generator=generator, device=generator.device)


def _inverse_cdf(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Index drawn by ``u`` from each row of cumulative probabilities
    (``cdf`` ``[S]`` or ``[B, S]``, ``u`` ``[B]``): ``jax.random.choice``'s
    ``searchsorted(cdf, cdf[-1] * (1 - u))``."""
    r = (cdf[..., -1:] * (1 - u[:, None])).contiguous()
    if cdf.dim() == 1:
        idx = torch.searchsorted(cdf, r[:, 0])
    else:
        idx = torch.searchsorted(cdf.contiguous(), r)[:, 0]
    return idx.clamp_(max=cdf.shape[-1] - 1)


class TabularMDP(Env):
    """Finite MDP: T[S,A,S] transitions, R[S] rewards, fixed horizon."""

    def __init__(
        self,
        transition_matrix: np.ndarray,  # [S, A, S]
        reward_matrix: np.ndarray,  # [S]
        horizon: int,
        initial_state_dist: Optional[np.ndarray] = None,  # [S]
        observation_matrix: Optional[np.ndarray] = None,  # [S, obs_dim]
    ):
        transition_matrix = np.asarray(transition_matrix, np.float32)
        S, A, S2 = transition_matrix.shape
        if S != S2:
            raise ValueError(f"transition matrix not square in states: {transition_matrix.shape}")
        if not np.allclose(transition_matrix.sum(-1), 1.0, atol=1e-5):
            raise ValueError("transition probabilities do not sum to 1")
        self.transition_matrix = transition_matrix
        self.reward_matrix = np.asarray(reward_matrix, np.float32)
        if self.reward_matrix.shape != (S,):
            raise ValueError(f"reward matrix must be [S]={S}, got {self.reward_matrix.shape}")
        self.horizon = horizon
        self.max_episode_steps = horizon
        if initial_state_dist is None:
            initial_state_dist = np.full(S, 1.0 / S, np.float32)
        self.initial_state_dist = np.asarray(initial_state_dist, np.float32)
        if observation_matrix is None:
            observation_matrix = np.eye(S, dtype=np.float32)
        self.observation_matrix = np.asarray(observation_matrix, np.float32)
        self.n_states = S
        self.n_actions = A
        self.obs_dim = self.observation_matrix.shape[1]
        self._on_device: Dict[str, Dict[str, torch.Tensor]] = {}

    @property
    def observation_space(self) -> Space:
        return Space.box(-np.inf, np.inf, (self.obs_dim,))

    @property
    def action_space(self) -> Space:
        return Space.discrete(self.n_actions)

    def tensors(self, device) -> Dict[str, torch.Tensor]:
        """The matrices as float32 tensors on ``device``, copied there once:
        ``T``, ``R``, ``p0``, ``obs`` and the cumulative sums the draws
        invert, ``T_cdf`` (over next states) and ``p0_cdf``."""
        device = torch.device(device)
        key = str(device)
        if key not in self._on_device:
            m = {name: torch.from_numpy(arr).to(device) for name, arr in (
                ("T", self.transition_matrix), ("R", self.reward_matrix),
                ("p0", self.initial_state_dist), ("obs", self.observation_matrix))}
            m["T_cdf"] = torch.cumsum(m["T"], dim=-1)
            m["p0_cdf"] = torch.cumsum(m["p0"], dim=-1)
            self._on_device[key] = m
        return self._on_device[key]

    # -- Env interface (state = [B, 2]: state index, step count) -----------
    def reset(self, n: int, generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        m = self.tensors(generator.device)
        s = _inverse_cdf(m["p0_cdf"], _tabular_uniforms(n, generator))
        state = torch.stack([s, torch.zeros_like(s)], dim=-1)
        return self.obs_of(state), state

    def obs_of(self, state: torch.Tensor) -> torch.Tensor:
        return self.tensors(state.device)["obs"][state[:, 0]]

    def step(self, state: torch.Tensor, action: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, TimeStep]:
        if generator is None:
            raise ValueError("TabularMDP.step draws the next state and needs a generator")
        m = self.tensors(state.device)
        cdf = m["T_cdf"][state[:, 0], action.long()]  # [B, S]
        # A data-parallel rank's rows take their block of the whole batch's draw.
        u = distributed.draw_rows(lambda shape: _tabular_uniforms(shape[0], generator), (state.shape[0],))
        s_next = _inverse_cdf(cdf, u)
        new_state = torch.stack([s_next, state[:, 1] + 1], dim=-1)
        f = torch.zeros((state.shape[0],), dtype=torch.bool, device=state.device)
        return new_state, TimeStep(obs=self.obs_of(new_state), reward=m["R"][s_next],
                                   terminated=f, truncated=f)


def random_mdp(
    n_states: int,
    n_actions: int,
    horizon: int,
    obs_dim: Optional[int] = None,
    branch_factor: int = 2,
    seed: int = 0,
) -> TabularMDP:
    """Random MDP: ``branch_factor`` successors per (s, a) with Dirichlet
    probabilities, normal rewards, a Dirichlet initial distribution and
    one-hot (or, with ``obs_dim``, normal) observations; the JAX package's
    matrices exactly, draw for draw from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    T = np.zeros((n_states, n_actions, n_states), np.float32)
    for s in range(n_states):
        for a in range(n_actions):
            succ = rng.choice(n_states, size=branch_factor, replace=False)
            probs = rng.dirichlet(np.ones(branch_factor))
            T[s, a, succ] = probs
    reward = rng.normal(size=n_states).astype(np.float32)
    if obs_dim is None:
        obs_mat = np.eye(n_states, dtype=np.float32)
    else:
        obs_mat = rng.normal(size=(n_states, obs_dim)).astype(np.float32)
    init = rng.dirichlet(np.ones(n_states)).astype(np.float32)
    return TabularMDP(T, reward, horizon, init, obs_mat)
