"""Maximum Causal Entropy IRL (tabular, finite horizon).

Port of ``imitation_tpu/algorithms/mce_irl.py``:

* ``mce_partition_fh``: soft value iteration by backward recursion,
  ``Q[t] = R + discount * T @ V[t+1]``, ``V[t] = logsumexp_a Q[t]``,
  ``pi = exp(Q - V)``;
* ``mce_occupancy_measures``: the forward pass
  ``D[t+1] = sum_{s,a} D[t][s] pi[t,s,a] T[s,a,:]`` and the discounted sum;
* ``TabularPolicy``: a time-dependent ``pi[t, s, a]`` sampled with numpy;
* ``sample_tabular_trajectories``: episodes of a tabular policy, all chains
  stepped together on the device;
* ``MCEIRL``: gradient descent on ``dot(r_theta, D_pi - D_demo)``, whose
  gradient in ``r`` is the MCE IRL gradient, until the occupancy gap or the
  gradient norm falls below its threshold.

The JAX package scans the horizon recursions; here they are Python loops
of ``[S, A]`` panels, contracted in the JAX package's order (``"sat,t->sa"``
backward; ``D[t] * pi[t]`` then ``"sa,sat->t"`` forward; ``"t,ts->s"`` for
the discounted sum). No Pallas kernel is on this path: these are dense
products and reductions, done by torch's own.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from imitation_tpu_torch import Device, default_device, make_generator
from imitation_tpu_torch.algorithms import base
from imitation_tpu_torch.data import types
from imitation_tpu_torch.envs.tabular import TabularMDP
from imitation_tpu_torch.models.networks import Dense, init_dense_, lecun_normal_
from imitation_tpu_torch.rl.common import Adam
from imitation_tpu_torch.util.logger import HierarchicalLogger


def mce_partition_fh(
    env: TabularMDP,
    *,
    reward: Optional[torch.Tensor] = None,
    discount: float = 1.0,
    device: Optional[Device] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Soft value iteration. Returns (V [T,S], Q [T,S,A], pi [T,S,A]) on the
    reward's device (``device`` when the env's own reward is used)."""
    dev = reward.device if reward is not None else default_device(device)
    m = env.tensors(dev)
    T_mat = m["T"]
    R = (m["R"] if reward is None else reward)[:, None]  # [S, 1] over actions
    Q = R.expand(env.n_states, env.n_actions)
    V = torch.logsumexp(Q, dim=1)
    Vs, Qs = [V], [Q]
    for _ in range(env.horizon - 1):
        Q = R + discount * torch.einsum("sat,t->sa", T_mat, V)
        V = torch.logsumexp(Q, dim=1)
        Vs.append(V)
        Qs.append(Q)
    V = torch.stack(Vs[::-1])  # [T, S]
    Q = torch.stack(Qs[::-1])  # [T, S, A]
    return V, Q, torch.exp(Q - V[:, :, None])


def mce_occupancy_measures(
    env: TabularMDP,
    *,
    pi: Optional[torch.Tensor] = None,
    reward: Optional[torch.Tensor] = None,
    discount: float = 1.0,
    device: Optional[Device] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expected state visitations. Returns (Dt [T,S], D [S]): ``Dt[0]`` is
    the initial distribution, ``D`` the discounted sum over time."""
    if pi is None:
        _, _, pi = mce_partition_fh(env, reward=reward, discount=discount, device=device)
    elif not isinstance(pi, torch.Tensor):
        pi = torch.as_tensor(np.asarray(pi, np.float32), device=default_device(device))
    m = env.tensors(pi.device)
    T_mat = m["T"]
    D = m["p0"]
    Dts = [D]
    for t in range(env.horizon - 1):
        D = torch.einsum("sa,sat->t", D[:, None] * pi[t], T_mat)
        Dts.append(D)
    Dt = torch.stack(Dts)  # [T, S]
    discounts = discount ** torch.arange(env.horizon, dtype=torch.float32, device=pi.device)
    return Dt, torch.einsum("t,ts->s", discounts, Dt)


class TabularPolicy:
    """Time-dependent tabular policy pi[t, s, a], sampled on the host."""

    def __init__(self, env: TabularMDP, pi: np.ndarray, rng: int = 0):
        self.env = env
        self.pi = np.asarray(pi)
        assert self.pi.shape == (env.horizon, env.n_states, env.n_actions)
        self.rng = np.random.default_rng(rng)

    def set_pi(self, pi: np.ndarray) -> None:
        assert np.allclose(pi.sum(-1), 1.0, atol=1e-4)
        assert (pi >= 0).all()
        self.pi = np.asarray(pi)

    def predict(self, states: np.ndarray, timesteps: np.ndarray) -> np.ndarray:
        """Sample actions for (state, t) pairs."""
        out = np.empty(len(states), np.int64)
        for i, (s, t) in enumerate(zip(states, timesteps)):
            out[i] = self.rng.choice(self.env.n_actions, p=self.pi[t, s])
        return out


def _gumbel(shape: Sequence[int], generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, ``u`` uniform in
    ``[tiny, 1)``, as ``jax.random.gumbel`` draws it (tests substitute the
    JAX package's draws)."""
    u = torch.rand(tuple(shape), generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))


def sample_tabular_trajectories(
    env: TabularMDP,
    pi: torch.Tensor,  # [T, S, A]
    n_episodes: int,
    generator: torch.Generator,
) -> List[types.TrajectoryWithRew]:
    """``n_episodes`` episodes of ``pi``, all chains stepped together on the
    generator's device: the initial states as the env's ``reset`` draws them, each
    action and next state by the Gumbel-max of its log-probabilities
    (``jax.random.categorical``)."""
    dev = generator.device
    m = env.tensors(dev)
    pi = torch.as_tensor(pi, dtype=torch.float32, device=dev)
    s = env.reset(n_episodes, generator)[1][:, 0]  # the env's own initial draw
    ss, aa, sn = [], [], []
    for t in range(env.horizon):
        logits = torch.log(torch.clamp(pi[t, s], min=1e-30))  # [B, A]
        a = torch.argmax(_gumbel((n_episodes, env.n_actions), generator) + logits, dim=-1)
        probs = m["T"][s, a]  # [B, S]
        s_next = torch.argmax(_gumbel((n_episodes, env.n_states), generator)
                              + torch.log(torch.clamp(probs, min=1e-30)), dim=-1)
        ss.append(s)
        aa.append(a)
        sn.append(s_next)
        s = s_next
    ss, aa, sn = (torch.stack(x).cpu().numpy() for x in (ss, aa, sn))  # [T, B]
    rr = env.reward_matrix[sn]
    trajs = []
    for b in range(n_episodes):
        state_seq = np.concatenate([ss[:, b], sn[-1:, b]])
        trajs.append(types.TrajectoryWithRew(
            obs=env.observation_matrix[state_seq],
            acts=aa[:, b].astype(np.int32),
            rews=rr[:, b].astype(np.float64),
            infos=None,
            terminal=True,
        ))
    return trajs


class LinearRewardNet(nn.Module):
    """r(s) = w . phi(s) over observation features: the classic MCE IRL
    reward (``MLPRewardNet`` for a nonlinear one)."""

    def __init__(self, obs_dim: int):
        super().__init__()
        self.w = Dense(obs_dim, 1, bias=False)
        self.init()

    def init(self, generator: Optional[torch.Generator] = None) -> "LinearRewardNet":
        """flax ``Dense`` initialisation from ``generator``; returns self."""
        lecun_normal_(self.w.weight, generator)
        return self

    def forward(self, obs_features: torch.Tensor) -> torch.Tensor:
        return self.w(obs_features)[:, 0]


class MLPRewardNet(nn.Module):
    """A relu MLP reward over observation features (layers ``dense{i}``,
    ``out``: the flax names)."""

    def __init__(self, obs_dim: int, hid_sizes: Tuple[int, ...] = (32, 32)):
        super().__init__()
        self.hid_sizes = tuple(hid_sizes)
        sizes = (obs_dim,) + self.hid_sizes
        for i in range(len(self.hid_sizes)):
            setattr(self, f"dense{i}", Dense(sizes[i], sizes[i + 1]))
        self.out = Dense(sizes[-1], 1)
        self.init()

    def init(self, generator: Optional[torch.Generator] = None) -> "MLPRewardNet":
        """flax ``Dense`` initialisation from ``generator``; returns self."""
        for i in range(len(self.hid_sizes)):
            init_dense_(getattr(self, f"dense{i}"), generator)
        init_dense_(self.out, generator)
        return self

    def forward(self, obs_features: torch.Tensor) -> torch.Tensor:
        x = obs_features
        for i in range(len(self.hid_sizes)):
            x = torch.relu(getattr(self, f"dense{i}")(x))
        return self.out(x)[:, 0]


class MCEIRL(base.DemonstrationAlgorithm):
    """Tabular MCE IRL trainer.

    The reward net is re-initialised from ``rng`` and trained with Adam
    (``optimizer_kwargs``: ``lr`` or ``learning_rate``, default 1e-2, and
    Adam's ``b1``, ``b2``, ``eps``; no clipping) on the env's device, CUDA
    unless the caller passes ``device="cpu"``.
    """

    def __init__(
        self,
        demonstrations: Optional[base.AnyDemonstrations],
        env: TabularMDP,
        reward_net: Optional[nn.Module] = None,
        *,
        optimizer_kwargs: Optional[dict] = None,
        discount: float = 1.0,
        linf_eps: float = 1e-3,
        grad_l2_eps: float = 1e-4,
        log_interval: Optional[int] = 100,
        rng: int = 0,
        custom_logger: Optional[HierarchicalLogger] = None,
        device: Optional[Device] = None,
    ):
        self.env = env
        self.discount = discount
        self.linf_eps = linf_eps
        self.grad_l2_eps = grad_l2_eps
        self.log_interval = log_interval
        self.device = default_device(device)
        self.demo_state_om: Optional[np.ndarray] = None
        super().__init__(
            demonstrations=demonstrations, custom_logger=custom_logger,
            allow_variable_horizon=False,
        )
        net = reward_net if reward_net is not None else LinearRewardNet(env.obs_dim)
        self.reward_net = net.to(self.device).init(make_generator(rng, self.device))
        opt_kwargs = dict(optimizer_kwargs or {})
        lr = opt_kwargs.pop("lr", opt_kwargs.pop("learning_rate", 1e-2))
        self.optimizer = Adam(self.reward_net.parameters(), lr, **opt_kwargs)
        self._policy = TabularPolicy(
            env, np.full((env.horizon, env.n_states, env.n_actions),
                         1.0 / env.n_actions), rng=rng,
        )

    # -- demonstrations -> state occupancy ----------------------------------
    def set_demonstrations(self, demonstrations) -> None:
        env = self.env
        if isinstance(demonstrations, torch.Tensor):
            demonstrations = demonstrations.detach().cpu().numpy()
        if isinstance(demonstrations, np.ndarray):
            # raw occupancy-measure vector
            if demonstrations.shape != (env.n_states,):
                raise ValueError(
                    f"OM vector shape {demonstrations.shape} != ({env.n_states},)"
                )
            self.demo_state_om = demonstrations.astype(np.float64)
            return
        obs_mat = np.asarray(env.observation_matrix)

        def state_of(obs_row: np.ndarray) -> int:
            # match obs row back to state index
            d = np.abs(obs_mat - obs_row[None]).sum(1)
            return int(d.argmin())

        om = np.zeros(env.n_states, np.float64)
        items = list(demonstrations) if isinstance(demonstrations, Iterable) else demonstrations
        if isinstance(items, list) and items and isinstance(items[0], types.Trajectory):
            self._check_fixed_horizon(len(t) for t in items)
            for traj in items:
                obs = np.asarray(traj.obs)
                cum_discount = 1.0
                for t in range(len(obs)):
                    om[state_of(obs[t])] += cum_discount
                    if t < len(obs) - 1:
                        cum_discount *= self.discount
            om /= len(items)
        elif isinstance(items, types.TransitionsMinimal) or (
            isinstance(items, list) and items and isinstance(items[0], dict)
        ):
            raise TypeError(
                "MCE IRL requires trajectories or an occupancy-measure vector "
                "(transitions lack episode structure for discounted OM).",
            )
        else:
            raise TypeError(f"unsupported demonstrations type {type(demonstrations)}")
        self.demo_state_om = om

    @property
    def policy(self) -> TabularPolicy:
        return self._policy

    def train(self, max_iter: int = 1000) -> np.ndarray:
        """Gradient loop; returns the final predicted reward ``[S]``.

        Each iteration reads the occupancy gap and the gradient norm on the
        host (two reads, as the JAX package does) to test the stop
        condition."""
        if self.demo_state_om is None:
            raise ValueError("No demonstrations provided")
        env, net = self.env, self.reward_net
        obs_features = env.tensors(self.device)["obs"]
        demo_om = torch.from_numpy(self.demo_state_om.astype(np.float32)).to(self.device)
        for it in range(max_iter):
            self.optimizer.zero_grad()
            r = net(obs_features)
            with torch.no_grad():
                _, D = mce_occupancy_measures(env, reward=r.detach(), discount=self.discount)
            # The gradient of dot(r, D_pi - D_demo) in r is D_pi - D_demo,
            # the MCE IRL gradient.
            torch.dot(r, D - demo_om).backward()
            grad_norm = self.optimizer.step()
            linf = torch.max(torch.abs(D - demo_om))
            linf_f, grad_f = float(linf), float(grad_norm)
            if self.log_interval is not None and it % self.log_interval == 0:
                self.logger.record("iteration", it)
                self.logger.record("linf_delta", linf_f)
                self.logger.record("grad_norm", grad_f)
                self.logger.dump(it)
            if linf_f <= self.linf_eps or grad_f <= self.grad_l2_eps:
                break
        with torch.no_grad():
            predicted_r = net(obs_features)
            _, _, pi = mce_partition_fh(env, reward=predicted_r, discount=self.discount)
        self._policy.set_pi(pi.cpu().numpy())
        return predicted_r.cpu().numpy()
