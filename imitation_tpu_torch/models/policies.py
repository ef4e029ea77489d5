"""Actor-critic policy network and the policy interface.

Port of ``imitation_tpu/models/policies.py``. The JAX package pairs a flax
module definition with a separate variables dict; here ``ActorCriticPolicy``
is an ``nn.Module`` that owns its parameters, and its methods take only the
observations:

* ``value(obs)``, ``dist_and_value(obs)``;
* ``evaluate_actions(obs, acts, update_stats=False)`` -> (log_prob,
  entropy, value), SB3's ``evaluate_actions``;
* ``sample_fn()`` -> a rollout closure
  ``(obs, generator) -> (acts, {"log_prob", "value"})``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from imitation_tpu_torch.envs.base import Space
from imitation_tpu_torch.models import networks
from imitation_tpu_torch.models.distributions import Categorical, DiagGaussian


class ActorCriticNet(nn.Module):
    """Shared-input actor-critic with separate pi/vf MLP torsos.

    SB3's ``ActorCriticPolicy(net_arch=[32, 32])`` (the reference's
    ``FeedForward32Policy``). Continuous actions use a state-independent
    learned ``log_std``. Layer names follow the flax module: ``pi{i}``,
    ``vf{i}``, ``pi_out``, ``vf_out``, ``feat_norm``.
    """

    def __init__(
        self,
        obs_dim: int,
        action_space: Space,
        hid_sizes: Sequence[int] = (32, 32),
        activation: Callable[[torch.Tensor], torch.Tensor] = torch.tanh,
        normalize_features: bool = False,
        log_std_init: float = 0.0,
    ):
        super().__init__()
        self.action_space = action_space
        self.hid_sizes = tuple(hid_sizes)
        self.activation = activation
        self.log_std_init = log_std_init
        self.feat_norm = networks.RunningNorm(obs_dim) if normalize_features else None
        size = obs_dim
        for i, h in enumerate(self.hid_sizes):
            self.add_module(f"pi{i}", networks.dense(size, h))
            self.add_module(f"vf{i}", networks.dense(size, h))
            size = h
        self.vf_out = networks.dense(size, 1)
        if action_space.is_discrete:
            self.pi_out = networks.dense(size, action_space.n)
            self.log_std = None
        else:
            act_dim = action_space.flat_dim
            self.pi_out = networks.dense(size, act_dim)
            self.log_std = nn.Parameter(torch.full((act_dim,), float(log_std_init)))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Re-draws every weight from ``generator`` (flax ``init``)."""
        for i in range(len(self.hid_sizes)):
            networks.init_dense_(getattr(self, f"pi{i}"), generator)
            networks.init_dense_(getattr(self, f"vf{i}"), generator)
        networks.init_dense_(self.vf_out, generator)
        networks.init_dense_(self.pi_out, generator)
        if self.log_std is not None:
            with torch.no_grad():
                self.log_std.fill_(self.log_std_init)
        if self.feat_norm is not None:
            self.feat_norm.reset_stats()

    def forward(self, obs: torch.Tensor, update_stats: bool = False):
        x = obs.reshape(obs.shape[0], -1).float()
        if self.feat_norm is not None:
            x = self.feat_norm(x, update_stats=update_stats)
        pi_x, vf_x = x, x
        for i in range(len(self.hid_sizes)):
            pi_x = self.activation(getattr(self, f"pi{i}")(pi_x))
            vf_x = self.activation(getattr(self, f"vf{i}")(vf_x))
        value = self.vf_out(vf_x).squeeze(-1)
        if self.action_space.is_discrete:
            dist = Categorical(logits=self.pi_out(pi_x))
        else:
            dist = DiagGaussian(mean=self.pi_out(pi_x), log_std=self.log_std)
        return dist, value


class ActorCriticPolicy(nn.Module):
    """An ``ActorCriticNet`` with the policy interface of the JAX package."""

    def __init__(
        self,
        observation_space: Space,
        action_space: Space,
        hid_sizes: Sequence[int] = (32, 32),
        activation: Callable[[torch.Tensor], torch.Tensor] = torch.tanh,
        normalize_features: bool = False,
        log_std_init: float = 0.0,
    ):
        super().__init__()
        self.observation_space = observation_space
        self.action_space = action_space
        self.normalize_features = normalize_features
        obs_dim = observation_space.flat_dim
        self.net = ActorCriticNet(
            obs_dim,
            action_space,
            hid_sizes=hid_sizes,
            activation=activation,
            normalize_features=normalize_features,
            log_std_init=log_std_init,
        )

    def init(self, generator: Optional[torch.Generator] = None) -> "ActorCriticPolicy":
        """Re-initialises the weights from ``generator``; returns self."""
        self.net.reset_parameters(generator)
        return self

    def value(self, obs: torch.Tensor) -> torch.Tensor:
        return self.net(obs)[1]

    def dist_and_value(self, obs: torch.Tensor):
        return self.net(obs)

    def _format_act(self, act: torch.Tensor) -> torch.Tensor:
        if self.action_space.is_discrete:
            return act.to(torch.int32)
        return act.reshape((-1,) + tuple(self.action_space.shape))

    def sample_fn(self):
        """(obs, generator) -> (acts, {log_prob, value}) for rollouts."""

        @torch.no_grad()
        def f(obs: torch.Tensor, generator: Optional[torch.Generator] = None):
            dist, value = self.net(obs)
            acts = dist.sample(generator)
            return self._format_act(acts), {"log_prob": dist.log_prob(acts), "value": value}

        return f

    def evaluate_actions(self, obs: torch.Tensor, acts: torch.Tensor, update_stats: bool = False):
        """Returns (log_prob, entropy, value), SB3's ``evaluate_actions``.

        ``update_stats=True`` folds ``obs`` into the feature normalizer's
        running statistics first (in place).
        """
        dist, value = self.net(obs, update_stats=update_stats)
        if self.action_space.is_discrete:
            acts_in = acts
        else:
            acts_in = acts.reshape(acts.shape[0], -1)
        return dist.log_prob(acts_in), dist.entropy(), value
