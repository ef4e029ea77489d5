"""Reward networks.

Port of ``imitation_tpu/rewards/reward_nets.py`` for array observations: the
``RewardNet`` base (preprocessing, ``predict_processed``), ``BasicRewardNet``,
the potential-shaped nets (``BasicPotentialMLP``, ``ShapedRewardNet``,
``BasicShapedRewardNet``), and the wrappers of preference comparisons:
``NormalizedRewardNet``, ``RewardEnsemble`` and ``AddSTDRewardWrapper``. A
reward net maps ``(obs, acts, next_obs, dones)`` to rewards ``[B]``; the
forward is the training path, ``predict_processed`` the inference path
(output normalization, ensemble mean). The image nets (``CnnRewardNet``,
``BasicPotentialCNN``) are not ported.

Preprocessing matches SB3's ``preprocess_obs`` as the JAX package does it:
discrete spaces one-hot, continuous spaces flattened to float32, integer
(image) spaces scaled to [0, 1].
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Type

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from imitation_tpu_torch.envs.base import Space
from imitation_tpu_torch.models import networks


def preprocess_space(space: Space, x: torch.Tensor) -> torch.Tensor:
    """One-hot discrete, flatten + cast continuous."""
    if space.is_discrete:
        return F.one_hot(x.long(), space.n).float()
    x = x.float()
    if np.issubdtype(np.dtype(space.dtype), np.integer):
        hi = float(np.max(space.high)) if space.high is not None else 255.0
        x = x / hi
    return x.reshape(x.shape[0], -1)


class RewardNet(nn.Module):
    """Base reward net: subclasses implement ``forward``."""

    def __init__(self, observation_space: Space, action_space: Space):
        super().__init__()
        self.observation_space = observation_space
        self.action_space = action_space

    def preprocess(self, obs, acts, next_obs, dones):
        return (
            preprocess_space(self.observation_space, obs),
            preprocess_space(self.action_space, acts),
            preprocess_space(self.observation_space, next_obs),
            dones.float(),
        )

    def predict_processed(self, obs, acts, next_obs, dones, update_stats: bool = False):
        return self(obs, acts, next_obs, dones)

    def init(self, generator: Optional[torch.Generator] = None) -> "RewardNet":
        """Re-initialises the weights from ``generator``; returns self."""
        raise NotImplementedError


class BasicRewardNet(RewardNet):
    """MLP over any subset of (s, a, s', done); defaults (s, a), (32, 32) relu.

    With ``num_members=M`` it is M such nets in one module (a
    ``RewardEnsemble``'s members, ``nn.vmap`` of the JAX net): the MLP is a
    ``StackedMLP`` and the input normalizer keeps per-member statistics. The
    forward then returns ``[M, B]``, from inputs shared by all members or
    from one set per member (``obs [M, B, ...]``, ``dones [M, B]``).
    """

    def __init__(
        self,
        observation_space: Space,
        action_space: Space,
        use_state: bool = True,
        use_action: bool = True,
        use_next_state: bool = False,
        use_done: bool = False,
        hid_sizes: Sequence[int] = (32, 32),
        activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
        normalize_input: bool = False,
        num_members: Optional[int] = None,
    ):
        super().__init__(observation_space, action_space)
        self.num_members = num_members
        self.use_state = use_state
        self.use_action = use_action
        self.use_next_state = use_next_state
        self.use_done = use_done
        in_size = (
            observation_space.flat_dim * (int(use_state) + int(use_next_state))
            + (action_space.flat_dim if use_action else 0)
            + int(use_done)
        )
        self.input_norm = (
            networks.RunningNorm(in_size, members=num_members) if normalize_input else None
        )
        if num_members is None:
            self.mlp = networks.MLP(
                in_size, hid_sizes, out_size=1, activation=activation, squeeze_output=True
            )
        else:
            self.mlp = networks.StackedMLP(
                num_members, in_size, hid_sizes, out_size=1, activation=activation,
                squeeze_output=True,
            )

    def init(self, generator: Optional[torch.Generator] = None) -> "BasicRewardNet":
        self.mlp.reset_parameters(generator)
        if self.input_norm is not None:
            self.input_norm.reset_stats()
        return self

    def forward(self, obs, acts, next_obs, dones, update_stats: bool = False):
        lead = tuple(dones.shape[:-1])  # (M,) for per-member inputs, else ()
        if lead:
            def flat(x):
                return x.reshape((-1,) + tuple(x.shape[2:]))

            obs, acts, next_obs, dones = flat(obs), flat(acts), flat(next_obs), dones.reshape(-1)
        obs_p, acts_p, next_obs_p, dones_p = self.preprocess(obs, acts, next_obs, dones)
        inputs = []
        if self.use_state:
            inputs.append(obs_p)
        if self.use_action:
            inputs.append(acts_p)
        if self.use_next_state:
            inputs.append(next_obs_p)
        if self.use_done:
            inputs.append(dones_p[:, None])
        x = torch.cat(inputs, dim=-1)
        if lead:
            x = x.reshape(lead + (-1, x.shape[-1]))
        elif self.num_members is not None and self.input_norm is not None:
            x = x.expand(self.num_members, -1, -1)
        if self.input_norm is not None:
            x = self.input_norm(x, update_stats=update_stats)
        return self.mlp(x)


class BasicPotentialMLP(nn.Module):
    """State-only potential function phi(s): a (32, 32) relu MLP."""

    def __init__(self, observation_space: Space, hid_sizes: Sequence[int] = (32, 32)):
        super().__init__()
        self.observation_space = observation_space
        self.mlp = networks.MLP(
            observation_space.flat_dim, hid_sizes, out_size=1, squeeze_output=True
        )

    def init(self, generator: Optional[torch.Generator] = None) -> "BasicPotentialMLP":
        self.mlp.reset_parameters(generator)
        return self

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.mlp(preprocess_space(self.observation_space, obs))


class ShapedRewardNet(RewardNet):
    """Potential shaping: r'(s,a,s') = r(s,a,s') + gamma*phi(s')*(1-done) - phi(s).

    The ``(1-done)`` factor zeroes the terminal new-state potential, so the
    shaping leaves optimal policies unchanged at episode ends. ``update_stats``
    reaches only the base (the potential has no normalizer).
    """

    def __init__(self, base: RewardNet, potential: nn.Module, discount_factor: float = 0.99):
        super().__init__(base.observation_space, base.action_space)
        self.base = base
        self.potential = potential
        self.discount_factor = discount_factor

    def init(self, generator: Optional[torch.Generator] = None) -> "ShapedRewardNet":
        self.base.init(generator)
        self.potential.init(generator)
        return self

    def forward(self, obs, acts, next_obs, dones, update_stats: bool = False):
        base_out = self.base(obs, acts, next_obs, dones, update_stats=update_stats)
        new_pot = self.potential(next_obs)
        old_pot = self.potential(obs)
        d = dones.float()
        return base_out + self.discount_factor * (1.0 - d) * new_pot - old_pot

    def base_forward(self, obs, acts, next_obs, dones):
        """The unshaped base reward (AIRL's transferable ``reward_test``)."""
        return self.base(obs, acts, next_obs, dones)


def BasicShapedRewardNet(
    observation_space: Space,
    action_space: Space,
    *,
    reward_hid_sizes: Sequence[int] = (32,),
    potential_hid_sizes: Sequence[int] = (32, 32),
    discount_factor: float = 0.99,
    **kwargs,
) -> ShapedRewardNet:
    """An MLP reward (``BasicRewardNet`` over ``(s, a)``, hid ``reward_hid_sizes``;
    ``kwargs`` go to it) shaped by an MLP potential (hid ``potential_hid_sizes``)."""
    base = BasicRewardNet(observation_space, action_space, hid_sizes=reward_hid_sizes, **kwargs)
    potential = BasicPotentialMLP(observation_space, hid_sizes=potential_hid_sizes)
    return ShapedRewardNet(base, potential, discount_factor=discount_factor)


class NormalizedRewardNet(RewardNet):
    """Output normalization for inference: the forward (training path)
    returns the raw base reward; ``predict_processed`` standardizes it by a
    width-1 ``RunningNorm`` or ``EMANorm`` of the outputs, folding the batch
    into the statistics first where ``update_stats`` (the default, as in the
    JAX package). Over a member-stacked base (``num_members=M``) the
    normalizer keeps one set of statistics per member."""

    def __init__(self, base: RewardNet, normalize_cls: Type[networks.NormLayer] = networks.RunningNorm):
        super().__init__(base.observation_space, base.action_space)
        self.base = base
        self.normalize_cls = normalize_cls
        self.normalizer = normalize_cls(1, members=getattr(base, "num_members", None))

    def init(self, generator: Optional[torch.Generator] = None) -> "NormalizedRewardNet":
        self.base.init(generator)
        self.normalizer.reset_stats()
        return self

    def forward(self, obs, acts, next_obs, dones, update_stats: bool = False):
        return self.base(obs, acts, next_obs, dones)

    def predict_processed(self, obs, acts, next_obs, dones, update_stats: bool = True):
        rew = self.base(obs, acts, next_obs, dones)
        return self.normalizer(rew[..., None], update_stats=update_stats)[..., 0]


class RewardEnsemble(RewardNet):
    """``num_members`` reward nets with mean and variance predictions.

    The members are one ``BasicRewardNet(num_members=M)`` module (``members``):
    each layer's member weights are stacked and all members are evaluated by
    one batched product per layer. With ``member_normalize_cls`` the members
    are wrapped in a ``NormalizedRewardNet`` with per-member output
    statistics. The forward (training path) returns the raw member outputs
    ``[M, B]``; ``predict_processed`` their mean. Only ``BasicRewardNet``
    members are ported.
    """

    def __init__(
        self,
        observation_space: Space,
        action_space: Space,
        member_cls: Type[RewardNet] = BasicRewardNet,
        num_members: int = 3,
        member_kwargs: Optional[dict] = None,
        member_normalize_cls: Optional[Type[networks.NormLayer]] = None,
    ):
        super().__init__(observation_space, action_space)
        if num_members < 2:
            raise ValueError("Must be at least 2 member in the ensemble.")
        if member_cls is not BasicRewardNet:
            raise NotImplementedError("only BasicRewardNet ensemble members are ported")
        self.member_cls = member_cls
        self.num_members = num_members
        self.member_kwargs = dict(member_kwargs or {})
        self.member_normalize_cls = member_normalize_cls
        members: RewardNet = BasicRewardNet(
            observation_space, action_space, num_members=num_members, **self.member_kwargs
        )
        if member_normalize_cls is not None:
            members = NormalizedRewardNet(members, member_normalize_cls)
        self.members = members

    def init(self, generator: Optional[torch.Generator] = None) -> "RewardEnsemble":
        self.members.init(generator)
        return self

    def forward(self, obs, acts, next_obs, dones, update_stats: bool = False):
        """``[M, B]`` raw member outputs; per-member inputs (``[M, B, ...]``)
        give each member its own rows."""
        return self.members(obs, acts, next_obs, dones)

    def predict_processed_all(self, obs, acts, next_obs, dones, update_stats: bool = False):
        """``[M, B]`` per-member processed rewards."""
        return self.members.predict_processed(obs, acts, next_obs, dones, update_stats=update_stats)

    def predict_reward_moments(
        self, obs, acts, next_obs, dones, update_stats: bool = False
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean ``[B]``, variance ``[B]``) across members, the variance with
        ddof 1."""
        all_r = self.predict_processed_all(obs, acts, next_obs, dones, update_stats=update_stats)
        return all_r.mean(dim=0), all_r.var(dim=0, unbiased=True)

    def predict_processed(self, obs, acts, next_obs, dones, update_stats: bool = False):
        return self.predict_reward_moments(obs, acts, next_obs, dones, update_stats=update_stats)[0]


class AddSTDRewardWrapper(RewardNet):
    """r = mean + alpha * std over an ensemble's members: a risk-sensitive
    reward for inference (the forward is the same)."""

    def __init__(self, base: RewardEnsemble, default_alpha: float = 0.0):
        super().__init__(base.observation_space, base.action_space)
        self.base = base
        self.default_alpha = default_alpha

    def init(self, generator: Optional[torch.Generator] = None) -> "AddSTDRewardWrapper":
        self.base.init(generator)
        return self

    def forward(self, obs, acts, next_obs, dones, update_stats: bool = False):
        return self.predict_processed(obs, acts, next_obs, dones)

    def predict_processed(self, obs, acts, next_obs, dones, update_stats: bool = False,
                          alpha: Optional[float] = None):
        if alpha is None:
            alpha = self.default_alpha
        mean, var = self.base.predict_reward_moments(obs, acts, next_obs, dones, update_stats=update_stats)
        return mean + alpha * torch.sqrt(var)
