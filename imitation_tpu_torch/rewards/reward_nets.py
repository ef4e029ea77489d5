"""Reward networks.

Port of ``imitation_tpu/rewards/reward_nets.py``: the ``RewardNet`` base
(preprocessing, ``predict_processed``, ``predict``), ``BasicRewardNet``, the
image net ``CnnRewardNet``, the potential-shaped nets
(``BasicPotentialMLP``, ``BasicPotentialCNN``, ``ShapedRewardNet``,
``BasicShapedRewardNet``), and the wrappers of preference comparisons:
``NormalizedRewardNet``, ``RewardEnsemble`` (of any member class) and
``AddSTDRewardWrapper``. A reward net maps ``(obs, acts, next_obs, dones)``
to rewards ``[B]``; the forward is the training path, ``predict_processed``
the inference path (output normalization, ensemble mean).

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
from torch.func import functional_call, vmap

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

    @torch.no_grad()
    def predict(self, obs, acts, next_obs, dones) -> np.ndarray:
        """``predict_processed`` from host arrays to a host array, with no
        gradient and no statistics folded in (``update_stats=False``), on
        the net's device (the CPU for a net without parameters)."""
        device = next(self.parameters(), torch.empty(0)).device
        args = (torch.as_tensor(np.asarray(x), device=device) for x in (obs, acts, next_obs, dones))
        return self.predict_processed(*args, update_stats=False).cpu().numpy()

    def init(self, generator: Optional[torch.Generator] = None) -> "RewardNet":
        """Re-initialises the weights from ``generator``; returns self."""
        raise NotImplementedError


def _one_hot(acts: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot ``[..., n]`` by comparison (it batches under vmap)."""
    return (acts.long()[..., None] == torch.arange(n, device=acts.device)).float()


def _scale_image(space: Space, x: torch.Tensor) -> torch.Tensor:
    """float32 ``x``, divided by 255 for an integer observation space."""
    x = x.float()
    if np.issubdtype(np.dtype(space.dtype), np.integer):
        x = x / 255.0
    return x


def _in_channels(space: Space) -> int:
    """The channel count of ``[H, W, C]`` (or one-channel ``[H, W]``) frames."""
    return space.shape[2] if len(space.shape) == 3 else 1


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


class CnnRewardNet(RewardNet):
    """CNN reward net for image observations and discrete actions.

    A ``CNN`` over the state (or the next state) gives one reward per
    action, dotted with the one-hot action (a single column without
    ``use_action``); with ``use_done`` the output doubles and ``done``
    selects the half. Integer observation spaces are divided by 255.
    """

    def __init__(
        self,
        observation_space: Space,
        action_space: Space,
        use_state: bool = True,
        use_action: bool = True,
        use_next_state: bool = False,
        use_done: bool = False,
        hid_channels: Sequence[int] = (32, 32),
        activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
        kernel_size: int = 3,
        stride: int = 1,
    ):
        super().__init__(observation_space, action_space)
        if not (use_state or use_next_state):
            raise ValueError("CnnRewardNet must take current or next state as input.")
        if not action_space.is_discrete and use_action:
            raise ValueError("CnnRewardNet uses one-hot actions: action space must be discrete.")
        self.use_state = use_state
        self.use_action = use_action
        self.use_done = use_done
        n_actions = action_space.n if use_action else 1
        self.out_size = n_actions * (2 if use_done else 1)
        self.cnn = networks.CNN(
            _in_channels(observation_space), hid_channels, out_size=self.out_size,
            activation=activation, kernel_size=kernel_size, stride=stride,
        )

    def init(self, generator: Optional[torch.Generator] = None) -> "CnnRewardNet":
        self.cnn.reset_parameters(generator)
        return self

    def forward(self, obs, acts, next_obs, dones, update_stats: bool = False):
        x = _scale_image(self.observation_space, obs if self.use_state else next_obs)
        outputs = self.cnn(x)  # [B, out_size]
        if self.use_action:
            one_hot = _one_hot(acts, self.action_space.n)
        else:
            one_hot = torch.ones((x.shape[0], 1), device=x.device)
        if self.use_done:
            n = self.out_size // 2
            d = dones.float()[:, None]
            per_action = outputs[:, :n] * (1 - d) + outputs[:, n:] * d
        else:
            per_action = outputs
        return (per_action * one_hot).sum(dim=-1)


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


class BasicPotentialCNN(nn.Module):
    """State-only potential function phi(s) over image observations: a
    (32, 32) ``CNN`` with one squeezed output."""

    def __init__(self, observation_space: Space, hid_channels: Sequence[int] = (32, 32)):
        super().__init__()
        self.observation_space = observation_space
        self.cnn = networks.CNN(
            _in_channels(observation_space), hid_channels, out_size=1, squeeze_output=True
        )

    def init(self, generator: Optional[torch.Generator] = None) -> "BasicPotentialCNN":
        self.cnn.reset_parameters(generator)
        return self

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.cnn(_scale_image(self.observation_space, obs))


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


class VmapMembers(RewardNet):
    """``num_members`` reward nets of one class as one module, the JAX
    package's ``nn.vmap`` over members: every parameter of ``member`` is
    stacked member-first (a ``Linear`` weight as ``[M, in, out]``, flax's
    stacked kernel; a conv weight as ``[M, out, in, k, k]``) under the
    member's own names, and the forward runs ``member``'s forward on each
    member's slice with ``torch.func.vmap(functional_call)``. It returns
    ``[M, B]`` from inputs shared by all members, or from one set per member
    (``obs [M, B, ...]``, ``dones [M, B]``). ``member`` serves as the
    template of the call only; its own weights are not used."""

    def __init__(self, member: RewardNet, num_members: int):
        super().__init__(member.observation_space, member.action_space)
        if any(True for _ in member.buffers()):
            raise ValueError("VmapMembers stacks parameters only; the member has buffers")
        self.num_members = num_members
        self._template = [member]  # a list, so it is not a submodule
        self._dense = {f"{name}.weight" for name, m in member.named_modules() if isinstance(m, nn.Linear)}
        self._fan_in = {}
        for name, m in member.named_modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                self._fan_in[f"{name}.weight"] = m.weight[0].numel()
        for name, p in member.named_parameters():
            shape = tuple(p.shape[::-1]) if name in self._dense else tuple(p.shape)
            *path, leaf = name.split(".")
            owner = self
            for part in path:
                if not hasattr(owner, part):
                    owner.add_module(part, nn.Module())
                owner = getattr(owner, part)
            owner.register_parameter(leaf, nn.Parameter(torch.zeros((num_members,) + shape)))

    def init(self, generator: Optional[torch.Generator] = None) -> "VmapMembers":
        """Each member's weights LeCun-normal over their own fan-in (flax's
        init of a vmapped member), biases zero."""
        for name, p in self.named_parameters():
            if name in self._fan_in:
                networks.lecun_normal_(p, generator, fan_in=self._fan_in[name])
            else:
                with torch.no_grad():
                    p.zero_()
        return self

    def forward(self, obs, acts, next_obs, dones, update_stats: bool = False):
        params = {name: p.transpose(-1, -2) if name in self._dense else p
                  for name, p in self.named_parameters()}
        template = self._template[0]

        def member(p, o, a, no, d):
            return functional_call(template, p, (o, a, no, d))

        per_member = 0 if dones.dim() > 1 else None
        return vmap(member, in_dims=(0,) + (per_member,) * 4)(params, obs, acts, next_obs, dones)


class RewardEnsemble(RewardNet):
    """``num_members`` reward nets with mean and variance predictions.

    ``BasicRewardNet`` members are one ``BasicRewardNet(num_members=M)``
    module (``members``): each layer's member weights are stacked and all
    members are evaluated by one batched product per layer. Members of any
    other class (``CnnRewardNet``) are one ``VmapMembers`` module. With
    ``member_normalize_cls`` the members are wrapped in a
    ``NormalizedRewardNet`` with per-member output statistics. The forward
    (training path) returns the raw member outputs ``[M, B]``;
    ``predict_processed`` their mean.
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
        if not (isinstance(member_cls, type) and issubclass(member_cls, RewardNet)):
            # The JAX package's nn.vmap takes module classes only (a factory
            # such as BasicShapedRewardNet fails there too).
            raise TypeError(f"member_cls must be a RewardNet class, not {member_cls!r}")
        self.member_cls = member_cls
        self.num_members = num_members
        self.member_kwargs = dict(member_kwargs or {})
        self.member_normalize_cls = member_normalize_cls
        members: RewardNet
        if member_cls is BasicRewardNet:
            members = BasicRewardNet(
                observation_space, action_space, num_members=num_members, **self.member_kwargs
            )
        else:
            members = VmapMembers(
                member_cls(observation_space, action_space, **self.member_kwargs), num_members
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
