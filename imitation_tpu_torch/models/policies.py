"""Actor-critic policy network and the policy interface.

Port of ``imitation_tpu/models/policies.py``. The JAX package pairs a flax
module definition with a separate variables dict; here ``ActorCriticPolicy``
is an ``nn.Module`` that owns its parameters, and its methods take only the
observations:

* ``distribution(obs)``, ``value(obs)``, ``dist_and_value(obs)``;
* ``evaluate_actions(obs, acts, update_stats=False)`` -> (log_prob,
  entropy, value), SB3's ``evaluate_actions``;
* ``sample_fn()`` and ``deterministic_fn()`` (the distribution's mode) ->
  rollout closures ``(obs, generator) -> (acts, {"log_prob", "value"})``;
* ``predict(obs, deterministic, seed)``: numpy in, numpy out, SB3 style.

``features="nature_cnn"`` puts SB3's NatureCNN in front of the torsos for
image observations ``[B, H, W, C]`` (or ``[B, H, W]``): the input divided
by 255, three VALID convs (32 8x8/4, 64 4x4/2, 64 3x3/1) with ReLU, a
flatten in flax's NHWC order (h, w, c), and ``cnn_fc`` (512, ReLU).
``ActorCriticNet``'s ``compute_dtype`` runs the layers in that dtype
(parameters and feature statistics stay float32; logits and values come
back float32).

Dict observations (a ``DictSpace``; a dict of ``[B, ...]`` tensors) are
flattened per key and concatenated in sorted key order before
``feat_norm``, as the JAX package's ``ActorCriticNet`` does (the reference's
``CombinedExtractor``).

``FeedForward32Policy`` is the (32, 32) actor-critic; ``RandomPolicy`` and
``ZeroPolicy`` are the non-trainable baselines, with the same rollout
closures.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from imitation_tpu_torch import make_generator
from imitation_tpu_torch.data.rollout import module_fn
from imitation_tpu_torch.envs.base import DictSpace, Space
from imitation_tpu_torch.models import networks
from imitation_tpu_torch.models.distributions import Categorical, DiagGaussian


# NatureCNN's convs: (name, out channels, kernel, stride), all VALID.
NATURE_CNN = (("conv32_8", 32, 8, 4), ("conv64_4", 64, 4, 2), ("conv64_3", 64, 3, 1))
FEATURES = ("flatten", "nature_cnn")


def features_dim(space: Union[Space, DictSpace]) -> int:
    """The width of the flattened observation: a dict space's sub-spaces
    each flattened to their shape's size (a discrete one to 1)."""
    if isinstance(space, DictSpace):
        return sum(int(np.prod(s.shape)) for s in space.spaces.values())
    return space.flat_dim


def nature_cnn_flat_dim(obs_shape: Sequence[int]) -> int:
    """The flatten size of NatureCNN's last conv over ``[H, W(, C)]``
    frames: 96 -> 23 -> 10 -> 8 gives 8 * 8 * 64 = 4,096."""
    h, w = obs_shape[:2]
    for _, _, k, s in NATURE_CNN:
        h, w = (h - k) // s + 1, (w - k) // s + 1
    if h < 1 or w < 1:
        raise ValueError(f"NatureCNN needs frames of at least 36 pixels, not {tuple(obs_shape)}")
    return h * w * NATURE_CNN[-1][1]


class ActorCriticNet(nn.Module):
    """Shared-input actor-critic with separate pi/vf MLP torsos.

    SB3's ``ActorCriticPolicy(net_arch=[32, 32])`` (the reference's
    ``FeedForward32Policy``), or with ``features="nature_cnn"`` its
    ``CnnPolicy`` over ``obs_shape`` frames. Continuous actions use a
    state-independent learned ``log_std``. Layer names follow the flax
    module: ``conv32_8``, ``conv64_4``, ``conv64_3``, ``cnn_fc``, ``pi{i}``,
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
        features: str = "flatten",
        obs_shape: Optional[Sequence[int]] = None,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if features not in FEATURES:
            raise ValueError(f"features {features!r} not in {FEATURES}")
        self.action_space = action_space
        self.hid_sizes = tuple(hid_sizes)
        self.activation = activation
        self.log_std_init = log_std_init
        self.features = features
        self.compute_dtype = compute_dtype
        if features == "nature_cnn":
            channels = obs_shape[2] if len(obs_shape) == 3 else 1
            for name, out, k, s in NATURE_CNN:
                self.add_module(name, networks.conv2d(channels, out, k, s))
                channels = out
            self.cnn_fc = networks.dense(nature_cnn_flat_dim(obs_shape), 512)
            obs_dim = 512
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
        if self.features == "nature_cnn":
            for name, _, _, _ in NATURE_CNN:
                networks.init_conv_(getattr(self, name), generator)
            networks.init_dense_(self.cnn_fc, generator)
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

    def _extract(self, obs) -> torch.Tensor:
        """The features before ``feat_norm``, in the compute dtype."""
        if isinstance(obs, Mapping):
            return torch.cat([obs[k].reshape(obs[k].shape[0], -1).to(self.compute_dtype)
                              for k in sorted(obs)], dim=-1)
        if self.features == "flatten":
            return obs.reshape(obs.shape[0], -1).to(self.compute_dtype)
        x = obs.to(self.compute_dtype)
        if x.dim() == 3:
            x = x[..., None]
        x = (x / 255.0).permute(0, 3, 1, 2)  # NHWC -> NCHW
        for name, _, _, _ in NATURE_CNN:
            x = torch.relu(networks.conv_nchw(getattr(self, name), x))
        # Back to NHWC before the flatten, so cnn_fc's rows are in flax's
        # (h, w, c) order and its weights carry across unpermuted.
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return torch.relu(networks.linear(self.cnn_fc, x))

    def _features(self, obs: torch.Tensor, update_stats: bool) -> torch.Tensor:
        x = self._extract(obs)
        if self.feat_norm is not None:
            x = self.feat_norm(x, update_stats=update_stats)
        return x

    @torch.no_grad()
    def update_feature_stats(self, obs: torch.Tensor) -> None:
        """Folds ``obs``'s features into ``feat_norm``'s statistics."""
        self.feat_norm.update(self._extract(obs))

    def _dist(self, x: torch.Tensor):
        for i in range(len(self.hid_sizes)):
            x = self.activation(networks.linear(getattr(self, f"pi{i}"), x))
        out = networks.linear(self.pi_out, x).float()
        if self.action_space.is_discrete:
            return Categorical(logits=out)
        return DiagGaussian(mean=out, log_std=self.log_std)

    def forward(self, obs: torch.Tensor, update_stats: bool = False):
        x = self._features(obs, update_stats)
        vf_x = x
        for i in range(len(self.hid_sizes)):
            vf_x = self.activation(networks.linear(getattr(self, f"vf{i}"), vf_x))
        return self._dist(x), networks.linear(self.vf_out, vf_x).float().squeeze(-1)

    def distribution(self, obs: torch.Tensor):
        """The action distribution alone (the value torso is not run)."""
        return self._dist(self._features(obs, update_stats=False))


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
        features: str = "flatten",
    ):
        super().__init__()
        self.observation_space = observation_space
        self.action_space = action_space
        self.normalize_features = normalize_features
        self.features = features
        self.net = ActorCriticNet(
            features_dim(observation_space),
            action_space,
            hid_sizes=hid_sizes,
            activation=activation,
            normalize_features=normalize_features,
            log_std_init=log_std_init,
            features=features,
            obs_shape=None if isinstance(observation_space, DictSpace) else tuple(observation_space.shape),
        )

    def init(self, generator: Optional[torch.Generator] = None) -> "ActorCriticPolicy":
        """Re-initialises the weights from ``generator``; returns self."""
        self.net.reset_parameters(generator)
        return self

    def distribution(self, obs: torch.Tensor):
        return self.net.distribution(obs)

    def value(self, obs: torch.Tensor) -> torch.Tensor:
        return self.net(obs)[1]

    def dist_and_value(self, obs: torch.Tensor):
        return self.net(obs)

    def _format_act(self, act: torch.Tensor) -> torch.Tensor:
        if self.action_space.is_discrete:
            return act.to(torch.int32)
        return act.reshape((-1,) + tuple(self.action_space.shape))

    def _rollout_fn(self, deterministic: bool):
        @torch.no_grad()
        def f(obs: torch.Tensor, generator: Optional[torch.Generator] = None):
            dist, value = self.net(obs)
            acts = dist.mode() if deterministic else dist.sample(generator)
            return self._format_act(acts), {"log_prob": dist.log_prob(acts), "value": value}

        return f

    def sample_fn(self):
        """(obs, generator) -> (acts, {log_prob, value}) for rollouts."""
        return module_fn(self, functools.partial(ActorCriticPolicy._rollout_fn, deterministic=False))

    def deterministic_fn(self):
        """As ``sample_fn``, with the distribution's mode for the action."""
        return module_fn(self, functools.partial(ActorCriticPolicy._rollout_fn, deterministic=True))

    def predict(self, obs, deterministic: bool = False, seed: int = 0) -> np.ndarray:
        """SB3-style host prediction: numpy observations in (one, or a batch
        with a leading axis; a dict of batches for dict observations),
        numpy actions out. Sampling draws from a generator seeded with
        ``seed`` on the policy's device."""
        device = next(self.parameters()).device
        if isinstance(obs, Mapping):
            obs_t, single = {k: torch.as_tensor(np.asarray(v), device=device) for k, v in obs.items()}, False
        else:
            obs_t = torch.as_tensor(np.asarray(obs), device=device)
            single = obs_t.dim() == len(self.observation_space.shape)
        if single:
            obs_t = obs_t[None]
        fn = self.deterministic_fn() if deterministic else self.sample_fn()
        acts, _ = fn(obs_t, make_generator(seed, device))
        acts = acts.cpu().numpy()
        return acts[0] if single else acts

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


def FeedForward32Policy(observation_space: Space, action_space: Space, **kwargs) -> ActorCriticPolicy:
    """The (32, 32) actor-critic, the reference's ``FeedForward32Policy``."""
    return ActorCriticPolicy(observation_space, action_space, hid_sizes=(32, 32), **kwargs)


# ---------------------------------------------------------------------------
# Non-trainable policies
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RandomPolicy:
    """Uniform-random actions (``Space.sample``)."""

    observation_space: Space
    action_space: Space

    def init(self, generator: Optional[torch.Generator] = None) -> "RandomPolicy":
        return self

    def sample_fn(self):
        space = self.action_space

        def f(obs: torch.Tensor, generator: torch.Generator):
            return space.sample(obs.shape[0], generator), {}

        return f

    deterministic_fn = sample_fn


@dataclasses.dataclass
class ZeroPolicy:
    """All-zero actions: int32 for a discrete space, float32 for a box."""

    observation_space: Space
    action_space: Space

    def init(self, generator: Optional[torch.Generator] = None) -> "ZeroPolicy":
        return self

    def sample_fn(self):
        space = self.action_space
        dtype = torch.int32 if space.is_discrete else torch.float32

        def f(obs: torch.Tensor, generator: Optional[torch.Generator] = None):
            return torch.zeros((obs.shape[0],) + tuple(space.shape), dtype=dtype, device=obs.device), {}

        return f

    deterministic_fn = sample_fn
