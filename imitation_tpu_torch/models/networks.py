"""Network building blocks: the MLP, the CNN and running input normalization.

Port of ``imitation_tpu/models/networks.py``:

* ``MLP`` / ``build_mlp``: hidden sizes, optional input normalization layer,
  squeezed scalar output. Layers keep the flax names (``dense0``, ...,
  ``dense_out``, ``input_norm``) so ``convert.py`` maps weights one to one.
* ``CNN`` / ``build_cnn``: a conv stack (``conv0``, ...) over NHWC images,
  a mean over height and width, and ``dense_out``. The convolutions run
  NCHW with explicit padding: ``"SAME"`` pads as XLA does, ``max((ceil(H /
  s) - 1) * s + k - H, 0)`` in all, the larger half after.
* ``NormLayer``: the base of the input normalization layers, whose
  statistics are buffers; ``RunningNorm``: Chan et al. streaming moments with
  the same update rule, including the first batch adopting its own
  statistics outright; ``EMANorm``: bias-corrected exponential moving
  averages of the moments. With ``members=M`` a layer keeps M independent
  sets of statistics (``[M, F]``), as ``nn.vmap`` over members does.
  Inside ``parallel.distributed.local_rows`` (a data-parallel rank's rows)
  an update folds the moments of every rank's rows together.
* ``StackedMLP``: M MLPs of one shape whose layers are stacked ``[M, in,
  out]`` and evaluated for all members in one batched product per layer
  (the members of a ``RewardEnsemble``).

Linear and conv layers are initialised as flax's ``Dense`` and ``Conv``
are: LeCun-normal kernels (a normal truncated at two standard deviations,
variance 1/fan_in, fan_in = k * k * C_in for a conv) and zero biases, drawn
from an explicit ``torch.Generator``.

Dtype policy, as in the JAX package: parameters stay float32;
``compute_dtype`` (e.g. ``torch.bfloat16``) runs the products and
convolutions in that dtype, with the parameters cast to it at use, and the
output is cast back to float32. Normalizer statistics stay float32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple, Type

import torch
import torch.nn.functional as F
from torch import nn

from imitation_tpu_torch.parallel import distributed

# Std of a standard normal truncated to [-2, 2] (flax's variance_scaling).
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: Optional[torch.Generator] = None,
                  fan_in: Optional[int] = None) -> None:
    """flax ``lecun_normal`` for a torch ``[out, in]`` weight (fan_in the
    weight's dim 1 unless given), in place."""
    fan_in = weight.shape[1] if fan_in is None else fan_in
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def dense(in_size: int, out_size: int) -> nn.Linear:
    """A float32 linear layer with flax ``Dense`` initialisation."""
    layer = nn.Linear(in_size, out_size)
    init_dense_(layer)
    return layer


def init_dense_(layer: nn.Linear, generator: Optional[torch.Generator] = None) -> None:
    lecun_normal_(layer.weight, generator)
    with torch.no_grad():
        layer.bias.zero_()


def conv2d(in_channels: int, out_channels: int, kernel_size: int, stride: int = 1) -> nn.Conv2d:
    """A float32 conv layer (OIHW weight, no padding of its own) with flax
    ``Conv`` initialisation."""
    layer = nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride)
    init_conv_(layer)
    return layer


def init_conv_(layer: nn.Conv2d, generator: Optional[torch.Generator] = None) -> None:
    o, i, kh, kw = layer.weight.shape
    lecun_normal_(layer.weight, generator, fan_in=i * kh * kw)
    with torch.no_grad():
        layer.bias.zero_()


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` in ``x``'s dtype: the float32 parameters are cast to it
    (flax's ``Dense(dtype=...)``)."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: (before, after)."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_nchw(layer: nn.Conv2d, x: torch.Tensor, padding: str = "VALID") -> torch.Tensor:
    """``layer`` over NCHW ``x`` in ``x``'s dtype, with flax's ``"SAME"`` or
    ``"VALID"`` padding."""
    if padding == "SAME":
        (kh, kw), (sh, sw) = layer.kernel_size, layer.stride
        top, bottom = same_padding(x.shape[2], kh, sh)
        left, right = same_padding(x.shape[3], kw, sw)
        x = F.pad(x, (left, right, top, bottom))
    elif padding != "VALID":
        raise ValueError(f"padding {padding!r} is not 'SAME' or 'VALID'")
    return F.conv2d(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype), stride=layer.stride)


class NormLayer(nn.Module):
    """Base of the input normalization layers with streaming statistics.

    The statistics are buffers (``running_mean``, ``running_var``,
    ``count``). ``update_stats=True`` folds the batch in before normalizing,
    matching the JAX layers' train-time behaviour; subclasses define
    ``update``. With ``members=M`` every buffer gains a leading member axis
    and inputs are ``[M, ..., F]``: member m is normalized, and updated, by
    its own statistics.
    """

    def __init__(self, num_features: int, eps: float = 1e-5, members: Optional[int] = None):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.members = members
        lead = () if members is None else (members,)
        self.register_buffer("running_mean", torch.zeros(lead + (num_features,)))
        self.register_buffer("running_var", torch.ones(lead + (num_features,)))
        self.register_buffer("count", torch.zeros(lead, dtype=torch.int32))

    def reset_stats(self) -> None:
        self.running_mean.zero_()
        self.running_var.fill_(1.0)
        self.count.zero_()

    def update(self, x: torch.Tensor) -> None:
        raise NotImplementedError

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as float32 rows ``[N, F]``, or ``[M, N, F]`` per member."""
        lead = () if self.members is None else (self.members,)
        return x.reshape(lead + (-1, self.num_features)).float()

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        if update_stats:
            self.update(x)
        mean, var = self.running_mean, self.running_var
        if self.members is not None:  # [M, F] against [M, ..., F]
            shape = (self.members,) + (1,) * (x.dim() - 2) + (self.num_features,)
            mean, var = mean.reshape(shape), var.reshape(shape)
        out = (x - mean) * torch.rsqrt(var + self.eps)
        # Normalized in float32, returned in a float x's dtype (bfloat16 compute).
        return out.to(x.dtype) if x.is_floating_point() else out


class RunningNorm(NormLayer):
    """Streaming mean/var via the Chan et al. parallel update."""

    @torch.no_grad()
    def update(self, x: torch.Tensor) -> None:
        b = self._rows(x)
        # The global batch's moments on a data-parallel rank's rows.
        b_count, b_mean, b_var = distributed.row_moments(b)
        count = self.count[..., None]
        total = count + b_count
        denom = torch.clamp(total, min=1)
        delta = b_mean - self.running_mean
        new_mean = self.running_mean + delta * (b_count / denom)
        m_a = self.running_var * count
        m_b = b_var * b_count
        m2 = m_a + m_b + delta * delta * count * b_count / denom
        new_var = m2 / denom
        # First batch: adopt the batch stats outright (the var init of 1 must
        # not pollute them).
        is_first = count == 0
        self.running_mean.copy_(torch.where(is_first, b_mean, new_mean))
        self.running_var.copy_(torch.where(is_first, b_var, new_var))
        self.count.copy_(total[..., 0])


class EMANorm(NormLayer):
    """Bias-corrected EMA of the mean and of the mean square.

    The raw (uncorrected) accumulators are the buffers ``raw_mean`` and
    ``raw_sq``; ``count`` counts updates, not rows. After ``k`` updates the
    moments are the raw ones divided by ``1 - decay**k``, and the variance is
    the corrected mean square less the squared corrected mean, floored at 0.
    """

    def __init__(self, num_features: int, eps: float = 1e-5, decay: float = 0.99,
                 members: Optional[int] = None):
        super().__init__(num_features, eps, members)
        self.decay = decay
        self.register_buffer("raw_mean", torch.zeros_like(self.running_mean))
        self.register_buffer("raw_sq", torch.zeros_like(self.running_mean))

    def reset_stats(self) -> None:
        super().reset_stats()
        self.raw_mean.zero_()
        self.raw_sq.zero_()

    @torch.no_grad()
    def update(self, x: torch.Tensor) -> None:
        b = self._rows(x)
        d = self.decay
        self.raw_mean.copy_(d * self.raw_mean + (1 - d) * distributed.row_mean(b))
        self.raw_sq.copy_(d * self.raw_sq + (1 - d) * distributed.row_mean(b * b))
        self.count.add_(1)
        correction = 1.0 - torch.pow(d, self.count[..., None].float())  # float32, as in JAX
        corr_mean = self.raw_mean / correction
        corr_sq = self.raw_sq / correction
        self.running_mean.copy_(corr_mean)
        self.running_var.copy_(torch.clamp(corr_sq - corr_mean * corr_mean, min=0.0))


class MLP(nn.Module):
    """MLP with the ``build_mlp`` feature set (no dropout). Inputs of rank
    above 2 are flattened; ``compute_dtype`` runs the layers in that dtype
    after the input normalizer and returns float32."""

    def __init__(
        self,
        in_size: int,
        hid_sizes: Sequence[int],
        out_size: int = 1,
        activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
        squeeze_output: bool = False,
        normalize_input_layer: Optional[Type[NormLayer]] = None,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if squeeze_output and out_size != 1:
            raise ValueError("squeeze_output is only valid with out_size=1")
        self.hid_sizes = tuple(hid_sizes)
        self.activation = activation
        self.squeeze_output = squeeze_output
        self.compute_dtype = compute_dtype
        self.input_norm = (
            normalize_input_layer(in_size) if normalize_input_layer is not None else None
        )
        size = in_size
        for i, h in enumerate(self.hid_sizes):
            self.add_module(f"dense{i}", dense(size, h))
            size = h
        self.dense_out = dense(size, out_size)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for i in range(len(self.hid_sizes)):
            init_dense_(getattr(self, f"dense{i}"), generator)
        init_dense_(self.dense_out, generator)
        if self.input_norm is not None:
            self.input_norm.reset_stats()

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        if x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        if self.input_norm is not None:
            x = self.input_norm(x, update_stats=update_stats)
        x = x.to(self.compute_dtype)
        for i in range(len(self.hid_sizes)):
            x = self.activation(linear(getattr(self, f"dense{i}"), x))
        x = linear(self.dense_out, x).float()
        if self.squeeze_output:
            x = x.squeeze(-1)
        return x


def build_mlp(in_size: int, hid_sizes: Sequence[int], out_size: int = 1, **kwargs) -> MLP:
    """An ``MLP`` (the JAX package's ``build_mlp``; the port's layers are
    sized at construction, so it takes the input size first)."""
    return MLP(in_size, tuple(hid_sizes), out_size, **kwargs)


class CNN(nn.Module):
    """Conv stack + mean over height and width + dense head (``build_cnn``,
    no dropout). Input NHWC ``[B, H, W, C]``, or ``[B, H, W]`` with one
    channel; ``compute_dtype`` as in ``MLP``."""

    def __init__(
        self,
        in_channels: int,
        hid_channels: Sequence[int],
        out_size: int = 1,
        activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
        kernel_size: int = 3,
        stride: int = 1,
        padding: str = "SAME",
        squeeze_output: bool = False,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if squeeze_output and out_size != 1:
            raise ValueError("squeeze_output is only valid with out_size=1")
        self.hid_channels = tuple(hid_channels)
        self.activation = activation
        self.padding = padding
        self.squeeze_output = squeeze_output
        self.compute_dtype = compute_dtype
        size = in_channels
        for i, ch in enumerate(self.hid_channels):
            self.add_module(f"conv{i}", conv2d(size, ch, kernel_size, stride))
            size = ch
        self.dense_out = dense(size, out_size)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for i in range(len(self.hid_channels)):
            init_conv_(getattr(self, f"conv{i}"), generator)
        init_dense_(self.dense_out, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            x = x[..., None]
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW
        for i in range(len(self.hid_channels)):
            x = self.activation(conv_nchw(getattr(self, f"conv{i}"), x, self.padding))
        # The mean is taken in float32 and rounded to the compute dtype, as
        # jnp.mean does for bfloat16.
        x = x.float().mean(dim=(2, 3)).to(self.compute_dtype)
        x = linear(self.dense_out, x).float()
        if self.squeeze_output:
            x = x.squeeze(-1)
        return x


def build_cnn(in_channels: int, hid_channels: Sequence[int], out_size: int = 1, **kwargs) -> CNN:
    """A ``CNN`` (the JAX package's ``build_cnn``, with the input's channel
    count first)."""
    return CNN(in_channels, tuple(hid_channels), out_size, **kwargs)


class StackedMLP(nn.Module):
    """``members`` MLPs of one shape, layers ``dense{i}`` and ``dense_out``
    with weights ``[M, in, out]`` and biases ``[M, out]`` (flax's kernel
    layout under ``nn.vmap``). ``forward`` takes inputs shared by every
    member, ``[B, in]``, or one set per member, ``[M, B, in]``, and runs each
    layer for all members as one batched product (``baddbmm``)."""

    def __init__(
        self,
        members: int,
        in_size: int,
        hid_sizes: Sequence[int],
        out_size: int = 1,
        activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
        squeeze_output: bool = False,
    ):
        super().__init__()
        if squeeze_output and out_size != 1:
            raise ValueError("squeeze_output is only valid with out_size=1")
        self.members = members
        self.hid_sizes = tuple(hid_sizes)
        self.activation = activation
        self.squeeze_output = squeeze_output
        size = in_size
        for name, out in [(f"dense{i}", h) for i, h in enumerate(self.hid_sizes)] + [("dense_out", out_size)]:
            layer = nn.Module()
            layer.weight = nn.Parameter(torch.empty(members, size, out))
            layer.bias = nn.Parameter(torch.zeros(members, out))
            self.add_module(name, layer)
            size = out
        self.reset_parameters()

    def _layers(self):
        return [getattr(self, f"dense{i}") for i in range(len(self.hid_sizes))] + [self.dense_out]

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Each member's kernel LeCun-normal over its fan-in, biases zero."""
        for layer in self._layers():
            lecun_normal_(layer.weight, generator)  # fan_in is dim 1 of [M, in, out]
            with torch.no_grad():
                layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:
            x = x.expand(self.members, -1, -1)
        layers = self._layers()
        for i, layer in enumerate(layers):
            x = torch.baddbmm(layer.bias[:, None, :], x, layer.weight)
            if i < len(layers) - 1:
                x = self.activation(x)
        if self.squeeze_output:
            x = x.squeeze(-1)
        return x
