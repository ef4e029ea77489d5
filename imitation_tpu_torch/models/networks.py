"""Network building blocks: the MLP and running input normalization.

Port of ``imitation_tpu/models/networks.py``:

* ``MLP``: hidden sizes, optional input normalization layer,
  squeezed scalar output. Layers keep the flax names (``dense0``, ...,
  ``dense_out``, ``input_norm``) so ``convert.py`` maps weights one to one.
* ``RunningNorm``: Chan et al. streaming moments with the same update rule,
  including the first batch adopting its own statistics outright.

Linear layers are initialised as flax's ``Dense`` is: LeCun-normal kernels
(a normal truncated at two standard deviations, variance 1/fan_in) and zero
biases, drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Type

import torch
from torch import nn

# Std of a standard normal truncated to [-2, 2] (flax's variance_scaling).
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: Optional[torch.Generator] = None) -> None:
    """flax ``lecun_normal`` for a torch ``[out, in]`` weight, in place."""
    fan_in = weight.shape[1]
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


class RunningNorm(nn.Module):
    """Streaming mean/var via the Chan et al. parallel update.

    The statistics are buffers (``running_mean``, ``running_var``, ``count``).
    ``update_stats=True`` folds the batch in before normalizing, matching the
    JAX layer's train-time behaviour.
    """

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("count", torch.zeros((), dtype=torch.int32))

    def reset_stats(self) -> None:
        self.running_mean.zero_()
        self.running_var.fill_(1.0)
        self.count.zero_()

    @torch.no_grad()
    def update(self, x: torch.Tensor) -> None:
        b = x.reshape(-1, self.num_features).float()
        b_count = b.shape[0]
        b_mean = b.mean(dim=0)
        b_var = b.var(dim=0, unbiased=False)
        count = self.count
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
        self.count.copy_(total)

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        if update_stats:
            self.update(x)
        return (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)


class MLP(nn.Module):
    """MLP with the ``build_mlp`` feature set used by this slice."""

    def __init__(
        self,
        in_size: int,
        hid_sizes: Sequence[int],
        out_size: int = 1,
        activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
        squeeze_output: bool = False,
        normalize_input_layer: Optional[Type[RunningNorm]] = None,
    ):
        super().__init__()
        if squeeze_output and out_size != 1:
            raise ValueError("squeeze_output is only valid with out_size=1")
        self.hid_sizes = tuple(hid_sizes)
        self.activation = activation
        self.squeeze_output = squeeze_output
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
        for i in range(len(self.hid_sizes)):
            x = self.activation(getattr(self, f"dense{i}")(x))
        x = self.dense_out(x)
        if self.squeeze_output:
            x = x.squeeze(-1)
        return x
