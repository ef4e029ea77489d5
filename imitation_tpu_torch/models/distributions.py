"""Action distributions: Categorical, DiagGaussian and SquashedGaussian.

Port of ``imitation_tpu/models/distributions.py``. Sampling takes an explicit
``torch.Generator``; it does not reproduce ``jax.random``'s bits, so tests
compare log-probabilities and entropies, not samples, or feed the JAX
package's noise to ``DiagGaussian`` and ``SquashedGaussian`` through
``_standard_normal``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from imitation_tpu_torch.parallel import distributed

_LOG_2PI = math.log(2.0 * math.pi)
_LOG_2 = math.log(2.0)


def _standard_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard-normal noise of a Gaussian or squashed-Gaussian sample, on
    the generator's device (tests substitute the JAX package's draws)."""
    return torch.randn(shape, generator=generator, device=generator.device)


def _noise(shape, generator: torch.Generator) -> torch.Tensor:
    """``_standard_normal`` for a batch of rows: a data-parallel rank's rows
    (``parallel.distributed.local_rows``) take their block of the whole
    batch's draw."""
    return distributed.draw_rows(lambda s: _standard_normal(s, generator), shape)


@dataclasses.dataclass
class Categorical:
    """Categorical over the last axis of ``logits``."""

    logits: torch.Tensor  # [..., n]

    @property
    def log_probs_all(self) -> torch.Tensor:
        return F.log_softmax(self.logits, dim=-1)

    def log_prob(self, actions: torch.Tensor) -> torch.Tensor:
        lp = self.log_probs_all
        return torch.gather(lp, -1, actions.long().unsqueeze(-1)).squeeze(-1)

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Gumbel-max sampling, as ``jax.random.categorical`` does."""
        u = distributed.draw_rows(
            lambda s: torch.rand(s, generator=generator, device=self.logits.device),
            self.logits.shape,
        ).clamp_(min=torch.finfo(torch.float32).tiny)
        return torch.argmax(self.logits - torch.log(-torch.log(u)), dim=-1)

    def mode(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1)

    def entropy(self) -> torch.Tensor:
        lp = self.log_probs_all
        return -(torch.exp(lp) * lp).sum(dim=-1)

    def kl(self, other: "Categorical") -> torch.Tensor:
        """KL(self || other) over the last axis."""
        lp, lq = self.log_probs_all, other.log_probs_all
        return (torch.exp(lp) * (lp - lq)).sum(dim=-1)


@dataclasses.dataclass
class DiagGaussian:
    """Diagonal Gaussian; log_prob sums over the last (action) axis."""

    mean: torch.Tensor  # [..., d]
    log_std: torch.Tensor  # [..., d] or [d] (state-independent)

    def _lstd(self) -> torch.Tensor:
        return self.log_std.expand_as(self.mean)

    def log_prob(self, actions: torch.Tensor) -> torch.Tensor:
        lstd = self._lstd()
        z = (actions - self.mean) * torch.exp(-lstd)
        per_dim = -0.5 * (z * z + _LOG_2PI) - lstd
        return per_dim.sum(dim=-1)

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if generator is None:
            eps = torch.randn(self.mean.shape, device=self.mean.device)
        else:
            eps = _noise(tuple(self.mean.shape), generator)
        return self.mean + eps * torch.exp(self._lstd())

    def mode(self) -> torch.Tensor:
        return self.mean

    def entropy(self) -> torch.Tensor:
        lstd = self._lstd()
        return (0.5 * (1.0 + _LOG_2PI) + lstd).sum(dim=-1)


def _tanh_log_det(pre: torch.Tensor) -> torch.Tensor:
    """log|d tanh/dx| = log(1 - tanh^2 x) = 2*(log2 - x - softplus(-2x)),
    summed over the action axis (the numerically stable form)."""
    return (2.0 * (_LOG_2 - pre - F.softplus(-2.0 * pre))).sum(dim=-1)


@dataclasses.dataclass
class SquashedGaussian:
    """tanh-squashed diagonal Gaussian (SAC); actions in (-1, 1)."""

    mean: torch.Tensor  # [..., d]
    log_std: torch.Tensor  # [..., d]

    def sample_and_log_prob(self, generator: torch.Generator):
        """(tanh(mean + eps*std), log-prob): the base log-prob taken from
        the noise ``eps``, less the tanh correction."""
        lstd = self.log_std.expand_as(self.mean)
        eps = _noise(tuple(self.mean.shape), generator)
        pre = self.mean + eps * torch.exp(lstd)
        base_lp = (-0.5 * (eps * eps + _LOG_2PI) - lstd).sum(dim=-1)
        return torch.tanh(pre), base_lp - _tanh_log_det(pre)

    def log_prob(self, actions: torch.Tensor) -> torch.Tensor:
        """Log-prob of squashed actions, clipped to +-(1 - 1e-6) first."""
        pre = torch.atanh(torch.clamp(actions, -1.0 + 1e-6, 1.0 - 1e-6))
        lstd = self.log_std.expand_as(self.mean)
        z = (pre - self.mean) * torch.exp(-lstd)
        base_lp = (-0.5 * (z * z + _LOG_2PI) - lstd).sum(dim=-1)
        return base_lp - _tanh_log_det(pre)

    def mode(self) -> torch.Tensor:
        return torch.tanh(self.mean)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        return self.sample_and_log_prob(generator)[0]
